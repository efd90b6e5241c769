"""The port's evaluation CLI (``vmap_tpu_torch.eval.eval_3d``) against the
JAX package's (``vmap_tpu.eval.eval_3d``) over the same mesh directory and
GT, on the CPU: the object protocol (Replica, and ScanNet's id offset and
background vocabulary) and the scene protocol. Every metric within 1e-6
of JAX's; the same objects scored, skipped and empty after the crop."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vmap_tpu.eval import eval_3d as jeval
from vmap_tpu_torch.eval import eval_3d as teval
from vmap_tpu_torch.geometry.mesh import Mesh
from vmap_tpu_torch.geometry.primitives import box, icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
FRAME = 7


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A reconstruction (background, two objects, one without GT, one far
    from its GT) and its GT: per-object submeshes, background-class
    submeshes and info_semantic.json in both vocabularies, the GT scene."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(3)
    mesh_dir, gt_dir = root / "scene_mesh", root / "habitat"
    mesh_dir.mkdir()
    gt_dir.mkdir()

    def jitter(m: Mesh, s: float) -> Mesh:
        return Mesh(m.vertices + rng.normal(scale=s, size=m.vertices.shape),
                    m.faces)

    floor = box([-2, 0, -2], [2, 0.02, 2])
    wall = box([-2, -1.5, 1.98], [2, 0, 2])
    sphere = icosphere(0.4, (0.5, -0.4, 0.0), subdivisions=3)
    crate = box([-1.2, -0.5, -0.8], [-0.6, 0.0, -0.3])
    # 10 / 11 Replica background (floor 40, wall 93); 12 the floor again
    # as ScanNet's background (its floor is class 3)
    gt = {1: (sphere, 20), 2: (crate, 7), 10: (floor, 40), 11: (wall, 93),
          12: (floor, 3), 4: (icosphere(0.2, (1.5, -0.2, 1.5), 2), 20)}
    for oid, (m, _) in gt.items():
        m.export(str(gt_dir / f"mesh_semantic.ply_{oid}.ply"))
    (gt_dir / "info_semantic.json").write_text(json.dumps({"objects": [
        {"id": oid, "class_id": cls} for oid, (_, cls) in gt.items()]}))
    recon = {0: Mesh.concatenate([jitter(floor, 0.01), jitter(wall, 0.02)]),
             1: jitter(icosphere(0.41, (0.5, -0.4, 0.0), 2), 0.005),
             2: jitter(box([-1.22, -0.52, -0.8], [-0.6, 0.0, -0.29]), 0.004),
             3: icosphere(0.3, (0.0, -1.0, 0.0), 2),      # no GT submesh
             4: icosphere(0.2, (-1.5, -0.2, -1.5), 2)}    # empty after crop
    for oid, m in recon.items():
        m.export(str(mesh_dir / f"frame_{FRAME}_obj{oid}.obj"))
    icosphere(0.3, (0, 0, 0), 1).export(str(mesh_dir / "frame_3_obj1.obj"))
    Mesh.concatenate([m for m, _ in gt.values()]).export(
        str(root / "gt_scene.obj"))
    return root


def _close(got, want, what=""):
    """Nested dicts of metrics equal in keys, each value within ATOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("fmt", ["Replica", "ScanNet"])
def test_object_protocol_matches_jax(scene, fmt, tmp_path):
    argv = ["object", "--mesh_dir", str(scene / "scene_mesh"),
            "--gt_dir", str(scene / "habitat"), "--frame", str(FRAME),
            "--n_points", "4000", "--format", fmt]
    got = teval.main(argv + ["--out", str(tmp_path / "t.json")])
    want = jeval.main(argv + ["--out", str(tmp_path / "j.json")])
    _close(got, want)
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    # Replica: background, sphere and crate scored, 3 (no GT) and 4 (empty
    # after the crop) skipped; ScanNet shifts ids by 1, so only the
    # background (the floor as ScanNet's class 3) keeps its GT
    want_ids = {"Replica": [0, 1, 2], "ScanNet": [0]}[fmt]
    assert sorted(got["per_object"]) == want_ids
    assert all(np.isfinite(v) for v in got["mean"].values())


def test_scene_protocol_matches_jax(scene):
    for frame in (str(FRAME), None):
        argv = ["scene", "--mesh_dir", str(scene / "scene_mesh"),
                "--gt_mesh", str(scene / "gt_scene.obj"),
                "--n_points", "20000"]
        if frame is not None:
            argv += ["--frame", frame]
        got, want = teval.main(argv), jeval.main(argv)
        _close(got, want)
        assert got["accuracy"] < 0.1


def test_gt_background_mesh_matches_jax(scene):
    for classes in (teval.REPLICA_BACKGROUND_CLASSES, [40], [7, 20]):
        got = teval.gt_background_mesh(str(scene / "habitat"), classes)
        want = jeval.gt_background_mesh(str(scene / "habitat"), classes)
        np.testing.assert_array_equal(got.vertices, want.vertices)
        np.testing.assert_array_equal(got.faces, want.faces)
    assert teval.REPLICA_BACKGROUND_CLASSES == \
        jeval.REPLICA_BACKGROUND_CLASSES


def test_eval_cli_runs_as_a_module_without_jax(scene, tmp_path):
    out = tmp_path / "obj.json"
    code = (
        "import runpy, sys\n"
        "sys.argv = ['eval_3d', 'object', '--mesh_dir', "
        f"{str(scene / 'scene_mesh')!r}, '--gt_dir', "
        f"{str(scene / 'habitat')!r}, '--frame', '{FRAME}', "
        f"'--n_points', '2000', '--out', {str(out)!r}]\n"
        "runpy.run_module('vmap_tpu_torch.eval.eval_3d', "
        "run_name='__main__')\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vmap_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'vmap_tpu.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(json.loads(out.read_text())["per_object"]) == ["0", "1",
                                                                "2"]
