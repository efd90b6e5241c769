"""The port's counterparts of the JAX package's scripts
``scripts/remesh.py``, ``scripts/eval_synthetic.py`` and
``scripts/quality_study.py`` on the CPU: remesh's meshes are the exporting
Mapper's at that grid from the same saved state; eval_synthetic's metrics
are ``vmap_tpu.eval.mesh_eval.eval_object``'s on the same meshes and a tiny
run ends finite; quality_study runs the JAX script's variants and writes
nothing under ``docs/``; none of the three imports jax or vmap_tpu."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one torch thread a worker)
from _torch_parity import small_synthetic_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# eval_synthetic at a tiny size: 48 x 36 frames, 3 frames once, grid 16
TINY = ["--frames", "3", "--passes", "1", "--grid", "16", "--iters", "2",
        "--width", "48", "--height", "36"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A CPU trainer run of 11 frames with --save_ckpt: its config, logdir
    and Mapper."""
    from vmap_tpu_torch import train
    d = tmp_path_factory.mktemp("remesh")
    cfg = small_synthetic_config(d / "cfg.json")
    logdir = d / "logs"
    mapper = train.main(["--config", cfg, "--logdir", str(logdir),
                         "--device", "cpu", "--max_frames", "11",
                         "--save_ckpt"])
    return cfg, logdir, mapper


def _objs(path) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".obj")}


@pytest.mark.parametrize("grid", [16, 32])
def test_remesh_equals_the_exporting_mappers_meshes(trained, tmp_path, grid):
    """The checkpoint re-meshed at a grid cap: the same files, vertices and
    faces, byte for byte, as the Mapper that saved it exporting at that
    cap, named after the checkpoint's frame or --frame."""
    from vmap_tpu_torch import remesh
    cfg, logdir, mapper = trained
    mapper.cfg.grid_dim = grid
    want = tmp_path / "want"
    mapper.export_meshes(str(want), 10)
    got = remesh.main(["--config", cfg, "--ckpt",
                       str(logdir / "ckpt" / "state"), "--out",
                       str(tmp_path / "got"), "--grid_dim", str(grid),
                       "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in got) == sorted(_objs(want))
    assert _objs(tmp_path / "got") == _objs(want)
    assert len(_objs(want)) == 3
    named = remesh.main(["--config", cfg, "--ckpt",
                         str(logdir / "ckpt" / "state"), "--out",
                         str(tmp_path / "named"), "--grid_dim", str(grid),
                         "--frame", "7", "--device", "cpu"])
    assert all(os.path.basename(p).startswith("frame_7_") for p in named)


def test_eval_synthetic_scores_as_jax_eval_object(tmp_path, monkeypatch):
    """A tiny CPU run (3 frames, grid 16) ends with finite metrics, and
    they are vmap_tpu's eval_object's (its scene's GT meshes and observed
    floor) on the meshes the port's run made."""
    from vmap_tpu.data.synthetic import SyntheticScene as JScene
    from vmap_tpu.eval import mesh_eval as jeval
    from vmap_tpu.geometry.mesh import Mesh as JMesh
    from vmap_tpu_torch import eval_synthetic
    from vmap_tpu_torch.core.mapper import Mapper
    meshes = {}
    mesh_object = Mapper.mesh_object

    def record(self, obj_id, bound=None, grid_dim=None):
        meshes[obj_id] = mesh_object(self, obj_id, bound, grid_dim)
        return meshes[obj_id]

    monkeypatch.setattr(Mapper, "mesh_object", record)
    out = tmp_path / "metrics.json"
    got = eval_synthetic.main(TINY + ["--device", "cpu", "--out", str(out)])
    assert json.load(open(out)) == got
    assert set(got) == {"background", "sphere", "box"}
    assert all(np.isfinite(v) for met in got.values() for v in met.values())
    args = eval_synthetic.parse_args(TINY)
    fx = args.width * 0.75
    scene = JScene(width=args.width, height=args.height, fx=fx, fy=fx)
    frames = [scene.render(f, n_frames=args.frames)
              for f in range(args.frames)]
    poses = np.stack([f[3] for f in frames])
    depths = np.stack([f[1] for f in frames])

    def bg_filter(pts):
        return jeval.observed_points_mask(pts, poses, depths, fx, fx,
                                          (args.width - 1) / 2,
                                          (args.height - 1) / 2, tol=0.05)

    names = {0: "background", scene.SPHERE_ID: "sphere",
             scene.BOX_ID: "box"}
    for oid, gt in scene.gt_meshes().items():
        rec = meshes[oid]
        want = jeval.eval_object(JMesh(rec.vertices, rec.faces), gt, n=8000,
                                 gt_filter=bg_filter if oid == 0 else None)
        assert got[names[oid]].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[names[oid]][k], v, rtol=1e-12,
                                       err_msg=f"{names[oid]} {k}")


def test_eval_synthetic_takes_the_jax_scripts_knobs():
    """The JAX script's flags (``--cpu`` become ``--device cpu``); --fused
    onto tpu.fused_train_step (auto, false, true), --bg_hidden onto the
    background's width."""
    from vmap_tpu_torch import eval_synthetic as ES
    from vmap_tpu_torch.config import Config
    src = open(os.path.join(REPO, "scripts", "eval_synthetic.py")).read()
    flags = set(re.findall(r'add_argument\("--(\w+)"', src)) - {"cpu"}
    mine = set(re.findall(r'add_argument\("--(\w+)"',
                          open(ES.__file__).read())) - {"device"}
    assert flags == mine
    for fused, want in (("auto", "auto"), ("0", False), ("1", True)):
        cfg = ES.scene_config(ES.parse_args(["--fused", fused,
                                             "--bg_hidden", "64"]), Config)
        assert cfg.fused_train_step == want
        assert cfg.hidden_feature_size_bg == 64
        assert cfg.hidden_feature_size == 32


def test_quality_study_runs_the_variants_and_leaves_docs_alone(
        tmp_path, monkeypatch):
    """The JAX script's five variants, each a process of eval_synthetic;
    run here at a tiny size (two of them), the table to the working
    directory by default, docs/ untouched."""
    from vmap_tpu_torch import quality_study as QS
    src = open(os.path.join(REPO, "scripts", "quality_study.py")).read()
    jax_runs = re.findall(r'run\("(\w+)", (\[[^\]]*\])', src)
    assert [(tag, eval(extra)) for tag, extra in jax_runs] == \
        [(tag, extra) for tag, extra in QS.VARIANTS]
    assert QS.SIZES[False] == ["--frames", "16", "--passes", "3", "--grid",
                               "64", "--height", "96", "--width", "128"]
    docs = os.path.join(REPO, "docs")
    before = {f: os.stat(os.path.join(docs, f)).st_mtime_ns
              for f in os.listdir(docs)}
    monkeypatch.setitem(QS.SIZES, True, TINY)
    monkeypatch.setattr(QS, "VARIANTS", QS.VARIANTS[:1] + QS.VARIANTS[-1:])
    monkeypatch.chdir(tmp_path)
    table = QS.main(["--quick", "--device", "cpu"])
    assert json.load(open(tmp_path / "quality_study.json")) == table
    assert set(table) == {"f32", "bg_rays320_h64"}
    for variant in table.values():
        assert set(variant) == {"background", "sphere", "box"}
        assert all(np.isfinite(v) for m in variant.values()
                   for v in m.values())
    assert {f: os.stat(os.path.join(docs, f)).st_mtime_ns
            for f in os.listdir(docs)} == before


def test_entry_points_stay_jax_free(trained, tmp_path):
    """eval_synthetic, remesh and quality_study run as ``python -m`` in a
    process that must import neither jax nor any vmap_tpu module."""
    cfg, logdir, _ = trained
    code = (
        "import runpy, sys\n"
        "from vmap_tpu_torch import quality_study as QS\n"
        f"QS.SIZES[True] = {TINY!r}\n"
        "QS.VARIANTS = QS.VARIANTS[:1]\n"
        "for mod, argv in (\n"
        f"    ('eval_synthetic', {TINY + ['--device', 'cpu']!r}),\n"
        f"    ('remesh', ['--config', {cfg!r}, '--ckpt',"
        f" {str(logdir / 'ckpt' / 'state')!r}, '--out',"
        f" {str(tmp_path / 'mesh')!r}, '--grid_dim', '16',"
        " '--device', 'cpu'])):\n"
        "    sys.argv = [mod] + argv\n"
        "    runpy.run_module('vmap_tpu_torch.' + mod, run_name='__main__')\n"
        f"QS.main(['--quick', '--device', 'cpu', '--out',"
        f" {str(tmp_path / 'qs.json')!r}])\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vmap_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'vmap_tpu.')))\n"
        "assert not bad, bad\n"
        "print('JAXFREE')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAXFREE" in out.stdout
    assert os.path.getsize(tmp_path / "qs.json") > 0
