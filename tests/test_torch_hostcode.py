"""The port's own copies of the JAX package's host modules (config, data,
core.keyframe, geometry, native, utils.viewer) against their originals on
the same inputs: every shipped config field by field, marching cubes on
both backends, OBBs and depth unprojection, the synthetic loader's first
frames, keyframe-table decisions over a frame sequence and the HTML
viewer snapshot. The copies differ from the originals only in their
imports (and ``Config.fused_enabled``, which resolves against the
device), so each must give exactly the original's result."""

import dataclasses
import glob
import json
import os
import shutil
import time

import numpy as np
import pytest

from vmap_tpu import config as jconfig
from vmap_tpu import native as jnative
from vmap_tpu.core import keyframe as jkeyframe
from vmap_tpu.data import loader as jloader
from vmap_tpu.geometry.marching_cubes import marching_cubes as j_mc
from vmap_tpu.geometry import obb as jobb
from vmap_tpu.geometry import pointcloud as jpc
from vmap_tpu.geometry.mesh import Mesh as JMesh
from vmap_tpu.utils import viewer as jviewer
from vmap_tpu_torch import config as tconfig
from vmap_tpu_torch import native as tnative
from vmap_tpu_torch.core import keyframe as tkeyframe
from vmap_tpu_torch.data import loader as tloader
from vmap_tpu_torch.geometry.marching_cubes import \
    marching_cubes as t_mc
from vmap_tpu_torch.geometry import obb as tobb
from vmap_tpu_torch.geometry import pointcloud as tpc
from vmap_tpu_torch.geometry.mesh import Mesh as TMesh
from vmap_tpu_torch.utils import viewer as tviewer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "configs", "**", "*.json"),
                           recursive=True))


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (a is not None and b is not None
                and np.array_equal(np.asarray(a), np.asarray(b)))
    return a == b


@pytest.mark.parametrize("rel", CONFIGS)
def test_config_matches_field_by_field(rel, tmp_path):
    """Every shipped config; a config without camera.fx (ScanNet) reads
    intrinsic/intrinsic_depth.txt from its dataset, here a temporary
    directory holding only that file."""
    with open(os.path.join(REPO, rel)) as f:
        raw = json.load(f)
    if "fx" not in raw.get("camera", {}):
        intr = tmp_path / "intrinsic"
        intr.mkdir()
        (intr / "intrinsic_depth.txt").write_text(
            "577.59 0 318.9 0\n0 578.73 242.68 0\n0 0 1 0\n0 0 0 1\n")
        raw["dataset"]["path"] = str(tmp_path)
    want = jconfig.Config.from_dict(raw)
    got = tconfig.Config.from_dict(raw)
    names = [f.name for f in dataclasses.fields(jconfig.Config)]
    assert names == [f.name for f in dataclasses.fields(tconfig.Config)]
    for name in names:
        assert _equal(getattr(got, name), getattr(want, name)), name
    assert got.fused_enabled("cuda") and not got.fused_enabled("cpu")
    got.fused_train_step = False
    assert not got.fused_enabled("cuda")


def _sphere_volume(dim=24, radius=8.0):
    c = (dim - 1) / 2.0
    idx = np.arange(dim)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    return (1.0 / (1.0 + np.exp((r - radius) * 2.0))).astype(np.float32)


def _wait_for_jax_native(timeout_s: float = 60.0) -> bool:
    """The JAX package builds its library in place, so a test worker that
    loads it while another worker's g++ is still writing it fails to load
    it, and the module then caches that failure. Where g++ exists, forget
    the failure and try again until the other build has finished."""
    deadline = time.monotonic() + timeout_s
    while not jnative.available():
        if shutil.which("g++") is None or time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        with jnative._lock:
            jnative._tried = False
    return True


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_marching_cubes_matches(backend):
    """A sphere volume on each backend; the port's native library is its
    own build of its own copy of the source."""
    vol = _sphere_volume()
    assert tnative.available() and _wait_for_jax_native()
    assert tnative.get_lib()._name != jnative.get_lib()._name
    v_t, f_t = t_mc(vol, 0.5, backend=backend)
    v_j, f_j = j_mc(vol, 0.5, backend=backend)
    assert len(f_t) > 100
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)


def test_obb_and_unprojection_match(rng):
    depth = rng.uniform(0.5, 4.0, (40, 30)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    mask = rng.uniform(size=depth.shape) < 0.7
    t_wc = np.eye(4)
    t_wc[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t_wc[:3, 3] = [0.3, -1.0, 2.0]
    args = (depth, 30.0, 31.0, 19.5, 14.5, t_wc, mask)
    pts = tpc.unproject_depth(*args)
    np.testing.assert_array_equal(pts, jpc.unproject_depth(*args))
    np.testing.assert_array_equal(tpc.voxel_downsample(pts, 0.1),
                                  jpc.voxel_downsample(pts, 0.1))
    got, want = tobb.obb_from_points(pts), jobb.obb_from_points(pts)
    for k in ("center", "R", "extent"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.corners(), want.corners())
    for a, b in zip(tobb.oriented_bounds(pts), jobb.oriented_bounds(pts)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_loader_first_frames_match():
    raw = json.load(open(os.path.join(REPO, "configs",
                                      "synthetic_vmap.json")))
    raw["camera"].update(w=80, h=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    ds_t = tloader.make_dataset(tconfig.Config.from_dict(raw))
    ds_j = jloader.make_dataset(jconfig.Config.from_dict(raw))
    assert len(ds_t) == len(ds_j)
    for i in range(3):
        a, b = ds_t[i], ds_j[i]
        assert sorted(a) == sorted(b)
        for k in ("image", "depth", "obj", "T"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["frame_id"] == b["frame_id"]
        assert sorted(a["bbox_dict"]) == sorted(b["bbox_dict"])
        for oid in a["bbox_dict"]:
            np.testing.assert_array_equal(a["bbox_dict"][oid],
                                          b["bbox_dict"][oid])


def test_keyframe_table_decisions_match(rng):
    """Two objects over 60 frames with a small buffer: first frames,
    rolling slots, keyframe ticks, seeded pruning and evictions."""
    tabs = [mod.KeyframeTable(4, 5) for mod in (tkeyframe, jkeyframe)]
    for frame in range(60):
        bbox = rng.uniform(0, 50, 4).astype(np.float32)
        events = []
        for tab in tabs:
            ev = []
            for slot in ((0,) if frame < 7 else (0, 2)):
                t = tab.objects.get(slot)
                if t is None:
                    t = tab.get_or_create(slot, 3, seed=slot)
                    t.first_frame(frame % 16, bbox)
                    ev.append(None)
                else:
                    ev.append(t.append(frame % 16, bbox))
                ev.append(t.latest2())
            tab.mark_dirty()
            events.append(ev)
        assert events[0] == events[1], frame
        for a, b in zip(tabs[0].as_arrays(), tabs[1].as_arrays()):
            np.testing.assert_array_equal(a, b)


def test_viewer_snapshot_matches(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    colors = np.linspace(0, 1, 12, dtype=np.float32).reshape(4, 3)
    out = {}
    for tag, mod, mesh_cls in (("t", tviewer, TMesh), ("j", jviewer, JMesh)):
        meshes = {1: mesh_cls(verts, faces, colors), 2: None}
        d = tmp_path / tag
        for frame in (10, 20):
            mod.write_snapshot(str(d), meshes, frame)
        out[tag] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
    assert out["t"] == out["j"] and len(out["t"]) >= 3
