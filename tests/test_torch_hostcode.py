"""The port's own copies of the JAX package's host modules against their
originals on the same inputs:

  * ``config``: every shipped config field by field;
  * ``native`` and ``geometry.marching_cubes``: marching cubes on both
    backends;
  * ``geometry.obb`` / ``geometry.pointcloud``: OBBs and depth
    unprojection;
  * ``geometry.mesh``: the .obj writer's bytes and the reader's arrays
    (``test_obj_io_matches``);
  * ``data``: the synthetic loader's first frames;
  * ``core.keyframe``: keyframe-table decisions over a frame sequence;
  * ``utils.viewer``: the HTML viewer snapshot;
  * ``geometry.frames`` (``vmap_tpu/geometry/frames.py``): every function;
  * ``data_generation.settings`` (``vmap_tpu/data_generation/
    settings.py``): ``orbit_trajectory`` and the intrinsics;
  * ``data_generation.room`` (``vmap_tpu/data_generation/room.py``):
    ``make_room_scene`` at 6 and 40 objects for two seeds (triangles, ids,
    classes, albedos), ``room_trajectory``, ``write_ply_library``,
    ``SCANNET_CLS_MAP``;
  * ``eval.metrics`` (``vmap_tpu/eval/metrics.py``) on random point sets;
  * ``eval.mesh_eval`` (``vmap_tpu/eval/mesh_eval.py``):
    ``crop_to_gt_bound``, ``eval_object``, ``eval_scene``,
    ``observed_points_mask``, ``compose_scene_mesh`` and
    ``object_ids_in_dir`` on small meshes;
  * ``eval.extract_objects`` (``vmap_tpu/eval/extract_objects.py``):
    ``split_by_object_id``;
  * ``utils.vis`` (``vmap_tpu/utils/vis.py``): ``label_to_rgb``.

The copies differ from the originals only in their imports, apart from
``Config.fused_enabled``, which resolves against the device, and
``geometry.mesh``'s .obj writer and reader, which format and parse whole
arrays at once (the reader for the files the writer makes; other files
still token by token). Each must give exactly the original's result. ``eval.eval_3d``,
``data_generation.writer`` and the renderer are held in
tests/test_torch_eval.py and tests/test_torch_datagen.py."""

import dataclasses
import glob
import json
import os

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
from vmap_tpu.geometry.mesh import load_mesh as j_load_mesh
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
from vmap_tpu_torch.geometry.mesh import load_mesh as t_load_mesh
from vmap_tpu_torch.utils import viewer as tviewer
from vmap_tpu.data_generation import room as jroom
from vmap_tpu.data_generation import settings as jsettings
from vmap_tpu.eval import extract_objects as jextract
from vmap_tpu.eval import mesh_eval as jmesh_eval
from vmap_tpu.eval import metrics as jmetrics
from vmap_tpu.geometry import frames as jframes
from vmap_tpu.geometry import primitives as jprim
from vmap_tpu.utils import vis as jvis
from vmap_tpu_torch.data_generation import room as troom
from vmap_tpu_torch.data_generation import settings as tsettings
from vmap_tpu_torch.eval import extract_objects as textract
from vmap_tpu_torch.eval import mesh_eval as tmesh_eval
from vmap_tpu_torch.eval import metrics as tmetrics
from vmap_tpu_torch.geometry import frames as tframes
from vmap_tpu_torch.geometry import primitives as tprim
from vmap_tpu_torch.utils import vis as tvis

from _torch_parity import both_native

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


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_marching_cubes_matches(backend):
    """A sphere volume on each backend; the port's native library is its
    own build of its own copy of the source."""
    vol = _sphere_volume()
    assert both_native()
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


OBJ_ODD = """# faces with texture / normal indices, a quad, mixed vertex widths
v 0 0 0 0.5 0.25 1
v 1 0 0
v 0 1 0 0.1 0.2 0.3
v 1 1 0.5
vt 0 0
f 1/1/1 2/1/1 3/1/1
f 1 2 4 3
f 2 4 3
"""


def test_obj_io_matches(rng, tmp_path):
    """``Mesh.export`` to .obj byte for byte (float and uint8 colours, none)
    and ``load_mesh`` of those files and of an .obj with slashed indices, a
    quad and mixed vertex widths, equal to the original's."""
    verts = rng.normal(size=(50, 3)) * 3
    verts[0] = [-0.0, 1e-9, -1e-9]
    faces = rng.integers(0, 50, (70, 3))
    for cols in (None, rng.uniform(size=(50, 3)),
                 rng.integers(0, 256, (50, 3)).astype(np.uint8),
                 rng.uniform(size=(50, 4)).astype(np.float32)):
        out = {}
        for tag, cls in (("t", TMesh), ("j", JMesh)):
            path = tmp_path / f"{tag}.obj"
            cls(verts.astype(np.float32), faces, cols).export(str(path))
            out[tag] = path.read_bytes()
        assert out["t"] == out["j"]
        (tmp_path / "odd.obj").write_text(OBJ_ODD)
        for name in ("t.obj", "odd.obj"):
            a = t_load_mesh(str(tmp_path / name))
            b = j_load_mesh(str(tmp_path / name))
            np.testing.assert_array_equal(a.vertices, b.vertices)
            np.testing.assert_array_equal(a.faces, b.faces)
            assert (a.vertex_colors is None) == (b.vertex_colors is None)
            if a.vertex_colors is not None:
                np.testing.assert_array_equal(a.vertex_colors,
                                              b.vertex_colors)


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


# ------------------------------------------------- frames, settings, room
def test_frames_match(rng):
    q = rng.normal(size=4)
    t = rng.normal(size=3)
    pose = np.eye(4)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = t
    np.testing.assert_array_equal(tframes.T_GL_CV, jframes.T_GL_CV)
    np.testing.assert_array_equal(tframes.T_YUP_ZUP, jframes.T_YUP_ZUP)
    for name in ("opengl_to_opencv_pose", "opencv_to_opengl_pose",
                 "yup_world_to_zup", "zup_world_to_yup"):
        np.testing.assert_array_equal(getattr(tframes, name)(pose),
                                      getattr(jframes, name)(pose), name)
    for order in ("wxyz", "xyzw"):
        np.testing.assert_array_equal(tframes.quat_to_rotation(q, order),
                                      jframes.quat_to_rotation(q, order))
        np.testing.assert_array_equal(
            tframes.pose_from_quat_trans(q, t, order),
            jframes.pose_from_quat_trans(q, t, order))
    np.testing.assert_array_equal(tframes.quat_to_rotation(np.zeros(4)),
                                  jframes.quat_to_rotation(np.zeros(4)))
    with pytest.raises(ValueError):
        tframes.quat_to_rotation(q, "zyxw")


def test_orbit_trajectory_and_intrinsics_match():
    for n, kw in ((8, {}), (5, {"radius": 2.0, "height": -0.3,
                                "target": (0.1, 0.2, 0.3)})):
        np.testing.assert_array_equal(tsettings.orbit_trajectory(n, **kw),
                                      jsettings.orbit_trajectory(n, **kw))
    for kw in ({}, {"width": 81, "height": 61, "cx": 40.0}):
        assert (tsettings.RenderSettings(**kw).intrinsics()
                == jsettings.RenderSettings(**kw).intrinsics())
    assert (dataclasses.asdict(tsettings.RenderSettings())
            == dataclasses.asdict(jsettings.RenderSettings()))


def _scene_arrays(objects):
    return [(np.asarray(o.mesh.triangles), o.instance_id, o.class_id,
             tuple(o.albedo)) for o in objects]


@pytest.mark.parametrize("n_objects", [6, 40])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_room_scene_matches(n_objects, seed):
    """Triangles, instance and class ids and albedos of every furniture
    piece and shell part, and the room's extents, bit for bit."""
    t_objs, t_shell, t_meta = troom.make_room_scene(n_objects, seed=seed)
    j_objs, j_shell, j_meta = jroom.make_room_scene(n_objects, seed=seed)
    assert t_meta == j_meta and t_meta["n_objects"] == n_objects
    got = _scene_arrays(t_objs + t_shell)
    want = _scene_arrays(j_objs + j_shell)
    assert len(got) == len(want) == n_objects + 6
    for (tt, ti, tc, ta), (jt, ji, jc, ja) in zip(got, want):
        np.testing.assert_array_equal(tt, jt)
        assert (ti, tc, ta) == (ji, jc, ja)
    assert troom.SCANNET_CLS_MAP == jroom.SCANNET_CLS_MAP


def test_room_trajectory_and_ply_library_match(tmp_path):
    for n, kw in ((24, {}), (7, {"size": (9.0, 6.5), "seed": 2,
                                 "loops": 1.0})):
        np.testing.assert_array_equal(troom.room_trajectory(n, **kw),
                                      jroom.room_trajectory(n, **kw))
    got = troom.write_ply_library(str(tmp_path / "t"), seed=1, n=4)
    want = jroom.write_ply_library(str(tmp_path / "j"), seed=1, n=4)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    t_objs, _, _ = troom.make_room_scene(8, seed=1,
                                         ply_dir=str(tmp_path / "t"))
    j_objs, _, _ = jroom.make_room_scene(8, seed=1,
                                         ply_dir=str(tmp_path / "j"))
    for (tt, *tr), (jt, *jr) in zip(_scene_arrays(t_objs),
                                    _scene_arrays(j_objs)):
        np.testing.assert_array_equal(tt, jt)
        assert tr == jr


# ---------------------------------------------------------------- eval
def test_metrics_match(rng):
    gt = rng.normal(size=(700, 3))
    rec = gt[:500] + rng.normal(scale=0.02, size=(500, 3))
    for name in ("accuracy", "completion", "chamfer", "all_metrics"):
        assert (getattr(tmetrics, name)(gt, rec)
                == getattr(jmetrics, name)(gt, rec)), name
    for th in (0.01, 0.05):
        assert (tmetrics.completion_ratio(gt, rec, th)
                == jmetrics.completion_ratio(gt, rec, th))


def _meshes(prim, mesh_cls):
    """A sphere reconstruction with a stray box, and its GT sphere."""
    rec = mesh_cls.concatenate([prim.icosphere(0.5, (0.0, 0.0, 0.0), 2),
                                prim.box([1.5, 0, 0], [1.8, 0.3, 0.3])])
    gt = prim.icosphere(0.52, (0.01, 0.0, 0.0), 3)
    return rec, gt


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


def test_mesh_eval_matches(tmp_path):
    t_rec, t_gt = _meshes(tprim, TMesh)
    j_rec, j_gt = _meshes(jprim, JMesh)
    _same_mesh(tmesh_eval.crop_to_gt_bound(t_rec, t_gt),
               jmesh_eval.crop_to_gt_bound(j_rec, j_gt))
    assert (tmesh_eval.eval_object(t_rec, t_gt, n=3000)
            == jmesh_eval.eval_object(j_rec, j_gt, n=3000))
    half = lambda p: p[:, 0] > 0    # noqa: E731
    assert (tmesh_eval.eval_object(t_rec, t_gt, n=2000, gt_filter=half)
            == jmesh_eval.eval_object(j_rec, j_gt, n=2000, gt_filter=half))
    far = tprim.box([5, 5, 5], [6, 6, 6])
    assert tmesh_eval.eval_object(far, t_gt, n=100) is None
    assert (tmesh_eval.eval_scene(t_rec, t_gt, n=4000, seed=2)
            == jmesh_eval.eval_scene(j_rec, j_gt, n=4000, seed=2))
    for tag, rec, gt in (("t", t_rec, t_gt), ("j", j_rec, j_gt)):
        d = tmp_path / tag
        d.mkdir()
        rec.export(str(d / "frame_9_obj1.obj"))
        gt.export(str(d / "frame_9_obj2.ply"))
        gt.export(str(d / "frame_12_obj3.obj"))
    for frame in (9, None):
        _same_mesh(tmesh_eval.compose_scene_mesh(str(tmp_path / "t"), frame),
                   jmesh_eval.compose_scene_mesh(str(tmp_path / "j"), frame))
    assert (tmesh_eval.object_ids_in_dir(str(tmp_path / "t"))
            == jmesh_eval.object_ids_in_dir(str(tmp_path / "j"))
            == [1, 2, 3])


def test_observed_points_mask_matches(rng):
    W, H, f = 40, 30, 25.0
    poses = np.stack([np.eye(4)] * 3)
    for T in poses[1:]:
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(scale=0.2, size=3)
    depths = rng.uniform(0.5, 3.0, (3, W, H)).astype(np.float32)
    depths[rng.uniform(size=depths.shape) < 0.2] = 0.0
    pts = rng.normal(scale=1.5, size=(2000, 3))
    pts[:500, 2] = np.abs(pts[:500, 2]) + 0.5
    args = (pts, poses, depths, f, f, (W - 1) / 2, (H - 1) / 2)
    for tol in (0.05, 0.5):
        got = tmesh_eval.observed_points_mask(*args, tol=tol)
        np.testing.assert_array_equal(
            got, jmesh_eval.observed_points_mask(*args, tol=tol))
    assert got.any() and not got.all()


SEMANTIC_PLY = """ply
format ascii 1.0
element vertex 7
property float x
property float y
property float z
element face 4
property list uchar int vertex_indices
property int object_id
end_header
0 0 0
1 0 0
0 1 0
5 5 5
6 5 5
5 6 5
9 9 9
3 0 1 2 7
3 3 4 5 9
4 3 5 4 6 9
3 0 2 6 11
"""


def test_split_by_object_id_matches(tmp_path):
    out = {}
    for tag, mod in (("t", textract), ("j", jextract)):
        d = tmp_path / tag
        d.mkdir()
        (d / "mesh_semantic.ply").write_text(SEMANTIC_PLY)
        written = mod.split_by_object_id(str(d / "mesh_semantic.ply"))
        out[tag] = {os.path.basename(p): open(p, "rb").read()
                    for p in written}
    assert out["t"] == out["j"]
    assert sorted(out["t"]) == [f"mesh_semantic.ply_{i}.ply"
                                for i in (11, 7, 9)]
    head, body = SEMANTIC_PLY.split("end_header\n")
    faces = [" ".join(r.split()[:-1]) for r in body.splitlines()[7:]]
    (tmp_path / "t" / "plain.ply").write_text(
        head.replace("property int object_id\n", "") + "end_header\n"
        + "\n".join(body.splitlines()[:7] + faces) + "\n")
    with pytest.raises(ValueError, match="object_id"):
        textract.split_by_object_id(str(tmp_path / "t" / "plain.ply"))


def test_label_to_rgb_matches(rng):
    inst = rng.integers(-1, 7, (31, 23))
    for seed in (0, 5):
        got = tvis.label_to_rgb(inst, seed)
        np.testing.assert_array_equal(got, jvis.label_to_rgb(inst, seed))
    assert got.dtype == np.uint8 and got.shape == (31, 23, 3)
