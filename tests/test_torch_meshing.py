"""Meshing of the port against vmap_tpu.core.meshing on the CPU.

A small JAX Mapper (the config of tests/test_batched_meshing.py) trains on
five frames of the analytic scene; the port's Mapper ingests the same
frames and takes the JAX banks through ``bank_from_numpy``. Both then mesh.
Tolerances: occupancy volumes atol 1e-5 (f32 products summed in another
order), object vertices atol 1e-4 (the background's 1e-3, see its test),
faces equal, colours within 1 of 255 (uint8 rounding of colours that
differ in the last bits)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from vmap_tpu.config import Config
from vmap_tpu.core import meshing as JM
from vmap_tpu.core.mapper import FrameSample as JFrame
from vmap_tpu.core.mapper import Mapper as JMapper
from vmap_tpu.data.synthetic import SyntheticScene
from vmap_tpu.ops.render import make_3d_grid as j_make_3d_grid
from vmap_tpu_torch.core import mapper as tmapper
from vmap_tpu_torch.core import meshing as TM
from vmap_tpu_torch.ops.render import make_3d_grid

from _torch_parity import n, port_bank


def _cfg():
    return Config(
        max_n_models=4, do_bg=True, hidden_feature_size=8,
        hidden_feature_size_bg=8, n_iter_per_frame=2,
        win_size=2, n_samples_per_frame=8, win_size_bg=2,
        n_samples_per_frame_bg=8, keyframe_buffer_size=5, keyframe_step=2,
        keyframe_step_bg=2, W=80, H=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5,
        frame_pool_size=16, seed=0, grid_dim=24, live_voxel_size=0.05)


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    scene = SyntheticScene(width=80, height=60)
    jm, pm = JMapper(cfg), tmapper.Mapper(cfg, device="cpu")
    for fid in range(5):
        s = scene.frame_sample(fid, n_frames=8)
        args = (s["image"], s["depth"], s["obj"], s["bbox_dict"], s["T"], fid)
        jm.process_frame(JFrame(*args))
        pm.ingest_frame(tmapper.FrameSample(*args))
    pm.bank_obj = port_bank(jm.bank_obj)
    pm.bank_bg = port_bank(jm.bank_bg)
    return jm, pm


def _objects(m):
    return [oid for oid in sorted(m.registry) if not m.registry[oid].is_bg]


def _assert_meshes_close(got, want, what, atol=1e-4):
    if want is None:
        assert got is None, what
        return
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0,
                               atol=atol, err_msg=what)
    np.testing.assert_array_equal(got.faces, want.faces, err_msg=what)
    np.testing.assert_allclose(got.vertex_colors.astype(np.int32),
                               want.vertex_colors.astype(np.int32), atol=1,
                               err_msg=what)


def test_make_3d_grid_matches_jax():
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.linalg.qr(np.random.default_rng(0).normal(
        size=(3, 3)))[0]
    T[:3, 3] = [0.5, -1.0, 2.0]
    scale = np.array([0.3, 0.7, 1.1])
    for dim in (2, 24, 33):
        want = j_make_3d_grid((-1.0, 1.0), dim, transform=jnp.asarray(T),
                              scale=jnp.asarray(scale, jnp.float32))
        got = make_3d_grid((-1.0, 1.0), dim, transform=T, scale=scale)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_pool_unpack_matches_jax(pair):
    jm, pm = pair
    slots = sorted(set(np.nonzero(pm.pool.refcount > 0)[0].tolist()))
    depth, inst = pm.pool.unpack_depth_inst(slots)
    for i, s in enumerate(slots):
        np.testing.assert_array_equal(depth[i], jm.pool.slot_depth_m(s))
        np.testing.assert_array_equal(inst[i], jm.pool.slot_inst(s))
        np.testing.assert_array_equal(pm.pool.slot_depth_m(s), depth[i])


def test_object_bounds_match_jax(pair):
    jm, pm = pair
    for oid in sorted(jm.registry):
        jb, tb = jm.get_bound(oid), pm.get_bound(oid)
        assert (jb is None) == (tb is None)
        if jb is not None:
            for f in ("center", "R", "extent"):
                np.testing.assert_allclose(getattr(tb, f), getattr(jb, f),
                                           atol=1e-9, err_msg=f"{oid} {f}")


def test_eval_points_matches_jax(pair):
    jm, pm = pair
    pts = np.random.default_rng(1).uniform(-3, 3, (3000, 3)).astype(
        np.float32)
    for oid in sorted(jm.registry):
        o_j, c_j = JM.eval_points(*jm.object_params(oid), pts, chunk=1024)
        o_t, c_t = TM.eval_points(*pm.object_params(oid), pts, chunk=1024)
        np.testing.assert_allclose(o_t, o_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(c_t, c_j, rtol=0, atol=2e-5)


def test_occupancy_volumes_match_jax(pair):
    jm, pm = pair
    work = TM.mesh_work(pm, _objects(pm))
    assert work
    got = TM.grid_volumes(pm, work, TM.bank_prepared(pm, work), chunk=4096)

    # the JAX package's chunk program on the same grids and slots
    Op = 1 << (len(work) - 1).bit_length()
    slots = [jm.registry[oid].slot for oid, _, _ in work]
    slots += slots[-1:] * (Op - len(work))
    bank = jm.bank_obj
    pe, mlp_p = bank.spec.unflatten(bank.flat[jnp.asarray(slots)])
    frames = [jnp.asarray(n(a)) for a in TM.grid_frames(work, Op, "cpu")]
    frames[3] = frames[3].astype(jnp.int32)
    gd = max(g for _, _, g in work)
    chunks = [np.asarray(JM._bank_grid_chunk(
        (pe, mlp_p, bank.scale[jnp.asarray(slots)]), *frames,
        jnp.int32(s), bank.spec.hidden, False, 4096)[0])
        for s in range(0, gd ** 3, 4096)]
    occ = np.concatenate(chunks, axis=1)
    for o, (oid, _, g) in enumerate(work):
        want = occ[o, :g ** 3].reshape(g, g, g)
        assert got[o].shape == want.shape
        np.testing.assert_allclose(got[o], want, rtol=0, atol=1e-5,
                                   err_msg=f"object {oid}")


def test_mesh_all_objects_matches_jax(pair):
    jm, pm = pair
    want = JM.mesh_all_objects(jm)
    got = TM.mesh_all_objects(pm)
    assert set(got) == set(want) == set(_objects(pm))
    assert any(m is not None for m in got.values())
    for oid in want:
        _assert_meshes_close(got[oid], want[oid], f"object {oid}")


def test_mesh_all_objects_matches_serial(pair):
    _, pm = pair
    batched = TM.mesh_all_objects(pm, chunk=4096)
    for oid in _objects(pm):
        _assert_meshes_close(batched[oid], pm.mesh_object(oid),
                             f"object {oid}")


def test_background_mesh_matches_jax(pair):
    """atol 1e-3 m: the background grid's voxels are about 0.4 m here, and
    a vertex interpolated along an edge whose occupancy is nearly flat
    moves by up to ~5e-4 of a voxel for an occupancy difference of 1e-6."""
    jm, pm = pair
    _assert_meshes_close(pm.mesh_object(0), jm.mesh_object(0), "background",
                         atol=1e-3)


def test_export_meshes_names_match_jax(pair, tmp_path):
    jm, pm = pair
    want = jm.export_meshes(str(tmp_path / "jax"), frame_id=4)
    got = pm.export_meshes(str(tmp_path / "port"), frame_id=4)
    assert want and [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    assert all(os.path.getsize(p) > 0 for p in got)


def test_export_meshes_times_its_stages(pair, tmp_path):
    """Every export stage lands in STAGE_S; the written .obj reads back."""
    _, pm = pair
    paths = pm.export_meshes(str(tmp_path), frame_id=4)
    assert {"objects bounds", "objects grid query", "objects marching cubes",
            "objects vertex colours", "objects .obj write",
            "background bounds", "background grid query",
            "background marching cubes", "background .obj write"} \
        <= set(TM.STAGE_S)
    assert all(v >= 0.0 for v in TM.STAGE_S.values())
    assert os.path.basename(paths[0]) == "frame_4_obj0.obj"
    np.testing.assert_allclose(TM.read_obj_vertices(paths[0]),
                               pm.mesh_object(0).vertices, rtol=0, atol=1e-6)
