"""The iMAP configuration family on the port, against vmap_tpu on the CPU.

iMAP trains one scene-wide field (``imap_mode 1``, ``do_bg 0``,
``n_models 1``, hidden 256). The configuration is
``configs/Replica/room0_imap.json`` at its full width cut to the analytic
80x60 scene (``_torch_parity.small_imap_config``): 60 rays of 14 samples,
3 iterations per frame.

  * the iMAP path as a whole: the port's Mapper against the JAX Mapper frame
    by frame, on JAX's draws with the JAX bank carried across each frame
    (registry, keyframe tables and pool equal; last-iteration loss within
    rtol 2e-3, the bar of tests/test_torch_mapper.py);
  * meshing of the h=256 scene field through ``mesh_all_objects`` against
    JAX on the same bank (the bars of tests/test_torch_meshing.py), and
    its per-object ``.npz`` both ways (bit-equal);
  * the CLI for 11 frames with ``--save_ckpt``, then ``--resume``;
  * the train-frame kernel's launch geometry (``frame_geometry``), and the
    widths of the shipped iMAP configurations against the kernels'.
"""

import json
import os

import numpy as np
import pytest

from vmap_tpu.config import Config
from vmap_tpu.core import checkpoint as JC
from vmap_tpu.core import meshing as JM
from vmap_tpu.core.mapper import FrameSample as JFrame
from vmap_tpu.core.mapper import Mapper as JMapper
from vmap_tpu.data.loader import make_dataset
from vmap_tpu_torch import kernels
from vmap_tpu_torch.core import checkpoint as TC
from vmap_tpu_torch.core import mapper as tmapper
from vmap_tpu_torch.core import meshing as TM
from vmap_tpu_torch.kernels import train_step as K

from _torch_parity import (both_native, jax_frame_draw_source, port_bank,
                           small_imap_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4


def _sample(s, cls):
    return cls(image=s["image"], depth=s["depth"], inst=s["obj"],
               bbox_dict=s["bbox_dict"], t_wc=s["T"], frame_id=s["frame_id"])


@pytest.fixture(scope="module")
def imap(tmp_path_factory):
    """The JAX and the port Mapper over N_FRAMES frames of the small iMAP
    configuration; each frame the JAX bank goes into the port, then both
    train on JAX's draws. Returns (cfg, jm, pm, per-frame records); at the
    end the port holds the JAX bank, so both mesh the same field."""
    cfg = Config.from_json(small_imap_config(
        tmp_path_factory.mktemp("imap") / "cfg.json"))
    ds = make_dataset(cfg)
    jm = JMapper(cfg)
    keys = []
    next_key = jm._next_key
    jm._next_key = lambda: keys.append(next_key()) or keys[-1]
    frame_key = {}
    pm = tmapper.Mapper(cfg, device="cpu",
                        draw_source=lambda bank, shapes: jax_frame_draw_source(
                            frame_key["k"])(bank, shapes))
    records = []
    for i in range(N_FRAMES):
        s = ds[i]
        jm.ingest_frame(_sample(s, JFrame))
        pm.ingest_frame(_sample(s, tmapper.FrameSample))
        rec = {"registry": ({k: vars(r) for k, r in pm.registry.items()},
                            {k: vars(r) for k, r in jm.registry.items()}),
               "tables": (pm.obj_table.as_arrays(), jm.obj_table.as_arrays()),
               "refcount": (pm.pool.refcount.copy(),
                            jm.pool.refcount.copy()),
               "pool": (pm.pool.packed.numpy().view(np.uint32).copy(),
                        np.asarray(jm.pool.packed))}
        pm.bank_obj = port_bank(jm.bank_obj)
        met_j = jm.train_frame()
        frame_key["k"] = keys[-1]
        met_p = pm.train_frame()
        rec["loss"] = (float(met_p["loss"]), float(met_j["loss"]))
        records.append(rec)
    pm.bank_obj = port_bank(jm.bank_obj)
    return cfg, jm, pm, records


def test_imap_mapper_matches_jax_frame_by_frame(imap):
    cfg, jm, pm, records = imap
    assert cfg.imap_mode and not cfg.do_bg and cfg.hidden_feature_size == 256
    for i, rec in enumerate(records):
        got, want = rec["registry"]
        assert got == want == {0: {"obj_id": 0, "slot": 0, "is_bg": False,
                                   "first_seen": 0, "scale": cfg.obj_scale}}
        for a, b in zip(*rec["tables"]):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
        np.testing.assert_array_equal(*rec["refcount"], err_msg=f"frame {i}")
        np.testing.assert_array_equal(*rec["pool"], err_msg=f"frame {i}")
        np.testing.assert_allclose(*rec["loss"], rtol=2e-3,
                                   err_msg=f"frame {i}")
    assert pm.bank_bg is None and jm.bank_bg is None
    assert pm.n_objects == jm.n_objects == 1
    # one slot at h=256: no round-up to 8 (that applies at h <= 64)
    assert pm.slots == jm.slots == 1
    assert pm.bank_obj.flat.shape == (1, 319811)
    # the scene field is object 0 in the object bank, trained as THIS_OBJ
    assert pm._slot_objid[0] == 0
    assert all(np.isfinite(r["loss"][0]) and r["loss"][0] > 0
               for r in records)


def test_imap_rays_are_the_scene_fields(imap):
    """iMAP ingests instance 0 everywhere: every pixel's biased instance is
    1, so the scene field (object 0, slot 0) samples every ray as
    THIS_OBJ, with 5 + 9 = 14 samples."""
    import torch
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.ops import sampling
    _, _, pm, _ = imap
    st = pm.statics
    obj_tab, _ = pm._device_tables()
    draws = ST.torch_draws(torch.Generator().manual_seed(0), ST.draw_shapes(
        pm.slots, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins,
        st.px_block), pm.device)
    batch = ST._sample_bank(*pm.pool.arrays(), *obj_tab,
                            torch.from_numpy(pm._slot_objid),
                            st.n_iter * st.win, st.n_px, st.n_b2s, st, draws,
                            px_block=st.px_block)
    assert batch["z"].shape == (1, st.n_iter * st.win * st.n_px, 14)
    assert bool((batch["state"] == sampling.THIS_OBJ).all())


def test_imap_scene_mesh_matches_jax(imap):
    """The h=256 scene field through mesh_all_objects: the room's bound
    from every keyframe's points, the grid through the field query,
    marching cubes, vertex colours. Vertices atol 1e-3 m, the bar of the
    room-scale background mesh in tests/test_torch_meshing.py (voxels of
    about 0.4 m here); faces equal; colours within 1 of 255. Both sides
    mesh on their native libraries (``both_native``)."""
    _, jm, pm, _ = imap
    assert both_native()
    jb, tb = jm.get_bound(0), pm.get_bound(0)
    for f in ("center", "R", "extent"):
        np.testing.assert_allclose(getattr(tb, f), getattr(jb, f), atol=1e-9)
    want = JM.mesh_all_objects(jm)
    TM.STAGE_S.clear()
    got = TM.mesh_all_objects(pm)
    assert set(got) == set(want) == {0}
    if want[0] is None:
        assert got[0] is None
        return
    np.testing.assert_allclose(got[0].vertices, want[0].vertices, rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got[0].faces, want[0].faces)
    np.testing.assert_allclose(got[0].vertex_colors.astype(np.int32),
                               want[0].vertex_colors.astype(np.int32),
                               atol=1)
    assert {"objects bounds", "objects grid query",
            "objects marching cubes"} <= set(TM.STAGE_S)


def test_imap_npz_loads_both_ways(imap, tmp_path):
    """The scene field's .npz: JAX -> port and port -> JAX, bit-equal."""
    _, jm, pm, _ = imap
    file = JC.save_object_checkpoint(jm, 0, str(tmp_path / "j"), epoch=3)
    TC.restore_object_into_mapper(pm, TC.load_object_checkpoint(file))
    np.testing.assert_array_equal(pm.bank_obj.flat[0].numpy(),
                                  np.asarray(jm.bank_obj.flat[0]))
    pm.bank_obj.flat[0] *= 0.5
    file = TC.save_object_checkpoint(pm, 0, str(tmp_path / "t"), epoch=4)
    JC.restore_object_into_mapper(jm, JC.load_object_checkpoint(file))
    np.testing.assert_array_equal(np.asarray(jm.bank_obj.flat[0]),
                                  pm.bank_obj.flat[0].numpy())
    assert np.load(file)["mlp/w_mid1"].shape == (256, 256)


def test_imap_cli_meshes_checkpoints_and_resumes(tmp_path):
    """``--max_frames 11 --save_ckpt`` on the iMAP configuration writes the
    scene mesh frame_10_obj0.obj and its checkpoints; ``--resume`` trains
    frames 11 and 12 with finite losses."""
    from vmap_tpu_torch import train
    cfg = small_imap_config(tmp_path / "cfg.json")
    logdir = tmp_path / "logs"
    base = ["--config", cfg, "--logdir", str(logdir), "--device", "cpu"]
    mapper = train.main(base + ["--max_frames", "11", "--save_ckpt"])
    assert mapper.bank_bg is None and mapper.n_objects == 1
    meshes = sorted(os.listdir(logdir / "scene_mesh"))
    assert meshes == ["frame_10_obj0.obj"]
    assert os.path.getsize(logdir / "scene_mesh" / meshes[0]) > 0
    assert os.listdir(logdir / "ckpt" / "0") == ["obj_0_frame_10.npz"]
    state = logdir / "ckpt" / "state"
    mapper = train.main(base + ["--max_frames", "13", "--resume",
                                str(state)])
    rows = [json.loads(line) for line in open(logdir / "train_log.jsonl")]
    assert [r["frame"] for r in rows] == list(range(13))
    assert all(np.isfinite(r["loss"]) and r["n_objects"] == 1 for r in rows)
    assert mapper.frames_ingested == 13


# ----------------------------------------------------- launch geometry
def _smem_bytes(hidden, rt, S):
    """Shared memory of one int8 train_grad block (csrc/train_step_q8.cu
    q8_smem_bytes), the larger of its two tiles': int8 / int8_static's s8
    backward and the _fwd halves' f32 one."""
    return max(K.q8_smem_bytes(hidden, rt, S, pol)
               for pol in ("int8", "int8_fwd"))


def test_imap_geometry_bounds_the_scratch():
    """At the full iMAP shape (h=256, 14 samples, 4800 rays, one slot) the
    partial-gradient rows are bounded by the SM count: <= 512 MiB."""
    g = K.frame_geometry(256, 14, 4800, 1)
    assert g.rays_per_tile == 4 and g.n_tiles == 1200
    assert g.blocks == g.rows == K.GRID_SMS == 132
    # each block's partial row (staged weights, then dirs and biases) and
    # activation scratch (h1..h3 of 56 points at stride 57)
    assert g.scratch_bytes == 132 * (333136 + 3 * 256 * 57) * 4 <= 512 << 20
    # more rays do not grow it
    assert K.frame_geometry(256, 14, 48000, 1).scratch_bytes == \
        g.scratch_bytes


def test_vmap_geometry_is_one_block_per_tile():
    """The vMAP shapes keep one block per ray tile: their scratch is within
    the budget."""
    obj = K.frame_geometry(32, 10, 120, 104)
    assert (obj.rays_per_tile, obj.n_tiles, obj.blocks, obj.rows) == \
        (6, 20, 20, 2080)
    assert obj.scratch_bytes == 2080 * (13040 + 3 * 32 * 61) * 4
    bg = K.frame_geometry(128, 14, 1200, 1)
    assert (bg.rays_per_tile, bg.n_tiles, bg.blocks, bg.rows) == \
        (4, 300, 300, 300)
    assert max(obj.scratch_bytes, bg.scratch_bytes) <= K.SCRATCH_BUDGET


@pytest.mark.parametrize("h,S,n_per,cap", [
    (256, 14, 4800, 1), (256, 14, 61, 1), (256, 5, 4801, 3),
    (32, 10, 120, 104), (128, 14, 1200, 1), (32, 32, 7, 200)])
def test_geometry_covers_every_ray_once(h, S, n_per, cap):
    """Block b takes tiles b, b + blocks, ... (the kernel's loop): every
    ray of the iteration lies in exactly one tile of exactly one block,
    every block has a tile, and a tile fits the block's shared memory
    (the float policies' plan, float_smem_bytes)."""
    g = K.frame_geometry(h, S, n_per, cap)
    assert 1 <= g.blocks <= g.n_tiles and g.rows == cap * g.blocks
    assert g.scratch_bytes <= max(
        K.SCRATCH_BUDGET, max(cap, K.GRID_SMS) * K.block_scratch_bytes(
            256, kernels.FLOAT_POINTS[256], 1))
    hits = np.zeros(n_per, np.int64)
    for b in range(g.blocks):
        tiles = range(b, g.n_tiles, g.blocks)
        assert len(tiles) >= 1
        for tile in tiles:
            r0 = tile * g.rays_per_tile
            assert r0 < n_per                  # no tile is all padding
            hits[r0:r0 + g.rays_per_tile] += 1
    np.testing.assert_array_equal(hits, 1)
    assert K.float_smem_bytes(h, g.rays_per_tile, S) <= 232448


def test_max_points_fit_shared_memory():
    """Every width's largest tile fits the 227 KB a block may use."""
    for h, pts in K.MAX_POINTS.items():
        assert h in kernels.KERNEL_HIDDEN["train_frame"]
        assert _smem_bytes(h, pts, 1) <= 232448, h
    assert set(K.MAX_POINTS) == set(kernels.KERNEL_HIDDEN["train_frame"])


# ----------------------------------------------------- configurations
def _shipped(name):
    raw = json.load(open(os.path.join(REPO, "configs", name)))
    raw["dataset"]["path"] = ""      # ScanNet resolves intrinsics from it
    return Config.from_dict(raw)


@pytest.mark.parametrize("name", ["Replica/room0_imap.json",
                                  "ScanNet/scene0000_imap.json",
                                  "ScanNet/scene0024_imap.json"])
def test_shipped_imap_configs_have_kernels(name):
    cfg = _shipped(name)
    assert cfg.imap_mode and not cfg.do_bg and cfg.max_n_models == 1
    tmapper.check_supported(cfg)
    tmapper.check_kernel_widths(cfg)
    for k in tmapper.PATH_KERNELS:
        assert cfg.hidden_feature_size in kernels.KERNEL_HIDDEN[k]


def test_kernel_path_names_the_kernel_a_width_lacks(monkeypatch):
    """A width that K1 has and K2 lacks is refused at construction, naming
    K2, and not at the first mesh export."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setitem(kernels.KERNEL_HIDDEN, "field_fwd", (32, 128))
    cfg = _shipped("Replica/room0_imap.json")
    with pytest.raises(NotImplementedError,
                       match=r"hidden sizes 256: no CUDA kernel field_fwd"):
        tmapper.Mapper(cfg, device="cuda")
