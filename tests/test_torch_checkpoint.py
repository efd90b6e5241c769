"""Checkpoints of the port: per-object ``.npz`` files cross-load with
vmap_tpu.core.checkpoint in both directions with the parameters
bit-equal, and a full-state save / resume continues the uninterrupted
run exactly (banks and losses equal) on the CPU."""

import os

import numpy as np
import pytest
import torch

from vmap_tpu.config import Config
from vmap_tpu.core import checkpoint as JC
from vmap_tpu.core.mapper import FrameSample as JFrame
from vmap_tpu.core.mapper import Mapper as JMapper
from vmap_tpu.data.synthetic import SyntheticScene
from vmap_tpu_torch.core import checkpoint as TC
from vmap_tpu_torch.core import mapper as tmapper
from vmap_tpu_torch.interop import FIELDS

from _torch_parity import small_synthetic_config


def _frames(n):
    scene = SyntheticScene(width=80, height=60)
    for fid in range(n):
        s = scene.frame_sample(fid, n_frames=8)
        yield (s["image"], s["depth"], s["obj"], s["bbox_dict"], s["T"], fid)


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port Mapper that ingested the same frames; each keeps
    its own random initial parameters."""
    cfg = Config(max_n_models=4, do_bg=True, hidden_feature_size=8,
                 hidden_feature_size_bg=8, W=80, H=60, fx=60.0, fy=60.0,
                 cx=39.5, cy=29.5, frame_pool_size=16, seed=0)
    jm, pm = JMapper(cfg), tmapper.Mapper(cfg, device="cpu",
                                          draw_source=lambda b, s: None)
    for args in _frames(3):
        jm.ingest_frame(JFrame(*args))
        pm.ingest_frame(tmapper.FrameSample(*args))
    return jm, pm


def _slot_flat(m, obj_id):
    rec = m.registry[obj_id]
    bank = m.bank_bg if rec.is_bg else m.bank_obj
    return np.asarray(bank.flat[rec.slot]), float(bank.scale[rec.slot])


@pytest.mark.parametrize("obj_id", [0, 1])
def test_jax_npz_restores_into_port(pair, tmp_path, obj_id):
    jm, pm = pair
    file = JC.save_object_checkpoint(jm, obj_id, str(tmp_path), epoch=3)
    ck = TC.load_object_checkpoint(file)
    assert ck["obj_id"] == obj_id and ck["epoch"] == 3
    TC.restore_object_into_mapper(pm, ck)
    flat_j, scale_j = _slot_flat(jm, obj_id)
    flat_t, scale_t = _slot_flat(pm, obj_id)
    np.testing.assert_array_equal(flat_t, flat_j)
    assert scale_t == scale_j


@pytest.mark.parametrize("obj_id", [0, 1])
def test_port_npz_restores_into_jax(pair, tmp_path, obj_id):
    jm, pm = pair
    rec = pm.registry[obj_id]
    bank = pm.bank_bg if rec.is_bg else pm.bank_obj
    bank.flat[rec.slot] = torch.randn(bank.flat.shape[1])   # new params
    bank.scale[rec.slot] = 1.75
    file = TC.save_object_checkpoint(pm, obj_id, str(tmp_path), epoch=5)
    assert os.path.basename(file) == f"obj_{obj_id}_frame_5.npz"
    ck = JC.load_object_checkpoint(file)
    JC.restore_object_into_mapper(jm, ck)
    flat_j, scale_j = _slot_flat(jm, obj_id)
    flat_t, scale_t = _slot_flat(pm, obj_id)
    np.testing.assert_array_equal(flat_j, flat_t)
    assert scale_j == scale_t == 1.75
    # same payload keys and bound as a file the JAX package writes
    jfile = JC.save_object_checkpoint(jm, obj_id, str(tmp_path / "j"), 5)
    zj, zt = np.load(jfile), np.load(file)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        if k.startswith("bound"):
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)


def _run(mapper, frames):
    losses = []
    for args in frames:
        met = mapper.process_frame(tmapper.FrameSample(*args))
        losses.append(float(met["loss"]))
    return losses


def test_full_state_resume_continues_the_run(tmp_path):
    """frames 0..12 uninterrupted == frames 0..10, save, load into a fresh
    Mapper, frames 11..12: banks, tables and losses equal."""
    cfg = Config.from_json(small_synthetic_config(tmp_path / "cfg.json"))
    frames = list(_frames(13))
    ref = tmapper.Mapper(cfg, device="cpu")
    ref_losses = _run(ref, frames)

    first = tmapper.Mapper(cfg, device="cpu")
    _run(first, frames[:11])
    TC.save_full_checkpoint(first, str(tmp_path / "state"), frame_id=10)
    resumed = tmapper.Mapper(cfg, device="cpu")
    assert TC.load_full_checkpoint(resumed, str(tmp_path / "state")) == 10
    losses = _run(resumed, frames[11:])

    assert losses == ref_losses[11:]
    for name in ("bank_obj", "bank_bg"):
        for f in FIELDS:
            assert torch.equal(getattr(getattr(resumed, name), f),
                               getattr(getattr(ref, name), f)), (name, f)
    for a, b in zip(resumed.obj_table.as_arrays(), ref.obj_table.as_arrays()):
        np.testing.assert_array_equal(a, b)
    assert {k: vars(r) for k, r in resumed.registry.items()} == \
        {k: vars(r) for k, r in ref.registry.items()}
    assert torch.equal(resumed.pool.packed, ref.pool.packed)
    np.testing.assert_array_equal(resumed.pool.refcount, ref.pool.refcount)
