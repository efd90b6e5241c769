"""The forloop ablation (training_strategy "forloop", reference
train.py:278-290) in the port, on the plain path:

  * against the JAX Mapper's forloop frame by frame, JAX's draws injected
    for each of its successive keys (one per slot call, then the
    background: ``tests/_torch_parity.py KeyedDraws``), the JAX banks
    copied into the port before each frame: losses and every active slot's
    parameters agree at the tolerances of ``tests/test_torch_mapper.py`` /
    ``test_torch_step.py`` (rtol 2e-3);
  * against the port's own vectorised frame with the same per-slot draws:
    every object slot's parameters and moments within rtol 2e-3;
  * ``tests/test_forloop.py``'s two checks mirrored: every active slot
    and the background step n_iter times a frame, and both strategies
    learn the sphere (occupancy on its surface above that of empty space).
"""

import numpy as np
import torch

from vmap_tpu.config import Config as JConfig
from vmap_tpu.core.mapper import FrameSample as JFrame
from vmap_tpu.core.mapper import Mapper as JMapper
from vmap_tpu_torch.config import Config
from vmap_tpu_torch.core import mapper as tmapper
from vmap_tpu_torch.core.step import Draws, draw_shapes
from vmap_tpu_torch.data.synthetic import SyntheticScene
from vmap_tpu_torch.interop import FIELDS, bank_from_numpy

from _torch_parity import KeyedDraws, StepKeys


def _kw(strategy):
    return dict(
        max_n_models=4, do_bg=True, hidden_feature_size=8,
        hidden_feature_size_bg=8, n_iter_per_frame=2,
        win_size=2, n_samples_per_frame=8, win_size_bg=2,
        n_samples_per_frame_bg=8, keyframe_buffer_size=5, keyframe_step=2,
        keyframe_step_bg=2, W=80, H=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5,
        frame_pool_size=16, seed=0, training_strategy=strategy)


def _frame(scene, fid, cls):
    s = scene.frame_sample(fid, n_frames=8)
    return cls(s["image"], s["depth"], s["obj"], s["bbox_dict"], s["T"],
               fid)


def _numpy_bank(bank):
    return {f: np.array(getattr(bank, f)) for f in FIELDS}


def test_forloop_matches_jax_frame_by_frame():
    cfg = _kw("forloop")
    jm = JMapper(JConfig(**cfg))
    rec = StepKeys(jm)
    keys = rec.keys
    source = KeyedDraws(keys, forloop=True)
    pm = tmapper.Mapper(Config(**cfg), device="cpu", draw_source=source)
    scene = SyntheticScene(width=80, height=60)
    for fid in range(3):
        jm.ingest_frame(_frame(scene, fid, JFrame))
        pm.ingest_frame(_frame(scene, fid, tmapper.FrameSample))
        pm.bank_obj = bank_from_numpy(_numpy_bank(jm.bank_obj), 8)
        pm.bank_bg = bank_from_numpy(_numpy_bank(jm.bank_bg), 8)
        n_keys = len(keys)
        with rec.recording():
            met_j = jm.train_frame()
        active = np.asarray(jm.bank_obj.active)
        assert len(keys) - n_keys == active.sum() + 1   # slots, then bg
        met_p = pm.train_frame()
        assert source.used == len(keys)
        np.testing.assert_allclose(met_p["loss"], met_j["loss"], rtol=2e-3,
                                   err_msg=f"frame {fid}")
        for name, tb, jb in (("obj", pm.bank_obj, jm.bank_obj),
                             ("bg", pm.bank_bg, jm.bank_bg)):
            act = np.asarray(jb.active)
            np.testing.assert_array_equal(tb.step.numpy(),
                                          np.asarray(jb.step))
            np.testing.assert_allclose(tb.flat.numpy()[act],
                                       np.asarray(jb.flat)[act], rtol=2e-3,
                                       atol=1e-5, err_msg=f"{name} {fid}")


class _SlotDraws:
    """Per-slot capacity-1 draws from one generator; the forloop takes
    them in slot order, the vectorised frame stacked over every slot."""

    def __init__(self, mapper, seed=0):
        st = mapper.statics
        self.one = draw_shapes(1, st.n_iter * st.win, st.n_px, st.n_b2s,
                               st.n_bins, st.px_block, st.sample_reuse)
        gen = torch.Generator().manual_seed(seed)
        self.slots = [Draws(**{k: torch.rand(s, generator=gen)
                               for k, s in self.one.items()})
                      for _ in range(mapper.slots)]
        self.calls = 0

    def forloop(self, bank, shapes):
        # the active slots are 0, 1, ... (registration order): the n-th
        # object call is slot n's
        assert shapes == self.one
        draws = self.slots[self.calls] if bank == "obj" else self.slots[0]
        self.calls += 1
        return draws

    def stacked(self, bank, shapes):
        if bank == "bg":
            return Draws(**{k: torch.rand(s) for k, s in shapes.items()})
        return Draws(**{k: torch.cat([getattr(d, k) for d in self.slots])
                        for k in self.one})


def test_forloop_matches_the_vectorised_frame_with_the_same_draws():
    scene = SyntheticScene(width=80, height=60)
    mappers = {}
    for strategy in ("forloop", "vmap"):
        m = tmapper.Mapper(Config(**_kw(strategy)), device="cpu")
        src = _SlotDraws(m)
        m.draw_source = getattr(src, "forloop" if strategy == "forloop"
                                else "stacked")
        m.ingest_frame(_frame(scene, 0, tmapper.FrameSample))
        m.train_frame()
        mappers[strategy] = m
    lo, vec = mappers["forloop"].bank_obj, mappers["vmap"].bank_obj
    act = lo.active.numpy()
    assert act.sum() >= 2
    for f in ("flat", "m", "v"):
        np.testing.assert_allclose(getattr(lo, f).numpy()[act],
                                   getattr(vec, f).numpy()[act], rtol=2e-3,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(lo.step.numpy(), vec.step.numpy())


def test_forloop_strategy_trains():
    scene = SyntheticScene(width=80, height=60)
    m = tmapper.Mapper(Config(**_kw("forloop")), device="cpu")
    losses = [m.process_frame(_frame(scene, fid, tmapper.FrameSample))
              ["loss"] for fid in range(4)]
    assert np.isfinite(losses).all()
    steps = m.bank_obj.step.numpy()
    active = m.bank_obj.active.numpy()
    assert (steps[active] > 0).all() and (steps[~active] == 0).all()
    assert int(m.bank_bg.step[0]) == 4 * 2


def test_forloop_and_vmap_agree_statistically():
    """Both strategies learn the scene: mean occupancy over points near
    the sphere's surface beats mean occupancy in empty space."""
    from vmap_tpu_torch.ops.embedding import embed
    from vmap_tpu_torch.ops.mlp import mlp_apply
    from vmap_tpu_torch.ops.render import occupancy_activation

    scene = SyntheticScene(width=80, height=60)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(32, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    surf = scene.sphere_center + dirs * scene.sphere_radius * 0.95
    empty = np.array([[0.0, -0.8, -1.5], [1.5, -0.5, 1.5], [0.0, -1.5, 0.0]])
    for strategy in ("vmap", "forloop"):
        kw = _kw(strategy)
        kw.update(hidden_feature_size=16, n_iter_per_frame=4)
        m = tmapper.Mapper(Config(**kw), device="cpu")
        for fid in list(range(8)) * 2:
            m.process_frame(_frame(scene, fid, tmapper.FrameSample))
        pe, mlp_p, scale = m.object_params(scene.SPHERE_ID)

        def occ(pts):
            x = torch.tensor(pts, dtype=torch.float32)
            alpha, _ = mlp_apply(mlp_p, embed(pe, x, torch.tensor(scale)))
            return occupancy_activation(alpha[..., 0]).mean().item()

        assert occ(surf) > occ(empty), strategy
