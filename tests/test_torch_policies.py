"""The port's ``sample_reuse`` and matmul policies (``bwd_bf16``, ``bf16``)
against the JAX package on the CPU: the reuse sampler with JAX's draws
injected, the kernel operands under reuse against the tiled ones, the
plain train-frame function under each policy against the JAX train-frame
kernel in interpret mode, and one frame step with reuse 4 + bwd_bf16
against JAX's fused frame step (interpret mode).

Policy tolerances. The port and JAX sum in different orders (and take
sin / cos differently), so a value within f32 noise of a bf16 rounding
boundary can round to neighbouring bf16 values (a 2^-8 relative step) on
the two sides: sparse steps of 2^-8 of one term of a gradient's sum. So
the policies are compared at n_iter=1 on gradients (read from the first
AdamW moment, m' = 0.9 m + 0.1 g) and losses: each gradient tensor's
largest error within 1e-2 of the tensor's scale (max |g|), and, where the
policy moves the tensor at all (JAX's policy against JAX's f32), the
error at least 10x smaller in norm than that effect (which proves the
rounding happens where JAX's does). Tensors that a policy leaves exact
(the alpha and colour-output biases under bwd_bf16: their gradients are
sums of f32 upstream gradients) take the f32 tolerance instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmap_tpu.core import step as js
from vmap_tpu.kernels.train_step import (fused_bank_frame, prepare_bank,
                                         unprepare_bank)
from vmap_tpu_torch.core import step as ts
from vmap_tpu_torch.kernels import train_step as K

from _torch_parity import jax_bank_draws, jax_frame_draw_source, n, \
    port_bank, t
from test_torch_step import CAP, _jax_banks, _pool, _statics, _tables
from test_torch_train_step import conditioned_jax_bank, numpy_batch

LR, WD, CS, OSC = 1e-3, 0.013, 5.0, 10.0
# the port's policy names (tpu.compute_dtype) -> the JAX kernel's bf16=
JAX_POLICY = {"float32": "f32", "bwd_bf16": "bwd_bf16", "bfloat16": "bf16"}
PIXEL_KEYS = ("rgb", "depth", "state", "valid", "origins", "dirs")


@pytest.mark.parametrize("reuse", [2, 4])
def test_sample_bank_reuse_matches_jax(reuse):
    """Untiled pixel arrays over n_frames / reuse frames (JAX's fused-path
    ``tile_pixels=False``), z fresh over all frames, on JAX's draws."""
    packed, twc = _pool()
    tabs = _tables()
    st_j, st_t = _statics(n_iter=4, sample_reuse=reuse)
    obj_ids = np.arange(CAP, dtype=np.int32)
    n_frames = st_t.n_iter * st_t.win
    key = jax.random.PRNGKey(11)
    want = js._sample_bank(key, jnp.asarray(packed), jnp.asarray(twc),
                           *map(jnp.asarray, tabs), jnp.asarray(obj_ids),
                           n_frames, st_j.n_px, st_j.n_b2s, st_j,
                           reuse=reuse, tile_pixels=False)
    shapes = ts.draw_shapes(CAP, n_frames, st_t.n_px, st_t.n_b2s,
                            st_t.n_bins, 1, reuse)
    got = ts._sample_bank(t(packed.view(np.int32)), t(twc), *map(t, tabs),
                          t(obj_ids), n_frames, st_t.n_px, st_t.n_b2s, st_t,
                          jax_bank_draws(key, shapes), reuse=reuse)
    n_eff = n_frames // reuse * st_t.n_px
    assert got["depth"].shape == (CAP, n_eff)
    assert got["z"].shape == (CAP, n_frames * st_t.n_px, 5)
    np.testing.assert_array_equal(n(got["depth"]), np.asarray(want["depth"]))
    np.testing.assert_array_equal(n(got["state"]), np.asarray(want["state"]))
    np.testing.assert_array_equal(n(got["valid"]), np.asarray(want["valid"]))
    np.testing.assert_array_equal(
        n(got["rgb"]), np.moveaxis(np.asarray(want["rgb_sm"]), 1, -1))
    for k, jk in (("z", "z_sm"), ("origins", "origins_sm"),
                  ("dirs", "dirs_sm")):
        np.testing.assert_allclose(
            n(got[k]), np.moveaxis(np.asarray(want[jk]), 1, -1), rtol=1e-6,
            atol=1e-6, err_msg=k)


def _untiled_and_tiled(rng, cap, n_iter, n_per, S, reuse):
    """A batch with n_iter / reuse iterations of pixels (z for all n_iter)
    and the same batch with its pixel arrays tiled along the iterations."""
    b = numpy_batch(rng, cap, n_iter * n_per, S)
    n_eff = n_iter // reuse * n_per
    untiled = {k: t(v[:, :n_eff] if k in PIXEL_KEYS else v)
               for k, v in b.items()}
    tiled = {k: (v.repeat(1, reuse, *([1] * (v.dim() - 2)))
                 if k in PIXEL_KEYS else v) for k, v in untiled.items()}
    return untiled, tiled


def test_kernel_operands_under_reuse_equal_the_tiled_ones(rng):
    """``kernel_operands(reuse=R)`` builds od, ray and wmul once for the
    n_iter / R pixel blocks; repeated along the iterations they equal, bit
    for bit, the operands of the tiled batch, and z is the same. The plain
    frame under reuse is bit-identical to the frame on the tiled batch."""
    cap, n_iter, n_per, S, R = 3, 4, 40, 6, 4
    untiled, tiled = _untiled_and_tiled(rng, cap, n_iter, n_per, S, R)
    untiled["state"][1, :n_per] = 2        # an empty opacity mask
    tiled["state"][1, :] = untiled["state"][1].repeat(R)
    active = torch.tensor([True, True, False])
    u = K.kernel_operands(untiled, active, n_iter, n_per, reuse=R)
    tl = K.kernel_operands(tiled, active, n_iter, n_per)
    assert u["od"].shape == (cap, n_per, 6) and u["wmul"].shape == (cap, 1, 4)
    for k in ("od", "ray"):
        assert torch.equal(u[k].repeat(1, R, 1), tl[k]), k
    assert torch.equal(u["wmul"].repeat(1, R, 1), tl["wmul"])
    assert torch.equal(u["z"], tl["z"])
    assert float(u["wmul"][:, 0, 2].abs().sum()) == 0.0

    bank = port_bank(conditioned_jax_bank(cap, 16, 2))
    got_b, got_l = K.fused_frame_reference(bank, untiled, n_iter, n_per, LR,
                                           WD, CS, OSC, reuse=R)
    want_b, want_l = K.fused_frame_reference(bank, tiled, n_iter, n_per, LR,
                                             WD, CS, OSC)
    assert torch.equal(got_l, want_l) and torch.equal(got_b.flat, want_b.flat)
    with pytest.raises(ValueError, match="sample_reuse 3"):
        K.kernel_operands(untiled, active, n_iter, n_per, reuse=3)


# 4 slots (3 active) at h=16, 48 rays x 5 samples, one iteration
POL_CAP, POL_H, POL_NPER, POL_S = 4, 16, 48, 5


@pytest.fixture(scope="module")
def policy_frames():
    """The JAX train-frame kernel (interpret mode) under float32, bwd_bf16
    and bfloat16 on one batch and bank, and the port's plain frame under
    each."""
    rng = np.random.default_rng(3)
    jbank = conditioned_jax_bank(POL_CAP, POL_H, 3)
    b = numpy_batch(rng, POL_CAP, POL_NPER, POL_S)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    pbank = port_bank(jbank)
    m0 = np.asarray(jbank.m)
    out = {"bank": jbank}
    for pol in JAX_POLICY:
        jb, jl = fused_bank_frame(jbank, jbatch, 1, POL_NPER, POL_CAP, LR, WD,
                                  CS, OSC, bf16=JAX_POLICY[pol],
                                  interpret=True)
        pb, pl = K.fused_frame_reference(
            pbank, {k: t(v) for k, v in b.items()}, 1, POL_NPER, LR, WD, CS,
            OSC, policy=pol)
        out[pol] = {"jax_g": (np.asarray(jb.m) - 0.9 * m0) / 0.1,
                    "port_g": (n(pb.m) - 0.9 * m0) / 0.1,
                    "jax_loss": np.asarray(jl), "port_loss": n(pl)}
    return out


def policy_errors(got, want, ref_f32, spec, active):
    """Per parameter tensor over the active slots: the largest error
    |got - want|max over the scale |want|max, the error's norm, the
    norm of ref_f32 - want (the policy's effect) and of want."""
    res = {}
    for _, name, _, off, size in spec.names:
        sl = (active, slice(off, off + size))
        g, w, r = got[sl], want[sl], ref_f32[sl]
        res[name] = {"max_rel": float(np.abs(g - w).max())
                     / max(float(np.abs(w).max()), 1e-30),
                     "err": float(np.linalg.norm(g - w)),
                     "effect": float(np.linalg.norm(r - w)),
                     "norm": float(np.linalg.norm(w))}
    return res


@pytest.mark.parametrize("policy", ["bwd_bf16", "bfloat16"],
                         ids=["bwd_bf16", "bf16"])
def test_reference_policy_matches_jax_kernel(policy_frames, policy):
    fr = policy_frames
    jbank = fr["bank"]
    act = np.asarray(jbank.active)
    cur, f32 = fr[policy], fr["float32"]
    errs = policy_errors(cur["port_g"], cur["jax_g"], f32["jax_g"],
                         jbank.spec, act)
    for name, e in errs.items():
        assert e["max_rel"] <= 1e-2, (name, e)
        if e["effect"] > 0:   # the policy rounds this tensor's products
            assert e["err"] <= 0.1 * e["effect"], (name, e)
        else:                 # exact under the policy: the f32 tolerance
            assert e["max_rel"] <= 1e-5, (name, e)
    # the policy acts on most tensors
    assert sum(e["effect"] > 1e-3 * e["norm"] for e in errs.values()) >= 10
    np.testing.assert_allclose(cur["port_loss"], cur["jax_loss"], rtol=2e-4,
                               atol=2e-6)
    loss_effect = np.abs(f32["jax_loss"] - cur["jax_loss"]).max()
    loss_err = np.abs(cur["port_loss"] - cur["jax_loss"]).max()
    if policy == "bfloat16":  # the forward products are rounded too
        assert loss_effect > 0 and loss_err <= 0.1 * loss_effect
    else:                     # bwd_bf16: the forward is f32
        assert loss_effect == 0.0


def _frame_step_reuse_matches_jax_fused(policy: str) -> None:
    """One frame of both banks, sample_reuse 4 on the objects and
    ``policy`` on both, against JAX's fused frame step (interpret mode,
    G = 1) on the same pool, tables and draws; see the two tests below."""
    packed, twc = _pool(1)
    tabs = _tables(1)
    bg_tab = tuple(a[:1] for a in _tables(2, cap=1))
    kw = dict(n_iter=4, px_block_bg=4, sample_reuse=4)
    st_j, st_t = _statics(use_fused_frame=True, compute_dtype=policy, **kw)
    bo_j, bb_j = _jax_banks()
    pb_o, pb_b = prepare_bank(bo_j, 1), prepare_bank(bb_j, 1)
    obj_ids = np.arange(CAP, dtype=np.int32)
    key = jax.random.PRNGKey(200)
    pb_o, pb_b, met_j = js.make_frame_step(st_j)(
        pb_o, pb_b, jnp.asarray(packed), jnp.asarray(twc),
        tuple(map(jnp.asarray, tabs)), jnp.asarray(obj_ids),
        tuple(map(jnp.asarray, bg_tab)), key)

    def port_frame(st):
        draws = jax_frame_draw_source(key)
        return ts.frame_step(
            st, port_bank(bo_j), port_bank(bb_j), t(packed.view(np.int32)),
            t(twc), tuple(map(t, tabs)), t(obj_ids), tuple(map(t, bg_tab)),
            draws("obj", ts.draw_shapes(CAP, 8, 16, 1, 4, 1, 4)),
            draws("bg", ts.draw_shapes(1, 8, 16, 2, 4, 4)))

    bo_t, bb_t, met_t = port_frame(st_t)
    f32_o, f32_b, _ = port_frame(
        _statics(use_fused_frame=True, compute_dtype="float32", **kw)[1])
    for k in ("loss", "loss_mean"):
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                   rtol=2e-3, err_msg=k)
    for ours, pb, f32 in ((bo_t, pb_o, f32_o), (bb_t, pb_b, f32_b)):
        theirs = unprepare_bank(pb)
        np.testing.assert_allclose(n(ours.flat), np.asarray(theirs.flat),
                                   rtol=0, atol=4 * LR)
        np.testing.assert_array_equal(n(ours.step), np.asarray(theirs.step))
        m = n(ours.m)
        err = np.linalg.norm(m - np.asarray(theirs.m))
        effect = np.linalg.norm(n(f32.m) - m)
        assert err <= 0.1 * effect, (err, effect)


def test_frame_step_reuse_bwd_bf16_matches_jax_fused():
    """One frame of both banks, sample_reuse 4 on the objects and
    bwd_bf16 on both, against JAX's fused frame step (interpret mode) on
    the same pool, tables and draws. Four AdamW steps carry the bf16
    rounding-boundary noise of the gradients into the parameters (a
    flipped near-zero gradient moves its parameter by up to 2 lr, and the
    f32 frames differ as much), so parameters compare within atol 4 lr.
    The first moment, the decayed sum of the four gradients, carries no
    such amplification: so that a step that dropped the policy cannot
    pass, the port's must lie at least 10x closer in norm to JAX's than to
    the port's own float32 frame on the same draws. The losses within
    rtol 2e-3."""
    _frame_step_reuse_matches_jax_fused("bwd_bf16")


def test_frame_step_reuse_int8_static_matches_jax_fused():
    """As the bwd_bf16 test above, under int8_static: its activation and
    gradient scales are fixed (ops.quant.Q8_SCALES, JAX's defaults), and
    at G = 1 JAX's weight scales are per slot and tensor as the port's, so
    the two granularities coincide and the same bars hold."""
    _frame_step_reuse_matches_jax_fused("int8_static")
