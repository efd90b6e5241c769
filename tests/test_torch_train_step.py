"""The port's train-frame function against the XLA reference of the JAX
train-frame kernel (tests/test_train_kernel.py::ref_frame), on the CPU.

``fused_frame_reference`` is the plain PyTorch version of the CUDA kernels
in vmap_tpu_torch/kernels/csrc/train_step.cu; the kernels themselves are
held against it on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmap_tpu.core.bank import activate_slot, init_bank
from vmap_tpu_torch.kernels import train_step as K
from vmap_tpu_torch.ops import losses as tl
from vmap_tpu_torch.ops import render as tr

from _torch_parity import n, port_bank, ref_frame, t

LR, WD, CS, OSC = 1e-3, 0.013, 5.0, 10.0


def conditioned_jax_bank(cap, h, n_active):
    """As tests/test_train_kernel.py:88-103: active slots, weights x0.3 so
    occupancy stays unsaturated (the 1/(sqrt(var)+1e-4) information weight
    amplifies rounding on saturated data), small moments, step 3."""
    key = jax.random.PRNGKey(0)
    bank = init_bank(key, cap, hidden=h)
    for s in range(n_active):
        bank = activate_slot(bank, s, jax.random.fold_in(key, s),
                             2.0 + 0.5 * s, hidden=h)
    return bank.replace(
        flat=bank.flat * 0.3,
        m=jax.random.normal(jax.random.fold_in(key, 90), bank.m.shape) * 1e-4,
        v=jax.random.uniform(jax.random.fold_in(key, 91), bank.v.shape) * 1e-6,
        step=jnp.where(bank.active, 3, 0).astype(jnp.int32))


def numpy_batch(rng, cap, n_rays, S):
    depth = rng.uniform(0.5, 3.0, (cap, n_rays)).astype(np.float32)
    depth[rng.uniform(size=(cap, n_rays)) < 0.15] = 0.0
    z = np.sort(rng.uniform(0.1, 3.5, (cap, n_rays, S)), -1).astype(np.float32)
    return {"rgb": rng.uniform(0, 1, (cap, n_rays, 3)).astype(np.float32),
            "depth": depth,
            "state": rng.integers(0, 3, (cap, n_rays)).astype(np.int32),
            "valid": depth > 0, "z": z,
            "origins": rng.normal(0, 0.1, (cap, n_rays, 3)).astype(np.float32),
            "dirs": rng.normal(0, 0.3, (cap, n_rays, 3)).astype(np.float32)}


def jax_batch(b):
    out = {k: jnp.asarray(v) for k, v in b.items()}
    out["pts"] = (out["origins"][:, :, None, :]
                  + out["z"][..., None] * out["dirs"][:, :, None, :])
    return out


@pytest.mark.parametrize("cap,h,n_per,n_iter,S,n_active", [
    (8, 32, 120, 3, 10, 7),      # object-bank shape
    (2, 16, 200, 2, 5, 2),       # background-like
    (1, 256, 96, 2, 4, 1),       # iMAP single field (hidden 256)
    (1, 256, 40, 2, 14, 1),      # iMAP: 5 + 9 = 14 samples per ray
])
def test_reference_frame_matches_jax(rng, cap, h, n_per, n_iter, S,
                                     n_active):
    jbank = conditioned_jax_bank(cap, h, n_active)
    b = numpy_batch(rng, cap, n_iter * n_per, S)
    ref_bank, ref_losses = ref_frame(jbank, jax_batch(b), n_iter, n_per)
    bank = port_bank(jbank)
    new, losses = K.fused_frame_reference(
        bank, {k: t(v) for k, v in b.items()}, n_iter, n_per, LR, WD, CS, OSC)
    # the tolerances of tests/test_train_kernel.py:111-120
    np.testing.assert_allclose(n(losses), np.asarray(ref_losses), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(n(new.flat), np.asarray(ref_bank.flat),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(n(new.m), np.asarray(ref_bank.m), rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(n(new.v), np.asarray(ref_bank.v), rtol=2e-4,
                               atol=1e-12)
    np.testing.assert_array_equal(n(new.step), np.asarray(ref_bank.step))
    inact = ~np.asarray(jbank.active)
    for f in ("flat", "m", "v"):
        np.testing.assert_array_equal(n(getattr(new, f))[inact],
                                      np.asarray(getattr(jbank, f))[inact])


def test_wrapper_on_cpu_runs_plain_and_launches_nothing(rng):
    bank = port_bank(conditioned_jax_bank(2, 32, 2))
    batch = {k: t(v) for k, v in numpy_batch(rng, 2, 2 * 24, 6).items()}
    before = dict(K.LAUNCHES)
    got_bank, got = K.fused_frame(bank, batch, 2, 24, LR, WD, CS, OSC)
    want_bank, want = K.fused_frame_reference(bank, batch, 2, 24, LR, WD, CS,
                                              OSC)
    assert K.LAUNCHES == before
    assert torch.equal(got, want) and torch.equal(got_bank.flat,
                                                  want_bank.flat)
    with pytest.raises(ValueError, match="CUDA"):
        K.FrameLaunch(bank, batch, 2, 24, CS, OSC)


def test_kernel_operands_reproduce_the_loss(rng):
    """The kernel's host-side operands (per-ray columns and the
    flag * active / (count + 1e-10) normalisers) rebuild step_batch_loss
    per slot when combined the way train_grad_kernel combines them — with
    an active slot whose opacity mask is empty (zeroes that term for all)."""
    cap, n_iter, n_per, S = 3, 2, 40, 6
    b = {k: t(v) for k, v in numpy_batch(rng, cap, n_iter * n_per, S).items()}
    b["state"][1, :n_per] = 2          # slot 1, iteration 0: mask_sem empty
    active = torch.tensor([True, True, False])
    alpha = torch.tensor(rng.normal(0, 0.5, (cap, n_iter * n_per, S)),
                         dtype=torch.float32)
    color = torch.tensor(rng.uniform(0, 1, (cap, n_iter * n_per, S, 3)),
                         dtype=torch.float32)
    ops = K.kernel_operands(b, active, n_iter, n_per)
    wm = ops["wmul"]
    assert ops["od"].shape == (cap, n_iter * n_per, 6)
    for it in range(n_iter):
        sl = slice(it * n_per, (it + 1) * n_per)
        _, want = tl.step_batch_loss(
            alpha[:, sl], color[:, sl], b["depth"][:, sl], b["rgb"][:, sl],
            b["state"][:, sl], b["valid"][:, sl], b["z"][:, sl], active,
            CS, OSC)
        ray, z = ops["ray"][:, sl], ops["z"][:, sl]
        term = tr.occupancy_to_termination(torch.sigmoid(alpha[:, sl]))
        dep = (term * z).sum(-1)
        var = (term * (z - dep[..., None]) ** 2).sum(-1)
        rc = (term[..., None] * color[:, sl]).sum(-2)
        ld = (dep - ray[..., 0]).abs() * ray[..., 6] / (var.sqrt() + 1e-4)
        lc = (rc - ray[..., 1:4]).abs().sum(-1) * ray[..., 4]
        lo = (term.sum(-1) - ray[..., 4]).abs() * ray[..., 5]
        w = wm[:, it]
        got = ((w[:, 0:1] * ld).sum(-1) + CS * (w[:, 1:2] * lc).sum(-1)
               + OSC * (w[:, 2:3] * lo).sum(-1))
        np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-6)
    assert float(wm[:, 0, 2].abs().sum()) == 0.0     # opacity term zeroed
    assert float(wm[2].abs().sum()) == 0.0           # inactive slot


def test_tile_rays_fits_the_slice_shapes():
    assert K.tile_rays(32, 10) * 10 <= K.MAX_POINTS[32]
    assert K.tile_rays(128, 14) * 14 <= K.MAX_POINTS[128]
    assert K.tile_rays(128, 14) >= 1 and K.tile_rays(32, 64) == 1
