"""The widths K1 gained (h=16, the fixture room's objects; h=64,
quality_study's background): the port's plain frame against the JAX
train-frame kernel in interpret mode at each, on the CPU, as
tests/test_train_kernel.py runs JAX's own kernel at h=16.

* float32 at n_iter=1 (a conditioned bank, weights x0.3, as that test's):
  losses, parameters and moments within rtol 2e-3 plus 1e-3 of each
  tensor's scale (the n_iter=1 tier, ReLU ties), steps equal, inactive
  slots bit-identical;
* int8_static by the ratio rule of tests/test_torch_quant.py (a fresh
  field, whose losses the policy moves): the static scales make the two
  sides' granularities coincide at the kernel's own tile
  (``kernels.tile_rays``, ``MAX_POINTS[16] = 64``, ``MAX_POINTS[64] =
  56``).

The CUDA instances at these widths are held to this plain frame on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py phase 18)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vmap_tpu.core.bank import activate_slot, init_bank
from vmap_tpu.kernels.train_step import fused_bank_frame
from vmap_tpu_torch import kernels
from vmap_tpu_torch.kernels import train_step as K

from _torch_parity import n, port_bank, t
from test_torch_quant import hold_by_ratio_rule, one_iteration_vs_jax
from test_torch_train_step import conditioned_jax_bank, numpy_batch

LR, WD, CS, OSC = 1e-3, 0.013, 5.0, 10.0
# hidden: (slots, active slots, rays per iteration, samples)
SHAPES = {16: (2, 2, 200, 5), 64: (1, 1, 112, 7)}


@pytest.mark.parametrize("h", [16, 64])
def test_plain_frame_matches_jax_kernel_at_n_iter_1(h):
    cap, n_active, n_per, S = SHAPES[h]
    assert h in kernels.KERNEL_HIDDEN["train_frame"]
    jbank = conditioned_jax_bank(cap, h, n_active)
    b = numpy_batch(np.random.default_rng(h), cap, n_per, S)
    jb, jl = fused_bank_frame(jbank, {k: jnp.asarray(v) for k, v in
                                      b.items()}, 1, n_per, 1, LR, WD, CS,
                              OSC, bf16="f32", interpret=True)
    pb, pl = K.fused_frame_reference(port_bank(jbank),
                                     {k: t(v) for k, v in b.items()}, 1,
                                     n_per, LR, WD, CS, OSC)
    np.testing.assert_allclose(n(pl), np.asarray(jl), rtol=2e-3, atol=1e-6)
    for f in ("flat", "m", "v"):
        want = np.asarray(getattr(jb, f))
        np.testing.assert_allclose(n(getattr(pb, f)), want, rtol=2e-3,
                                   atol=1e-3 * np.abs(want).max(),
                                   err_msg=f)
    np.testing.assert_array_equal(n(pb.step), np.asarray(jb.step))
    inact = ~np.asarray(jbank.active)
    for f in ("flat", "m", "v"):
        np.testing.assert_array_equal(n(getattr(pb, f))[inact],
                                      np.asarray(getattr(jbank, f))[inact])


@pytest.mark.parametrize("h", [16, 64])
def test_int8_static_matches_jax_kernel_at_the_kernel_tile(h):
    """One fresh field (scale 5.0, its weights as activate_slot draws
    them), n_iter=1, under int8_static at the kernel's own int8 tile."""
    _, _, n_per, S = SHAPES[h]
    key = jax.random.PRNGKey(h)
    jbank = activate_slot(init_bank(key, 1, hidden=h), 0,
                          jax.random.fold_in(key, 0), 5.0, hidden=h)
    assert kernels.tile_rays(h, S) * S <= kernels.MAX_POINTS[h]
    b = numpy_batch(np.random.default_rng(3), 1, n_per, S)
    fr = one_iteration_vs_jax(jbank, b, n_per, ("int8_static",))
    hold_by_ratio_rule(fr, "int8_static", jbank)
