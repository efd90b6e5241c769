"""The field kernels' module (K2 forward, K3 backward) of the port against
vmap_tpu.kernels.ensemble on the CPU: the port's plain versions (what
``field_eval`` / ``FieldTrain`` run on CPU tensors) against the Pallas
kernels in interpret mode, on the same numpy parameters and points.

Tolerances are the JAX package's own kernel bar
(tests/test_pallas_kernel.py): alpha atol 3e-4 (alpha is x10), colour atol
2e-5; gradients rtol 2e-3 with atol 2e-3 x max(1, |g|max) (sums over the
points in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmap_tpu.kernels import ensemble as JE
from vmap_tpu_torch.kernels import ensemble as E
from vmap_tpu_torch.ops.embedding import ICO_DIRS
from vmap_tpu_torch.ops.mlp import LAYERS, layer_fans

from _torch_parity import n, t


def np_params(n_obj: int, hidden: int, seed: int) -> tuple[dict, dict]:
    """Stacked (pe, mlp) numpy parameters of n_obj fields."""
    rng = np.random.default_rng(seed)
    pe = {"dirs": (ICO_DIRS[None] + 0.02 * rng.standard_normal(
        (n_obj, 21, 3))).astype(np.float32)}
    mlp = {}
    for name, (fi, fo) in zip(LAYERS, layer_fans(hidden)):
        std = (2.0 / (fi + fo)) ** 0.5
        mlp[f"w_{name}"] = (rng.standard_normal((n_obj, fo, fi))
                            * std).astype(np.float32)
        mlp[f"b_{name}"] = rng.uniform(-fi ** -0.5, fi ** -0.5,
                                       (n_obj, fo)).astype(np.float32)
    return pe, mlp


def both_prepared(pe, mlp, scale, hidden):
    jp = JE.prepare_params({k: jnp.asarray(v) for k, v in pe.items()},
                           {k: jnp.asarray(v) for k, v in mlp.items()},
                           jnp.asarray(scale), hidden)
    tp = E.prepare_params({k: t(v) for k, v in pe.items()},
                          {k: t(v) for k, v in mlp.items()}, t(scale), hidden)
    return jp, tp


def test_prepare_params_matches_jax_layout():
    pe, mlp = np_params(2, 32, 0)
    jp, tp = both_prepared(pe, mlp, np.array([2.0, 3.0], np.float32), 32)
    assert set(tp) == set(jp) == set(E.W_NAMES) | {"scale"}
    shapes = E.prepared_shapes(32)
    for k in jp:
        np.testing.assert_array_equal(n(tp[k]), np.asarray(jp[k]), err_msg=k)
        if k != "scale":
            assert tuple(tp[k].shape[1:]) == shapes[k]


@pytest.mark.parametrize("hidden", [32, 128, 256])
@pytest.mark.parametrize("m", [1, 127, 513])
def test_field_eval_matches_pallas_interpret(hidden, m):
    pe, mlp = np_params(2, hidden, hidden + m)
    scale = np.array([2.0, 5.0], np.float32)
    pts = np.random.default_rng(m).standard_normal((2, m, 3)).astype(
        np.float32) * 2.0
    jp, tp = both_prepared(pe, mlp, scale, hidden)
    a_j, c_j = JE.fused_field_eval(jp, jnp.asarray(pts), hidden,
                                   interpret=True)
    before = dict(E.LAUNCHES)
    a_t, c_t = E.field_eval(tp, t(pts))
    assert E.LAUNCHES == before          # CPU tensors: no kernel launch
    assert a_t.shape == (2, m) and c_t.shape == (2, m, 3)
    np.testing.assert_allclose(n(a_t), np.asarray(a_j), atol=3e-4, rtol=0)
    np.testing.assert_allclose(n(c_t), np.asarray(c_j), atol=2e-5, rtol=0)


def _grads_port(pe, mlp, scale, pts, hidden, readout):
    pe_t = {k: t(v).requires_grad_(True) for k, v in pe.items()}
    mlp_t = {k: t(v).requires_grad_(True) for k, v in mlp.items()}
    a, c = E.field_train(E.prepare_params(pe_t, mlp_t, t(scale), hidden),
                         t(pts), 256)
    readout(a, c).backward()
    return {**{k: n(v.grad) for k, v in pe_t.items()},
            **{k: n(v.grad) for k, v in mlp_t.items()}}


def _grads_jax(pe, mlp, scale, pts, hidden, readout):
    def loss(pe, mlp):
        prepared = JE.prepare_params(pe, mlp, jnp.asarray(scale), hidden)
        a, c = JE.fused_field_train(prepared, jnp.asarray(pts), hidden,
                                    True, 256)
        return readout(a, c)

    g_pe, g_mlp = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in pe.items()},
        {k: jnp.asarray(v) for k, v in mlp.items()})
    return {k: np.asarray(v) for k, v in {**g_pe, **g_mlp}.items()}


def _assert_grads_close(g_port, g_jax):
    assert set(g_port) == set(g_jax)
    for k, want in g_jax.items():
        np.testing.assert_allclose(
            g_port[k], want, rtol=2e-3,
            atol=2e-3 * max(1.0, float(np.abs(want).max())),
            err_msg=f"gradient of {k}")


@pytest.mark.parametrize("hidden", [32, 128, 256])
def test_field_train_grads_match_pallas_vjp(hidden):
    """Every weight gradient, the PE projection included, of a smooth
    readout over (alpha, colour)."""
    m = 200
    pe, mlp = np_params(2, hidden, 7)
    scale = np.array([2.0, 3.0], np.float32)
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((2, m, 3)).astype(np.float32)
    w_a = rng.standard_normal((2, m)).astype(np.float32)
    w_c = rng.standard_normal((2, m, 3)).astype(np.float32)
    g_jax = _grads_jax(pe, mlp, scale, pts, hidden,
                       lambda a, c: (a * w_a).sum() + (c * w_c).sum())
    g_port = _grads_port(pe, mlp, scale, pts, hidden,
                         lambda a, c: (a * t(w_a)).sum() + (c * t(w_c)).sum())
    _assert_grads_close(g_port, g_jax)


def test_field_train_padding_adds_nothing():
    """77 points, a readout over the first 50: the points outside the
    readout and the tile's padding leave the gradients unchanged."""
    pe, mlp = np_params(1, 32, 11)
    scale = np.array([2.0], np.float32)
    pts = np.random.default_rng(12).standard_normal((1, 77, 3)).astype(
        np.float32)

    def readout(a, c):
        return a[:, :50].sum() + c[:, :50].sum()

    g_jax = _grads_jax(pe, mlp, scale, pts, 32, readout)
    g_port = _grads_port(pe, mlp, scale, pts, 32, readout)
    g_port_50 = _grads_port(pe, mlp, scale, pts[:, :50], 32,
                            lambda a, c: a.sum() + c.sum())
    _assert_grads_close(g_port, g_jax)
    for k in g_port:
        np.testing.assert_allclose(g_port[k], g_port_50[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_points_and_scale_get_zero_gradients():
    pe, mlp = np_params(1, 32, 3)
    scale = torch.tensor([2.0], requires_grad=True)
    tp = E.prepare_params({k: t(v) for k, v in pe.items()},
                          {k: t(v) for k, v in mlp.items()}, scale, 32)
    pts = torch.randn(1, 40, 3, requires_grad=True)
    a, c = E.field_train(tp, pts)
    (a.sum() + c.sum()).backward()
    assert torch.equal(pts.grad, torch.zeros_like(pts))
    assert torch.equal(scale.grad, torch.zeros_like(scale))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel launchers take CUDA tensors only; the CPU path goes
    through the plain version, never through a launcher."""
    pe, mlp = np_params(1, 32, 4)
    _, tp = both_prepared(pe, mlp, np.array([2.0], np.float32), 32)
    pts = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        E._launch_fwd(tp, pts)
    with pytest.raises(ValueError, match="CUDA"):
        E._launch_bwd(tp, pts, torch.zeros(1, 8), torch.zeros(1, 8, 3), 512)
