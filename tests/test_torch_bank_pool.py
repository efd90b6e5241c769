"""The port's bank and frame pool against the JAX package's on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmap_tpu.core import bank as jb
from vmap_tpu.core import pool as jp
from vmap_tpu_torch.core import bank as tb
from vmap_tpu_torch.core import pool as tp
from vmap_tpu_torch.interop import bank_from_numpy, bank_to_numpy

from _torch_parity import n, port_bank, t


@pytest.mark.parametrize("hidden", [16, 32, 128])
def test_bankspec_order_matches_jax(hidden):
    js, ts = jb.BankSpec.create(hidden), tb.BankSpec.create(hidden)
    assert ts.n_params == js.n_params
    assert ts.names == js.names
    # unflatten views land on the same parameters
    flat = np.arange(2 * js.n_params, dtype=np.float32).reshape(2, -1)
    pe_j, mlp_j = js.unflatten(jnp.asarray(flat))
    pe_t, mlp_t = ts.unflatten(t(flat))
    for a, b in ((pe_j, pe_t), (mlp_j, mlp_t)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), n(b[k]))


def _jax_bank(hidden=32, cap=5, n_active=3, seed=0):
    key = jax.random.PRNGKey(seed)
    bank = jb.init_bank(key, cap, hidden)
    for s in range(n_active):
        bank = jb.activate_slot(bank, s, jax.random.fold_in(key, s),
                                2.0 + s, hidden=hidden)
    return bank.replace(
        m=jax.random.normal(jax.random.fold_in(key, 90), bank.m.shape) * 1e-3,
        v=jax.random.uniform(jax.random.fold_in(key, 91), bank.v.shape) * 1e-5,
        step=jnp.where(bank.active, 4, 0).astype(jnp.int32))


def test_interop_round_trip_bit_exact():
    jbank = _jax_bank()
    arrays = {f: np.asarray(getattr(jbank, f)) for f in
              ("flat", "m", "v", "step", "active", "scale")}
    back = bank_to_numpy(bank_from_numpy(arrays, 32))
    for f, a in arrays.items():
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a)
    with pytest.raises(ValueError):
        bank_from_numpy(arrays, 16)        # wrong width for the flat buffer


@pytest.mark.parametrize("cap,hidden,n_active", [(5, 32, 3), (4, 32, 3),
                                                  (1, 128, 1)])
def test_apply_adamw_matches_jax(rng, cap, hidden, n_active):
    jbank = _jax_bank(hidden, cap, n_active)
    g = rng.normal(0, 1, jbank.flat.shape).astype(np.float32)
    want = jb.apply_adamw(jbank, jnp.asarray(g), 1e-3, 0.013)
    got = tb.apply_adamw(port_bank(jbank), t(g), 1e-3, 0.013)
    for f in ("flat", "m", "v"):
        np.testing.assert_allclose(n(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-12)
    np.testing.assert_array_equal(n(got.step), np.asarray(want.step))
    inact = ~np.asarray(jbank.active)
    np.testing.assert_array_equal(n(got.flat)[inact],
                                  np.asarray(jbank.flat)[inact])


def test_adam_bias_corrections_match_apply_adamw():
    """1 - b^t for t = step + i + 1, as the f32 ``1 - b ** t`` of the JAX
    apply_adamw."""
    step = np.array([0, 3, 7], np.int32)
    bc1, bc2 = tb.adam_bias_corrections(t(step), 4)
    tt = jnp.asarray(step[:, None] + np.arange(1, 5)[None], jnp.float32)
    np.testing.assert_allclose(n(bc1), np.asarray(1 - 0.9 ** tt), rtol=1e-6)
    np.testing.assert_allclose(n(bc2), np.asarray(1 - 0.999 ** tt),
                               rtol=1e-6)


def test_init_and_activate_slot():
    gen = torch.Generator().manual_seed(0)
    bank = tb.init_bank(gen, 4, 32, default_scale=2.0)
    assert bank.flat.shape == (4, tb.BankSpec.create(32).n_params)
    assert not bool(bank.active.any())
    pe, _ = bank.params_for(0)
    np.testing.assert_array_equal(n(pe["dirs"]),
                                  np.asarray(jb.BankSpec.create(32).unflatten(
                                      jb.init_bank(jax.random.PRNGKey(0), 1,
                                                   32).flat)[0]["dirs"][0]))
    bank.m[2] = 1.0
    tb.activate_slot(bank, 2, gen, 3.5)
    assert bool(bank.active[2]) and float(bank.scale[2]) == 3.5
    assert float(bank.m[2].abs().sum()) == 0.0
    mlp = {k: np.full(tuple(v.shape), 0.25, np.float32)
           for k, v in bank.params_for(1)[1].items()}
    tb.set_slot_params(bank, 1, {"dirs": np.zeros((21, 3), np.float32)}, mlp)
    assert float(bank.params_for(1)[1]["w_in"].mean()) == 0.25


def _frame(rng, W=16, H=12):
    rgb = rng.integers(0, 256, (W, H, 3)).astype(np.uint8)
    depth = rng.integers(0, 65536, (W, H)).astype(np.uint16)
    inst = rng.integers(-1, 40000, (W, H)).astype(np.int16)
    inst[0, :4] = [-1, 0, 32766, -32768]
    return rgb, depth, inst


def test_pool_pack_unpack_matches_jax(rng):
    rgb, depth, inst = _frame(rng)
    twc = rng.normal(size=(4, 4)).astype(np.float32)
    packed_j, twc_j = jp._write_frame(
        jnp.zeros((3, 16, 12, 2), jnp.uint32),
        jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (3, 1, 1)),
        jnp.int32(1), jnp.asarray(rgb), jnp.asarray(depth),
        jnp.asarray(inst), jnp.asarray(twc))
    pool = tp.FramePool(3, 16, 12)
    pool.write(1, rgb, depth, inst, twc)
    # the port's int32 words are the JAX package's uint32 bits
    np.testing.assert_array_equal(n(pool.packed).view(np.uint32),
                                  np.asarray(packed_j))
    np.testing.assert_array_equal(n(pool.twc), np.asarray(twc_j))
    want = jp._unpack_slot(packed_j[1])
    got = tp.unpack_slot(pool.packed[1])
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))


def test_pool_refcounts_match_jax():
    """The host slot accounting follows the JAX pool call for call."""
    pj, pt = jp.FramePool(3, 4, 4), tp.FramePool(3, 4, 4)
    ops = [("alloc", 10), ("inc", None), ("alloc", 11), ("inc", None),
           ("alloc", 10), ("dec", 0), ("alloc", 12), ("alloc", 13),
           ("inc", None), ("dec", 1), ("alloc", 14)]
    last = None
    for op, arg in ops:
        if op == "alloc":
            last = pj.allocate(arg)
            assert pt.allocate(arg) == last
        elif op == "inc":
            pj.incref(last)
            pt.incref(last)
        else:
            pj.decref(arg)
            pt.decref(arg)
        np.testing.assert_array_equal(pt.refcount, pj.refcount)
        np.testing.assert_array_equal(pt.frame_id, pj.frame_id)
    assert pt.n_used == pj.n_used
    full = tp.FramePool(1, 2, 2)
    full.incref(full.allocate(0))
    with pytest.raises(RuntimeError):
        full.allocate(1)
    with pytest.raises(RuntimeError):
        tp.FramePool(1, 2, 2).decref(0)
