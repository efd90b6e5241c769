"""The int8 policies' tensor-core tile of the train-frame kernel
(vmap_tpu_torch/kernels/csrc/train_step_q8.cu), on the CPU: the plain
versions of what it reads and computes beside the products, and its
shared-memory plan.

* ``kernels.train_step.stage_q8`` / ``q8_layout``, the s8 weights
  ``train_quant_w`` writes: each QW tensor of ``ops.quant.quant_weights``
  value for value, its transpose, and their zero padding to whole 16 x 32
  tiles, at h = 32 / 128 / 256;
* the exactness of the s8 products: torch int32 products of the operands
  padded with s8 zeros to whole k32 steps (and 8-point n tiles) equal the
  f32 products of the same integer values at K1's layer shapes, also at
  the largest magnitudes, and scaled as the kernel scales them, acc *
  (s_a * s_b), they equal ``ops.quant``'s forward, input- and
  weight-gradient products bit for bit;
* the int8 tile's shared memory (``q8_smem_bytes``) within the 232,448
  bytes a block may use at every S <= 32 and the shipped shapes, two h=32
  blocks an SM, and its slabs covering every product the tile streams;
* ``kernels.q8_profile_fault``'s source variants (the measuring build's
  fault, reproduced on the card) and its refusal without a CUDA device.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from vmap_tpu_torch import kernels
from vmap_tpu_torch.core.bank import BankSpec
from vmap_tpu_torch.kernels import train_step as K
from vmap_tpu_torch.ops import quant as Q

WIDTHS = (32, 128, 256)
SMEM_LIMIT = 232448
TWO_BLOCKS = 115712      # (228 KB - 1 KB reserved a block) / 2
INT8 = Q.INT8_POLICIES


def _up(x, m):
    return -(-x // m) * m


def _quantised(h, n=3, seed=0):
    spec = BankSpec.create(h)
    rng = np.random.default_rng(seed + h)
    flat = torch.from_numpy(
        (rng.standard_normal((n, spec.n_params)) * 0.2).astype(np.float32))
    _, w = spec.unflatten(flat)
    return Q.quant_weights(w, h)


@pytest.mark.parametrize("h", WIDTHS)
def test_q8_layout_holds_the_quantised_weights(h):
    """Every QW tensor's copy [up16(out), up32(in)] equals ops.quant's
    integer values, its transpose [up16(in), up32(out)] their transpose,
    and the padding of both is zero; each block starts 512-byte aligned."""
    qw = _quantised(h)
    layout, size = K.q8_layout(h)
    assert [name for name, *_ in layout] == list(Q.QW_NAMES)
    assert size == {32: 27136, 128: 206848, 256: 675840}[h]
    staged = K.stage_q8(qw, h)
    assert staged.dtype == torch.int8 and staged.shape == (3, size)
    ends = [off for _, _, _, off, _ in layout[1:]] + [size]
    for (name, n_out, n_in, off, off_t), end in zip(layout, ends):
        q = qw[name][0]
        assert tuple(q.shape[1:]) == (n_out, n_in)
        assert float(q.abs().max()) <= 127.0
        assert torch.equal(q, torch.round(q))       # integer-valued
        assert off % 512 == 0 and off_t % 512 == 0
        r, c = _up(n_out, 16), _up(n_in, 32)
        rt, ct = _up(n_in, 16), _up(n_out, 32)
        assert off_t == off + r * c and end == off_t + rt * ct
        block = staged[:, off:off_t].view(3, r, c).to(torch.float32)
        trans = staged[:, off_t:end].view(3, rt, ct).to(torch.float32)
        assert torch.equal(block[:, :n_out, :n_in], q)
        assert torch.equal(trans[:, :n_in, :n_out], q.transpose(1, 2))
        for b, (a0, a1) in ((block, (n_out, n_in)), (trans, (n_in, n_out))):
            pad = b.clone()
            pad[:, :a0, :a1] = 0.0
            assert not pad.any(), f"{name}: padding not zero"


def _k1_products(h):
    """(kind, M, K, N) of K1's s8 products at width h, out [M, N] = A [M,
    K] B [K, N]: the forward (rows n_out, depth n_in: w_in, the hidden
    layers, the x parts of w_cat and w_col, the heads; N the tile's
    points), the input gradients (rows n_in, depth n_out: the hidden
    layers, the heads' 3 and 1 rows, the embedding's 87 and 42 columns)
    and the weight gradients (rows n_out, depth the tile's points, N n_in),
    at the shipped tiles' points 60 / 56 / 28, the widest at h=256 (38) and
    ragged ones."""
    pts = (60, 56, 28, 38, 63, 52, 33)
    out = []
    for p in pts[:4]:
        out += [("fwd", h, 87, p), ("fwd", h, h, p), ("fwd", h, 42, p),
                ("fwd", 1, h, p), ("fwd", 3, h, p),
                ("dgrad", h, h, p), ("dgrad", h, 3, p), ("dgrad", h, 1, p),
                ("dgrad", 87, h, p), ("dgrad", 42, h, p)]
    for p in pts:
        out += [("wgrad", h, p, h), ("wgrad", h, p, 87), ("wgrad", 3, p, h),
                ("wgrad", 1, p, h)]
    return out


@pytest.mark.parametrize("h", WIDTHS)
def test_s8_products_are_exact_and_scaled_as_plain(h):
    """At K1's product shapes, an int32 product of s8 operands padded with
    zeros (the depth to whole k32 steps, the rows to 16, the columns to 8)
    equals the f32 product of the same integers, at random and at the
    largest magnitudes (every operand +-127: the largest sum, under 2^24);
    scaled as the kernel scales it, float(acc) * (s_a * s_b), it equals
    ops.quant's product of the integer-valued f32 operands bit for bit."""
    rng = np.random.default_rng(h)
    s_w = torch.tensor([[[0.0123]]])        # a weight's scale [n, 1, 1]
    s_x = torch.tensor([[0.0371]])          # a tile's scale [n, n_tiles]
    s = s_w[:, :, 0] * s_x                  # as ops.quant multiplies them
    for kind, M, Kd, N in _k1_products(h):
        for full in (False, True):
            if full:
                a = np.full((M, Kd), 127, np.int32)
                b = np.full((Kd, N), -127, np.int32)
            else:
                a = rng.integers(-127, 128, (M, Kd), dtype=np.int32)
                b = rng.integers(-127, 128, (Kd, N), dtype=np.int32)
            ap = np.zeros((_up(M, 16), _up(Kd, 32)), np.int32)
            ap[:M, :Kd] = a
            bp = np.zeros((_up(Kd, 32), _up(N, 8)), np.int32)
            bp[:Kd, :N] = b
            acc = (torch.from_numpy(ap) @ torch.from_numpy(bp))[:M, :N]
            ta, tb = torch.from_numpy(a).float(), torch.from_numpy(b).float()
            assert torch.equal(acc.float(), ta @ tb), (kind, M, Kd, N)
            assert int(acc.abs().max()) < 2 ** 24
        want = acc.float() * s[0, 0]        # the kernel: acc * (s_a * s_b)
        if kind == "fwd":     # xq [1, N, K], wq [1, M, K] -> [N, M]
            got = Q._mm(tb.T[None], ta[None], s, N)[0].T
        elif kind == "dgrad":  # dyq [1, N, K], wq [1, K, M] -> [N, M]
            got = Q._mt(tb.T[None], ta.T[None], s, N)[0].T
        else:                  # dyq [1, K, M], xq [1, K, N]: one tile
            got = Q._wg(ta.T[None], tb[None], s, Kd)[0]
        assert torch.equal(got, want), (kind, M, Kd, N)


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("policy", INT8)
def test_int8_tile_fits_every_sample_count(h, policy):
    """Every S the kernel takes (1..32) gives an int8 tile (tile_rays, the
    scale granularity) within the shared memory a block may use, two
    blocks an SM at h=32; the widest tile too."""
    for S in range(1, 33):
        rt = kernels.tile_rays(h, S)
        assert rt * S <= max(kernels.MAX_POINTS[h], S)
        smem = K.q8_smem_bytes(h, rt, S, policy)
        assert smem <= (TWO_BLOCKS if h == 32 else SMEM_LIMIT), (h, S, smem)
    assert K.q8_smem_bytes(h, kernels.MAX_POINTS[h], 1, policy) <= SMEM_LIMIT


def test_int8_tile_plan_at_the_shipped_shapes():
    """The int8 tile's shared memory at the phase-3 shapes (obj 6 x 10, bg
    4 x 14, iMAP 2 x 14 points; the figures phase 11 logs beside the
    library's vmap_q8_smem), and the slabs of each width covering every
    product it streams: rows x (columns, at most Q8_KS, + 16) bytes."""
    assert [K.q8_smem_bytes(h, rt, S, pol) for h, rt, S in
            ((32, 6, 10), (128, 4, 14), (256, 2, 14))
            for pol in ("int8", "int8_fwd")] == \
        [103232, 103488, 169088, 168688, 151472, 149168]
    for h in WIDTHS:
        ks = K.Q8_KS[h]
        # forward (rows h: depths 96, h, 64; heads 16 rows) and input
        # gradients (rows h, 96, 48: depths h, 32)
        products = [(h, 96), (h, h), (h, 64), (16, h), (h, 32), (96, h),
                    (48, h)]
        need = max(r * (min(ks, k) + 16) for r, k in products)
        assert K.q8_slab_bytes(h, "int8") == need
        assert K.q8_slab_bytes(h, "int8_fwd") == max(
            need, K.slab_bytes(h, "float32"))


@pytest.mark.parametrize("name", ["profile", "mark_after_prod",
                                  "clock_after_prod", "sync_after_prod",
                                  "mark_syncwarp", "checked",
                                  "checked_mark"])
def test_profile_fault_variants_edit_the_int8_tile(name):
    """kernels.q8_profile_fault's variants of csrc/train_step_q8.cu: the
    shipped source for the control (and the checked build), else its code
    right after bwd_layer's product in place of the section mark after the
    mask pass, and nothing else changed."""
    from vmap_tpu_torch.kernels import q8_profile_fault as F
    src = (Path(K.__file__).parent / "csrc" / "train_step_q8.cu").read_text()
    out = F.variant_source(name, src)
    code, _ = {**F.VARIANTS, **F.CHECKED}[name]
    if code is None:
        assert out == src
        return
    edited = F._PRODUCT.replace("  float m", code + "  float m")
    assert F._SHIPPED_MARK not in out and out.count(edited) == 1
    assert out.replace(edited, F._PRODUCT) == src.replace(F._SHIPPED_MARK,
                                                          "")


def test_profile_fault_needs_the_card(monkeypatch):
    """The fault tool refuses without a CUDA device, before it builds."""
    import torch
    from vmap_tpu_torch.kernels import q8_profile_fault as F
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        F.main()


def test_checked_build_is_off_in_the_shipped_builds():
    """The checked build's define (csrc/mma.cuh VMAP_SMEM_CHECK) is set
    only by kernels.q8_profile_fault's checked variants: never by the
    libraries' own flags, and its sites compile to nothing without it."""
    from vmap_tpu_torch.kernels import _build
    from vmap_tpu_torch.kernels import q8_profile_fault as F
    assert not any("VMAP_SMEM_CHECK" in f for f in _build.NVCC_FLAGS)
    assert all("VMAP_SMEM_CHECK" in d for _, d in F.CHECKED.values())
    assert not any("VMAP_SMEM_CHECK" in d for _, d in F.VARIANTS.values())
    mma = (Path(K.__file__).parent / "csrc" / "mma.cuh").read_text()
    assert "#define SMEM_CHECK(base, p, n, site) ((void)0)" in mma
