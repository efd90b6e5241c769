"""The float policies' tensor-core tile of the train-frame kernel
(vmap_tpu_torch/kernels/csrc/train_step.cu), on the CPU: the plain
versions of what it computes beside the products, and its geometry.

* ``ops.mlp.split_bf16``, the bf16 pieces of an f32 operand: hi + lo
  gives back x to within half a bf16 ulp of lo, three pieces to within
  2^-24 |x|;
* ``mm_bf16_pieces``, the plain version of the products of those pieces
  (``csrc/mma.cuh`` mma_pieces): the
  three-pass product of two pieces within the error the kernel's source
  note states, (3 2^-16 + K 2^-24) sum_k |a_ik b_kj|, of the f64 product
  at K1's layer shapes (K = 87, h, h + 87, h + 42), and one bf16 pass
  outside it; the six-pass product of three pieces within (4 + K) 2^-24;
* ``kernels.train_step.stage_weights``, the staged bf16 pieces of the
  product weights the kernel streams through shared memory (its layout,
  padding and split), the first JAX's bf16 rounding of the weight;
* the float tile's geometry (``kernels.FLOAT_POINTS``): its points, rows
  per slot, scratch bytes and shared-memory plan within the 232,448 bytes
  a block may use, for every width, policy and sample count of the
  shipped configurations and every S up to 32; ``MAX_POINTS``, the int8
  tile and scale granularity, unchanged;
* chip_smoke.py's train_grad bound under every policy: the tensor-core
  passes its kernel runs (bf16 under the float policies, s8 under the
  int8 ones, the _fwd halves' backward as float32's).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmap_tpu_torch import kernels
from vmap_tpu_torch.core.bank import BankSpec
from vmap_tpu_torch.kernels import train_step as K
from vmap_tpu_torch.ops.mlp import POLICIES, split_bf16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (32, 128, 256)
SMEM_LIMIT = 232448


def mm_bf16_pieces(a: torch.Tensor, b: torch.Tensor,
                   pieces: int) -> torch.Tensor:
    """``a @ b`` of f32 operands as the train-frame kernel computes it from
    ``pieces`` bf16 pieces of each (``csrc/mma.cuh`` mma_pieces), f32
    accumulation, the small terms first: 2 pieces the three passes a1 b0 + a0 b1 + a0 b0,
    within (3 2^-16 + K 2^-24) sum_k |a_ik b_kj| of the exact product (K =
    a.shape[-1]); 3 pieces the six down to a0 b2, a2 b0, within (4 + K)
    2^-24 of it."""
    f = torch.float32
    pa = [t.to(f) for t in split_bf16(a, pieces)]
    pb = [t.to(f) for t in split_bf16(b, pieces)]
    terms = [(i, j) for i in range(pieces) for j in range(pieces)
             if i + j < pieces]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=f)
    for i, j in sorted(terms, key=lambda ij: -(ij[0] + ij[1])):
        out = out + pa[i] @ pb[j]
    return out


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """The bf16 ulp at |x| (8 significant bits), 0 at 0."""
    e = np.floor(np.log2(np.where(x == 0, 1.0, np.abs(x))))
    return np.where(x == 0, 0.0, 2.0 ** (e - 7))


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 3e2, 7e5])
def test_split_gives_back_x_within_half_an_ulp_of_lo(scale):
    rng = np.random.default_rng(int(np.log10(scale) * 10) + 100)
    x = (rng.standard_normal(20000) * scale).astype(np.float32)
    x[:7] = [0.0, 1.0, -2.5, scale, 1 + 2 ** -9, 1 + 2 ** -8, 1 - 2 ** -20]
    hi, lo = split_bf16(torch.from_numpy(x))
    h = hi.float().double().numpy()
    lo64 = lo.float().double().numpy()
    # hi is the nearest bf16: JAX's round-to-nearest-even of x
    want_hi = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(h, np.asarray(want_hi, np.float64))
    err = np.abs(x.astype(np.float64) - (h + lo64))
    assert np.all(err <= 0.5 * _ulp_bf16(lo64)), err.max()
    # and so within 2^-16 |x|; three pieces within 2^-24 |x|
    assert np.all(err <= 2.0 ** -16 * np.abs(x))
    p = [t.float().double().numpy() for t in
         split_bf16(torch.from_numpy(x), 3)]
    np.testing.assert_array_equal(p[0], h)
    np.testing.assert_array_equal(p[1], lo64)
    err3 = np.abs(x.astype(np.float64) - (p[0] + p[1] + p[2]))
    assert np.all(err3 <= 2.0 ** -24 * np.abs(x))


def _layer_shapes():
    for h in WIDTHS:
        for k in (87, h, h + 87, h + 42):
            yield h, k


@pytest.mark.parametrize("h,k", list(_layer_shapes()))
def test_three_pass_product_within_the_stated_error(h, k):
    """At K1's layer shapes: a [h, K] weight times [K, 64] activations
    (the forward), the 3-pass product against the f64 one within (3 2^-16
    + K 2^-24) sum_k |a||b| elementwise; one bf16 pass is not."""
    rng = np.random.default_rng(h * 1000 + k)
    a = (rng.standard_normal((h, k)) * np.sqrt(2.0 / (h + k))
         ).astype(np.float32)
    b = np.abs(rng.standard_normal((k, 64))).astype(np.float32)
    b[rng.uniform(size=b.shape) < 0.4] = 0.0      # post-ReLU activations
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    bound = (3 * 2.0 ** -16 + k * 2.0 ** -24) * mag
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = mm_bf16_pieces(ta, tb, 2).double().numpy()
    assert np.all(np.abs(got - exact) <= bound), \
        float(np.max(np.abs(got - exact) / np.maximum(mag, 1e-30)))
    one = mm_bf16_pieces(ta, tb, 1).double().numpy()
    assert np.any(np.abs(one - exact) > bound)
    # three pieces, six passes (bwd_bf16's forward): about f32's own error
    six = mm_bf16_pieces(ta, tb, 3).double().numpy()
    bound6 = (4 + k) * 2.0 ** -24 * mag
    assert np.all(np.abs(six - exact) <= bound6)
    assert np.abs(six - exact).max() < 0.25 * np.abs(got - exact).max()


@pytest.mark.parametrize("h", WIDTHS)
def test_stage_weights_layout(h):
    """The staged copy: each product weight as a zero-padded [up16(out),
    up16(in)] block of each of its three bf16 pieces; the first equal to
    JAX's bf16 rounding of the weight, two the weight within 2^-16 of it,
    three within 2^-24."""
    spec = BankSpec.create(h)
    rng = np.random.default_rng(h)
    flat = rng.standard_normal((3, spec.n_params)).astype(np.float32) * 0.2
    ws = K.stage_weights(torch.from_numpy(flat), spec)
    layout, ns = K.staged_layout(h)
    assert ws.shape == (3, 3, ns) and ws.dtype == torch.bfloat16
    assert [name for name, *_ in layout] == list(K.STAGED_NAMES)
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    assert ns == sum(up(o) * up(i) for _, o, i, _ in layout)
    assert ns % 256 == 0      # every block starts 16-byte aligned
    _, mlp_p = spec.unflatten(torch.from_numpy(flat))
    for name, n_out, n_in, off in layout:
        assert (n_out, n_in) == tuple(mlp_p[name].shape[1:])
        block = ws[:, :, off:off + up(n_out) * up(n_in)].reshape(
            3, 3, up(n_out), up(n_in)).float().double().numpy()
        w = mlp_p[name].double().numpy()
        want_hi = jnp.asarray(mlp_p[name].numpy()).astype(jnp.bfloat16)
        np.testing.assert_array_equal(block[:, 0, :n_out, :n_in],
                                      np.asarray(want_hi, np.float64))
        recon = block[:, 0, :n_out, :n_in] + block[:, 1, :n_out, :n_in]
        assert np.all(np.abs(recon - w) <= 2.0 ** -16 * np.abs(w))
        recon = recon + block[:, 2, :n_out, :n_in]
        assert np.all(np.abs(recon - w) <= 2.0 ** -24 * np.abs(w))
        pad = block.copy()
        pad[:, :, :n_out, :n_in] = 0.0
        assert not pad.any(), f"{name}: padding not zero"


@pytest.mark.parametrize("h", WIDTHS)
def test_grad_row_index_places_each_parameter_once(h):
    """A float-policy partial-gradient row: every product weight at its
    staged index (the layout the kernel's 16-byte writes fill), the dirs
    and biases, which lead the parameter layout, packed after them at NS +
    their own index, each place once; the row NS + up16(5 h + 67) floats
    (csrc/train_step.cu grad_row)."""
    spec = BankSpec.create(h)
    layout, ns = K.staged_layout(h)
    idx = K.grad_row_index(spec)
    assert idx.dtype == torch.int32       # train_adamw's index
    n_row = K.grad_row_size(h)
    assert n_row == ns + -(-(5 * h + 67) // 16) * 16 and n_row % 16 == 0
    assert len(set(idx.tolist())) == spec.n_params and int(idx.max()) < n_row
    flat = torch.arange(spec.n_params, dtype=torch.float64)
    row = torch.full((n_row,), -1.0, dtype=torch.float64)
    row[idx] = flat
    _, mlp_p = spec.unflatten(flat)
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    weights = set()
    for name, n_out, n_in, off in layout:
        block = row[off:off + up(n_out) * up(n_in)].view(up(n_out), up(n_in))
        assert torch.equal(block[:n_out, :n_in], mlp_p[name])
        weights.update(range(spec.offset(name),
                             spec.offset(name) + n_out * n_in))
    rest = set(range(spec.n_params)) - weights       # biases, dirs
    assert rest == set(range(5 * h + 67))
    for j in rest:
        assert row[ns + j] == j


def test_staged_sizes_and_slabs():
    """staged_layout's plane sizes, and the slab buffers of the kernel's
    Tile<H> per policy (forward KF columns of h rows, input gradients KB
    rows of up16(h + 87) columns; a plane per piece, rows padded by 8
    bf16)."""
    assert [K.staged_layout(h)[1] for h in WIDTHS] == [12800, 100352, 331776]
    assert K.slab_bytes(32, "float32") == 2 * 2 * 32 * 72
    assert K.slab_bytes(32, "bwd_bf16") == 3 * 2 * 32 * 56
    assert K.slab_bytes(128, "float32") == 2 * 2 * 128 * 40
    assert K.slab_bytes(128, "bwd_bf16") == 3 * 2 * 128 * 24
    assert K.slab_bytes(128, "bfloat16") == 2 * 128 * 40
    assert K.slab_bytes(256, "float32") == 2 * 2 * 256 * 24
    assert K.slab_bytes(256, "bwd_bf16") == 3 * 2 * 256 * 24
    # the input gradients' slabs (16 rows of up16(h + 87) + 8) are the
    # smaller at every width: h=256 float32 23,040 against 24,576
    assert K.slab_bytes(256, "bfloat16") == 2 * 256 * 24
    assert K.slab_bytes(32, "bfloat16") == 2 * 32 * 72
    assert 2 * 2 * 16 * (352 + 8) < K.slab_bytes(256, "float32")
    # two h=32 blocks an SM at the shipped tile (60 points), every policy
    assert all(K.float_smem_bytes(32, 6, 10, pol) <= 115712
               for pol in POLICIES[:3])


def _shipped_banks():
    """(config, hidden, S, rays per iteration, slots) of every bank of every
    shipped configuration whose width has a kernel."""
    from vmap_tpu_torch.config import Config
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "**",
                                              "*.json"), recursive=True)):
        raw = json.load(open(path))
        raw["dataset"]["path"] = ""
        cfg = Config.from_dict(raw)
        name = os.path.relpath(path, os.path.join(REPO, "configs"))
        banks = [(cfg.hidden_feature_size,
                  cfg.n_bins + cfg.n_bins_cam2surface, cfg.n_per_optim,
                  cfg.max_n_models)]
        if cfg.do_bg and not cfg.imap_mode:
            banks.append((cfg.hidden_feature_size_bg,
                          cfg.n_bins + cfg.n_bins_cam2surface_bg,
                          cfg.n_per_optim_bg, 1))
        out += [(name, *b) for b in banks
                if b[0] in kernels.KERNEL_HIDDEN["train_frame"]]
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_shipped_geometry_fits(policy):
    banks = _shipped_banks()
    assert {h for _, h, _, _, _ in banks} == set(WIDTHS)
    for name, h, S, n_per, cap in banks:
        g = K.frame_geometry(h, S, n_per, cap, policy)
        pts = g.rays_per_tile * S
        if policy in POLICIES[:3]:
            assert g.rays_per_tile == kernels.float_tile_rays(h, S)
            assert pts <= kernels.FLOAT_POINTS[h], name
            assert K.float_smem_bytes(h, g.rays_per_tile, S,
                                      policy) <= SMEM_LIMIT
        else:
            assert g.rays_per_tile == kernels.tile_rays(h, S)
            assert pts <= kernels.MAX_POINTS[h], name
            assert K.q8_smem_bytes(h, g.rays_per_tile, S,
                                   policy) <= SMEM_LIMIT
        assert 1 <= g.blocks <= g.n_tiles
        assert g.n_tiles * g.rays_per_tile >= n_per
        assert g.rows == cap * g.blocks
        # what FrameLaunch allocates: the partial rows (the staged layout
        # under every policy), and but under int8 / int8_static each
        # block's activation scratch [3, h, LDP]
        per = K.grad_row_size(h)
        if policy not in ("int8", "int8_static"):
            per += 3 * h * (pts | 1)
        assert g.scratch_bytes == 4 * g.rows * per


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("policy", POLICIES[:3])
def test_float_tile_fits_every_sample_count(h, policy):
    """Every S the kernel takes (1..32) gives a float tile of whole rays
    within FLOAT_POINTS and the shared memory a block may use; the largest
    fills it to within one ray."""
    for S in range(1, 33):
        rt = kernels.float_tile_rays(h, S)
        assert rt * S <= max(kernels.FLOAT_POINTS[h], S)
        assert (rt + 1) * S > kernels.FLOAT_POINTS[h] or rt * S == S
        assert K.float_smem_bytes(h, rt, S, policy) <= SMEM_LIMIT, (h, S)
    # the widest tile: every point but no more
    assert K.float_smem_bytes(h, kernels.FLOAT_POINTS[h], 1,
                              policy) <= SMEM_LIMIT


def test_max_points_stays_the_int8_tile():
    """The int8 tile and scale granularity is unchanged by the float tile,
    and the shipped shapes' float tiles are the rays of before."""
    assert kernels.MAX_POINTS == {32: 64, 128: 56, 256: 38}
    assert set(kernels.FLOAT_POINTS) == set(kernels.MAX_POINTS)
    assert (kernels.tile_rays(32, 10), kernels.tile_rays(128, 14),
            kernels.tile_rays(256, 14)) == (6, 4, 2)
    # the float tile keeps two hidden-activation buffers (h1..h3 go to
    # global scratch), so at h=256 it holds twice the int8 tile's rays
    assert (kernels.float_tile_rays(32, 10), kernels.float_tile_rays(128, 14),
            kernels.float_tile_rays(256, 14)) == (6, 4, 4)
    assert K.frame_geometry(256, 5, 4800, 1, "int8").rays_per_tile == 7
    assert K.frame_geometry(256, 5, 4800, 1, "bwd_bf16").rays_per_tile == 11
    rows = 129 + 4 * 21 + 2 * 256 + 8
    assert K.float_smem_bytes(256, 4, 14) == 2 * 24576 + 4 * (57 * rows + 4)
    # bwd_bf16's three forward pieces leave room for one slab at 56 points
    assert K.float_smem_bytes(256, 4, 14, "bwd_bf16") == \
        36864 + 4 * (57 * rows + 4)


def test_k1_sections_needs_the_card(capsys):
    """The section-timing mode (chip_smoke.py --sections) runs on the card
    only: without CUDA it refuses before it builds or measures anything,
    and prints no result."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    assert not torch.cuda.is_available()
    assert chip_smoke.main(["--sections"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs an NVIDIA GPU" in out.err


@pytest.mark.parametrize("policy,passes", [("float32", 9), ("bwd_bf16", 8),
                                           ("bfloat16", 3), ("int8", 0),
                                           ("int8_static", 0),
                                           ("int8_fwd", 6),
                                           ("int8_static_fwd", 6)])
def test_k1_bound_is_the_route_the_kernel_takes(policy, passes):
    """chip_smoke.py's train_grad bound counts the MLP products as the
    tensor-core passes the kernel runs them in (the forward and the
    backward's two products): under a float policy bf16 passes (float32 3
    + 2 x 3, bwd_bf16 6 + 2 x 1, bfloat16 1 + 2 x 1) at 989 TFLOP/s; under
    int8 / int8_static one s8 pass each (1 + 2 x 1) at 1979 TOP/s; under
    the _fwd halves the forward's s8 pass and the f32 backward's three
    bf16 passes (2 x 3); the PE's projection and its gradient at the FP32
    rate. The FP32-rate figure, the phase-3 log's second, is the
    slower."""
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    name, cap, n_act, h, n_per, S, scale = chip_smoke.SHAPES[0]
    bank = chip_smoke.conditioned_bank(cap, n_act, h, scale, 0,
                                       torch.device("cpu"))
    pts = n_act * n_per * S
    mlp = 87 * h + 2 * h * h + (h + 87) * h + h + (h + 42) * h + 3 * h
    s8 = {"int8": 3, "int8_static": 3, "int8_fwd": 1,
          "int8_static_fwd": 1}.get(policy, 0)
    want = (passes * 2 * mlp * pts / 989e12 + s8 * 2 * mlp * pts / 1979e12
            + 3 * 2 * 63 * pts / 67e12)
    got = chip_smoke.grad_bound(bank, n_per, S, policy)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(want * 1e3, rel=1e-12)
    fp32 = chip_smoke.grad_bound(bank, n_per, S, policy, fp32_rate=True)
    assert fp32["bound_ms"] == pytest.approx(
        3 * 2 * (mlp + 63) * pts / 67e12 * 1e3, rel=1e-12)
    assert fp32["bound_ms"] > got["bound_ms"]
