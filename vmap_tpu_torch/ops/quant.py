"""The int8 matmul policies as plain PyTorch (counterpart of the int8 paths
of the JAX train-frame kernel, ``vmap_tpu/kernels/train_step.py``:
``quant_dyn`` / ``quant_static`` / ``quant_weights`` and the forward at
``fwd_mlp``, the backward ``bwd_chunk_q8``).

Policies (``INT8_POLICIES``, the config's ``tpu.compute_dtype`` names):
  * ``int8``: every MLP product runs on s8 operands with an exact s32 sum,
    forward and backward. Each operand is a tensor of integers ``q`` in
    [-127, 127] with a scale ``s`` (it stands for ``q * s``), so a product
    is ``(sum q_a q_b) * (s_a * s_b)``;
  * ``int8_fwd``: the forward as ``int8``; the backward in f32 on the f32
    weights and the f32 ReLU outputs of the quantised forward;
  * ``int8_static`` / ``int8_static_fwd``: as the two above, with fixed
    activation and gradient scales in place of the abs-max (``static_scales``:
    the environment's ``VMAP_Q8_SACT`` / ``VMAP_Q8_SHEAD`` /
    ``VMAP_Q8_SGRAD``, as the JAX kernel reads them, else ``Q8_SCALES``,
    JAX's defaults: activations 8.0, head gradients 0.125, hidden gradients
    0.02); values past them saturate. ``python -m
    vmap_tpu_torch.calibrate_int8_scales`` suggests values from a run.
Dynamic scales: ``s = max|x| / 127 + 1e-30``, ``q = round(x * (1 / s))``
(round half to even, as ``jnp.round`` and CUDA's ``rintf``). Static:
``q = round(clip(x * (127 / m), -127, 127))``, ``s = m / 127``. The
embedding takes static row scales: x127 for the sin rows, x127 / XS_RANGE
for the three ``xs`` rows (saturating); the weights that read it absorb
them (``w_in`` and the embedding columns of ``w_cat`` divided by the row
scale, those of ``w_col`` by 127) before they are quantised. The gradient
of each linear's output is quantised once (head gradients with the head
scale, the others with the hidden one) and read by both the weight- and
the input-gradient product. Bias gradients, the ReLU masks (taken from
the quantised activations, as JAX's ``pos(hq)``), the PE, the ``dirs``
projection and its gradient stay f32.

Scale granularity, a decision of the port and not a translation. The JAX
kernel's scales cover a tile of its TPU layout: one per G-object
block-diagonal group (G = 128 / h) and tensor for the weights, once per
iteration; one per (subgroup of G objects x chunk of 128 rays x S
samples) for the activations; one per merged row block of ns * G objects
for the head gradients. The port has no such tile. Its train-frame
kernel's block owns ``tile_rays(h, S)`` whole rays of one slot
(``kernels.MAX_POINTS``: 6 rays x 10 samples at the object shape, 4 x 14
at the background, 2 x 14 at h=256), and the scales follow that tile:
  * weights: one scale per (slot, tensor, iteration);
  * activations and gradients: one per (slot, ray tile, tensor), a
    reduction inside one block;
  * the static policies fix the activation and gradient scales, so for
    them only the weights' granularity differs from JAX (per slot against
    per group).
The scales are finer than JAX's, so the quantisation error is smaller.
The tile's ray count is part of the policy's numerics: the plain version
takes it as ``tile_points`` (rays per tile x S), which the frame reads
from the same constant as the kernel. The two granularities coincide for
one slot (G = 1) whose rays fill exactly one JAX chunk of 128 rays (JAX's
pad rays would carry bias-only activations into its abs-max) and one
port tile; ``tests/test_torch_quant.py`` holds the port to JAX there.

Products of s8 operands are exact in f32 while the sum stays below 2^24:
a forward contraction over at most h + 87 = 343 inputs reaches
343 * 127^2 = 5.5 M, an input gradient over at most 256 rows 4.1 M, a
weight gradient over one tile's points ``tile_points * 127^2`` (64 points
in the kernel: 1.0 M); so they equal the TPU's s32 sums, and the scale
multiplies in the same order as there (``acc * (s_a * s_b)``).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

INT8_POLICIES = ("int8", "int8_fwd", "int8_static", "int8_static_fwd")
# static (activation, head gradient, hidden gradient) maxima: JAX's
# VMAP_Q8_SACT / SHEAD / SGRAD defaults
Q8_SCALES = (8.0, 0.125, 0.02)
Q8_SCALE_VARS = ("VMAP_Q8_SACT", "VMAP_Q8_SHEAD", "VMAP_Q8_SGRAD")
# the band-0 xs pass-through rows of the embedding quantise x127 / XS_RANGE
XS_RANGE = 4.0
# the nine quantised weight tensors of a slot, in the order of the
# kernel's per-slot weight scales (csrc/train_step_q8.cu QW_*): the
# embedding-facing column blocks of w_cat and w_col are tensors of their own
QW_NAMES = ("w_in", "w_mid1", "w_cat_h", "w_cat_x", "w_mid2", "w_alpha",
            "w_col_h", "w_col_x", "w_out")


def q8_backward(policy: str) -> bool:
    """True where the backward products are quantised too."""
    return policy in ("int8", "int8_static")


def q8_static(policy: str) -> bool:
    return policy in ("int8_static", "int8_static_fwd")


def static_scales() -> tuple[float, float, float]:
    """The static policies' (activation, head gradient, hidden gradient)
    maxima: ``VMAP_Q8_SACT`` / ``VMAP_Q8_SHEAD`` / ``VMAP_Q8_SGRAD`` where
    set, else ``Q8_SCALES`` (read where a frame builds its scales, as the
    JAX kernel reads them where it is built)."""
    return tuple(float(os.environ.get(k, str(d)))
                 for k, d in zip(Q8_SCALE_VARS, Q8_SCALES))


def emb_row_scales(emb1: int, device=None) -> torch.Tensor:
    """[emb1] static row scales of the trunk's embedding: 127 / XS_RANGE
    for the three xs rows, 127 for the sin rows."""
    m = torch.full((emb1,), 127.0, dtype=torch.float32, device=device)
    m[:3] = 127.0 / XS_RANGE
    return m


def quant_emb(e: torch.Tensor, m) -> torch.Tensor:
    """Embedding rows at their static scales ``m``, saturating."""
    return torch.round(torch.clamp(e * m, -127.0, 127.0))


def quant_weights(w: dict, hidden: int) -> dict:
    """A bank's MLP weights (``ops.mlp`` names, [n, out, in]) -> {QW_NAMES
    entry: (q [n, out, in] integer-valued f32, scale [n, 1, 1])}: one
    dynamic scale per slot and tensor, the embedding row scales folded in
    first."""
    h = hidden
    inv1 = 1.0 / emb_row_scales(w["w_in"].shape[-1], w["w_in"].device)
    folded = {"w_in": w["w_in"] * inv1, "w_mid1": w["w_mid1"],
              "w_cat_h": w["w_cat"][..., :h],
              "w_cat_x": w["w_cat"][..., h:] * inv1,
              "w_mid2": w["w_mid2"], "w_alpha": w["w_alpha"],
              "w_col_h": w["w_col"][..., :h],
              "w_col_x": w["w_col"][..., h:] * (1.0 / 127.0),
              "w_out": w["w_col_out"]}
    out = {}
    for name in QW_NAMES:
        x = folded[name]
        s = x.abs().amax(dim=(1, 2), keepdim=True) * (1.0 / 127.0) + 1e-30
        out[name] = (torch.round(x * (1.0 / s)), s)
    return out


def _n_tiles(m: int, pts: int) -> int:
    return -(-m // pts)


def _expand(s: torch.Tensor, pts: int, m: int) -> torch.Tensor:
    """Per-tile values [n, n_tiles] -> per point [n, m, 1]."""
    return s.repeat_interleave(pts, dim=1)[:, :m, None]


def _by_tile(x: torch.Tensor, pts: int) -> torch.Tensor:
    """[n, m, c] -> [n, n_tiles, pts, c], the last tile padded with 0."""
    n, m, c = x.shape
    nt = _n_tiles(m, pts)
    return F.pad(x, (0, 0, 0, nt * pts - m)).reshape(n, nt, pts, c)


class Quantiser:
    """Activation / gradient quantisation of one policy at a granularity
    of ``pts`` consecutive points (one ray tile) per slot."""

    def __init__(self, policy: str, pts: int):
        self.static = q8_static(policy)
        self.pts = pts
        self.s_act, self.s_head, self.s_grad = static_scales()

    def __call__(self, x: torch.Tensor, m: float):
        """x [n, M, c] -> (q, per-tile scale [n, n_tiles]); ``m`` is the
        static maximum (unused under a dynamic policy)."""
        n, M = x.shape[:2]
        nt = _n_tiles(M, self.pts)
        if self.static:
            s = torch.full((n, nt), m * (1.0 / 127.0), dtype=x.dtype,
                           device=x.device)
            return torch.round(torch.clamp(x * (127.0 / m), -127.0,
                                           127.0)), s
        amax = _by_tile(x.abs().amax(-1, keepdim=True), self.pts).amax((2, 3))
        s = amax * (1.0 / 127.0) + 1e-30
        return torch.round(x * _expand(1.0 / s, self.pts, M)), s


def _mm(xq, wq, s, pts):
    """Forward product ``(xq @ wq^T) * s``: xq [n, M, k], wq [n, o, k]; s
    [n, 1, 1] (a weight scale) or [n, n_tiles] (per tile)."""
    acc = xq @ wq.transpose(1, 2)
    return acc * (s if s.dim() == 3 else _expand(s, pts, xq.shape[1]))


def _mt(dyq, wq, s, pts):
    """Input-gradient product ``(dyq @ wq) * s`` (s per tile)."""
    return (dyq @ wq) * _expand(s, pts, dyq.shape[1])


def _wg(dyq, xq, s, pts):
    """Weight-gradient product: per tile ``(dyq^T xq) * s`` (exact integer
    sums, s [n, n_tiles]), summed over the tiles -> [n, o, k]."""
    acc = torch.einsum("ntpo,ntpk->ntok", _by_tile(dyq, pts),
                       _by_tile(xq, pts))
    return (acc * s[:, :, None, None]).sum(1)


def _pos(x: torch.Tensor) -> torch.Tensor:
    return (x > 0).to(x.dtype)


class Int8MLP(torch.autograd.Function):
    """The occupancy MLP of a bank (``ops.mlp``'s layers) under an int8
    policy, with the hand-written backward of ``bwd_chunk_q8`` (``int8``,
    ``int8_static``) or the f32 backward of the quantised forward
    (``int8_fwd``, ``int8_static_fwd``). One function for the whole MLP,
    not one per linear: each ReLU's mask comes from its quantised output,
    and each output gradient is quantised once for all the products that
    read it, two things a linear's boundary would cut.

    forward(emb [n, M, E], the 14 weights and biases in ``ops.mlp.LAYERS``
    order, policy, pts) -> (alpha [n, M, 1] (x10), colour logits
    [n, M, 3])."""

    @staticmethod
    def forward(ctx, emb, w_in, b_in, w_mid1, b_mid1, w_cat, b_cat, w_mid2,
                b_mid2, w_alpha, b_alpha, w_col, b_col, w_col_out, b_col_out,
                policy, pts):
        h, emb1 = w_in.shape[1], w_in.shape[2]
        quant = Quantiser(policy, pts)
        qw = quant_weights({"w_in": w_in, "w_mid1": w_mid1, "w_cat": w_cat,
                            "w_mid2": w_mid2, "w_alpha": w_alpha,
                            "w_col": w_col, "w_col_out": w_col_out}, h)
        W = {k: q for k, (q, _) in qw.items()}
        sw = {k: s for k, (_, s) in qw.items()}
        ma1 = emb_row_scales(emb1, emb.device)
        e1, e2 = emb[..., :emb1], emb[..., emb1:]
        eq1, eq2 = quant_emb(e1, ma1), quant_emb(e2, 127.0)

        def mm(xq, name, s_x=None):
            s = sw[name] if s_x is None else sw[name][:, :, 0] * s_x
            return _mm(xq, W[name], s, pts)

        def relu_q(y):
            r = torch.relu(y)
            q, s = quant(r, quant.s_act)
            return q, s, r

        h1q, s1, h1f = relu_q(mm(eq1, "w_in") + b_in[:, None])
        h2q, s2, h2f = relu_q(mm(h1q, "w_mid1", s1) + b_mid1[:, None])
        h3q, s3, h3f = relu_q(mm(h2q, "w_cat_h", s2) + mm(eq1, "w_cat_x")
                              + b_cat[:, None])
        h4q, s4, h4f = relu_q(mm(h3q, "w_mid2", s3) + b_mid2[:, None])
        alpha = (mm(h4q, "w_alpha", s4) + b_alpha[:, None]) * 10.0
        cq, sc, cf = relu_q(mm(h4q, "w_col_h", s4) + mm(eq2, "w_col_x")
                            + b_col[:, None])
        logits = mm(cq, "w_out", sc) + b_col_out[:, None]
        ctx.policy, ctx.pts, ctx.quant, ctx.h = policy, pts, quant, h
        if q8_backward(policy):
            ctx.save_for_backward(eq1, eq2, h1q, h2q, h3q, h4q, cq,
                                  *W.values())
            ctx.scales = (s1, s2, s3, s4, sc, sw, ma1)
        else:
            ctx.save_for_backward(e1, e2, h1f, h2f, h3f, h4f, cf, w_in,
                                  w_mid1, w_cat, w_mid2, w_alpha, w_col,
                                  w_col_out)
        return alpha, logits

    @staticmethod
    def backward(ctx, d_alpha, d_logits):
        dal = d_alpha * 10.0            # d(loss) / d(alpha layer output)
        dl = d_logits
        if q8_backward(ctx.policy):
            g = _backward_q8(ctx, dal, dl)
        else:
            g = _backward_f32(ctx, dal, dl)
        return (g["emb"], g["w_in"], g["b_in"], g["w_mid1"], g["b_mid1"],
                g["w_cat"], g["b_cat"], g["w_mid2"], g["b_mid2"],
                g["w_alpha"], g["b_alpha"], g["w_col"], g["b_col"],
                g["w_col_out"], g["b_col_out"], None, None)


def _wT(dy, x):
    """f32 weight gradient dy^T x over the points: [n, o, k]."""
    return dy.transpose(1, 2) @ x


def _backward_f32(ctx, dal, dl) -> dict:
    """``int8_fwd``: the f32 backward on the f32 weights, the f32 ReLU
    outputs and the f32 embedding (JAX's ``bwd_chunk`` at bdt = f32)."""
    (e1, e2, h1, h2, h3, h4, c, w_in, w_mid1, w_cat, w_mid2, w_alpha,
     w_col, w_col_out) = ctx.saved_tensors
    h = ctx.h
    g = {"w_col_out": _wT(dl, c), "b_col_out": dl.sum(1)}
    dc = (dl @ w_col_out) * _pos(c)
    g["w_col"] = torch.cat([_wT(dc, h4), _wT(dc, e2)], dim=-1)
    g["b_col"] = dc.sum(1)
    g["w_alpha"], g["b_alpha"] = _wT(dal, h4), dal.sum(1)
    dh4 = (dc @ w_col[..., :h] + dal @ w_alpha) * _pos(h4)
    g["w_mid2"], g["b_mid2"] = _wT(dh4, h3), dh4.sum(1)
    dh3 = (dh4 @ w_mid2) * _pos(h3)
    g["w_cat"] = torch.cat([_wT(dh3, h2), _wT(dh3, e1)], dim=-1)
    g["b_cat"] = dh3.sum(1)
    dh2 = (dh3 @ w_cat[..., :h]) * _pos(h2)
    g["w_mid1"], g["b_mid1"] = _wT(dh2, h1), dh2.sum(1)
    dh1 = (dh2 @ w_mid1) * _pos(h1)
    g["w_in"], g["b_in"] = _wT(dh1, e1), dh1.sum(1)
    demb1 = dh1 @ w_in + dh3 @ w_cat[..., h:]
    g["emb"] = torch.cat([demb1, dc @ w_col[..., h:]], dim=-1)
    return g


def _backward_q8(ctx, dal, dl) -> dict:
    """``int8``: ``bwd_chunk_q8``. Each output gradient is quantised once
    (head: dalpha, dlogits; hidden: the rest) after its f32 bias gradient
    is taken, and read by both products; the embedding's row scales
    re-emerge on the w_in / w_cat_x / w_col_x gradients and on demb."""
    (eq1, eq2, h1q, h2q, h3q, h4q, cq, *wq) = ctx.saved_tensors
    W = dict(zip(QW_NAMES, wq))
    s1, s2, s3, s4, sc, sw, ma1 = ctx.scales
    pts, quant = ctx.pts, ctx.quant
    inv1 = 1.0 / ma1
    sw = {k: v[:, :, 0] for k, v in sw.items()}         # [n, 1]

    g = {"b_col_out": dl.sum(1), "b_alpha": dal.sum(1)}
    daq, sda = quant(dal, quant.s_head)
    dlq, sdl = quant(dl, quant.s_head)
    g["w_col_out"] = _wg(dlq, cq, sdl * sc, pts)
    dc = _mt(dlq, W["w_out"], sw["w_out"] * sdl, pts) * _pos(cq)
    g["b_col"] = dc.sum(1)
    dcq, sdc = quant(dc, quant.s_grad)
    g["w_col"] = torch.cat([_wg(dcq, h4q, sdc * s4, pts),
                            _wg(dcq, eq2, sdc * (1.0 / 127.0), pts)], dim=-1)
    g["w_alpha"] = _wg(daq, h4q, sda * s4, pts)
    dh4 = (_mt(dcq, W["w_col_h"], sw["w_col_h"] * sdc, pts)
           + _mt(daq, W["w_alpha"], sw["w_alpha"] * sda, pts)) * _pos(h4q)
    g["b_mid2"] = dh4.sum(1)
    dh4q, sdh4 = quant(dh4, quant.s_grad)
    g["w_mid2"] = _wg(dh4q, h3q, sdh4 * s3, pts)
    dh3 = _mt(dh4q, W["w_mid2"], sw["w_mid2"] * sdh4, pts) * _pos(h3q)
    g["b_cat"] = dh3.sum(1)
    dh3q, sdh3 = quant(dh3, quant.s_grad)
    g["w_cat"] = torch.cat([_wg(dh3q, h2q, sdh3 * s2, pts),
                            _wg(dh3q, eq1, sdh3, pts) * inv1], dim=-1)
    dh2 = _mt(dh3q, W["w_cat_h"], sw["w_cat_h"] * sdh3, pts) * _pos(h2q)
    g["b_mid1"] = dh2.sum(1)
    dh2q, sdh2 = quant(dh2, quant.s_grad)
    g["w_mid1"] = _wg(dh2q, h1q, sdh2 * s1, pts)
    dh1 = _mt(dh2q, W["w_mid1"], sw["w_mid1"] * sdh2, pts) * _pos(h1q)
    g["b_in"] = dh1.sum(1)
    dh1q, sdh1 = quant(dh1, quant.s_grad)
    g["w_in"] = _wg(dh1q, eq1, sdh1, pts) * inv1
    demb1 = (_mt(dh1q, W["w_in"], sw["w_in"] * sdh1, pts)
             + _mt(dh3q, W["w_cat_x"], sw["w_cat_x"] * sdh3, pts)) * ma1
    demb2 = _mt(dcq, W["w_col_x"], sw["w_col_x"] * sdc, pts) * 127.0
    g["emb"] = torch.cat([demb1, demb2], dim=-1)
    return g


def int8_mlp_apply(params: dict, emb: torch.Tensor, policy: str,
                   tile_points: int):
    """A bank's MLP (``params`` [n, ...], ``emb`` [n, ..., E]) under the
    int8 ``policy``, scales per ``tile_points`` consecutive points of a
    slot -> (alpha [n, ..., 1], colour [n, ..., 3])."""
    if policy not in INT8_POLICIES:
        raise ValueError(f"{policy!r} is not an int8 policy "
                         f"{INT8_POLICIES}")
    n, lead = emb.shape[0], emb.shape[:-1]
    p = params
    alpha, logits = Int8MLP.apply(
        emb.reshape(n, -1, emb.shape[-1]),
        *[p[f"{k}_{name}"] for name in ("in", "mid1", "cat", "mid2", "alpha",
                                        "col", "col_out") for k in "wb"],
        policy, int(tile_points))
    return (alpha.reshape(*lead, 1),
            torch.sigmoid(logits).reshape(*lead, 3))
