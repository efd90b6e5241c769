"""The per-object occupancy MLP (counterpart of ``vmap_tpu/ops/mlp.py``).

    trunk:  Linear(emb1 -> h) + ReLU
            Linear(h -> h) + ReLU                      (mid1)
            Linear(h + emb1 -> h) + ReLU               (cat skip of emb trunk)
            Linear(h -> h) + ReLU                      (mid2)
    alpha:  Linear(h -> 1) * 10
    colour: Linear(h + emb2 -> h) + ReLU
            Linear(h -> 3) -> sigmoid

Weights are stored [out, in] (``y = x @ W.T + b``), Xavier-normal; biases
U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Parameters are plain dicts of tensors;
a bank of n slots is the same dict with a leading [n] axis.

Matmul policies (``POLICIES``, named as the config's
``tpu.compute_dtype`` names them; the JAX kernel's ``_mm_policy``;
accumulation is f32 under every policy):
  * ``"float32"``: every product in f32;
  * ``"bwd_bf16"``: the forward in f32; the backward products (dW and dx)
    from operands rounded to bf16: upstream gradients, saved activations,
    weights;
  * ``"bfloat16"``: as ``"bwd_bf16"``, and the forward products' operands
    (weights, embedding, activations) rounded to bf16 too;
  * ``"int8"``, ``"int8_fwd"``, ``"int8_static"``, ``"int8_static_fwd"``:
    s8 operands with scales, ``ops.quant`` (banks only; their scales are
    per ray tile of ``tile_points`` points).
Biases, their gradients, activations' ReLU masks and everything outside
the products stay f32. ``PolicyMatmul`` is the rounded product.
"""

from __future__ import annotations

import torch

from vmap_tpu_torch.ops.quant import INT8_POLICIES, int8_mlp_apply

LAYERS = ("in", "mid1", "cat", "mid2", "alpha", "col", "col_out")
# the ported policies; a float policy's index is its code in the
# train-frame kernel (csrc/train_step.cu Policy), the int8 ones run
# csrc/train_step_q8.cu
POLICIES = ("float32", "bwd_bf16", "bfloat16") + INT8_POLICIES


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bf16 (ties to even, as JAX's ``astype``
    and CUDA's ``__float2bfloat16_rn``), kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor, pieces: int = 2) -> tuple:
    """The f32 ``x`` as ``pieces`` bf16 tensors: p0 = bf16(x), p1 = bf16(x -
    p0), p2 = bf16(x - p0 - p1) (each difference exact in f32), so p0 + p1
    is ``x`` to within 2^-16 |x| and p0 + p1 + p2 to within 2^-24 |x|. The
    operands of the train-frame kernel's tensor-core products
    (``csrc/mma.cuh`` split, ``csrc/train_step.cu``)."""
    out, r = [], x
    for _ in range(pieces):
        p = r.to(torch.bfloat16)
        out.append(p)
        r = r - p.to(torch.float32)
    return tuple(out)


class PolicyMatmul(torch.autograd.Function):
    """``x @ w^T`` over a leading slot axis (x [n, M, k], w [n, o, k] ->
    [n, M, o]). ``fwd_bf16`` rounds both operands of the forward product;
    ``bwd_bf16`` rounds dy, w and the saved x before the backward products
    dx = dy w and dw = dy^T x. Products accumulate in f32."""

    @staticmethod
    def forward(ctx, x, w, fwd_bf16: bool, bwd_bf16: bool):
        ctx.save_for_backward(x, w)
        ctx.bwd_bf16 = bwd_bf16
        if fwd_bf16:
            x, w = bf16_round(x), bf16_round(w)
        return x @ w.transpose(1, 2)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if ctx.bwd_bf16:
            x, w, dy = bf16_round(x), bf16_round(w), bf16_round(dy)
        dx = dy @ w if ctx.needs_input_grad[0] else None
        dw = dy.transpose(1, 2) @ x if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def policy_matmul(x: torch.Tensor, w: torch.Tensor, policy: str,
                  fwd_f32: bool = False) -> torch.Tensor:
    """``x @ w^T`` (x [n, M, k], w [n, o, k]) under ``policy``;
    ``fwd_f32`` keeps the forward in f32 whatever the policy (the PE's
    dirs projection). Under an int8 policy only the dirs projection comes
    here, and it stays f32 both ways, as in the JAX kernel."""
    if policy not in POLICIES:
        raise ValueError(f"matmul policy {policy!r} not in {POLICIES}")
    if policy in INT8_POLICIES:
        if not fwd_f32:
            raise ValueError("int8 MLP products go through "
                             "ops.quant.int8_mlp_apply")
        return PolicyMatmul.apply(x, w, False, False)
    return PolicyMatmul.apply(x, w, policy == "bfloat16" and not fwd_f32,
                              policy != "float32")


def layer_fans(hidden: int, emb1: int = 87, emb2: int = 42) -> list:
    """(fan_in, fan_out) of each layer of LAYERS."""
    return [(emb1, hidden), (hidden, hidden), (hidden + emb1, hidden),
            (hidden, hidden), (hidden, 1), (hidden + emb2, hidden),
            (hidden, 3)]


def init_mlp_params(gen: torch.Generator, hidden: int, emb1: int = 87,
                    emb2: int = 42, device: torch.device | str = "cpu"
                    ) -> dict:
    """Fresh parameters drawn from ``gen`` (a CPU generator), placed on
    ``device``."""
    p = {}
    for name, (fi, fo) in zip(LAYERS, layer_fans(hidden, emb1, emb2)):
        std = (2.0 / (fi + fo)) ** 0.5
        w = torch.randn((fo, fi), generator=gen, dtype=torch.float32) * std
        bound = 1.0 / (fi ** 0.5)
        b = (torch.rand((fo,), generator=gen, dtype=torch.float32)
             * (2 * bound) - bound)
        p[f"w_{name}"] = w.to(device)
        p[f"b_{name}"] = b.to(device)
    return p


def _linear(p: dict, name: str, x: torch.Tensor,
            policy: str = "float32") -> torch.Tensor:
    w, b = p[f"w_{name}"], p[f"b_{name}"]
    if w.dim() == 2:
        if policy != "float32":
            raise ValueError("matmul policies take a bank's parameters")
        return x @ w.T + b
    # batched over a leading slot axis: w [n, out, in], x [n, ..., in]
    n = x.shape[0]
    x3 = x.reshape(n, -1, x.shape[-1])
    y = (x3 @ w.transpose(1, 2) if policy == "float32"
         else policy_matmul(x3, w, policy)) + b[:, None, :]
    return y.reshape(*x.shape[:-1], w.shape[1])


def mlp_apply(params: dict, emb: torch.Tensor, emb1: int = 87,
              policy: str = "float32", tile_points: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``emb`` [..., emb1+emb2] -> (alpha [..., 1], color [..., 3]), the
    products under the matmul ``policy``; an int8 policy takes a bank's
    parameters and the points of its scale tile (``tile_points``, see
    ``ops.quant``)."""
    if policy in INT8_POLICIES:
        if tile_points is None or params["w_in"].dim() != 3:
            raise ValueError("int8 policies take a bank's parameters and "
                             "tile_points")
        return int8_mlp_apply(params, emb, policy, tile_points)
    x1 = emb[..., :emb1]
    x2 = emb[..., emb1:]
    p = params
    h = torch.relu(_linear(p, "in", x1, policy))
    h = torch.relu(_linear(p, "mid1", h, policy))
    h = torch.relu(_linear(p, "cat", torch.cat([h, x1], dim=-1), policy))
    h4 = torch.relu(_linear(p, "mid2", h, policy))
    alpha = _linear(p, "alpha", h4, policy) * 10.0
    c = torch.relu(_linear(p, "col", torch.cat([h4, x2], dim=-1), policy))
    color = torch.sigmoid(_linear(p, "col_out", c, policy))
    return alpha, color
