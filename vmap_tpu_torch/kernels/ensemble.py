"""The field kernels: a bank of occupancy MLPs queried at arbitrary points,
and the gradient of that query (counterpart of
``vmap_tpu/kernels/ensemble.py``).

Per object and point (weights in the prepared layout of ``prepare_params``):

    xs = pts / scale, proj = dirs xs
    emb_a = [xs; sin(pi 2^k proj), k < 4]  (87)   emb_b = bands 4, 5  (42)
    h1 = relu(W_in emb_a + b)        h2 = relu(W_mid1 h1 + b)
    h3 = relu(W_cat_h h2 + W_cat_x emb_a + b)      h4 = relu(W_mid2 h3 + b)
    alpha = 10 (W_alpha h4 + b)      c = relu(W_col_h h4 + W_col_x emb_b + b)
    colour = sigmoid(W_out c + b)

Two versions of each function:
  * ``field_eval_reference`` / ``field_grad_reference``: plain PyTorch
    (``torch.matmul`` and autograd);
  * ``field_eval`` (K2, ``csrc/ensemble.cu`` ``field_fwd_kernel``, hidden
    32 / 128 / 256) and the backward of ``FieldTrain`` (K3,
    ``field_bwd_kernel``, hidden 32 / 128 / 256): on CPU tensors they run the
    plain version, on CUDA tensors they launch the kernel or raise
    (``kernels.KERNEL_HIDDEN``).

``LAUNCHES`` counts successful kernel launches by kernel name, and
``field_bwd``'s also by width (``field_bwd.<hidden>``); only
``_launch_fwd`` / ``_launch_bwd`` change it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from vmap_tpu_torch.kernels import KERNEL_HIDDEN, _build, check_width

LAUNCHES = {"field_fwd": 0, "field_bwd": 0,
            **{f"field_bwd.{h}": 0 for h in KERNEL_HIDDEN["field_bwd"]}}

EMB_PAD = 128                # emb_a (87) and emb_b (42) pad to 128 columns
EMB1, EMB2 = 87, 42
TILE_M = 512                 # default points per backward chunk (JAX TILE_M)
# the prepared tensors, in the order of the kernels' packed row
W_NAMES = ("dirs", "w_in", "b_in", "w_mid1", "b_mid1", "w_cat_h", "w_cat_x",
           "b_cat", "w_mid2", "b_mid2", "w_alpha", "b_alpha", "w_col_h",
           "b_col", "w_out", "b_out", "w_col_x")


def prepared_shapes(hidden: int) -> dict:
    """Per-object shape of each prepared tensor."""
    h = hidden
    return {"dirs": (21, 3), "w_in": (h, EMB_PAD), "b_in": (h, 1),
            "w_mid1": (h, h), "b_mid1": (h, 1), "w_cat_h": (h, h),
            "w_cat_x": (h, EMB_PAD), "b_cat": (h, 1), "w_mid2": (h, h),
            "b_mid2": (h, 1), "w_alpha": (1, h), "b_alpha": (1, 1),
            "w_col_h": (h, h), "b_col": (h, 1), "w_out": (3, h),
            "b_out": (3, 1), "w_col_x": (h, EMB_PAD)}


def prepare_params(pe: dict, mlp: dict, scale, hidden: int) -> dict:
    """Bank params ([O, ...]) or one object's -> kernel operands [O, ...]:
    the 87 / 42 embedding columns padded to 128, the concat layers split,
    biases as [O, h, 1] columns, ``scale`` as [O, 1]. Differentiable: the
    gradient of a prepared tensor flows back to ``pe`` / ``mlp``."""
    stacked = pe["dirs"].dim() == 3

    def lead(a):
        return a if stacked else a[None]

    def padcols(w, used):
        return F.pad(w, (0, EMB_PAD - used))

    h = hidden
    w_cat = lead(mlp["w_cat"])       # [O, h, h+87]
    w_col = lead(mlp["w_col"])       # [O, h, h+42]
    dirs = lead(pe["dirs"])

    def col2(b):
        return lead(b)[..., :, None]

    return {
        "dirs": dirs,
        "scale": torch.as_tensor(scale, dtype=torch.float32,
                                 device=dirs.device).reshape(-1, 1),
        "w_in": padcols(lead(mlp["w_in"]), EMB1), "b_in": col2(mlp["b_in"]),
        "w_mid1": lead(mlp["w_mid1"]), "b_mid1": col2(mlp["b_mid1"]),
        "w_cat_h": w_cat[..., :, :h],
        "w_cat_x": padcols(w_cat[..., :, h:], EMB1),
        "b_cat": col2(mlp["b_cat"]),
        "w_mid2": lead(mlp["w_mid2"]), "b_mid2": col2(mlp["b_mid2"]),
        "w_alpha": lead(mlp["w_alpha"]), "b_alpha": col2(mlp["b_alpha"]),
        "w_col_h": w_col[..., :, :h],
        "w_col_x": padcols(w_col[..., :, h:], EMB2),
        "b_col": col2(mlp["b_col"]),
        "w_out": lead(mlp["w_col_out"]), "b_out": col2(mlp["b_col_out"]),
    }


def field_eval_reference(prepared: dict, pts: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch field query: pts [O, M, 3] -> (alpha [O, M], colour
    [O, M, 3]). The padded columns are sliced off, so they add nothing."""
    p = prepared

    def lin(x, w, b, x2=None, w2=None):
        y = torch.baddbmm(b.transpose(1, 2), x, w.transpose(1, 2))
        if x2 is not None:
            y = y + x2 @ w2.transpose(1, 2)
        return y

    xs = pts / p["scale"][:, :, None]
    proj = xs @ p["dirs"].transpose(1, 2)                      # [O, M, 21]
    sins = [torch.sin(proj * 2.0 ** k * math.pi) for k in range(6)]
    emb_a = torch.cat([xs] + sins[:4], dim=-1)                 # [O, M, 87]
    emb_b = torch.cat(sins[4:], dim=-1)                        # [O, M, 42]
    h1 = torch.relu(lin(emb_a, p["w_in"][..., :EMB1], p["b_in"]))
    h2 = torch.relu(lin(h1, p["w_mid1"], p["b_mid1"]))
    h3 = torch.relu(lin(h2, p["w_cat_h"], p["b_cat"], emb_a,
                        p["w_cat_x"][..., :EMB1]))
    h4 = torch.relu(lin(h3, p["w_mid2"], p["b_mid2"]))
    alpha = lin(h4, p["w_alpha"], p["b_alpha"])[..., 0] * 10.0
    c = torch.relu(lin(h4, p["w_col_h"], p["b_col"], emb_b,
                       p["w_col_x"][..., :EMB2]))
    color = torch.sigmoid(lin(c, p["w_out"], p["b_out"]))
    return alpha, color


def field_grad_reference(prepared: dict, pts: torch.Tensor,
                         g_alpha: torch.Tensor, g_color: torch.Tensor
                         ) -> dict:
    """Plain version of K3: autograd of sum(g_alpha alpha) + sum(g_color
    colour) through ``field_eval_reference`` -> {name: grad} for W_NAMES."""
    leaves = {n: prepared[n].detach().requires_grad_(True) for n in W_NAMES}
    with torch.enable_grad():
        alpha, color = field_eval_reference(
            {**leaves, "scale": prepared["scale"].detach()}, pts.detach())
        grads = torch.autograd.grad((alpha, color), list(leaves.values()),
                                    (g_alpha, g_color))
    return dict(zip(W_NAMES, grads))


# ------------------------------------------------------------ CUDA launch
def _offsets(hidden: int) -> tuple[list, list, int]:
    """(offsets, sizes, n_params) of the packed prepared row."""
    offs, sizes, off = [], [], 0
    for shape in prepared_shapes(hidden).values():
        offs.append(off)
        sizes.append(math.prod(shape))
        off += sizes[-1]
    return offs, sizes, off


def _packed(prepared: dict, hidden: int) -> torch.Tensor:
    """Prepared tensors -> one contiguous f32 [O, n_params] buffer."""
    O = prepared["dirs"].shape[0]
    shapes = prepared_shapes(hidden)
    for n in W_NAMES:
        t = prepared[n]
        if tuple(t.shape) != (O,) + shapes[n]:
            raise ValueError(f"prepared[{n!r}] shape {tuple(t.shape)}, "
                             f"expected {(O,) + shapes[n]}")
    return torch.cat([prepared[n].detach().reshape(O, -1).float()
                      for n in W_NAMES], dim=1).contiguous()


class _Launch:
    """Validated operands common to both kernels; ``kernel`` names the one
    about to launch (its widths are checked)."""

    def __init__(self, prepared: dict, pts: torch.Tensor, kernel: str):
        dev = pts.device
        if dev.type != "cuda":
            raise ValueError(f"field kernels need CUDA tensors, got {dev}")
        h = prepared["w_mid1"].shape[-1]
        check_width(kernel, h)
        O = prepared["dirs"].shape[0]
        if pts.dim() != 3 or pts.shape[0] != O or pts.shape[2] != 3:
            raise ValueError(f"pts shape {tuple(pts.shape)}: expected "
                             f"({O}, M, 3)")
        if not 1 <= O <= 65535 or pts.shape[1] < 1:
            raise ValueError(f"{O} objects x {pts.shape[1]} points: the "
                             "kernels take 1..65535 objects, >= 1 point")
        for n in W_NAMES + ("scale",):
            if prepared[n].device != dev:
                raise ValueError(f"prepared[{n!r}] on {prepared[n].device}, "
                                 f"pts on {dev}")
        self.lib = _build.load()
        self.dev, self.h, self.O, self.M = dev, h, O, pts.shape[1]
        offs, self.sizes, self.n_params = _offsets(h)
        self.offsets = (ctypes.c_int * len(offs))(*offs)
        self.params = _packed(prepared, h)
        self.scale = prepared["scale"].detach().reshape(O).float().contiguous()
        self.pts = pts.detach().float().contiguous()

    def stream(self) -> ctypes.c_void_p:
        return ctypes.c_void_p(torch.cuda.current_stream(self.dev).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch_fwd(prepared: dict, pts: torch.Tensor):
    """K2 on CUDA tensors -> (alpha [O, M], colour [O, M, 3])."""
    L = _Launch(prepared, pts, "field_fwd")
    alpha = torch.empty((L.O, L.M), dtype=torch.float32, device=L.dev)
    color = torch.empty((L.O, L.M, 3), dtype=torch.float32, device=L.dev)
    code = L.lib.vmap_field_fwd(
        L.h, _ptr(L.params), ctypes.cast(L.offsets, ctypes.c_void_p),
        L.n_params, _ptr(L.scale), _ptr(L.pts), L.O, L.M, _ptr(alpha),
        _ptr(color), L.stream())
    _build.check(L.lib, code, "field_fwd kernel launch")
    LAUNCHES["field_fwd"] += 1
    return alpha, color


def _launch_bwd(prepared: dict, pts: torch.Tensor, g_alpha: torch.Tensor,
                g_color: torch.Tensor, tile_m: int) -> dict:
    """K3 on CUDA tensors -> {name: grad} for W_NAMES (chunk partials
    summed here, in a fixed order). ``tile_m`` must be a multiple of the
    kernel's sub-tile (``vmap_field_bwd_subtile``), which the launcher
    checks."""
    L = _Launch(prepared, pts, "field_bwd")
    ga = g_alpha.detach().float().contiguous()
    gc = g_color.detach().float().contiguous()
    if tuple(ga.shape) != (L.O, L.M) or tuple(gc.shape) != (L.O, L.M, 3) \
            or ga.device != L.dev or gc.device != L.dev:
        raise ValueError("cotangents must be [O, M] and [O, M, 3] on "
                         f"{L.dev}")
    n_chunks = -(-L.M // tile_m)
    part = torch.empty((L.O, n_chunks, L.n_params), dtype=torch.float32,
                       device=L.dev)
    code = L.lib.vmap_field_bwd(
        L.h, _ptr(L.params), ctypes.cast(L.offsets, ctypes.c_void_p),
        L.n_params, _ptr(L.scale), _ptr(L.pts), _ptr(ga), _ptr(gc), L.O,
        L.M, tile_m, _ptr(part), L.stream())
    if code:
        sub = L.lib.vmap_field_bwd_subtile(L.h)
        _build.check(L.lib, code, f"field_bwd kernel launch (tile_m "
                     f"{tile_m}; a multiple of {sub} at hidden {L.h})")
    LAUNCHES["field_bwd"] += 1
    LAUNCHES[f"field_bwd.{L.h}"] += 1
    total = part.sum(dim=1)
    shapes = prepared_shapes(L.h)
    return {n: g.reshape((L.O,) + shapes[n])
            for n, g in zip(W_NAMES, torch.split(total, L.sizes, dim=1))}


# ------------------------------------------------------------ public API
def field_eval(prepared: dict, pts: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Field query pts [O, M, 3] -> (alpha [O, M], colour [O, M, 3]).
    CPU tensors: the plain version. CUDA tensors: the K2 kernel."""
    if pts.device.type == "cpu":
        return field_eval_reference(prepared, pts)
    return _launch_fwd(prepared, pts)


def field_grad(prepared: dict, pts: torch.Tensor, g_alpha: torch.Tensor,
               g_color: torch.Tensor, tile_m: int = TILE_M) -> dict:
    """Weight gradients of the field query for cotangents (g_alpha
    [O, M], g_color [O, M, 3]). CPU tensors: the plain version. CUDA
    tensors: the K3 kernel."""
    if pts.device.type == "cpu":
        return field_grad_reference(prepared, pts, g_alpha, g_color)
    return _launch_bwd(prepared, pts, g_alpha, g_color, tile_m)


class FieldTrain(torch.autograd.Function):
    """Differentiable field query (counterpart of JAX ``fused_field_train``):
    forward ``field_eval``, backward ``field_grad``. Gradients flow to every
    prepared weight (the PE projection included); points and scale get zero
    gradients, as in the JAX custom VJP."""

    @staticmethod
    def forward(ctx, pts, scale, tile_m, *weights):
        ctx.tile_m = tile_m
        ctx.save_for_backward(pts, scale, *weights)
        prepared = dict(zip(W_NAMES, weights), scale=scale)
        return field_eval(prepared, pts)

    @staticmethod
    def backward(ctx, g_alpha, g_color):
        pts, scale, *weights = ctx.saved_tensors
        prepared = dict(zip(W_NAMES, weights), scale=scale)
        grads = field_grad(prepared, pts, g_alpha, g_color, ctx.tile_m)
        return (torch.zeros_like(pts), torch.zeros_like(scale), None,
                *[grads[n] for n in W_NAMES])


def field_train(prepared: dict, pts: torch.Tensor, tile_m: int = TILE_M
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha [O, M], colour [O, M, 3]) through ``FieldTrain``. ``tile_m``
    is the backward kernel's points per chunk (one partial gradient row per
    chunk), as the JAX kernel's point tile."""
    return FieldTrain.apply(pts, prepared["scale"], tile_m,
                            *[prepared[n] for n in W_NAMES])
