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
    ``field_bwd_kernel`` then ``field_wgrad_kernel``, hidden 32 / 128 /
    256): on CPU tensors they run the plain version, on CUDA tensors they
    launch the kernel or raise (``kernels.KERNEL_HIDDEN``).
The kernels' products run on bf16 tensor cores, float32 as three passes of
two-piece operands (K3's recomputed forward six passes of three), from the
weights' staged bf16 pieces (``stage``, ``field_stage_kernel``, reused
while the weights do not change); their tiles and grids are the
library's (``csrc/field_plan.cuh``, ``field_plan``).

``LAUNCHES`` counts successful kernel launches by kernel name, and
``field_bwd``'s also by width (``field_bwd.<hidden>``); only ``stage``,
``_launch_fwd`` and ``_launch_bwd`` change it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from vmap_tpu_torch.kernels import KERNEL_HIDDEN, _build, check_width

LAUNCHES = {"field_stage": 0, "field_fwd": 0, "field_bwd": 0,
            **{f"field_bwd.{h}": 0 for h in KERNEL_HIDDEN["field_bwd"]}}

EMB_PAD = 128                # emb_a (87) and emb_b (42) pad to 128 columns
EMB1, EMB2 = 87, 42
TILE_M = 512                 # default points per backward chunk (JAX TILE_M)
STAGED_PIECES = 3            # the weights' bf16 pieces (field_stage_kernel)
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
# The field kernels' tiles, grids and buffer sizes are the library's
# (csrc/field_plan.cuh): vmap_field_plan states them for a launch, in this
# order (PlanField), and the launchers size their grids by the same rule
PLAN = ("fwd_points", "fwd_threads", "fwd_smem_bytes", "fwd_blocks_per_sm",
        "fwd_blocks", "bwd_points", "bwd_threads", "bwd_smem_bytes",
        "bwd_blocks_per_sm", "blocks_per_object", "Mp", "wgrad_tiles",
        "wgrad_threads", "wgrad_smem_bytes", "wgrad_blocks_per_sm", "unit",
        "splits", "scratch_pieces", "scratch_rows", "rest_floats")


def field_plan(hidden: int, O: int, M: int, tile_m: int = TILE_M) -> dict:
    """The plan of the field kernels' launches on O objects x M points on
    the current CUDA device (PLAN's keys; ``tile_m`` sets only K3's weight
    gradient units), with each grid's blocks: ``bwd_blocks`` and
    ``wgrad_blocks``."""
    lib = _build.load()
    out = (ctypes.c_int * len(PLAN))()
    _build.check(lib, lib.vmap_field_plan(hidden, O, M, tile_m, out),
                 f"field plan (hidden {hidden}, {O} x {M} points, tile_m "
                 f"{tile_m})")
    return plan_dict(out, O)


def plan_dict(values, O: int) -> dict:
    """vmap_field_plan's values (PLAN order) for O objects -> the plan."""
    plan = dict(zip(PLAN, values))
    plan["bwd_blocks"] = plan["blocks_per_object"] * O
    plan["wgrad_blocks"] = plan["wgrad_tiles"] * plan["splits"] * O
    return plan


def _staged_layout(hidden: int) -> tuple[list, int]:
    """The staged layout of the product weights, K1's
    (``train_step.staged_layout``: [(name, n_out, n_in, offset)], elements
    a piece), which the field kernels share."""
    from vmap_tpu_torch.kernels.train_step import staged_layout
    return staged_layout(hidden)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def staged_pieces_reference(prepared: dict, hidden: int) -> torch.Tensor:
    """The plain version of ``field_stage_kernel``: the prepared weights'
    seven product matrices (the concat layers whole, without the padded
    columns) in the staged layout, as [O, 3, staged_size] bf16 pieces p0 =
    bf16(w), p1 = bf16(w - p0), p2 = bf16(w - p0 - p1), the padding 0."""
    p = {n: prepared[n].detach().float() for n in W_NAMES}
    mats = {"w_in": p["w_in"][..., :EMB1], "w_mid1": p["w_mid1"],
            "w_cat": torch.cat([p["w_cat_h"], p["w_cat_x"][..., :EMB1]], -1),
            "w_mid2": p["w_mid2"], "w_alpha": p["w_alpha"],
            "w_col": torch.cat([p["w_col_h"], p["w_col_x"][..., :EMB2]], -1),
            "w_col_out": p["w_out"]}
    layout, size = _staged_layout(hidden)
    O = p["dirs"].shape[0]
    out = torch.zeros((O, STAGED_PIECES, size), dtype=torch.bfloat16,
                      device=p["dirs"].device)
    for name, n_out, n_in, off in layout:
        r, c = _up(n_out, 16), _up(n_in, 16)
        w = mats[name]
        for pc in range(STAGED_PIECES):
            t = w.bfloat16()
            out[:, pc, off:off + r * c].view(O, r, c)[:, :n_out, :n_in] = t
            w = w - t.float()
    return out


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


# The packed rows and bf16 pieces of the last weights staged: meshing
# queries one bank's prepared weights some 256 times a grid, and
# FieldTrain's backward the forward's. The key holds the prepared tensors
# themselves and their version counters: a change through torch (in place,
# or a new tensor) misses. A write torch does not see would not: K1's
# train_adamw writes the bank through a raw pointer, and dirs, w_mid1,
# w_cat_h, w_mid2, w_alpha, w_col_h, w_out and every bias of a stacked
# bank's prepare_params are views of the bank's own tensors. What rules a
# stale hit out is that prepare_params pads w_in, w_cat_x and w_col_x into
# new tensors at every call (tests/test_torch_field_design.py holds that
# two calls on one bank never share a key): the key must keep one of them.
_STAGED: dict = {}


def _weights_key(prepared: dict, hidden: int):
    try:
        return (hidden,) + tuple((prepared[n], prepared[n]._version)
                                 for n in W_NAMES)
    except RuntimeError:   # inference tensors carry no version counter
        return None


def _same(a, b) -> bool:
    return (a is not None and b is not None and a[0] == b[0]
            and all(x is y and vx == vy
                    for (x, vx), (y, vy) in zip(a[1:], b[1:])))


def stage(prepared: dict, hidden: int, lib, offsets) -> tuple:
    """(packed f32 rows [O, n_params], bf16 pieces [O, 3, staged_size]) of
    the prepared weights on their CUDA device: ``field_stage_kernel``
    splits the pieces. Reused while the weights do not change."""
    key = _weights_key(prepared, hidden)
    if _same(key, _STAGED.get("key")):
        return _STAGED["value"]
    params = _packed(prepared, hidden)
    O = params.shape[0]
    ws = torch.empty((O, STAGED_PIECES, _staged_layout(hidden)[1]),
                     dtype=torch.bfloat16, device=params.device)
    code = lib.vmap_field_stage(
        hidden, _ptr(params), ctypes.cast(offsets, ctypes.c_void_p),
        params.shape[1], O, _ptr(ws),
        ctypes.c_void_p(torch.cuda.current_stream(params.device).cuda_stream))
    _build.check(lib, code, "field_stage kernel launch")
    LAUNCHES["field_stage"] += 1
    _STAGED.clear()
    if key is not None:
        _STAGED.update(key=key, value=(params, ws))
    return params, ws


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
        self.params, self.ws = stage(prepared, h, self.lib, self.offsets)
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
        L.n_params, _ptr(L.ws), _ptr(L.scale), _ptr(L.pts), L.O, L.M,
        _ptr(alpha), _ptr(color), L.stream())
    _build.check(L.lib, code, "field_fwd kernel launch")
    LAUNCHES["field_fwd"] += 1
    return alpha, color


def rest_layout(hidden: int) -> list:
    """[(name, floats)] of K3's rest row (csrc/field_plan.cuh r_*): the
    prepared tensors that are not product weights, in W_NAMES order."""
    shapes = prepared_shapes(hidden)
    return [(n, math.prod(shapes[n])) for n in W_NAMES
            if not n.startswith("w_")]


def unstage_grads(wgrad: torch.Tensor, rest: torch.Tensor,
                  hidden: int) -> dict:
    """K3's summed gradients -> {name: grad} in the prepared shapes:
    ``wgrad`` [O, staged_size] (the staged layout), ``rest`` [O, rest
    floats] (rest_layout, then padding); the padded columns' gradients 0."""
    h, O = hidden, wgrad.shape[0]
    blocks = {}
    for name, n_out, n_in, off in _staged_layout(h)[0]:
        r, c = _up(n_out, 16), _up(n_in, 16)
        blocks[name] = wgrad[:, off:off + r * c].view(O, r, c)

    def padded(g, used):
        return F.pad(g, (0, EMB_PAD - used))

    out = {"w_in": padded(blocks["w_in"][:, :h, :EMB1], EMB1),
           "w_mid1": blocks["w_mid1"][:, :h, :h],
           "w_cat_h": blocks["w_cat"][:, :h, :h],
           "w_cat_x": padded(blocks["w_cat"][:, :h, h:h + EMB1], EMB1),
           "w_mid2": blocks["w_mid2"][:, :h, :h],
           "w_alpha": blocks["w_alpha"][:, :1, :h],
           "w_col_h": blocks["w_col"][:, :h, :h],
           "w_col_x": padded(blocks["w_col"][:, :h, h:h + EMB2], EMB2),
           "w_out": blocks["w_col_out"][:, :3, :h]}
    shapes = prepared_shapes(h)
    off = 0
    for name, n in rest_layout(h):
        out[name] = rest[:, off:off + n].reshape((O,) + shapes[name])
        off += n
    return {n: out[n].contiguous() for n in W_NAMES}


class _BwdLaunch:
    """K3's operands on CUDA tensors: the validated launch, the cotangents,
    the plan and the buffers (the scratch, the blocks' rest rows, the
    splits' partial rows); ``bwd()`` and ``wgrad()`` launch its two
    kernels (chip_smoke.py times each alone)."""

    def __init__(self, prepared: dict, pts: torch.Tensor,
                 g_alpha: torch.Tensor, g_color: torch.Tensor, tile_m: int):
        self.L = L = _Launch(prepared, pts, "field_bwd")
        self.ga = g_alpha.detach().float().contiguous()
        self.gc = g_color.detach().float().contiguous()
        if tuple(self.ga.shape) != (L.O, L.M) \
                or tuple(self.gc.shape) != (L.O, L.M, 3) \
                or self.ga.device != L.dev or self.gc.device != L.dev:
            raise ValueError("cotangents must be [O, M] and [O, M, 3] on "
                             f"{L.dev}")
        self.tile_m = tile_m
        self.plan = plan = field_plan(L.h, L.O, L.M, tile_m)
        self.scratch = torch.empty(
            (L.O, plan["scratch_pieces"], plan["scratch_rows"], plan["Mp"]),
            dtype=torch.bfloat16, device=L.dev)
        self.rest = torch.empty(
            (L.O, plan["blocks_per_object"], plan["rest_floats"]),
            dtype=torch.float32, device=L.dev)
        self.part = torch.empty(
            (L.O, plan["splits"], _staged_layout(L.h)[1]),
            dtype=torch.float32, device=L.dev)

    def bwd(self) -> None:
        """field_bwd_kernel: the forward, the input gradients, the scratch
        and the blocks' rest rows."""
        L = self.L
        code = L.lib.vmap_field_bwd(
            L.h, _ptr(L.params), ctypes.cast(L.offsets, ctypes.c_void_p),
            L.n_params, _ptr(L.ws), _ptr(L.scale), _ptr(L.pts),
            _ptr(self.ga), _ptr(self.gc), L.O, L.M, self.tile_m,
            _ptr(self.scratch), _ptr(self.rest), L.stream())
        _build.check(L.lib, code, "field_bwd kernel launch")

    def wgrad(self) -> None:
        """field_wgrad_kernel: the weight gradients from the scratch."""
        L = self.L
        code = L.lib.vmap_field_wgrad(
            L.h, _ptr(self.scratch), L.O, L.M, self.tile_m, _ptr(self.part),
            L.stream())
        _build.check(L.lib, code,
                     f"field_wgrad kernel launch (tile_m {self.tile_m})")


def _launch_bwd(prepared: dict, pts: torch.Tensor, g_alpha: torch.Tensor,
                g_color: torch.Tensor, tile_m: int) -> dict:
    """K3 on CUDA tensors -> {name: grad} for W_NAMES: field_bwd_kernel,
    then field_wgrad_kernel (the weight gradients over splits of whole
    units of ``tile_m`` points, or of its halves where the splits would not
    fill the card; tile_m a multiple of 32); the splits and the blocks'
    rows summed here, in a fixed order."""
    k3 = _BwdLaunch(prepared, pts, g_alpha, g_color, tile_m)
    k3.bwd()
    k3.wgrad()
    LAUNCHES["field_bwd"] += 1
    LAUNCHES[f"field_bwd.{k3.L.h}"] += 1
    return unstage_grads(k3.part.sum(dim=1), k3.rest.sum(dim=1), k3.L.h)


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
    is the backward's points per chunk, as the JAX kernel's point tile: the
    weight gradients sum whole chunks a split, so it sets the order of the
    sum, not the grid."""
    return FieldTrain.apply(pts, prepared["scale"], tile_m,
                            *[prepared[n] for n in W_NAMES])
