"""The train-frame kernel: one bank's whole per-frame optimisation.

Counterpart of ``vmap_tpu/kernels/train_step.py`` (the TPU kernel
``_make_kernel``, launched by ``fused_frame_prepared``). Each of the
``n_iter`` iterations runs, for every active slot: points -> PE ->
7-layer MLP -> occupancy / termination render -> masked L1 losses ->
backward -> masked AdamW.

Two versions of one function:
  * ``fused_frame_reference``: plain PyTorch, the ``ops`` modules and
    ``torch.autograd`` on the flat parameter buffer (under an int8 policy
    the MLP is ``ops.quant.Int8MLP``, its backward written by hand);
  * ``fused_frame``: the wrapper of the hand-written CUDA kernels in
    ``csrc/train_step.cu`` (kernel A ``train_grad_kernel``: forward +
    render + hand-derived backward per (slot, ray tile), its MLP products
    on tensor cores from the weights' staged bf16 pieces
    (``stage_weights``), partial gradients to one scratch row per block,
    ``frame_geometry``; kernel B ``adamw_kernel``: the rows streamed by
    TMA bulk copies and summed in a fixed order (``row_sum``), masked
    AdamW, and the updated weights' staged copy) and, for the int8
    policies, ``csrc/train_step_q8.cu`` (``train_grad_q8_kernel``, the
    same grid and rows with every MLP product on s8 tensor cores, and
    ``quant_weights_kernel``, the weights' s8 copy and its transpose once
    per iteration, ``q8_layout``, by clusters of 32-row bands), built for
    hidden 16, 32, 64, 128 and 256; ``csrc/update_plan.cuh`` states the
    two update
    kernels' plan (``update_plan``). The
    loop over iterations runs on the host, two launches per iteration
    (int8: three). On CPU tensors it runs the plain version; on
    CUDA tensors it launches the kernels or raises.

Data-only factors are computed in plain torch before the loop, as the JAX
package computes them outside its kernel (``_prepare_batch``): the
normalisers ``flag * active / (count + 1e-10)`` of each loss term and
iteration (``flag`` zeroes a term for every slot when any active slot has
an empty mask) and the Adam bias corrections ``1 - b^t``.

Both versions take the matmul ``policy`` (``ops.mlp.POLICIES``:
"float32", "bwd_bf16", "bfloat16" and the int8 ones; the JAX kernel's
``bf16`` argument) and ``reuse`` (``sample_reuse``): the batch's pixel arrays then hold ``n_iter / reuse``
iterations of rays, untiled, and iteration ``it`` trains on pixel block
``it mod (n_iter / reuse)`` with its own z samples (the batch's z holds
all ``n_iter``), as the JAX kernel's ``_prepare_batch(reuse=R)`` repeats
its pixel operands along the iteration axis. Under an int8 policy the
activation and gradient scales are per ray tile of ``tile_rays(h, S)``
rays, the kernel's own tile (``kernels.MAX_POINTS``, ``ops.quant``), and
the static policies' scales are ``ops.quant.static_scales()``.

``LAUNCHES`` counts successful kernel launches by kernel name, and
``train_grad``'s also by policy (``train_grad.<policy>``) and by width
(``train_grad.h<hidden>``); only
``FrameLaunch.grad`` / ``adamw`` / ``quant_weights`` change it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from vmap_tpu_torch.core.bank import (BankSpec, BankState,
                                     adam_bias_corrections, apply_adamw)
# MAX_POINTS is re-exported: callers read it as train_step.MAX_POINTS
from vmap_tpu_torch.kernels import (MAX_POINTS, _build,  # noqa: F401
                                    KERNEL_HIDDEN, check_width,
                                    float_tile_rays, tile_rays)
from vmap_tpu_torch.kernels import ensemble as E
from vmap_tpu_torch.ops import losses as L
from vmap_tpu_torch.ops import quant as Q
from vmap_tpu_torch.ops.embedding import embed
from vmap_tpu_torch.ops.mlp import POLICIES, mlp_apply, split_bf16

LAUNCHES = {"train_grad": 0, "train_adamw": 0, "train_quant_w": 0,
            **{f"train_grad.{p}": 0 for p in POLICIES},
            **{f"train_grad.h{h}": 0 for h in KERNEL_HIDDEN["train_frame"]}}
# train_grad writes one partial gradient row per (slot, block). While one
# block per ray tile keeps that scratch within SCRATCH_BUDGET bytes, each
# block takes one tile; past it the grid is bounded to GRID_SMS blocks over
# the bank (the SM count of the H100 SXM the kernels are built for), each
# looping over its tiles. A constant, not the card's count: the geometry
# fixes the order of the partial sums, so the result does not depend on
# the card.
SCRATCH_BUDGET = 256 << 20
GRID_SMS = 132
# offsets handed to the kernel, in the order of csrc/train_step.cu Offsets
OFFSET_NAMES = ("dirs", "w_in", "b_in", "w_mid1", "b_mid1", "w_cat", "b_cat",
                "w_mid2", "b_mid2", "w_alpha", "b_alpha", "w_col", "b_col",
                "w_col_out", "b_col_out")
BATCH_KEYS = ("rgb", "depth", "state", "valid", "z", "origins", "dirs")
# the product weights in the order of csrc/train_step.cu WMat
STAGED_NAMES = ("w_in", "w_mid1", "w_cat", "w_mid2", "w_alpha", "w_col",
                "w_col_out")
# the staged weights' bf16 pieces (csrc/train_step.cu STAGED_PIECES), and
# the pieces of each forward / backward product operand per float policy
# (fwd_pieces / bwd_pieces)
STAGED_PIECES = 3
PIECES = {"float32": (2, 2), "bwd_bf16": (3, 1), "bfloat16": (1, 1)}
SMEM_LIMIT = 232448      # the dynamic shared memory a block may use


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer for a C entry; None -> null."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _slice_iter(batch: dict, it: int, n_per: int, n_eff: int | None = None
                ) -> dict:
    """Iteration ``it``'s rays: z at ``it``, the pixel arrays at pixel
    block ``it mod n_eff`` (``n_eff`` = n_iter / reuse; None: ``it``)."""
    pix = it if n_eff is None else it % n_eff

    def rays(k):
        i = it if k == "z" else pix
        return slice(i * n_per, (i + 1) * n_per)
    return {k: batch[k][:, rays(k)] for k in BATCH_KEYS}


def reuse_period(n_iter: int, reuse: int) -> int:
    """n_eff = n_iter / reuse, the iterations of distinct pixels."""
    if reuse < 1 or n_iter % reuse:
        raise ValueError(f"sample_reuse {reuse} must divide n_iter {n_iter}")
    return n_iter // reuse


def field_tile(n_points: int) -> int:
    """Points per backward chunk of the field kernel for one object's
    iteration batch: the batch rounded up to 128, at most 1536 (the JAX
    step's tile rule, vmap_tpu/core/step.py:351-352)."""
    return min(max(-(-n_points // 128) * 128, 128), 1536)


def iteration_loss_grad(bank: BankState, sl: dict, color_scaling: float,
                        opacity_scaling: float, field_kernel: bool = False,
                        policy: str = "float32",
                        q8_tile_rays: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain forward + autograd of one iteration's batch ``sl`` (rays of
    that iteration only) -> (per-slot losses [cap], grad [cap, n_params]),
    the MLP and PE products under the matmul ``policy``. Under an int8
    policy the scales are per ray tile of ``q8_tile_rays`` rays (default:
    the kernel's ``tile_rays``; ``ops.quant``).
    ``field_kernel``: the field goes through ``ensemble.FieldTrain`` on the
    prepared parameters (K2 / K3 on CUDA, f32 only); autograd carries its
    gradient back through the pad and split to the flat buffer."""
    if field_kernel and policy != "float32":
        raise ValueError(f"the field kernels are f32 only, not {policy!r}")
    flat = bank.flat.detach().requires_grad_(True)
    pe, mlp_p = bank.spec.unflatten(flat)
    pts = (sl["origins"][:, :, None, :]
           + sl["dirs"][:, :, None, :] * sl["z"][..., None])
    if field_kernel:
        cap, n_rays, n_s, _ = pts.shape
        m = n_rays * n_s
        prepared = E.prepare_params(pe, mlp_p, bank.scale, bank.spec.hidden)
        alpha, color = E.field_train(prepared, pts.reshape(cap, m, 3),
                                     field_tile(m))
        alpha = alpha.reshape(cap, n_rays, n_s)
        color = color.reshape(cap, n_rays, n_s, 3)
    else:
        n_s = pts.shape[2]
        rt = q8_tile_rays or tile_rays(bank.spec.hidden, n_s)
        alpha, color = mlp_apply(
            mlp_p, embed(pe, pts, bank.scale, policy=policy), policy=policy,
            tile_points=rt * n_s)
        alpha = alpha[..., 0]
    total, per = L.step_batch_loss(
        alpha, color, sl["depth"], sl["rgb"], sl["state"],
        sl["valid"], sl["z"], bank.active, color_scaling, opacity_scaling)
    (grad,) = torch.autograd.grad(total, flat)
    return per.detach(), grad


def fused_frame_reference(bank: BankState, batch: dict, n_iter: int,
                          n_per: int, lr: float, wd: float,
                          color_scaling: float = 5.0,
                          opacity_scaling: float = 10.0,
                          field_kernel: bool = False, policy: str = "float32",
                          reuse: int = 1, q8_tile_rays: int | None = None):
    """Plain PyTorch frame of one bank: ``n_iter`` x (forward, autograd,
    ``apply_adamw``). ``batch`` is the sampler's ray-major output, rays
    iteration-major with ``n_per`` rays per iteration (pixel arrays for
    n_iter / ``reuse`` iterations). Returns (new BankState, per-slot
    per-iteration losses [cap, n_iter]). ``field_kernel``, ``policy``,
    ``q8_tile_rays``: see ``iteration_loss_grad``."""
    n_eff = reuse_period(n_iter, reuse)
    losses = []
    for it in range(n_iter):
        per, grad = iteration_loss_grad(bank,
                                        _slice_iter(batch, it, n_per, n_eff),
                                        color_scaling, opacity_scaling,
                                        field_kernel, policy, q8_tile_rays)
        bank = apply_adamw(bank, grad, lr, wd)
        losses.append(per)
    return bank, torch.stack(losses, dim=1)


def kernel_operands(batch: dict, active: torch.Tensor, n_iter: int,
                    n_per: int, reuse: int = 1) -> dict:
    """Sampler output -> the kernel's operands, all f32 and contiguous:
    od [cap, NE, 6] (origins, dirs), z [cap, NR, S], ray [cap, NE, 8]
    (depth, r, g, b, mask_obj, mask_sem, mask_obj & valid, 0) and wmul
    [cap, n_eff, 4], the (depth, colour, opacity, 0) normalisers
    ``flag * active / (count + 1e-10)`` per slot and pixel block; NR =
    n_iter * n_per rays, NE = n_eff * n_per, n_eff = n_iter / ``reuse``
    (the pixel-periodic operands are built once, not tiled)."""
    f32 = torch.float32
    cap = active.shape[0]
    n_eff = reuse_period(n_iter, reuse)
    mask_obj = (batch["state"] != 0).to(f32)
    mask_sem = (batch["state"] != 2).to(f32)
    m_do = mask_obj * batch["valid"].to(f32)
    ray = torch.stack([batch["depth"].to(f32), batch["rgb"][..., 0],
                       batch["rgb"][..., 1], batch["rgb"][..., 2], mask_obj,
                       mask_sem, m_do, torch.zeros_like(mask_obj)], dim=-1)
    cnts = ray[..., 4:7].reshape(cap, n_eff, n_per, 3).sum(2)
    cnts = cnts[..., [2, 0, 1]]          # (m_do, mask_obj, mask_sem) counts
    empty = torch.any((cnts == 0) & active[:, None, None], dim=0)  # [NE, 3]
    wm = (1.0 - empty.to(f32))[None] * active.to(f32)[:, None, None] \
        / (cnts + 1e-10)
    od = torch.cat([batch["origins"], batch["dirs"]], dim=-1).to(f32)
    return {"od": od.contiguous(), "z": batch["z"].to(f32).contiguous(),
            "ray": ray.contiguous(),
            "wmul": torch.cat([wm, torch.zeros_like(wm[..., :1])],
                              dim=-1).contiguous()}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def staged_layout(hidden: int) -> tuple[list, int]:
    """The staged copy of the product weights (csrc/train_step.cu): each
    weight of ``STAGED_NAMES``, [n_out, n_in], as a zero-padded
    [up16(n_out), up16(n_in)] row-major block. Returns ([(name, n_out, n_in,
    offset)], elements per plane)."""
    spec = BankSpec.create(hidden)
    shapes = {n: shape for _, n, shape, _, _ in spec.names}
    layout, off = [], 0
    for name in STAGED_NAMES:
        n_out, n_in = shapes[name]
        layout.append((name, n_out, n_in, off))
        off += _up(n_out, 16) * _up(n_in, 16)
    return layout, off


def stage_weights(flat: torch.Tensor, spec: BankSpec) -> torch.Tensor:
    """[cap, n_params] f32 -> the staged bf16 copy [cap, STAGED_PIECES, NS]
    (plane i the i-th piece of ``ops.mlp.split_bf16``) of each slot's
    product weights: the plain version of what ``adamw_kernel`` writes,
    which the float policies' ``train_grad`` reads."""
    layout, ns = staged_layout(spec.hidden)
    cap = flat.shape[0]
    out = torch.zeros((cap, STAGED_PIECES, ns), dtype=torch.bfloat16,
                      device=flat.device)
    _, mlp_p = spec.unflatten(flat)
    for name, n_out, n_in, off in layout:
        rows, cols = _up(n_out, 16), _up(n_in, 16)
        for plane, t in enumerate(split_bf16(mlp_p[name], STAGED_PIECES)):
            block = out[:, plane, off:off + rows * cols].view(cap, rows, cols)
            block[:, :n_out, :n_in] = t
    return out


def slab_bytes(hidden: int, policy: str) -> int:
    """One slab buffer of a float-policy train_grad block
    (csrc/train_step.cuh slab_bytes): the forward's (its pieces' planes of
    [hidden rows][KF + 8] bf16; KF 112 at h=16, 64 at h=32, 32 at h=64 and
    h=128, 16 at h=256, and with three pieces 112, 48, 32, 16, 16) or the
    input gradients' (16 rows of up16(h + 87) + 8), the larger."""
    npf, npb = PIECES[policy]
    kf = {16: (112, 112), 32: (64, 48), 64: (32, 32), 128: (32, 16),
          256: (16, 16)}[hidden][npf == 3]
    return max(2 * npf * hidden * (kf + 8),
               2 * npb * 16 * (_up(hidden + 87, 16) + 8))


def _rest_size(spec: BankSpec) -> int:
    """The parameters that are no product weight (the dirs and biases):
    the first ones of the layout (BankSpec: the PE's dirs, then the MLP's
    names sorted, b_* before w_*)."""
    n = sum(size for _, name, _, _, size in spec.names
            if name not in STAGED_NAMES)
    if min(spec.offset(name) for name in STAGED_NAMES) != n:
        raise ValueError("the product weights do not follow the dirs and "
                         "biases in the parameter layout")
    return n


def grad_row_size(hidden: int) -> int:
    """Floats of a float-policy partial-gradient row (csrc/train_step.cu
    grad_row): the staged weights' NS, then the dirs and biases, to a
    multiple of 16."""
    spec = BankSpec.create(hidden)
    return staged_layout(hidden)[1] + _up(_rest_size(spec), 16)


def grad_row_index(spec: BankSpec) -> torch.Tensor:
    """Where each parameter's partial gradient sits in a float-policy
    partial-gradient row of ``grad_row_size`` floats, int32 (its inverse,
    ``grad_row_param``, is what ``train_adamw`` reads by): a product weight
    at its staged index, the dirs and biases, which lead the parameter
    layout, at NS + their own."""
    layout, ns = staged_layout(spec.hidden)
    idx = torch.arange(spec.n_params, dtype=torch.int32) + ns
    for name, n_out, n_in, off in layout:
        base = spec.offset(name)
        r = torch.arange(n_out)[:, None] * _up(n_in, 16) + torch.arange(n_in)
        idx[base:base + n_out * n_in] = (off + r).reshape(-1)
    _rest_size(spec)   # the dirs and biases lead the layout
    return idx


def grad_row_param(spec: BankSpec) -> torch.Tensor:
    """The inverse of ``grad_row_index``: the parameter at each of the
    ``grad_row_size`` positions of a partial-gradient row, -1 on the
    staged layout's zero padding and the row's tail, int32 (the index
    ``train_adamw`` reads by, position by position)."""
    idx = grad_row_index(spec).long()
    out = torch.full((grad_row_size(spec.hidden),), -1, dtype=torch.int32)
    out[idx] = torch.arange(spec.n_params, dtype=torch.int32)
    return out


def row_sum(grad_part: torch.Tensor) -> torch.Tensor:
    """[cap, n_rows, row] partial rows -> [cap, row], each position's rows
    added in row order from 0, one f32 add each: the summation order
    ``train_adamw`` states (csrc/update_plan.cuh), its plain version."""
    g = torch.zeros_like(grad_part[:, 0])
    for t in range(grad_part.shape[1]):
        g = g + grad_part[:, t]
    return g


def loss_sum(loss_part: torch.Tensor) -> torch.Tensor:
    """[cap, n_rows] partial losses -> [cap] in ``train_adamw``'s order
    (csrc/update_plan.cuh): lane l of 32 sums rows l, l + 32, ... in
    order, then the lanes pairwise, halves added to halves (16, 8, 4, 2,
    1 apart)."""
    cap, n = loss_part.shape
    x = torch.nn.functional.pad(loss_part, (0, -n % 32)).view(cap, -1, 32)
    lanes = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        lanes = lanes + x[:, k]
    while lanes.shape[1] > 1:
        half = lanes.shape[1] // 2
        lanes = lanes[:, :half] + lanes[:, half:]
    return lanes[:, 0]


# csrc/update_plan.cuh update_plan's values, in its order (vmap_update_plan)
UPDATE_PLAN = ("adam_threads", "adam_run", "adam_rows_a_stage",
               "adam_stages", "adam_smem_bytes", "adam_blocks_per_sm",
               "adam_runs", "adam_chunks", "adam_blocks", "adam_loss_blocks",
               "quant_threads", "quant_band_rows", "quant_cluster",
               "quant_smem_bytes", "quant_blocks_per_sm", "quant_clusters",
               "grad_row", "q8_size")


def update_plan(hidden: int, cap: int, n_rows: int, lib=None) -> dict:
    """The update kernels' plan of a bank of ``cap`` slots at ``hidden``
    with ``n_rows`` partial rows a slot on the current card
    (``vmap_update_plan``): train_adamw's threads, run, ring and grid,
    train_quant_w's band, cluster, shared memory and clusters."""
    lib = lib or _build.load()
    out = (ctypes.c_int * len(UPDATE_PLAN))()
    _build.check(lib, lib.vmap_update_plan(hidden, cap, n_rows, out),
                 f"update plan (hidden {hidden}, {cap} slots, {n_rows} rows)")
    return dict(zip(UPDATE_PLAN, out))


# the int8 tile's shape per width (csrc/train_step_q8.cu Q8Tile): the n
# tiles of a warp's product unit and the slab's columns
Q8_WN = {16: 1, 32: 2, 64: 4, 128: 7, 256: 5}
Q8_KS = {16: 96, 32: 96, 64: 96, 128: 128, 256: 64}


def q8_layout(hidden: int) -> tuple[list, int]:
    """The s8 weights ``train_quant_w`` writes (csrc/train_step_q8.cu
    qw_off): for each ``ops.quant.QW_NAMES`` tensor [n_out, n_in] in
    order, its copy as a zero-padded [up16(n_out), up32(n_in)] row-major
    block, then its transpose [up16(n_in), up32(n_out)]. Returns ([(name,
    n_out, n_in, offset, transpose offset)], bytes per slot)."""
    h = hidden
    spec = BankSpec.create(h)
    shapes = {n: shape for _, n, shape, _, _ in spec.names}
    emb1, emb2 = shapes["w_in"][1], shapes["w_col"][1] - h
    dims = {"w_in": (h, emb1), "w_mid1": (h, h), "w_cat_h": (h, h),
            "w_cat_x": (h, emb1), "w_mid2": (h, h), "w_alpha": (1, h),
            "w_col_h": (h, h), "w_col_x": (h, emb2), "w_out": (3, h)}
    layout, off = [], 0
    for name in Q.QW_NAMES:
        n_out, n_in = dims[name]
        off_t = off + _up(n_out, 16) * _up(n_in, 32)
        layout.append((name, n_out, n_in, off, off_t))
        off = off_t + _up(n_in, 16) * _up(n_out, 32)
    return layout, off


def stage_q8(qw: dict, hidden: int) -> torch.Tensor:
    """``ops.quant.quant_weights``' quantised weights ({name: (q [n, out,
    in] integer-valued f32, scale)}) -> their s8 layout [n, q8_layout
    bytes] (int8): the plain version of what ``quant_weights_kernel``
    writes, which the int8 ``train_grad`` reads."""
    layout, size = q8_layout(hidden)
    q0 = qw[layout[0][0]][0]
    n = q0.shape[0]
    out = torch.zeros((n, size), dtype=torch.int8, device=q0.device)
    for name, n_out, n_in, off, off_t in layout:
        q = qw[name][0].to(torch.int8)
        rows, cols = _up(n_out, 16), _up(n_in, 32)
        out[:, off:off + rows * cols].view(n, rows, cols)[
            :, :n_out, :n_in] = q
        rows, cols = _up(n_in, 16), _up(n_out, 32)
        out[:, off_t:off_t + rows * cols].view(n, rows, cols)[
            :, :n_in, :n_out] = q.transpose(1, 2)
    return out


def q8_smem_bytes(hidden: int, rays: int, n_samples: int,
                  policy: str = "int8") -> int:
    """Dynamic shared memory of one int8-policy train_grad block
    (csrc/train_step_q8.cu q8_smem_bytes; the library's vmap_q8_smem):
    two slabs (``q8_slab_bytes``), the f32 rows at the odd stride LDP = P |
    1 (int8 / int8_static: the embedding, the projection and its gradient
    and the heads' 8 rows, then the per-ray losses, 32 floats of reduction
    scratch and the bias partials [h][units]; the _fwd halves:
    ``float_smem_bytes``' rows, the per-ray losses and the 32 floats), to
    16 bytes, and the s8
    copies: point-major [up8(P)][K + 16] of the hidden layers (K = h), the
    embedding (96, 64) and, under int8 / int8_static, the two head
    gradients (32 each), which also keep feature-major copies
    [rows][up32(P) + 16] of the embedding (96, 64 rows), the five hidden
    activations (h) and the two head gradients (16 rows each)."""
    h, pts = hidden, rays * n_samples
    ldp, ldq = pts | 1, _up(pts, 32) + 16
    qb = Q.q8_backward(policy)
    nu = -(-_up(MAX_POINTS[h], 8) // (8 * Q8_WN[h]))
    rows = ((129 + 42 + 8) * ldp + h * nu if qb
            else (129 + 4 * 21 + 2 * h + 8) * ldp)
    f32 = _up(4 * (rows + rays + 32), 16)
    s8 = _up(pts, 8) * (h + 16 + 112 + 80 + (96 if qb else 0))
    if qb:
        s8 += ldq * (96 + 64 + 5 * h + 32)
    return 2 * q8_slab_bytes(h, policy) + f32 + s8


def q8_slab_bytes(hidden: int, policy: str = "int8") -> int:
    """One slab of an int8-policy train_grad block (csrc/train_step_q8.cu
    q8_slab): the largest product's rows x (its columns, at most
    ``Q8_KS``, + 16) bytes, the forward's h rows over up to max(96, h)
    columns or the input gradients' up to 96 rows (the embedding's) over
    up32(h) (a hidden depth in whole k32 steps); under a _fwd half at
    least the float backward's ``slab_bytes``."""
    h, ks = hidden, Q8_KS[hidden]
    slab = max(h * (min(ks, max(96, h)) + 16),
               96 * (min(ks, _up(h, 32)) + 16))
    if not Q.q8_backward(policy):
        slab = max(slab, slab_bytes(h, "float32"))
    return slab


def float_smem_bytes(hidden: int, rays: int, n_samples: int,
                     policy: str = "float32") -> int:
    """Dynamic shared memory of one float-policy train_grad block
    (csrc/train_step.cu float_smem_bytes and its launcher): the tile's f32
    rows at the odd stride LDP = P | 1 (the embedding, the projection and
    its gradient, two hidden-activation buffers, the heads' 8 rows, 42
    band-gradient rows) and its per-ray losses, and a ring of two slabs of
    staged weights where it fits within SMEM_LIMIT, else one."""
    ldp = (rays * n_samples) | 1
    act = 4 * (ldp * (129 + 4 * 21 + 2 * hidden + 8) + rays)
    slab = slab_bytes(hidden, policy)
    two = 2 * slab + act
    return two if two <= SMEM_LIMIT else two - slab


@dataclass(frozen=True)
class FrameGeometry:
    """train_grad's launch geometry for one bank and iteration. Block b of
    a slot takes the ray tiles b, b + blocks, b + 2 blocks, ... in order
    and adds them into its partial row (csrc/train_step.cu)."""
    rays_per_tile: int
    n_tiles: int          # ray tiles per slot and iteration
    blocks: int           # train_grad blocks per slot = partial rows per slot
    rows: int             # partial rows of the bank: cap * blocks
    scratch_bytes: int    # the blocks' f32 scratch (block_scratch_bytes)


def block_scratch_bytes(hidden: int, rays: int, n_samples: int,
                        policy: str = "float32") -> int:
    """One train_grad block's global scratch (``FrameLaunch``): its
    partial-gradient row of ``grad_row_size`` floats and, but under int8 /
    int8_static (whose backward keeps its s8 copies in shared memory), its
    activation scratch, h1, h2, h3 of its tile at the row stride (rays *
    S) | 1."""
    row = grad_row_size(hidden)
    if Q.q8_backward(policy):
        return 4 * row
    return 4 * (row + 3 * hidden * ((rays * n_samples) | 1))


def frame_geometry(hidden: int, n_samples: int, n_per: int,
                   cap: int, policy: str = "float32") -> FrameGeometry:
    """The geometry for ``cap`` slots at ``hidden`` with ``n_per`` rays of
    ``n_samples`` samples per iteration under the matmul ``policy`` (its
    tile: ``float_tile_rays``, or under an int8 policy ``tile_rays``).

    Of three ways to bound the scratch (K3's fixed grid of blocks that
    each loop over their own tiles; a thread-block cluster holding a
    larger tile in distributed shared memory; activations in global
    scratch so that a tile holds more rays), the fixed grid is taken: it
    runs the tile body unchanged and bounds the rows by the SM count
    (or by ``cap`` past 132 slots) whatever ``n_per``, where the other two
    only make tiles larger and so divide the rows by a constant. The
    scratch is ``block_scratch_bytes`` a block. One block per tile stays
    where it is small (the vMAP shapes under float32: 157.2 MB for the
    objects at h=32, 147.6 MB for the background at h=128), so those
    launches are unchanged; the iMAP field (h=256, 4800 rays x 14 samples:
    1200 float tiles of 1.51 MB or 2400 int8 ones of 1.33 MB, 1.8 or 3.2
    GB) gets 132 blocks, 199.0 MB under float32. Fewer rows than tiles
    below the budget would save only the rows' bytes, and the geometry is
    set by ``cap``, not by the slots active: a bank with few active slots
    would run few blocks of many tiles each on an idle card."""
    rt = (tile_rays if policy in Q.INT8_POLICIES
          else float_tile_rays)(hidden, n_samples)
    n_tiles = -(-n_per // rt)
    block_bytes = block_scratch_bytes(hidden, rt, n_samples, policy)
    blocks = n_tiles
    if cap * n_tiles * block_bytes > SCRATCH_BUDGET:
        blocks = max(1, min(n_tiles, GRID_SMS // cap))
    return FrameGeometry(rt, n_tiles, blocks, cap * blocks,
                         cap * blocks * block_bytes)


class FrameLaunch:
    """Validated operands and scratch of one bank's kernel frame; its
    methods launch the kernels for one iteration.

    ``ws`` holds the product weights' staged bf16 pieces
    (``stage_weights``): made here from the bank's parameters, and
    rewritten by each ``adamw`` from the parameters it updates; under a
    float policy ``train_grad``'s products read them, under int8_fwd /
    int8_static_fwd its f32 backward; int8 / int8_static have none
    (None). The partial-gradient rows
    (``grad_part``, every policy) hold the weights in the staged layout,
    ``row_index`` each parameter's place (``grad_row_index``) and
    ``row_param`` the parameter at each place (``grad_row_param``, which
    ``adamw`` reads by); ``plan`` the update kernels' (``update_plan``).
    Under an
    int8 policy ``wq`` holds the s8 weights and their transposes
    (``q8_layout``) and ``wscale`` their [cap, 9] scales
    (``ops.quant.QW_NAMES``), written by ``quant_weights``: here from the
    bank's parameters, then by each ``adamw`` but the frame's last; ``qs``
    the static policies' (scale, 127 / maximum) pairs of
    ``ops.quant.static_scales()``, None under the dynamic ones. So
    ``grad`` takes the bank's parameters as they stand after the latest
    ``adamw`` of this launch. ``lib``: the kernel library (default
    ``_build.load()``; the section-timing build of ``chip_smoke.py
    --sections``)."""

    def __init__(self, bank: BankState, batch: dict, n_iter: int, n_per: int,
                 color_scaling: float, opacity_scaling: float,
                 policy: str = "float32", reuse: int = 1, lib=None):
        dev = bank.flat.device
        if dev.type != "cuda":
            raise ValueError(f"kernel path needs CUDA tensors, got {dev}")
        h = bank.spec.hidden
        check_width("train_frame", h, policy)
        n_eff = reuse_period(n_iter, reuse)
        cap, n_params = bank.flat.shape
        for name in ("flat", "m", "v"):
            t = getattr(bank, name)
            if (t.dtype != torch.float32 or t.device != dev
                    or not t.is_contiguous() or t.shape != (cap, n_params)):
                raise ValueError(f"bank.{name} must be a contiguous f32 "
                                 f"[{cap}, {n_params}] tensor on {dev}")
        if n_params != bank.spec.n_params:
            raise ValueError("bank width does not match its spec")
        n_rays = n_iter * n_per
        for k in BATCH_KEYS:
            t = batch[k]
            rays = n_rays if k == "z" else n_eff * n_per
            if t.device != dev:
                raise ValueError(f"batch[{k!r}] on {t.device}, bank on {dev}")
            if t.shape[:2] != (cap, rays):
                raise ValueError(f"batch[{k!r}] shape {tuple(t.shape)}: "
                                 f"expected ({cap}, {rays}, ...)")
        S = batch["z"].shape[2]
        if not 1 <= S <= 32:
            raise ValueError(f"{S} samples per ray; the kernel takes 1..32")
        self.lib = lib or _build.load()
        self.dev, self.h, self.cap, self.n_params = dev, h, cap, n_params
        self.n_iter, self.n_per, self.S = n_iter, n_per, S
        self.n_eff, self.policy = n_eff, policy
        self.cs, self.osc = float(color_scaling), float(opacity_scaling)
        self.geom = frame_geometry(h, S, n_per, cap, policy)
        ops = kernel_operands(batch, bank.active, n_iter, n_per, reuse)
        self.od, self.z, self.ray = ops["od"], ops["z"], ops["ray"]
        self.wmul = ops["wmul"]
        bc1, bc2 = adam_bias_corrections(bank.step, n_iter)
        self.bc1, self.bc2 = bc1.contiguous(), bc2.contiguous()
        self.scale = bank.scale.to(torch.float32).contiguous()
        self.active = bank.active.to(torch.int32).contiguous()
        self.offsets = (ctypes.c_int * len(OFFSET_NAMES))(
            *[bank.spec.offset(n) for n in OFFSET_NAMES])
        g = self.geom
        self.q8 = policy in Q.INT8_POLICIES
        row = grad_row_size(h)
        # the update kernels' plan (csrc/update_plan.cuh), which also
        # states the rows' and the s8 weights' sizes
        self.plan = update_plan(h, cap, g.blocks, self.lib)
        if (self.lib.vmap_staged_size(h) != staged_layout(h)[1]
                or self.plan["grad_row"] != row
                or self.plan["q8_size"] != q8_layout(h)[1]):
            raise RuntimeError("staged_layout / grad_row_size / q8_layout "
                               "disagree with the kernel library's")
        # the rows hold the weights in the staged layout, then the dirs and
        # biases (row_index: each parameter's place in a row), and each
        # block but int8 / int8_static's has an activation scratch (h1, h2,
        # h3 of its tile at the kernel's row stride (rays * S) | 1):
        # block_scratch_bytes
        self.row_index = grad_row_index(bank.spec).to(dev)
        self.row_param = grad_row_param(bank.spec).to(dev)
        self.act_part = None
        if not (self.q8 and Q.q8_backward(policy)):
            self.act_part = torch.empty(
                (cap, g.blocks, 3, h, (g.rays_per_tile * S) | 1),
                dtype=torch.float32, device=dev)
        self.grad_part = torch.empty((cap, g.blocks, row),
                                     dtype=torch.float32, device=dev)
        self.loss_part = torch.empty((cap, g.blocks), dtype=torch.float32,
                                     device=dev)
        # the staged bf16 pieces, which no kernel of int8 / int8_static
        # reads (train_adamw writes them where they exist)
        self.ws = (None if self.q8 and Q.q8_backward(policy)
                   else stage_weights(bank.flat, bank.spec))
        self.wq = self.wscale = self.qs = None
        if self.q8:
            self.wq = torch.zeros((cap, q8_layout(h)[1]), dtype=torch.int8,
                                  device=dev)
            self.wscale = torch.empty((cap, len(Q.QW_NAMES)),
                                      dtype=torch.float32, device=dev)
            if Q.q8_static(policy):
                self.qs = torch.tensor(
                    [v for m in Q.static_scales()
                     for v in (m * (1.0 / 127.0), 127.0 / m)],
                    dtype=torch.float32, device=dev)
            self.quant_weights(bank.flat)

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.dev).cuda_stream

    def _check(self, name: str, t: torch.Tensor, shape: tuple) -> None:
        if (t.dtype != torch.float32 or t.device != self.dev
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous f32 {list(shape)} "
                             f"tensor on {self.dev}")

    def grad(self, params: torch.Tensor, it: int) -> None:
        """Kernel A: forward + backward of iteration ``it`` into the
        scratch partials (``csrc/train_step.cu``, or under an int8 policy
        ``csrc/train_step_q8.cu``)."""
        self._check("params", params, (self.cap, self.n_params))
        p = _ptr
        geom = (self.cap, self.n_params, self.n_per, self.n_iter, self.n_eff,
                it, self.S, self.geom.rays_per_tile, self.geom.n_tiles,
                self.geom.blocks, self.cs, self.osc,
                ctypes.c_void_p(self._stream()))
        batch = (p(self.od), p(self.z), p(self.ray), p(self.wmul),
                 p(self.scale), p(self.active), p(self.grad_part),
                 p(self.loss_part))
        offsets = ctypes.cast(self.offsets, ctypes.c_void_p)
        if self.q8:
            code = self.lib.vmap_train_grad_q8(
                int(Q.q8_backward(self.policy)), self.h, p(params),
                p(self.ws), p(self.wq), p(self.wscale), p(self.qs), *batch,
                p(self.act_part), offsets, *geom)
        else:
            code = self.lib.vmap_train_grad(
                POLICIES.index(self.policy), self.h, p(params), p(self.ws),
                *batch, p(self.act_part), offsets, *geom)
        _build.check(self.lib, code, "train_grad kernel launch")
        LAUNCHES["train_grad"] += 1
        LAUNCHES[f"train_grad.{self.policy}"] += 1
        LAUNCHES[f"train_grad.h{self.h}"] += 1

    def adamw(self, params, m, v, losses, it: int, lr: float,
              wd: float) -> None:
        """Kernel B: reduce the partials (``row_sum``'s order; the losses
        ``loss_sum``'s), masked AdamW in place on (params, m, v),
        losses[:, it] and ``ws`` (if the policy has it); under an int8
        policy then ``quant_weights`` for the next iteration, if there is
        one."""
        for name, t in (("params", params), ("m", m), ("v", v)):
            self._check(name, t, (self.cap, self.n_params))
        self._check("losses", losses, (self.cap, self.n_iter))
        p = _ptr
        code = self.lib.vmap_train_adamw(
            p(params), p(self.ws), p(self.row_param),
            p(m), p(v), p(self.grad_part), p(self.loss_part), p(losses),
            p(self.active), p(self.bc1), p(self.bc2), self.h, self.cap,
            self.n_params, self.geom.blocks, self.n_iter, it, float(lr),
            float(1 - lr * wd), ctypes.c_void_p(self._stream()))
        _build.check(self.lib, code, "train_adamw kernel launch")
        LAUNCHES["train_adamw"] += 1
        if self.q8 and it + 1 < self.n_iter:
            self.quant_weights(params)

    def quant_weights(self, params: torch.Tensor) -> None:
        """Int8 policies: the s8 copy ``wq`` (``q8_layout``) and scales
        ``wscale`` of ``params``' MLP weights (``ops.quant.quant_weights``,
        then ``stage_q8``): a cluster of 32-row bands per (active slot,
        source matrix), the grid from the card's SM count
        (csrc/update_plan.cuh)."""
        self._check("params", params, (self.cap, self.n_params))
        code = self.lib.vmap_train_quant_w(
            _ptr(params), _ptr(self.wq), _ptr(self.wscale),
            _ptr(self.active), ctypes.cast(self.offsets, ctypes.c_void_p),
            self.cap, self.n_params, self.h, ctypes.c_void_p(self._stream()))
        _build.check(self.lib, code, "train_quant_w kernel launch")
        LAUNCHES["train_quant_w"] += 1


def fused_frame(bank: BankState, batch: dict, n_iter: int, n_per: int,
                lr: float, wd: float, color_scaling: float = 5.0,
                opacity_scaling: float = 10.0, policy: str = "float32",
                reuse: int = 1):
    """One bank's frame under the matmul ``policy``, with ``reuse`` (see
    the module docstring).
    CPU tensors: the plain version. CUDA tensors: the CUDA kernels, 2
    launches per iteration (an int8 policy: 3, and one before the first),
    into fresh state tensors (the input bank is not modified). Returns
    (new BankState, losses [cap, n_iter])."""
    if bank.flat.device.type == "cpu":
        return fused_frame_reference(bank, batch, n_iter, n_per, lr, wd,
                                     color_scaling, opacity_scaling,
                                     policy=policy, reuse=reuse)
    fl = FrameLaunch(bank, batch, n_iter, n_per, color_scaling,
                     opacity_scaling, policy, reuse)
    params = torch.empty_like(bank.flat).copy_(bank.flat)
    m = torch.empty_like(bank.m).copy_(bank.m)
    v = torch.empty_like(bank.v).copy_(bank.v)
    losses = torch.empty((fl.cap, n_iter), dtype=torch.float32,
                         device=fl.dev)
    for it in range(n_iter):
        fl.grad(params, it)
        fl.adamw(params, m, v, losses, it, lr, wd)
    step = torch.where(bank.active, bank.step + n_iter, bank.step)
    return bank.replace(flat=params, m=m, v=v, step=step), losses
