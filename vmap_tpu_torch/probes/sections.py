"""K7: the cost of each of K1's sections alone, chained inside one launch.

Counterpart of ``scripts/microbench_sections.py::_one`` and its bodies
(``:95-194``). Each case runs ``reps`` dependent steps c <- body(c) on the
script's shapes (T = 1280 = S R, S = 10 samples, R = 128 rays, OG = 8
rows), computing the function the script's body computes:

  * ``render``: the render forward and backward of K1 on OG x R rays of S
    samples (occupancy, transmittance, depth / colour / variance sums,
    the losses' row sums ``ld`` / ``lc`` / ``lo`` over each row's 128 rays,
    the gradient back to alpha), fed back as alpha;
  * ``emb_cat``: the embedding concatenated to [384, T], two [128, 384]
    products; ``emb_split``: the same as 8 banded [128, 96] products. The
    case keeps the script's f32 products, on FP32 FMA (never TF32): it is
    held at rtol 1e-5 a step, which a 3xbf16 tensor-core route's error
    (3 2^-16 sum |a||b|, the route of K1's f32 products) does not meet;
  * ``ladder``: sin / cos and 5 double-angle levels on [96, T];
    ``ladder_sinpi``: the ``sinpif`` / ``cospif`` per band that the port's
    tile uses instead (``train_step.cuh``), on the same [96, T] (a
    measurement of an existing code path; its plain version is sin(pi x)
    in f64).

A step of emb / ladder is c <- KEEP c + 1e-6 section(c), so the section
moves the carry by only about 2e-4 (emb) or 1e-5 (ladder) of itself: a
check on the carry alone cannot see it. ``compare`` therefore also holds
the section's own output, read from one step of the kernel as
``increment`` (out - KEEP c) / 1e-6, against the plain ``section``
elementwise, within the two f32 roundings of that step (``increment``'s
bound) plus rtol 1e-5.

Layouts: the public functions take the script's [rows, T] arrays
(column s R + r). The render kernel keeps the port's layout, per ray x
sample ([OG, R, S], as ``train_step.cuh`` holds a ray's samples), one
block per row of 128 rays, so a row sum is a reduction inside one block;
the wrapper transposes in and out. A ray runs on two lanes of five
samples each, its transmittance and backward suffix as two-lane scans
(``render_step_lanes`` mirrors that order on the CPU). The other cases
are separable by column. The emb kernel runs on a plan cut from the card (``emb_plan``):
W1 and W2 (393 KB) do not fit one SM, so a slab of 20 columns is a
thread-block cluster of 2 blocks, each keeping 64 rows of both W^T in
shared memory for the whole chain and exchanging its new carry rows with
the other by a copy between shared memories each step; all 128 rows of
both products are computed, and the last step's rows 96-127, which no
later step reads, go to a side output that ``compare`` holds too
(``side_reference``). The ladders' elements go round one block an SM in
whole warps, two a lane (``ladder_plan``, ``probes.spread_plan``), their
sin / cos on the accurate functions' own fast paths without the branch to
the slow path (csrc/probe_common.cuh), which ``fast_check`` holds to the
library functions bit for bit on every float of their ranges.

    python -m vmap_tpu_torch.probes.sections [case ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from vmap_tpu_torch import probes
from vmap_tpu_torch.probes import _timing, mm

S, R, T, OG = 10, 128, 1280, 8
CASES = ("render", "emb_cat", "emb_split", "ladder", "ladder_sinpi")
SHAPES = {"render": ((OG, T), (OG, T), (OG, R), (3 * OG, R), (OG, R)),
          "emb_cat": ((96, T), (128, 384), (128, 384)),
          "emb_split": ((96, T), (128, 384), (128, 384)),
          "ladder": ((96, T),), "ladder_sinpi": ((96, T),)}
BASE_REPS = 200
LADDER_LEVELS = 5
# c <- KEEP c + SECTION_SCALE section(c): the carry's factor a step
KEEP = {"emb_cat": 0.999, "emb_split": 0.999, "ladder": 0.9,
        "ladder_sinpi": 0.9}
SECTION_SCALE = 1e-6
SECTION_RTOL = 1e-5


def tol(case: str, reps: int) -> float:
    """rtol of the last carry: 1e-5 for render and the ladders (sigmoid,
    sinf / cosf, sinpif against the plain functions), 1e-5 a step for the
    FMA products."""
    return 1e-5 * reps if case.startswith("emb") else 1e-5


def increment(case: str, c: torch.Tensor, out: torch.Tensor) -> tuple:
    """The section's output as one step c -> out shows it
    (``probes.increment`` with the case's KEEP and 1e-6: the bound of its
    error from the step's f32 roundings is 0.03-0.12 at these inputs,
    against sections of about 1-100)."""
    return probes.increment(KEEP[case], SECTION_SCALE, c, out)


def make_inputs(case: str, dev) -> list:
    """The script's inputs: each array from its own default_rng(7), uniform
    [0.25, 0.75), f32."""
    return [torch.tensor(np.random.default_rng(7).random(s) * 0.5 + 0.25,
                         dtype=torch.float32).to(dev)
            for s in SHAPES[case]]


# ------------------------------------------------------------- plain bodies
def _tile(a, s):
    return a[:, s * R:(s + 1) * R]


def _lane_sum(x):
    acc = _tile(x, 0)
    for s in range(1, S):
        acc = acc + _tile(x, s)
    return acc


def _bcast(x):
    return torch.cat([x] * S, 1)


def _rep3(x):
    return torch.cat([x, x, x], 0)


def _sum3(x):
    return x[0:OG] + x[OG:2 * OG] + x[2 * OG:3 * OG]


def render_step(ins, c):
    """microbench_sections.py::render_body on [OG, T] (ins: c0 source, z,
    dep, gtc, mo)."""
    z, dep, gtc, mo = ins[1], ins[2], ins[3], ins[4]
    alpha = c
    color = torch.sigmoid(_rep3(c * 0.3))
    occ = torch.sigmoid(alpha)
    free = torch.clamp(1.0 - occ + 1e-10, min=1e-10)
    cp = torch.ones(OG, R, dtype=c.dtype, device=c.device)
    cps = []
    for s in range(S):
        cps.append(cp)
        cp = cp * _tile(free, s)
    cp_full = torch.cat(cps, 1)
    terms = occ * cp_full
    rd = _lane_sum(terms * z)
    ro = _lane_sum(terms)
    dz = z - _bcast(rd)
    var = _lane_sum(terms * (dz * dz))
    info = 1.0 / (torch.sqrt(var) + 1e-4)
    terms3 = _rep3(terms)
    rc3 = _lane_sum(terms3 * color)
    res_d, res_o, res_c3 = rd - dep, ro - mo, rc3 - gtc
    mo3 = _rep3(mo)
    ld = torch.sum(res_d.abs() * info, 1, keepdim=True)
    lc = torch.sum(_sum3(res_c3.abs() * mo3), 1, keepdim=True)
    lo = torch.sum(res_o.abs(), 1, keepdim=True)
    d_rd = torch.sign(res_d) * info
    d_ro = torch.sign(res_o)
    d_rc3_b = _bcast(torch.sign(res_c3) * mo3)
    dterm = _bcast(d_rd) * z + _bcast(d_ro) + _sum3(d_rc3_b * color)
    tt = dterm * terms
    suf = torch.zeros(OG, R, dtype=c.dtype, device=c.device)
    sufs = [None] * S
    for s in range(S - 1, -1, -1):
        sufs[s] = suf
        suf = suf + _tile(tt, s)
    docc = dterm * cp_full - torch.cat(sufs, 1) / free
    dalpha = docc * occ * (1.0 - occ) * 10.0
    dlogits = d_rc3_b * terms3 * color * (1.0 - color)
    return (dalpha * 1e-3 + c * 0.999 + (ld + lc + lo) * 1e-6
            + dlogits[0:OG, 0:1].expand_as(c) * 1e-9)


RAY_LANES = 2        # the render kernel's lanes a ray (csrc/sections.cu)
RENDER_WARPS = R * RAY_LANES // 32


def _seq_sum(x):
    """x's last axis summed in order."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _row_sum_lanes(v):
    """A row's per-ray values [OG, R] summed as the render kernel sums
    them: each warp's 16 rays by a butterfly over the lanes of one parity
    (lane l holds ray 16 w + l // 2; offsets 16, 8, 4, 2), then the warps'
    lane 0 in warp order."""
    lanes = torch.arange(32)
    v = v.reshape(OG, RENDER_WARPS, 16)[:, :, lanes // 2]
    for off in (16, 8, 4, 2):
        v = v + v[:, :, lanes ^ off]
    return _seq_sum(v[:, :, 0])


def render_step_lanes(ins, c):
    """``render_step`` in csrc/sections.cu render_kernel's order, for
    tests: a ray on RAY_LANES lanes of S / RAY_LANES samples each; each
    lane's transmittance prefix products, its sums and its backward suffix
    in order, then the two-lane scans (the second lane's prefixes times
    the first lane's total, the second lane's suffix total added to the
    first lane's suffixes) and the halves' sums added; the losses' row sums
    as ``_row_sum_lanes``."""
    z, dep, gtc, mo = ins[1], ins[2], ins[3], ins[4]
    sl = S // RAY_LANES

    def rays(x):  # [OG, S R] -> [OG, R, lanes, samples a lane]
        return x.reshape(OG, S, R).transpose(1, 2).reshape(OG, R, RAY_LANES,
                                                           sl)
    a, zz = rays(c), rays(z)
    col = torch.sigmoid(a * 0.3)
    occ = torch.sigmoid(a)
    fr = torch.clamp(1.0 - occ + 1e-10, min=1e-10)
    cps, cpv = [], torch.ones(OG, R, RAY_LANES, dtype=c.dtype)
    for i in range(sl):
        cps.append(cpv)
        cpv = cpv * fr[..., i]
    cp = torch.stack(cps, -1)
    scale = torch.ones_like(cpv)
    scale[..., 1:] = cpv[..., :1]
    cp = cp * scale[..., None]
    terms = occ * cp

    def halves(x):
        h = _seq_sum(x)
        return h[..., 0] + h[..., 1]
    rd, ro, rc = halves(terms * zz), halves(terms), halves(terms * col)
    dz = zz - rd[..., None, None]
    var = halves(terms * (dz * dz))
    info = 1.0 / (torch.sqrt(var) + 1e-4)
    g0, g1, g2 = gtc[:OG], gtc[OG:2 * OG], gtc[2 * OG:]
    res_d, res_o = rd - dep, ro - mo
    rc0, rc1, rc2 = rc - g0, rc - g1, rc - g2
    ld = _row_sum_lanes(res_d.abs() * info)
    lc = _row_sum_lanes((rc0.abs() * mo + rc1.abs() * mo) + rc2.abs() * mo)
    lo = _row_sum_lanes(res_o.abs())
    loss = ((ld + lc) + lo) * 1e-6
    drd, dro = torch.sign(res_d) * info, torch.sign(res_o)
    dc0, dc1, dc2 = (torch.sign(x) * mo for x in (rc0, rc1, rc2))
    first = (slice(None), 0, 0, 0)
    dl = dc0[:, 0] * terms[first] * col[first] * (1.0 - col[first])
    e = (..., None, None)
    dterm = (drd[e] * zz + dro[e]) + ((dc0[e] * col + dc1[e] * col)
                                      + dc2[e] * col)
    sufs, sv = [None] * sl, torch.zeros(OG, R, RAY_LANES, dtype=c.dtype)
    for i in range(sl - 1, -1, -1):
        sufs[i] = sv
        sv = sv + dterm[..., i] * terms[..., i]
    carry = torch.zeros_like(sv)
    carry[..., :1] = sv[..., 1:]
    suf = torch.stack(sufs, -1) + carry[..., None]
    docc = dterm * cp - suf / fr
    dalpha = docc * occ * (1.0 - occ) * 10.0
    new = ((dalpha * 1e-3 + a * 0.999) + loss[:, None, None, None]) \
        + (dl * 1e-9)[:, None, None, None]
    return new.reshape(OG, R, S).transpose(1, 2).reshape(OG, T)


def emb_y(ins, c, split: bool):
    """The emb cases' products, all 128 rows: W1 @ emb + W2 @ emb, emb the
    4 bands c 2^-b (emb_cat: each product over the concatenated bands;
    emb_split: the bands' products added in band order)."""
    w1, w2 = ins[1], ins[2]
    bands = [c, c * 0.5, c * 0.25, c * 0.125]
    if not split:
        emb = torch.cat(bands, 0)
        return w1 @ emb + w2 @ emb
    y = None
    for k, b in enumerate(bands):
        sl = slice(k * 96, (k + 1) * 96)
        yk = w1[:, sl] @ b + w2[:, sl] @ b
        y = yk if y is None else y + yk
    return y


def emb_section(ins, c, split: bool):
    """The emb_cat / emb_split sections: (W1 @ emb + W2 @ emb)[:96]."""
    return emb_y(ins, c, split)[:96]


def ladder_section(c, sinpi: bool):
    """The ladder section: sins / coss of 6 levels summed. ``sinpi``: each
    level sin(pi 2^l c) directly (f64, then f32)."""
    if sinpi:
        x = c.double()
        sins = [torch.sin(math.pi * x * 2.0 ** lv).float()
                for lv in range(LADDER_LEVELS + 1)]
        coss = [torch.cos(math.pi * x * 2.0 ** lv).float()
                for lv in range(LADDER_LEVELS + 1)]
    else:
        x = c * np.float32(np.pi)
        sins, coss = [torch.sin(x)], [torch.cos(x)]
        for _ in range(LADDER_LEVELS):
            s_, c_ = sins[-1], coss[-1]
            sins.append(2.0 * s_ * c_)
            coss.append(1.0 - 2.0 * s_ * s_)
    acc = sins[0]
    for v in sins[1:] + coss:
        acc = acc + v
    return acc


def section(case: str, ins, c):
    """An emb / ladder case's section at carry c: y[:96] or the ladder's
    sum."""
    if case.startswith("emb"):
        return emb_section(ins, c, case == "emb_split")
    return ladder_section(c, case == "ladder_sinpi")


def step_reference(case: str, ins, c):
    """One step of the script's body."""
    if case == "render":
        return render_step(ins, c)
    return c * KEEP[case] + section(case, ins, c) * SECTION_SCALE


def chain_reference(case: str, ins: list, reps: int) -> torch.Tensor:
    """Plain version: the last carry, from c0 = ins[0] 1.0001."""
    c = ins[0] * 1.0001
    for _ in range(reps):
        c = step_reference(case, ins, c)
    return c


def side_reference(case: str, ins: list, reps: int) -> torch.Tensor:
    """An emb case's rows 96-127 of y at its last step (the kernel's side
    output): the step's products that no later step reads."""
    c = chain_reference(case, ins, reps - 1)
    return emb_y(ins, c, case == "emb_split")[96:]


# ----------------------------------------------------------- the emb plan
# csrc/sections.cu EmbPlan, in the order the launcher reads it
EMB_PLAN_FIELDS = ("cluster", "rows", "N", "slabs", "threads")
EMB_ROWS, EMB_K, BAND = 128, 384, 96
# a lane's tile (rows x columns of each product), the lanes of a band in
# a warp, a block's threads; the cluster sizes the kernel is built for
EMB_TILE, EMB_TILES, EMB_THREADS = (4, 10), 8, 128
EMB_BUILT = (2,)


def emb_smem_bytes(p: dict) -> int:
    """One block's dynamic shared memory (csrc/sections.cu emb_smem): W1^T's
    and W2^T's panel, the slab's carry twice, three mbarriers."""
    return 4 * (EMB_K * 2 * p["rows"] + 2 * BAND * p["N"]) + 3 * 8


def emb_plan(sms: int = mm.N_SMS, n: int = T) -> dict:
    """The emb kernel's plan for ``sms`` SMs (csrc/sections.cu EmbPlan,
    checked there by emb_plan_ok): the 393 KB of W1 and W2 do not fit one
    SM, so a slab of N columns is one thread-block cluster whose blocks
    each keep ``rows`` rows of both W^T in shared memory for the whole
    chain, beside the slab's carry (two buffers: the new rows go to the
    peer's next buffer). A block's 4 warps each own 16 rows x N, a lane a
    band and a 4 x 10 tile of each product, so rows x N = 1280 and the
    plan has 128 blocks, one an SM; the smallest cluster built whose panel
    fits (2: 64 rows, 192 KiB of W) is taken. Raises where none fits."""
    for cluster in EMB_BUILT:
        rows = EMB_ROWS // cluster
        N = 4 * EMB_TILES * EMB_TILE[0] * EMB_TILE[1] // rows
        if n % N:
            continue
        p = {"cluster": cluster, "rows": rows, "N": N, "slabs": n // N,
             "threads": EMB_THREADS}
        if all(emb_plan_checks(p, sms, n).values()):
            return p
    raise ValueError(f"no emb plan fits {sms} SMs at n={n}")


def emb_plan_checks(p: dict, sms: int = mm.N_SMS, n: int = T) -> dict:
    """The limits an emb plan must meet: a block's shared memory, every
    block resident at once (one an SM), W's panels covering y's 128 rows
    once and the slabs n's columns once, the block's tiles (4 warps of 16
    rows, 8 tiles of 4 x 10 a band), a cluster size built."""
    rows = [0] * EMB_ROWS
    for panel in range(p["cluster"]):
        for r in range(p["rows"]):
            if panel * p["rows"] + r < EMB_ROWS:
                rows[panel * p["rows"] + r] += 1
    cols = [0] * n
    for s in range(p["slabs"]):
        for c in range(p["N"]):
            if s * p["N"] + c < n:
                cols[s * p["N"] + c] += 1
    tr, tc = EMB_TILE
    return {"fits": emb_smem_bytes(p) <= mm.BLOCK_SMEM,
            "resident": p["cluster"] * p["slabs"] <= sms,
            "rows_once": rows == [1] * EMB_ROWS
            and p["cluster"] * p["rows"] == EMB_ROWS,
            "cols_once": cols == [1] * n and p["slabs"] * p["N"] == n,
            "tiles": p["rows"] == 4 * 16 and (16 // tr) * (p["N"] // tc)
            == EMB_TILES and p["threads"] == EMB_THREADS,
            "built": p["cluster"] in EMB_BUILT}


def emb_w_layout(w1: torch.Tensor, w2: torch.Tensor, p: dict) -> torch.Tensor:
    """W1 and W2 [128, 384] as the plan's panels, [cluster][384][2][rows]:
    block ``panel`` reads W1^T's and W2^T's rows panel * rows ... side by
    side for each k."""
    w = torch.stack([w1, w2], 0).reshape(2, p["cluster"], p["rows"], EMB_K)
    return w.permute(1, 3, 0, 2).contiguous()


# -------------------------------------------------------------- the kernels
def _check_inputs(case: str, ins: list) -> None:
    for x, shape in zip(ins, SHAPES[case]):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{case}: input {tuple(x.shape)} {x.dtype}, "
                             f"expected f32 {shape}")


def launch(case: str, ins: list, reps: int) -> torch.Tensor:
    """The case's kernel (csrc/sections.cu) on CUDA tensors: the last carry
    in the script's layout."""
    if case.startswith("emb"):
        return launch_emb(case, ins, reps)[0]
    _check_inputs(case, ins)
    lib = probes.LIBRARY.load()
    if case == "render":
        # [OG, S R] -> the port's layout [OG, R, S]
        x0, z = (x.reshape(OG, S, R).transpose(1, 2).contiguous()
                 for x in ins[:2])
        rest = [x.contiguous() for x in ins[2:]]
        dev = probes.check_cuda(x0, z, *rest)
        out = torch.empty_like(x0)
        code = lib.vmap_probe_render(*(probes.ptr(x) for x in (x0, z, *rest)),
                                     probes.ptr(out), reps, probes.stream(dev))
        result = out.transpose(1, 2).reshape(OG, T)
    else:
        c0 = ins[0].contiguous()
        dev = probes.check_cuda(c0)
        out = torch.empty_like(c0)
        p = ladder_plan(mm.sm_count(dev))
        code = lib.vmap_probe_ladder(int(case == "ladder_sinpi"),
                                     probes.ptr(c0), probes.ptr(out),
                                     probes.plan_ints(p, probes.SPREAD_FIELDS),
                                     c0.numel(), reps, probes.stream(dev))
        result = out
    probes.LIBRARY.check(code, f"sections probe ({case}) launch")
    probes.LAUNCHES["sections"] += 1
    return result


def launch_emb(case: str, ins: list, reps: int) -> tuple:
    """An emb case's kernel on CUDA tensors, on the plan for this card:
    (the last carry [96, T], the last step's y rows 96-127 [32, T])."""
    _check_inputs(case, ins)
    if reps < 1:
        raise ValueError("an emb chain takes at least one step")
    c0 = ins[0].contiguous()
    dev = probes.check_cuda(c0, *ins[1:])
    p = emb_plan(mm.sm_count(dev))
    w = mm.cached("emb_w", list(ins[1:]), p,
                  lambda: emb_w_layout(ins[1], ins[2], p))
    out = torch.empty_like(c0)
    side = torch.empty(EMB_ROWS - BAND, T, device=dev)
    code = probes.LIBRARY.load().vmap_probe_emb(
        int(case == "emb_split"), probes.ptr(c0), probes.ptr(w),
        probes.ptr(out), probes.ptr(side), probes.plan_ints(p, EMB_PLAN_FIELDS),
        T, reps, probes.stream(dev))
    probes.LIBRARY.check(code, f"sections probe ({case}, emb plan {p}) "
                         "launch")
    probes.LAUNCHES["sections"] += 1
    return out, side


# the ladders' elements a lane (csrc/sections.cu LADDER_ITEMS)
LADDER_ITEMS = 2


def ladder_plan(sms: int = mm.N_SMS) -> dict:
    """The ladders' spread over ``sms`` SMs (``probes.spread_plan`` of the
    [96, T] carry, LADDER_ITEMS a lane): on 132 SMs one block an SM of 15
    warps (14 or 15 of them holding elements)."""
    return probes.spread_plan(96 * T, LADDER_ITEMS, sms)


# The fast paths of csrc/probe_common.cuh, each held bit for bit to its
# library function on every float of its range (csrc/sections.cu
# fast_check_kernel): (kind, the floats of the range, the functions)
FAST_CHECKS = {
    # both signs, exponent fields 1 ... 252 (rcp_fast_ok)
    "render reciprocal": (0, 2 * 252 * 2 ** 23, "__frcp_rn"),
    # both signs, |x| < 105615 (trig_fast_ok): 0x47CE4780 floats a sign
    "sin / cos": (1, 2 * 0x47CE4780, "sinf / cosf"),
    # 0 < a < 2^21 (sincospi_fast_ok): bit patterns 1 ... 0x4A000000 - 1
    "sinpi / cospi": (2, 0x4A000000 - 1, "sinpif / cospif"),
    # c > -87 (sigmoid_fast_ok): +0 ... +inf and -0 ... the float above -87
    "sigmoid reciprocal": (3, 0x7F800001 + 0x42AE0000, "__frcp_rn")}


def fast_check(name: str, dev: torch.device) -> dict:
    """One of FAST_CHECKS on the card: the fast path against its library
    function on every float, bit for bit, the card counting the floats
    its range test admits and the mismatches. Raises unless that count is
    the range's and no float differs; returns the check as ``compare``
    reports its cases, with both counts."""
    kind, floats, lib = FAST_CHECKS[name]
    count = torch.zeros(2, dtype=torch.int64, device=dev)
    code = probes.LIBRARY.load().vmap_probe_fast_check(
        kind, probes.ptr(count), mm.sm_count(dev), probes.stream(dev))
    probes.LIBRARY.check(code, f"{name} check launch")
    n, covered = count.tolist()
    res = {"case": name, "max_abs_err": 0.0, "max_rel_err": 0.0,
           "rtol": 0.0, "used": 0.0, "floats": covered, "mismatches": n}
    if covered != floats:
        raise AssertionError(f"{name}: the range test admitted {covered} "
                             f"floats, its range holds {floats}")
    if n:
        raise AssertionError(f"{name}: {n} of {covered} floats differ from "
                             f"{lib}")
    return res


def chain(case: str, ins: list, reps: int) -> torch.Tensor:
    """The chain: the plain version on CPU tensors, the kernel on CUDA."""
    if ins[0].device.type == "cpu":
        return chain_reference(case, ins, reps)
    return launch(case, ins, reps)


def measure(case: str, dev: torch.device) -> dict:
    ins = make_inputs(case, dev)
    sl = _timing.slope(lambda r: chain(case, ins, r), BASE_REPS,
                       4 * BASE_REPS, dev)
    return {"case": case, "reps": (BASE_REPS, 4 * BASE_REPS), **sl}


def bound(case: dict) -> dict:
    """A step's bound, counted from csrc/sections.cu: per render sample 35
    FP32 ops and 2 exp + 3 reciprocals; per emb column 2 x 2 x 128 x 384
    flops; per ladder element 2 sin / cos (ladder) or 12 (sinpi) and 34
    ops (22)."""
    fp, sfu = {
        "render": (35.0 * OG * T, 5.0 * OG * T),
        "emb_cat": (2 * 128 * 384 * T, 0.0),
        "emb_split": (2 * 128 * 384 * T, 0.0),
        "ladder": (34.0 * 96 * T, 2.0 * 96 * T),
        "ladder_sinpi": (22.0 * 96 * T, 12.0 * 96 * T)}[case["case"]]
    return probes.bound(max(fp / probes.PEAK_F32_OPS, sfu / probes.PEAK_SFU))


def plain_ms(case: dict, dev: torch.device) -> float:
    ins = make_inputs(case["case"], dev)
    return _timing.graph_step_ms(
        lambda r: chain_reference(case["case"], ins, r), dev)


def library_chain(ins: list):
    """The emb step as ``torch.matmul`` calls, a function of the steps:
    W1 @ emb and W2 @ emb on the concatenated bands (f32, TF32 off), the
    bands and the carry update in torch ops."""
    w1, w2 = ins[1], ins[2]

    def run(reps):
        c = ins[0] * 1.0001
        for _ in range(reps):
            emb = torch.cat([c, c * 0.5, c * 0.25, c * 0.125], 0)
            y = torch.matmul(w1, emb) + torch.matmul(w2, emb)
            c = c * KEEP["emb_cat"] + y[:96] * SECTION_SCALE
        return c
    return run


def library_ms(case: dict, dev: torch.device) -> float | None:
    """emb_cat / emb_split: ``torch.matmul`` a product (``library_chain``;
    both cases compute the same function, so they share it). None for
    render and the ladders: no single PyTorch call computes their
    sections (elementwise chains, row sums, sin / cos)."""
    if not case["case"].startswith("emb"):
        return None
    return _timing.graph_step_ms(
        library_chain(make_inputs(case["case"], dev)), dev)


def compare(dev: torch.device, reps: int = 3) -> list:
    """Every case's kernel against its plain version at ``reps`` steps
    (within ``tol``), and each emb / ladder section, read from one step of
    the kernel, against the plain section (within ``increment``'s bound
    plus SECTION_RTOL); first every fast path of csrc/probe_common.cuh
    (``FAST_CHECKS``: the reciprocals of the render and of K5's sigmoid,
    the sin / cos of the ladders and of K5's sincos; ``fast_check``);
    raises if one is outside."""
    res = [fast_check(name, dev) for name in FAST_CHECKS]
    for case in CASES:
        ins = make_inputs(case, dev)
        res.append(probes.held(case, launch(case, ins, reps),
                               chain_reference(case, ins, reps),
                               tol(case, reps)))
        if case in KEEP:
            c = ins[0] * 1.0001
            inc, atol = increment(case, c, launch(case, ins, 1))
            res.append(probes.held(f"{case} section", inc,
                                   section(case, ins, c), SECTION_RTOL, atol))
        if case.startswith("emb"):
            res.append(probes.held(f"{case} rows 96-127",
                                   launch_emb(case, ins, reps)[1],
                                   side_reference(case, ins, reps),
                                   tol(case, reps)))
    return res


LINES = {"render": "render section (full render_bwd replica)",
         "emb_cat": "emb concat + 2 matmuls",
         "emb_split": "emb split (8 banded matmuls, no concat)",
         "ladder": f"ladder (sin+cos + 5 levels + 11 adds) [96,{T}]",
         "ladder_sinpi": f"  the port's sinpif / cospif per band [96,{T}]"}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", help=f"any of {CASES} (default all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; choose from {CASES}")
    dev = probes.device_from_arg(args.device)
    print(f"device: {_timing.device_label(dev)}", flush=True)
    out = []
    for case in args.cases or CASES:
        r = measure(case, dev)
        print(f"{LINES[case]}: {r['step_ns']:.0f} ns", flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
