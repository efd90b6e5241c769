"""K5: the per-op cost model of K1's sections, each op chained in one launch.

Counterpart of ``scripts/microbench_ops.py::_one`` and its bodies
(``:92-170``). Each case runs ``reps`` dependent steps c <- body(c) from
c = x0 1.0001 on the script's shapes and draws (each input from its own
default_rng(0), uniform [0.25, 0.75), f32; T = 1280 = 10 tiles of 128):

  * ``dep_fma`` c x + x and ``ind_fma`` (8 independent c (1 + 0.01 k) + x,
    summed in order, / 8) on [8, T]: dependent against independent FMAs,
    latency against issue;
  * ``sigmoid`` on [8, T] and ``sincos`` sin(c) + cos(c / 2) on [96, T];
  * ``lanesum_dot``: y = c @ m, [8, T] x [T, 128], c <- y's column 0
    broadcast; ``strided_sum``: c <- c + 1e-6 (the sum of c's 10 column
    tiles) in every tile;
  * ``fwd_mm`` / ``fwd_mm_bf16``: y = w @ c, [128, 384] x [384, T] (f32, or
    both operands rounded to bf16 with f32 sums), c <- concat(y, y, y)
    0.33333, on K4's chain kernel (``probes.mm``: its fold is the concat);
  * ``serial_tiles``: c <- 0.999 c + 1e-6 cp, cp the running product over
    the tiles (cp_0 = 1).

Every product the script's kernel computes is computed in full. Where the
carry cannot see a case's work, the kernel also writes the last step's
work to a side output: lanesum_dot's whole [8, 128] product (its carry
keeps column 0 only), strided_sum's sum of tiles and serial_tiles' running
products (1e-6 of the carry a step). ``compare`` holds, at 3 steps and
elementwise, the carry, the side output, and for strided_sum /
serial_tiles the work read back from one kernel step as
``probes.increment`` reads it ((out - KEEP c) / 1e-6, KEEP = 1 and 0.999).

lanesum_dot runs on one thread-block cluster whose blocks each keep a
panel of m's rows in shared memory for the whole chain
(``lanesum_plan``): a block's warps split its panel's rows and sum them by
FMA in row order, the warps' partials are added in warp order, and the
blocks' in block order (``lanesum_y_cluster`` mirrors that order on the
CPU; the tests hold it to the plain chain). Every step computes all of y.

dep_fma, ind_fma, sigmoid and sincos go round one block an SM in whole
warps (``ew_plan``, ``probes.spread_plan``). ind_fma adds its 8 terms as a
3-level tree (``ind_fma_tree`` mirrors that order); sigmoid's reciprocal
and sincos' sin / cos take the accurate functions' own fast paths without
their slow-path branches (csrc/probe_common.cuh; ``sections.fast_check``
holds them to the library functions bit for bit).

Values leave f32 range in lanesum_dot (about 640x a step, within about 13
steps) and fwd_mm (about 64x, within 21): at the script's 500 steps both
time arithmetic on inf, as the TPU's kernel did. dep_fma and sigmoid tend
to fixed points. So the kernels are held at a few steps and timed at the
script's reps (the slope between reps and 4 reps, ns a step).
``dep_fma`` against ``ind_fma`` is the script's question (is an FMA's
cost its latency or its issue?); that pair is timed ``RUNS`` times, and
its spread printed beside the difference.

    python -m vmap_tpu_torch.probes.ops [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from vmap_tpu_torch import probes
from vmap_tpu_torch.probes import _timing, mm

T, TILE = 1280, 128
NT = T // TILE
# the script's cases (its main's default list), their shapes and reps
CASES = ("dep_fma", "ind_fma", "sigmoid", "sincos", "lanesum_dot",
         "strided_sum", "fwd_mm", "fwd_mm_bf16", "serial_tiles")
SHAPES = {"dep_fma": ((8, T),), "ind_fma": ((8, T),),
          "sigmoid": ((8, T),), "sincos": ((96, T),),
          "lanesum_dot": ((8, T), (T, TILE)), "strided_sum": ((8, T),),
          "fwd_mm": ((384, T), (128, 384)),
          "fwd_mm_bf16": ((384, T), (128, 384)), "serial_tiles": ((8, T),)}
REPS = {"dep_fma": 4000, "ind_fma": 500, "sigmoid": 1000, "sincos": 500,
        "lanesum_dot": 500, "strided_sum": 1000, "fwd_mm": 500,
        "fwd_mm_bf16": 500, "serial_tiles": 1000}
# the case number of csrc/ops.cu vmap_probe_ew (0-3) / vmap_probe_ops
# (5, 6) (lanesum_dot: vmap_probe_lanesum; fwd_mm*: mm.cu)
KASE = {"dep_fma": 0, "ind_fma": 1, "sigmoid": 2, "sincos": 3,
        "strided_sum": 5, "serial_tiles": 6}
# the elementwise cases' elements a lane (csrc/ops.cu ew_items)
EW_ITEMS = {"dep_fma": 1, "ind_fma": 1, "sigmoid": 1, "sincos": 2}
# operations a step the script's ns/op divides by
OPS_PER_STEP = {"ind_fma": 16}
# c <- KEEP c + WORK_SCALE work
KEEP = {"strided_sum": 1.0, "serial_tiles": 0.999}
WORK_SCALE = 1e-6
MM_SCALE = 0.33333
RTOL = 1e-5           # a step, every f32 case (fwd_mm: mm.tol)
RUNS = 5              # timings of the dep_fma / ind_fma pair
PAIR = ("dep_fma", "ind_fma")
ROWS = 8              # rows of the carry of lanesum_dot and the tile cases

# lanesum_dot's plan: csrc/ops.cu LsPlan, in the order the launcher reads
# it; the cluster sizes the kernel is built for (portable, largest first)
# and its warps a block
LANESUM_PLAN_FIELDS = ("cluster", "rows", "warps")
LANESUM_BUILT = (8, 4)
LANESUM_WARPS = 8


def make_inputs(case: str, dev) -> list:
    """The script's inputs: each array from its own default_rng(0),
    uniform [0.25, 0.75), f32."""
    return [torch.tensor(np.random.default_rng(0).random(s) * 0.5 + 0.25,
                         dtype=torch.float32).to(dev)
            for s in SHAPES[case]]


def _variant(case: str) -> str:
    return "bf16" if case == "fwd_mm_bf16" else "f32"


def mm_operands(case: str, ins: list) -> dict:
    """fwd_mm's loop-invariant copies of w (``mm.operands``, one product)."""
    return mm.operands(ins[1], _variant(case), 1)


def via_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) taken in f64 and rounded once to f32: the correctly rounded
    value, on every device and thread count. torch's multithreaded f32
    sin / cos on the CPU were seen to return values 7.5e-5 off on part of
    a [96, 1280] array in some processes, none importing jax (cause not
    found), so the value a kernel is held to is not taken from them."""
    return fn(x.double()).float()


def _tiles(c: torch.Tensor) -> list:
    return [c[:, s * TILE:(s + 1) * TILE] for s in range(NT)]


def step_reference(case: str, ins: list, c: torch.Tensor,
                   exact: bool = True) -> tuple:
    """One step of the script's body: (the next carry, the step's work
    where the carry cannot see it, else None). ``exact`` (the value the
    kernels are held to): sigmoid, sin and cos taken in f64 and rounded
    once (``via_f64``); otherwise torch's f32 functions (the plain chain
    that is timed)."""
    x = ins[0]
    f32 = via_f64 if exact else (lambda fn, v: fn(v))
    if case == "dep_fma":
        return c * x + x, None
    if case == "ind_fma":
        outs = [c * np.float32(1.0 + 0.01 * k) + x for k in range(8)]
        s = outs[0]
        for o in outs[1:]:
            s = s + o
        return s * 0.125, None
    if case == "sigmoid":
        return f32(torch.sigmoid, c), None
    if case == "sincos":
        return f32(torch.sin, c) + f32(torch.cos, c * 0.5), None
    if case == "lanesum_dot":
        y = c @ ins[1]
        return y[:, :1].expand_as(c).contiguous(), y
    if case == "strided_sum":
        tiles = _tiles(c)
        acc = tiles[0]
        for t in tiles[1:]:
            acc = acc + t
        return c + torch.cat([acc] * NT, 1) * WORK_SCALE, acc
    if case == "serial_tiles":
        cp = torch.ones_like(c[:, :TILE])
        outs = []
        for t in _tiles(c):
            outs.append(cp)
            cp = cp * t
        work = torch.cat(outs, 1)
        return c * KEEP[case] + work * WORK_SCALE, work
    return mm.chain_reference(mm_operands(case, ins), c, _variant(case), 1,
                              MM_SCALE), None


def ew_plan(case: str, sms: int = mm.N_SMS) -> dict:
    """An elementwise case's spread over ``sms`` SMs
    (``probes.spread_plan`` of its carry, EW_ITEMS[case] a lane): on 132
    SMs, one block an SM, of 3 warps (dep_fma, ind_fma, sigmoid: 320 warps
    of one element a lane, at most one a scheduler) or 15 (sincos)."""
    return probes.spread_plan(SHAPES[case][0][0] * T, EW_ITEMS[case], sms)


# ---------------------------------------------------------- lanesum_dot
def lanesum_smem_bytes(p: dict) -> int:
    """One block's dynamic shared memory (csrc/ops.cu ls_smem): m's panel,
    c's K-slice of all 8 rows, the warps' partials of y, what the blocks
    send it by step parity (its slice of y's columns and column 0 from
    every block), three mbarriers."""
    return 4 * (p["rows"] * TILE + p["rows"] * ROWS
                + p["warps"] * ROWS * TILE + 2 * ROWS * TILE
                + 2 * p["cluster"] * ROWS) + 3 * 8


def lanesum_plan(sms: int = mm.N_SMS) -> dict:
    """lanesum_dot's plan for ``sms`` SMs (csrc/ops.cu LsPlan, checked
    there by ls_plan_ok): m's 640 KB fit no SM, so its T rows are cut into
    ``cluster`` panels of ``rows``, one a block of one thread-block
    cluster, each resident in its block's shared memory for the whole
    chain; ``warps`` warps a block split a panel's rows. The largest built
    cluster that the card's SMs hold and whose panel fits is taken (8: 160
    rows, 80 KB of m). Raises where none fits."""
    for cluster in LANESUM_BUILT:
        p = {"cluster": cluster, "rows": T // cluster,
             "warps": LANESUM_WARPS}
        if all(lanesum_plan_checks(p, sms).values()):
            return p
    raise ValueError(f"no lanesum_dot plan fits {sms} SMs")


def lanesum_plan_checks(p: dict, sms: int = mm.N_SMS) -> dict:
    """The limits a lanesum_dot plan must meet: a block's shared memory,
    the cluster's blocks all resident (one an SM), the panels covering m's
    rows once, the panel split evenly over the block's 8 warps (whose
    lanes, 4 columns each, span y's 128), enough threads for the block's
    slice of y's columns (8 rows x 128 / cluster), a cluster size
    built."""
    rows = [0] * T
    for b in range(p["cluster"]):
        for k in range(p["rows"]):
            if b * p["rows"] + k < T:
                rows[b * p["rows"] + k] += 1
    return {"fits": lanesum_smem_bytes(p) <= mm.BLOCK_SMEM,
            "resident": p["cluster"] <= sms,
            "rows_once": rows == [1] * T and p["cluster"] * p["rows"] == T,
            "warps": p["warps"] == LANESUM_WARPS
            and p["rows"] % p["warps"] == 0,
            "slice": TILE % p["cluster"] == 0
            and ROWS * (TILE // p["cluster"]) <= 32 * p["warps"],
            "built": p["cluster"] in LANESUM_BUILT}


def lanesum_m_layout(m: torch.Tensor, p: dict) -> torch.Tensor:
    """m [T, 128] as the plan's panels, [cluster][rows][128]: block b
    reads row k of its panel (m's row b rows + k) as 128 consecutive
    floats, lane l its columns 4 l ... 4 l + 3, so the panels are m's own
    rows in m's own order (a view)."""
    return m.reshape(p["cluster"], p["rows"], TILE)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once to f32 (in f64, where a b of two f32 is exact;
    the sum's rounding to f64 first may differ from FMA's in the last bit)."""
    return (a.double() * b.double() + c.double()).float()


def ind_fma_tree(ins: list, c: torch.Tensor) -> torch.Tensor:
    """ind_fma's step in csrc/ops.cu ew_step<1>'s order, for tests: the 8
    terms c (1 + 0.01 k) + x each one FMA (one rounding), added as the
    tree ((t0 + t1) + (t2 + t3)) + ((t4 + t5) + (t6 + t7)), then / 8."""
    t = [_fma(c, torch.full_like(c, float(np.float32(1.0 + 0.01 * k))),
              ins[0]) for k in range(8)]
    return (((t[0] + t[1]) + (t[2] + t[3]))
            + ((t[4] + t[5]) + (t[6] + t[7]))) * 0.125


def lanesum_y_cluster(c: torch.Tensor, m: torch.Tensor, p: dict) -> torch.Tensor:
    """y = c @ m in csrc/ops.cu lanesum_kernel's order, for tests: warp w
    of block b sums its rows k of m (b rows + w rows / warps ...) in k
    order by FMA from 0; a block adds its warps' partials in warp order,
    y is the blocks' partials added in block order."""
    cl, w = p["cluster"], p["warps"]
    kw = p["rows"] // w
    cc = c.reshape(ROWS, cl, w, kw)
    mw = m.reshape(cl, w, kw, TILE)
    acc = torch.zeros(ROWS, cl, w, TILE)
    for k in range(kw):
        acc = _fma(cc[..., k, None], mw[None, :, :, k], acc)
    blocks = acc[:, :, 0]
    for i in range(1, w):
        blocks = blocks + acc[:, :, i]
    y = blocks[:, 0]
    for b in range(1, cl):
        y = y + blocks[:, b]
    return y


def increment_of(case: str, work: torch.Tensor) -> torch.Tensor:
    """The increment (over WORK_SCALE) a strided_sum / serial_tiles step
    adds to the carry, from the step's work."""
    return torch.cat([work] * NT, 1) if case == "strided_sum" else work


def chain_reference(case: str, ins: list, reps: int,
                    exact: bool = True) -> tuple:
    """Plain version: (the last carry, the last step's work or None), from
    c0 = x0 1.0001 (``exact``: as ``step_reference``)."""
    c, work = ins[0] * 1.0001, None
    if case.startswith("fwd_mm"):
        return mm.chain_reference(mm_operands(case, ins), c, _variant(case),
                                  reps, MM_SCALE), None
    for _ in range(reps):
        c, work = step_reference(case, ins, c, exact)
    return c, work


def launch(case: str, ins: list, reps: int) -> tuple:
    """The case's kernel on CUDA tensors (csrc/ops.cu; fwd_mm* mm.cu):
    (the last carry, the side output or None)."""
    for t, shape in zip(ins, SHAPES[case]):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{case}: input {tuple(t.shape)} {t.dtype}, "
                             f"expected f32 {shape}")
    if case.startswith("fwd_mm"):
        key = {"case": case}
        w_ops = mm.cached("ops", [ins[1]], key, lambda: mm_operands(case, ins))
        c0 = mm.cached("c0", [ins[0]], key, lambda: ins[0] * 1.0001)
        out = mm.launch(w_ops, c0, _variant(case), reps, MM_SCALE,
                        mm.SCRIPT_NB, counter="ops")
        return out, None
    if case == "lanesum_dot":
        return _launch_lanesum(ins, reps)
    x = ins[0].contiguous()
    dev = probes.check_cuda(x)
    out = torch.empty_like(x)
    if case in EW_ITEMS:
        p = ew_plan(case, mm.sm_count(dev))
        code = probes.LIBRARY.load().vmap_probe_ew(
            KASE[case], probes.ptr(x), probes.ptr(out),
            probes.plan_ints(p, probes.SPREAD_FIELDS), x.numel(), reps,
            probes.stream(dev))
        side = None
    else:
        side = torch.empty((ROWS, TILE) if case == "strided_sum"
                           else (ROWS, T), device=dev)
        code = probes.LIBRARY.load().vmap_probe_ops(
            KASE[case], probes.ptr(x), probes.ptr(out), probes.ptr(side),
            x.shape[0], reps, probes.stream(dev))
    probes.LIBRARY.check(code, f"ops probe ({case}) launch")
    probes.LAUNCHES["ops"] += 1
    return out, side


def _launch_lanesum(ins: list, reps: int) -> tuple:
    """lanesum_dot's kernel on CUDA tensors, on the plan for this card:
    (the last carry [8, T], the last step's y [8, 128])."""
    if reps < 1:
        raise ValueError("a lanesum_dot chain takes at least one step")
    x = ins[0].contiguous()
    dev = probes.check_cuda(x, ins[1])
    p = lanesum_plan(mm.sm_count(dev))
    m = lanesum_m_layout(ins[1], p)
    out = torch.empty_like(x)
    side = torch.empty(ROWS, TILE, device=dev)
    ints = (ctypes.c_int * len(LANESUM_PLAN_FIELDS))(
        *(p[f] for f in LANESUM_PLAN_FIELDS))
    code = probes.LIBRARY.load().vmap_probe_lanesum(
        probes.ptr(x), probes.ptr(m), probes.ptr(out), probes.ptr(side),
        ctypes.cast(ints, ctypes.c_void_p), reps, probes.stream(dev))
    probes.LIBRARY.check(code, f"ops probe (lanesum_dot, plan {p}) launch")
    probes.LAUNCHES["ops"] += 1
    return out, side


def chain(case: str, ins: list, reps: int) -> tuple:
    """The chain: the plain version on CPU tensors, the kernel on CUDA."""
    if ins[0].device.type == "cpu":
        return chain_reference(case, ins, reps)
    return launch(case, ins, reps)


def tol(case: str, reps: int) -> float:
    """rtol of the carry and the side output: 1e-5 a step (FMA against
    separate roundings, accurate expf / sinf / cosf against torch's, sums
    in another order); fwd_mm as K4 (``mm.tol``)."""
    if case.startswith("fwd_mm"):
        return mm.tol(_variant(case), reps)
    return RTOL * reps


def compare(dev: torch.device, reps: int = 3) -> list:
    """Every case's kernel against its plain version at ``reps`` steps:
    the whole last carry and side output within ``tol``; for strided_sum /
    serial_tiles also the work read from one kernel step (within
    ``probes.increment``'s bound plus rtol 1e-5). Raises if one is
    outside; returns the errors."""
    res = []
    for case in CASES:
        ins = make_inputs(case, dev)
        got, got_w = launch(case, ins, reps)
        want, want_w = chain_reference(case, ins, reps)
        res.append(probes.held(case, got, want, tol(case, reps)))
        if want_w is not None:
            res.append(probes.held(f"{case} side", got_w, want_w,
                                   tol(case, reps)))
        if case in KEEP:
            c0 = ins[0] * 1.0001
            inc, atol = probes.increment(KEEP[case], WORK_SCALE, c0,
                                         launch(case, ins, 1)[0])
            want_inc = increment_of(case, step_reference(case, ins, c0)[1])
            res.append(probes.held(f"{case} increment", inc, want_inc, RTOL,
                                   atol))
    return res


def bound(case: dict) -> dict:
    """A step's bound: FP32 instructions and SFU results of the
    elementwise cases (ind_fma 8 FMAs, 7 adds, 1 mul an element;
    strided_sum 9 adds and 10 FMAs, serial_tiles 9 muls, 10 muls and 10
    FMAs per column-mod-128 group of a row, 1024 groups; sincos sin, cos
    and 2 FP32 ops), the products' flops over FP32's or bf16's peak."""
    n8, n96 = 8 * T, 96 * T
    fp, sfu, mma = {
        "dep_fma": (n8, 0, 0), "ind_fma": (16 * n8, 0, 0),
        "sigmoid": (0, 2 * n8, 0), "sincos": (2 * n96, 2 * n96, 0),
        "lanesum_dot": (0, 0, 2.0 * 8 * T * TILE),
        "strided_sum": (19 * 1024, 0, 0),
        "serial_tiles": (29 * 1024, 0, 0),
        "fwd_mm": (0, 0, 2.0 * 128 * 384 * T),
        "fwd_mm_bf16": (0, 0, 2.0 * 128 * 384 * T)}[case["case"]]
    peak = (probes.PEAK_BF16 if case["case"] == "fwd_mm_bf16"
            else probes.PEAK_F32)
    return probes.bound(max(fp / probes.PEAK_F32_OPS, sfu / probes.PEAK_SFU,
                            mma / peak))


def plain_ms(case: dict, dev: torch.device) -> float:
    """The plain chain (``exact`` off: torch's f32 sigmoid / sin / cos) a
    step."""
    ins = make_inputs(case["case"], dev)
    return _timing.graph_step_ms(
        lambda r: chain_reference(case["case"], ins, r, exact=False)[0], dev)


def library_chain(case: str, ins: list):
    """The chain of one PyTorch call a step, a function of the steps:
    ``torch.addcmul`` (dep_fma: x + c x, one FMA as the kernel's),
    ``torch.sigmoid`` (sigmoid) or ``torch.matmul`` (lanesum_dot; fwd_mm
    on f32 or bf16 operands, TF32 off). None for the others: no single
    call computes their step."""
    if case not in ("dep_fma", "sigmoid", "lanesum_dot", "fwd_mm",
                    "fwd_mm_bf16"):
        return None
    dt = torch.bfloat16 if case == "fwd_mm_bf16" else torch.float32
    x, w = ins[0], ins[-1].to(dt)

    def run(reps):
        c = (x * 1.0001).to(dt)
        for _ in range(reps):
            if case == "dep_fma":
                c = torch.addcmul(x, c, x)
            elif case == "sigmoid":
                c = torch.sigmoid(c)
            elif case == "lanesum_dot":
                c = torch.matmul(c, w)[:, :1].expand(8, T)
            else:
                c = mm.fold(torch.matmul(w, c), 384, MM_SCALE)
        return c
    return run


def library_ms(case: dict, dev: torch.device) -> float | None:
    """``library_chain``'s time a step, None where it has none."""
    run = library_chain(case["case"], make_inputs(case["case"], dev))
    return None if run is None else _timing.graph_step_ms(run, dev)


def measure(case: str, dev: torch.device) -> dict:
    ins = make_inputs(case, dev)
    reps = REPS[case]
    sl = _timing.slope(lambda r: chain(case, ins, r), reps, 4 * reps, dev)
    return {"case": case, "reps": (reps, 4 * reps), **sl,
            "ns_per_op": sl["step_ns"] / OPS_PER_STEP.get(case, 1)}


def _pair(dev: torch.device) -> dict:
    """dep_fma and ind_fma, each timed RUNS times in turns: the median run
    of each, with every run's slope."""
    runs = {case: [] for case in PAIR}
    for _ in range(RUNS):
        for case in PAIR:
            runs[case].append(measure(case, dev))
    out = {}
    for case, rs in runs.items():
        rs = sorted(rs, key=lambda r: r["step_ns"])
        out[case] = {**rs[len(rs) // 2],
                     "ns_per_op_runs": [r["ns_per_op"] for r in rs]}
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = probes.device_from_arg(args.device)
    print(f"device: {_timing.device_label(dev)}", flush=True)
    pair = _pair(dev)
    out = []
    for case in CASES:
        r = pair.get(case) or measure(case, dev)
        spread = ""
        if "ns_per_op_runs" in r:
            each = r["ns_per_op_runs"]
            spread = (f" (median of {len(each)}, runs {min(each):.3f}-"
                      f"{max(each):.3f})")
        print(f"{case} {'x'.join(map(str, SHAPES[case][0]))}: "
              f"{r['step_ns']:.1f} ns a step, {r['ns_per_op']:.3f} ns/op"
              f"{spread}", flush=True)
        out.append(r)
    dep, ind = (pair[c]["ns_per_op_runs"] for c in PAIR)
    gap = float(np.median(dep) - np.median(ind))
    noise = max(max(dep) - min(dep), max(ind) - min(ind))
    verdict = "exceeds" if abs(gap) > noise else "is within"
    print(f"dep_fma - ind_fma: {gap:.3f} ns/op, which {verdict} the larger "
          f"spread of the {RUNS} runs ({noise:.3f})", flush=True)
    return out


if __name__ == "__main__":
    main()
