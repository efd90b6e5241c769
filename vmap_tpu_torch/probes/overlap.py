"""K8: does FMA work hide tensor-core work inside one kernel?

Counterpart of ``scripts/microbench_overlap.py::_run``. Two independent
chains, stepped ``reps`` times in one launch:

  * vpu: 24 dependent elementwise ops on v [8, T] (``vpu_step``: v a + b,
    |v| + 1e-3, max(0.99 v, 0.5 b), v - sign(v) 1e-4, v (1 - 1e-3 v),
    v + 1e-3 a, four times), on the FMA pipe, each op rounded as the
    script's (no contraction into fused multiply-adds);
  * mxu: two dependent products c <- (W1 @ c) 1e-2, c <- (W2 @ c) 1e-2,
    [128, 128] x [128, T], on the tensor cores: ``wgmma`` m64n16k16 bf16
    with f32 accumulation and the 3xbf16 split of both operands, so it
    still computes the f32 product (a chain of FP32 FMA products would
    share the FMA pipe with the vpu chain and show no overlap by
    construction). W1's and W2's hi / lo pieces stay in shared memory in
    ``wgmma``'s K-major layout (``w_layout``); each product's fold writes
    the carry's hi / lo pieces straight into that layout;
  * both: each step advances both chains in the same warps, emitted as the
    script's kernel emits them (3 vpu ops, product 1, the other 21 ops,
    product 2), the vpu ops between a product's ``wgmma.commit_group`` and
    its ``wgmma.wait_group``: they run while the products are in flight.

Modes ``vpu``, ``mxu``, ``both``; overlap = (vpu + mxu - both) /
min(vpu, mxu) from the slopes between 200 and 600 steps (1: the smaller
chain hidden, 0: serial). On the H100 the script's vpu chain takes about
1/10 of the mxu chain's step, so that fraction divides the slopes' noise
by a small time. The balanced case, not in the script, runs the vpu
chain for ``BAL_ROUNDS`` = 27 x 4 rounds a step (``vpu_bal``), of the
order of the mxu chain's time, and ``both_bal`` places half of them
inside each product; its overlap is (vpu_bal + mxu - both_bal) /
min(vpu_bal, mxu). Every mode is timed ``RUNS`` times, and each run's
fractions are printed with their median. A block owns ``plan`` columns
of both chains (16: 80 blocks at T = 1280, one an SM); W's and the first
carry's pieces are laid out here, outside the chain.

The mxu chain decays by about 0.004 a step (to 0 within tens of steps), so
the kernel is held against its plain version at a few steps and timed at
the script's.

    python -m vmap_tpu_torch.probes.overlap [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vmap_tpu_torch import probes
from vmap_tpu_torch.probes import _timing, mm

T = 1280
MODES = ("vpu", "mxu", "both", "vpu_bal", "both_bal")
MODE_CODE = {m: i for i, m in enumerate(MODES)}
BAL_ROUNDS = 108
# vpu rounds a step (4: the script's vpu_step)
ROUNDS = {"vpu": 4, "mxu": 0, "both": 4, "vpu_bal": BAL_ROUNDS,
          "both_bal": BAL_ROUNDS}
R1, R2 = 200, 600
RUNS = 5


def tol(reps: int) -> float:
    """rtol 1e-5 a step: the vpu chain rounds as the plain version, the
    3xbf16 products against the plain f32 ones."""
    return 1e-5 * reps


def make_inputs(dev) -> dict:
    """The script's draws (one default_rng(7)): a, b [8, T] in [0.25,
    0.75), W1, W2 [128, 128] in [0, 0.1), c [128, T] in [0, 0.5); f32."""
    rng = np.random.default_rng(7)
    draws = {"a": rng.random((8, T)) * 0.5 + 0.25,
             "b": rng.random((8, T)) * 0.5 + 0.25,
             "w1": rng.random((128, 128)) * 0.1,
             "w2": rng.random((128, 128)) * 0.1,
             "c": rng.random((128, T)) * 0.5}
    out = {k: torch.tensor(v, dtype=torch.float32).to(dev)
           for k, v in draws.items()}
    for w in ("w1", "w2"):                     # the kernel's 3xbf16 copies
        hi = out[w].to(torch.bfloat16)
        out[w + "_hi"] = hi
        out[w + "_lo"] = (out[w] - hi.float()).to(torch.bfloat16)
    return out


def vpu_round(v, a, b):
    """One of the four rounds of the script's ``vpu_step``."""
    v = v * a + b
    v = torch.abs(v) + 1e-3
    v = torch.maximum(v * 0.99, b * 0.5)
    v = v - torch.sign(v) * 1e-4
    v = v * (1.0 - v * 1e-3)
    return v + a * 1e-3


def chain_reference(x: dict, mode: str, reps: int) -> tuple:
    """Plain version: (v, c) after ``reps`` steps from v = 1.0001 a,
    c = 1.0001 c0."""
    v, c = x["a"] * 1.0001, x["c"] * 1.0001
    for _ in range(reps):
        for _ in range(ROUNDS[mode]):
            v = vpu_round(v, x["a"], x["b"])
        if mode in ("mxu", "both", "both_bal"):
            c = (x["w1"] @ c) * 1e-2
            c = (x["w2"] @ c) * 1e-2
    return v, c


def plan(sms: int = mm.N_SMS, n: int = T) -> int:
    """The columns a block owns: the narrowest slab (a multiple of 8,
    wgmma's n step) that keeps the blocks within one an SM. The kernel is
    built for 16 (one element of v a thread, one warpgroup); its launcher
    refuses another."""
    for nb in range(8, n + 1, 8):
        if n % nb == 0 and n // nb <= sms:
            return nb
    raise ValueError(f"no slab of {n} columns fits {sms} SMs")


def _block_plan(nb: int) -> dict:
    """mm's block plan for [128, 128] x [128, T] at ``nb`` columns a block:
    W whole and resident, the slab's carry of depth 128."""
    return {"grid": 0, "rows": 128, "panels": 1, "slabs": T // nb, "N": nb,
            "ncols": nb, "k": 128, "w_resident": 1}


def w_layout(x: dict) -> torch.Tensor:
    """W1 hi, W1 lo, W2 hi, W2 lo, each [128, 128] bf16 as one piece in
    wgmma's no-swizzle K-major layout (``mm.w_layout``: chain.cuh tc_off):
    [4, 128 x 128]."""
    p = _block_plan(16)
    return torch.cat([mm.w_layout([x[f"{w}_hi"], x[f"{w}_lo"]], p)
                      .reshape(2, -1) for w in ("w1", "w2")]).contiguous()


def carry_layout(c: torch.Tensor, nb: int) -> torch.Tensor:
    """The initial carry c [128, T] (f32) as the kernel's B operand: a
    slab's hi and lo pieces [nb x 128] bf16 in the K-major layout
    (``mm.carry_layout``), [T / nb, 2, nb x 128]."""
    return mm.carry_layout(c, _block_plan(nb), "f32_3xbf16").reshape(
        T // nb, 2, nb * 128)


def launch(x: dict, mode: str, reps: int) -> tuple:
    """The kernel (csrc/overlap.cu) on CUDA tensors, on the slab for this
    card: (v, c)."""
    names = ("a", "b", "w1_hi", "w1_lo", "w2_hi", "w2_lo", "c")
    ops = [x[k].contiguous() for k in names]
    shapes = ((8, T), (8, T)) + ((128, 128),) * 4 + ((128, T),)
    if any(tuple(t.shape) != s for t, s in zip(ops, shapes)):
        raise ValueError("overlap probe: a, b [8, 1280], W hi / lo "
                         "[128, 128], c [128, 1280]")
    if reps < 1:
        raise ValueError("the overlap chains take at least one step")
    dev = probes.check_cuda(*ops)
    nb = plan(mm.sm_count(dev))
    w = mm.cached("overlap_w", ops[2:6], {}, lambda: w_layout(x))
    cl = mm.cached("overlap_c", ops[6:], {"nb": nb},
                   lambda: carry_layout(ops[6] * 1.0001, nb))
    v = torch.empty_like(x["a"])
    c = torch.empty_like(x["c"])
    code = probes.LIBRARY.load().vmap_probe_overlap(
        MODE_CODE[mode], *(probes.ptr(t) for t in (ops[0], ops[1], w, cl,
                                                   ops[6], v, c)),
        T, nb, reps, probes.stream(dev))
    probes.LIBRARY.check(code, f"overlap probe ({mode}, {nb} columns a "
                         "block) launch")
    probes.LAUNCHES["overlap"] += 1
    return v, c


def chain(x: dict, mode: str, reps: int) -> tuple:
    """The chains: the plain version on CPU tensors, the kernel on CUDA."""
    if x["a"].device.type == "cpu":
        return chain_reference(x, mode, reps)
    return launch(x, mode, reps)


def overlap_fraction(slopes: dict, balanced: bool = False) -> float:
    """The script's fraction from the slopes of one run (``balanced``: of
    vpu_bal, mxu and both_bal)."""
    vpu, both = ("vpu_bal", "both_bal") if balanced else ("vpu", "both")
    return ((slopes[vpu] + slopes["mxu"] - slopes[both])
            / min(slopes[vpu], slopes["mxu"]))


def bound(case: dict) -> dict:
    """A step's bound: 14 FP32 operations a vpu round on [8, T]; the two
    3xbf16 products."""
    mode = case["case"]
    vpu = 8 * T * 14 * ROUNDS[mode] / probes.PEAK_F32_OPS
    mxu = (2 * 3 * 2.0 * 128 * 128 * T / probes.PEAK_BF16
           if mode in ("mxu", "both", "both_bal") else 0.0)
    return probes.bound(max(vpu, mxu))


def plain_ms(case: dict, dev: torch.device) -> float:
    x = make_inputs(dev)
    return _timing.graph_step_ms(
        lambda r: chain_reference(x, case["case"], r), dev)


def library_chain(x: dict):
    """mxu's chain as ``torch.matmul`` calls, a function of the steps: two
    products a step, each times 1e-2 (f32, TF32 off)."""
    def run(reps):
        c = x["c"] * 1.0001
        for _ in range(reps):
            c = torch.matmul(x["w1"], c) * 1e-2
            c = torch.matmul(x["w2"], c) * 1e-2
        return c
    return run


def library_ms(case: dict, dev: torch.device) -> float | None:
    """mxu: ``torch.matmul`` a product (``library_chain``). None for vpu,
    vpu_bal (a chain of elementwise ops: no single call computes a round)
    and both, both_bal (no single call computes both chains)."""
    if case["case"] != "mxu":
        return None
    return _timing.graph_step_ms(library_chain(make_inputs(dev)), dev)


def compare(dev: torch.device, reps: int = 3) -> list:
    """Each mode's kernel against its plain version at ``reps`` steps (both
    chains' last values); raises if one is outside ``tol``."""
    x = make_inputs(dev)
    res = []
    for mode in MODES:
        got = launch(x, mode, reps)
        want = chain_reference(x, mode, reps)
        for name, g, w in zip(("v", "c"), got, want):
            res.append(probes.held(f"{mode} {name}", g, w, tol(reps)))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = probes.device_from_arg(args.device)
    print(f"device: {_timing.device_label(dev)}", flush=True)
    x = make_inputs(dev)
    runs = []
    for run in range(RUNS):
        res = {}
        for mode in MODES:
            sl = _timing.slope(lambda r: chain(x, mode, r), R1, R2, dev)
            res[mode] = sl
            print(f"run {run} {mode:8s}: {sl['t1_ms']:7.3f} ms @{R1}  "
                  f"{sl['t2_ms']:7.3f} ms @{R2}  slope "
                  f"{sl['step_ns'] / 1e3:7.3f} us/step", flush=True)
        ns = {m: r["step_ns"] for m, r in res.items()}
        runs.append({"modes": res, "overlap": overlap_fraction(ns),
                     "overlap_bal": overlap_fraction(ns, balanced=True)})
    out = {"modes": {m: {"step_ns": float(np.median(
        [r["modes"][m]["step_ns"] for r in runs])), "step_ns_runs": [
            r["modes"][m]["step_ns"] for r in runs]} for m in MODES}}
    for key, what in (("overlap", "script's case, vpu 4 rounds"),
                      ("overlap_bal", f"balanced, vpu {BAL_ROUNDS} rounds")):
        each = [r[key] for r in runs]
        out[key], out[key + "_runs"] = float(np.median(each)), each
        print(f"overlap fraction ({what}): median {out[key]:.2f} of "
              f"{' '.join(f'{v:.2f}' for v in each)}  (1 = smaller chain "
              f"fully hidden, 0 = serial)", flush=True)
    return out


if __name__ == "__main__":
    main()
