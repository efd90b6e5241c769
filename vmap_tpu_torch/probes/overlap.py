"""K8: does FMA work hide tensor-core work inside one kernel?

Counterpart of ``scripts/microbench_overlap.py::_run``. Two independent
chains, stepped ``reps`` times in one launch:

  * vpu: 24 dependent elementwise ops on v [8, T] (``vpu_step``: v a + b,
    |v| + 1e-3, max(0.99 v, 0.5 b), v - sign(v) 1e-4, v (1 - 1e-3 v),
    v + 1e-3 a, four times), on the FMA pipe, each op rounded as the
    script's (no contraction into fused multiply-adds);
  * mxu: two dependent products c <- (W1 @ c) 1e-2, c <- (W2 @ c) 1e-2,
    [128, 128] x [128, T], on the tensor cores: ``mma.sync`` bf16 with the
    3xbf16 split of both operands, so it still computes the f32 product
    (a chain of FP32 FMA products would share the FMA pipe with the vpu
    chain and show no overlap by construction);
  * both: each step advances both chains in the same warps, emitted as the
    script's kernel emits them (3 vpu ops, product 1, the other 21 ops,
    product 2), the vpu ops placed between a product's tensor-core
    instructions and the first use of their results.

Modes ``vpu``, ``mxu``, ``both``; overlap = (vpu + mxu - both) /
min(vpu, mxu) from the slopes between 200 and 600 steps (1: the smaller
chain hidden, 0: serial). On the H100 the script's vpu chain takes about
1/27 of the mxu chain's step, so that fraction divides the slopes' noise
by a small time. The balanced case, not in the script, runs the vpu
chain for ``BAL_ROUNDS`` = 27 x 4 rounds a step (``vpu_bal``), about the
mxu chain's time, and ``both_bal`` places half of them inside each
product; its overlap is (vpu_bal + mxu - both_bal) / min(vpu_bal, mxu).
Every mode is timed ``RUNS`` times, and each run's fractions are
printed with their median. A block owns 16 columns of both chains (80
blocks at T = 1280, one an SM). W's hi / lo copies are made here, outside
the chain, and the kernel keeps them in shared memory.
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
from vmap_tpu_torch.probes import _timing

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


def launch(x: dict, mode: str, reps: int) -> tuple:
    """The kernel (csrc/overlap.cu) on CUDA tensors: (v, c)."""
    names = ("a", "b", "w1_hi", "w1_lo", "w2_hi", "w2_lo", "c")
    ops = [x[k].contiguous() for k in names]
    shapes = ((8, T), (8, T)) + ((128, 128),) * 4 + ((128, T),)
    if any(tuple(t.shape) != s for t, s in zip(ops, shapes)):
        raise ValueError("overlap probe: a, b [8, 1280], W hi / lo "
                         "[128, 128], c [128, 1280]")
    dev = probes.check_cuda(*ops)
    v = torch.empty_like(x["a"])
    c = torch.empty_like(x["c"])
    code = probes.LIBRARY.load().vmap_probe_overlap(
        MODE_CODE[mode], *(probes.ptr(t) for t in ops), probes.ptr(v),
        probes.ptr(c), T, reps, probes.stream(dev))
    probes.LIBRARY.check(code, f"overlap probe ({mode}) launch")
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


def library_ms(case: dict, dev: torch.device) -> None:
    """None: no single PyTorch call computes both chains."""
    return None


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
