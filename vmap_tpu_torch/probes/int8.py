"""K10: does s8 ``wgmma`` pay at K1's shapes once quantisation is paid?

Counterpart of ``scripts/microbench_int8.py::_chain``. One launch runs
``reps`` dependent steps of a chained product y = W @ c, the carry folded
back to [k, n] (y's rows repeated, as the script's concat) each step, in
one of three modes:

  * ``f32``: y = W @ c on FP32 FMA, c <- fold(y) 1e-3 (``mm.py``'s chain
    kernel with scale 1e-3);
  * ``i8``: wq = s8(round(127 W)), c0 = s8(clip(100 c, +-127)) (truncating);
    a step is y = wq @ c in s32 and c <- s8(clip(fold(y) 1e-3, +-127)):
    the s8 tensor-core rate alone;
  * ``i8_quant``: the carry is f32; each step takes the per-tensor scale
    s = max|c| / 127 + 1e-30 over the whole carry, cq = round(c (1/s))
    (half to even), y = wq @ cq in s32, c <- fold(y) s 1e-3: the realistic
    cost with the in-loop quantisation.

``i8_quant``'s scale spans the whole carry, which on the card spans
blocks: on the script's shapes its kernel runs ``mm.plan``'s grid plan
over the whole card, each step's abs-max folded into a slot in global
memory by the same grid barrier that publishes the fold (``csrc/int8.cu``
says what that costs). K1's shapes run one chain per block (n = 132 P,
nb = P), whose scale is its own carry's; the plain version takes the
abs-max per group of ``n / groups`` columns to match. The cases also run
i8 on i8_quant's plan (``nb`` = "grid"): i8_quant less that case is the
quantisation's cost a step.

Values decay (f32: by about k 0.05 1e-3 a step) or saturate, so the kernel
is held against its plain version at a few steps (i8 bit-equal, i8_quant
rtol 1e-6, f32 rtol 1e-5 a step) and timed at the script's (200 and 800).

    python -m vmap_tpu_torch.probes.int8 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from vmap_tpu_torch import probes
from vmap_tpu_torch.probes import _timing, mm

MODES = ("f32", "i8", "i8_quant")
MODE_CODE = {"i8": 1, "i8_quant": 2}
# scripts/microbench_int8.py:109-111
SCRIPT_SHAPES = ((128, 128, 1280), (128, 384, 1280), (512, 512, 1280))
BASE_REPS = 200
F32_SCALE = 1e-3
# a case's nb: None (the plan the card gives the script's shape), K1's
# chain width, or GRID: i8_quant's grid plan for i8
GRID = "grid"


def tol(mode: str, reps: int) -> float:
    """i8 bit-equal (integer sums, the same 1e-3, clip and truncation);
    i8_quant rtol 1e-6 (the script's op order: c (1/s), round half to even,
    acc s); f32 rtol 1e-5 a step."""
    return {"i8": 0.0, "i8_quant": 1e-6, "f32": 1e-5 * reps}[mode]


def quantised_weights(w: torch.Tensor) -> torch.Tensor:
    """wq = s8(round(127 W)), ties to even (the script's in-kernel
    prologue; loop-invariant, so made here)."""
    return torch.round(w * 127.0).to(torch.int8)


def chain_reference(w: torch.Tensor, c0: torch.Tensor, mode: str, reps: int,
                    groups: int = 1) -> torch.Tensor:
    """Plain version: the last carry [k, n] as f32 (i8: its s8 values).
    ``groups``: i8_quant's scale is taken per group of n / groups columns."""
    k, n = c0.shape
    if mode == "f32":
        return mm.chain_reference({"w": w[None]}, c0, "f32", reps, F32_SCALE)
    # s8 products summed in f64: exact, as the s32 sums (< 2^24 here)
    wq = quantised_weights(w).to(torch.float64)
    if mode == "i8":
        c = torch.clamp(c0 * 100.0, -127, 127).to(torch.int8)
        for _ in range(reps):
            y = (wq @ c.to(torch.float64)).to(torch.float32)
            c = torch.clamp(mm.fold(y, k, F32_SCALE), -127, 127
                            ).to(torch.int8)
        return c.float()
    c = c0.clone()
    for _ in range(reps):
        cg = c.reshape(k, groups, n // groups)
        s = cg.abs().amax(dim=(0, 2), keepdim=True) * torch.tensor(
            1.0 / 127.0, dtype=torch.float32) + torch.tensor(
            1e-30, dtype=torch.float32)
        cq = torch.round(cg * (1.0 / s)).reshape(k, n).to(torch.float64)
        y = (wq @ cq).to(torch.float32).reshape(-1, groups, n // groups) * s
        c = mm.fold(y.reshape(-1, n), k, F32_SCALE)
    return c


def groups(n: int, nb) -> int:
    """i8_quant's scale groups: one a chain at K1's shapes, else one."""
    return n // nb if isinstance(nb, int) else 1


def launch(w: torch.Tensor, c0: torch.Tensor, mode: str, reps: int,
           nb=None, wq: torch.Tensor | None = None) -> torch.Tensor:
    """The chain kernel on CUDA tensors (f32: csrc/mm.cu; i8 / i8_quant:
    csrc/int8.cu) on ``mm.plan``'s plan for this card (``nb`` as in
    ``cases``): the last carry [k, n] f32."""
    k1 = nb if isinstance(nb, int) else mm.SCRIPT_NB
    if mode == "f32":
        return mm.launch({"w": w[None]}, c0, "f32", reps, F32_SCALE, k1,
                         counter="int8")
    wq = quantised_weights(w) if wq is None else wq
    m, k = wq.shape
    if c0.shape[0] != k or m % 16 or k % 32:
        raise ValueError(f"int8 probe: m={m} (a multiple of 16), k={k} (of "
                         f"32), carry {tuple(c0.shape)}")
    return mm.launch_chain(mode, [wq], c0, reps, 1.0, k1, 1, "int8",
                           exchange=nb == GRID)


def chain(w: torch.Tensor, c0: torch.Tensor, mode: str, reps: int,
          nb=None, wq: torch.Tensor | None = None) -> torch.Tensor:
    """The chain: the plain version on a CPU tensor, the kernel on a CUDA
    tensor (``nb`` as in ``cases``)."""
    if c0.device.type == "cpu":
        return chain_reference(w, c0, mode, reps, groups(c0.shape[1], nb))
    return launch(w, c0, mode, reps, nb, wq)


def cases() -> list:
    """(m, k, n, nb or None, mode) of the script's shapes and K1's."""
    return ([(m, k, n, None, mode) for (m, k, n) in SCRIPT_SHAPES
             for mode in MODES]
            # i8 on i8_quant's plan: i8_quant less this is the
            # quantisation's cost a step
            + [(m, k, n, GRID, "i8") for (m, k, n) in SCRIPT_SHAPES]
            + [(m, k, n, nb, mode) for (m, k, n, nb) in mm.k1_shapes()
               for mode in MODES])


def label(m, k, n, nb, mode) -> str:
    blocks = (" (i8_quant's plan)" if nb == GRID
              else f" ({n // nb} chains of {nb} cols)" if nb else "")
    return f"[{m:4d},{k:4d}]x[{k:4d},{n:5d}] {mode:9s}{blocks}"


def measure(case: tuple, dev: torch.device) -> dict:
    m, k, n, nb, mode = case
    w, c0 = mm.make_inputs(m, k, n, dev)
    wq = quantised_weights(w)
    sl = _timing.slope(lambda r: chain(w, c0, mode, r, nb, wq), BASE_REPS,
                       4 * BASE_REPS, dev)
    ns = sl["step_ns"]
    return {"case": label(*case), "m": m, "k": k, "n": n, "nb": nb,
            "mode": mode, "reps": (BASE_REPS, 4 * BASE_REPS),
            "plan": mm.describe(mm.plan(
                "f32" if mode == "f32" else mode, m, k, n,
                nb if isinstance(nb, int) else mm.SCRIPT_NB, 1,
                mm.sm_count(dev), exchange=nb == GRID)),
            **sl,
            "ns_per_product": ns, "tops": 2.0 * m * k * n / ns / 1e3}


def bound(case: dict) -> dict:
    """A step's bound: the products over the peak of their type; i8_quant
    adds per carry element |c|, max, c / s, rint and the rescale (5 FP32
    ops)."""
    ops = 2.0 * case["m"] * case["k"] * case["n"]
    return probes.bound({
        "f32": ops / probes.PEAK_F32, "i8": ops / probes.PEAK_INT8,
        "i8_quant": ops / probes.PEAK_INT8
        + 5.0 * case["k"] * case["n"] / probes.PEAK_F32_OPS}[case["mode"]])


def plain_ms(case: dict, dev: torch.device) -> float:
    w, c0 = mm.make_inputs(case["m"], case["k"], case["n"], dev)
    g = groups(case["n"], case["nb"])
    return _timing.graph_step_ms(
        lambda r: chain_reference(w, c0, case["mode"], r, g), dev)


def library_ms(case: dict, dev: torch.device) -> float | None:
    """``torch.matmul`` (f32 mode) or ``torch._int_mm`` (i8) a product;
    None for i8_quant (no single call quantises and multiplies)."""
    if case["mode"] == "f32":
        run = mm.matmul_chain(case, dev, torch.float32, F32_SCALE)
    elif case["mode"] == "i8":
        w, c0 = mm.make_inputs(case["m"], case["k"], case["n"], dev)
        wq, k = quantised_weights(w), case["k"]

        def run(reps):
            c = torch.clamp(c0 * 100.0, -127, 127).to(torch.int8)
            for _ in range(reps):
                y = torch._int_mm(wq, c).to(torch.float32)
                c = torch.clamp(mm.fold(y, k, 1e-3), -127, 127).to(
                    torch.int8)
            return c
    else:
        return None
    return _timing.graph_step_ms(run, dev)


def compare(dev: torch.device, reps: int = 3) -> list:
    """Every case's kernel against its plain version at ``reps`` steps;
    raises if one is outside ``tol``."""
    res = []
    for case in cases():
        m, k, n, nb, mode = case
        w, c0 = mm.make_inputs(m, k, n, dev)
        got = launch(w, c0, mode, reps, nb)
        want = chain_reference(w, c0, mode, reps, groups(n, nb))
        res.append(probes.held(label(*case), got, want, tol(mode, reps)))
    return res


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = probes.device_from_arg(args.device)
    print(f"device: {_timing.device_label(dev)}", flush=True)
    out = []
    for case in cases():
        r = measure(case, dev)
        print(f"{r['case']} {r['ns_per_product']:9.0f} ns/op  "
              f"{r['tops']:7.1f} TF/s(eff)  ({r['plan']})", flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
