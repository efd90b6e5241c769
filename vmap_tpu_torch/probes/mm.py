"""K4: the rate of chained matrix products at K1's shapes on the card.

Counterpart of ``scripts/microbench_mm.py::_one``. One launch runs
``reps`` dependent steps of

    y = sum_j W_j @ c,  W_j = W (1 + 0.001 j), j < ind      [m, n]
    c <- fold(y) / (1 + ind)                                 [k, n]

(``fold`` repeats y's rows until there are k of them, as the script's
concat does), from c = c0, and returns the last carry. Variants:

  * ``f32``: FP32 FMA, IEEE (never TF32);
  * ``bf16``: W and each step's carry rounded to bf16, products on
    ``mma.sync`` bf16 tensor cores with f32 accumulation, as the script's
    ``dt = bf16`` kernel computes (W_j = bf16(W) bf16(1 + 0.001 j), which
    is bf16(W) for j < 4);
  * ``f32_3xbf16``: the f32 product on bf16 tensor cores, each operand
    split as hi = bf16(x), lo = bf16(x - hi) and a @ b taken as
    ah bh + ah bl + al bh: the accurate tensor-core route for K1's f32
    policy, held to the f32 plain version.

W @ c is separable by column, so a block owns ``nb`` columns of the carry
and needs nothing from another block between steps. The script's shapes
run at nb = 8 (160 blocks at n = 1280); K1's own products run as one
independent chain of [h, h] x [h, P] per block on all 132 SMs (n = 132 P,
nb = P = ``kernels.MAX_POINTS[h]``, padded to the mma tile inside the
kernel). The loop-invariant operand copies (W^T for the FMA loop, the
bf16 / hi / lo copies and the scaled W_j) are made here, outside the chain.
W's copy goes to shared memory where it fits beside the carry with every
block of the grid still resident (``stages_w``), as K1 keeps its weights;
otherwise the kernel reads it from global memory (L2) each step.

Values leave the f32 range within tens of steps (the carry grows about
k 0.05 / (1 + ind) a step), so the kernel is held against its plain version
at a few steps and timed at the script's (200, or 40 above 400 M
multiply-adds, and 4x that).

    python -m vmap_tpu_torch.probes.mm [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vmap_tpu_torch import probes
from vmap_tpu_torch.kernels import MAX_POINTS
from vmap_tpu_torch.probes import _timing

VARIANTS = ("f32", "bf16", "f32_3xbf16")
VARIANT_CODE = {v: i for i, v in enumerate(VARIANTS)}
# scripts/microbench_mm.py:88-95: (m, k, n) per dtype, then f32 ind4
SCRIPT_SHAPES = ((128, 128, 1280), (128, 384, 1280), (256, 256, 1280),
                 (512, 512, 1280), (512, 512, 512), (1280, 1280, 1280))
IND4_SHAPES = ((128, 384, 1280), (128, 128, 1280))
N_SMS = 132
# shared memory of one SM of the card (228 KB, 1 KB of it reserved per
# resident block) and the most one block may take
SM_SMEM, BLOCK_RESERVED, BLOCK_SMEM = 228 * 1024, 1024, 227 * 1024
SCRIPT_NB = 8
TOL = {"f32": 1e-5, "f32_3xbf16": 1e-5, "bf16": 2e-3}   # rtol, see tol()


def k1_shapes() -> tuple:
    """K1's per-block products: (h, h, 132 P, P) for h = 32 / 128 / 256."""
    return tuple((h, h, N_SMS * p, p) for h, p in sorted(MAX_POINTS.items()))


def base_reps(m: int, k: int, n: int) -> int:
    return 200 if m * k * n < 400 * 1 << 20 else 40


def tol(variant: str, reps: int) -> float:
    """rtol of the kernel's last carry against the plain version's: 1e-5
    per step for the f32 products (FMA, and 3xbf16 against plain f32),
    2e-3 for bf16 (the plain version rounds where the kernel rounds; a
    carry element within f32 noise of a bf16 boundary may round the other
    way)."""
    return TOL[variant] * (reps if variant != "bf16" else 1)


def smem_bytes(variant: str, m: int, k: int, nb: int, ind: int,
               stage_w: bool) -> int:
    """One block's dynamic shared memory (``csrc/mm.cu`` smem_bytes): the
    f32 carry [k, nbp], then y [m, nbp] (f32) or the carry's bf16 copies
    [nbp, k + 8] (hi, and lo for 3xbf16), and W's copy if staged."""
    nbp = -(-nb // 8) * 8
    if variant == "f32":
        return 4 * (k * nbp + m * nbp + (ind * k * m if stage_w else 0))
    split = 2 if variant == "f32_3xbf16" else 1
    return 4 * k * nbp + 2 * split * (k + 8) * (nbp + (ind * m if stage_w
                                                        else 0))


def resident(smem: int, blocks: int) -> bool:
    """Whether ``blocks`` blocks of ``smem`` bytes of shared memory each fit
    on the card's SMs at once. A chain's blocks run for the whole launch,
    so a block that waits for a free SM doubles its time."""
    per_sm = SM_SMEM // (smem + BLOCK_RESERVED)
    return smem <= BLOCK_SMEM and per_sm * N_SMS >= blocks


def stages_w(variant: str, m: int, k: int, n: int, nb: int,
             ind: int) -> bool:
    """W's copy in shared memory: where it fits beside the carry with every
    block of the grid resident."""
    return resident(smem_bytes(variant, m, k, nb, ind, True), n // nb)


def make_inputs(m: int, k: int, n: int, dev) -> tuple:
    """The script's draws: W [m, k] and c [k, n], uniform [0, 0.1), f32."""
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.random((m, k)) * 0.1, dtype=torch.float32)
    c = torch.tensor(rng.random((k, n)) * 0.1, dtype=torch.float32)
    return w.to(dev), c.to(dev)


def fold_scale(ind: int) -> float:
    return float(np.float32(1.0 / (1.0 + ind)))


def operands(w: torch.Tensor, variant: str, ind: int) -> dict:
    """The loop-invariant copies of W the chain reads: ``w`` [ind, m, k]
    f32 (for bf16 its bf16 values), which the plain version reads, and the
    kernel's: ``wt`` [ind, k, m] f32 (f32), ``hi`` [ind, m, k] bf16 (bf16,
    3xbf16) and ``lo`` (3xbf16)."""
    if variant == "bf16":
        # the script's bf16 w * (1 + 0.001 j): the factor takes w's type
        # first (bf16(1.001) = 1), the product is rounded to bf16
        wb = w.to(torch.bfloat16)
        hi = torch.stack([wb] + [
            (wb.float() * float(torch.tensor(1.0 + 0.001 * j,
                                             dtype=torch.bfloat16)))
            .to(torch.bfloat16) for j in range(1, ind)])
        return {"w": hi.float(), "hi": hi}
    ws = torch.stack([w] + [w * np.float32(1.0 + 0.001 * j)
                            for j in range(1, ind)])
    if variant == "f32":
        return {"w": ws, "wt": ws.transpose(1, 2).contiguous()}
    hi = ws.to(torch.bfloat16)
    return {"w": ws, "hi": hi, "lo": (ws - hi.float()).to(torch.bfloat16)}


def fold(y: torch.Tensor, k: int, scale: float) -> torch.Tensor:
    """The script's fold: y's rows repeated to k rows, times ``scale``."""
    m = y.shape[0]
    if m != k:
        y = y.repeat(-(-k // m), 1)[:k]
    return y * scale


def chain_reference(ops: dict, c0: torch.Tensor, variant: str, reps: int,
                    scale: float) -> torch.Tensor:
    """Plain version: the chain with ``torch.matmul`` (bf16: operands
    rounded to bf16, products summed in f32; 3xbf16: the f32 product)."""
    w = ops["w"]
    c = c0.clone()
    for _ in range(reps):
        cc = c.to(torch.bfloat16).float() if variant == "bf16" else c
        y = w[0] @ cc
        for j in range(1, w.shape[0]):
            y = y + w[j] @ cc
        c = fold(y, c.shape[0], scale)
    return c


def launch(ops: dict, c0: torch.Tensor, variant: str, reps: int,
           scale: float, nb: int, counter: str = "mm") -> torch.Tensor:
    """The chain kernel (csrc/mm.cu) on CUDA tensors: returns the last
    carry [k, n]. ``counter``: the probe whose launch count it adds to."""
    w = ops["w"]
    ind, m, k = w.shape
    n = c0.shape[1]
    if c0.shape[0] != k or c0.dtype != torch.float32:
        raise ValueError(f"carry {tuple(c0.shape)} {c0.dtype}: expected "
                         f"f32 [{k}, n]")
    if m % 16 or k % 16 or not 1 <= ind <= 4 or n % nb or not 1 <= nb <= 64:
        raise ValueError(f"mm probe takes m, k multiples of 16, ind 1..4 "
                         f"and 1..64 columns a block dividing n; got m={m} "
                         f"k={k} ind={ind} n={n} nb={nb}")
    kops = [ops[key] for key in ("wt", "hi", "lo") if key in ops]
    dev = probes.check_cuda(c0, *kops)
    stage = stages_w(variant, m, k, n, nb, ind)
    out = torch.empty_like(c0)
    lib = probes.LIBRARY.load()
    code = lib.vmap_probe_mm(VARIANT_CODE[variant],
                             *(probes.ptr(ops.get(key))
                               for key in ("wt", "hi", "lo")),
                             probes.ptr(c0),
                             probes.ptr(out), m, k, n, nb, ind, reps, scale,
                             int(stage), probes.stream(dev))
    probes.LIBRARY.check(code, f"mm probe ({variant}) launch")
    probes.LAUNCHES[counter] += 1
    return out


def chain(ops: dict, c0: torch.Tensor, variant: str, reps: int,
          scale: float, nb: int = SCRIPT_NB) -> torch.Tensor:
    """The chain: the plain version on a CPU tensor, the kernel on a CUDA
    tensor."""
    if c0.device.type == "cpu":
        return chain_reference(ops, c0, variant, reps, scale)
    return launch(ops, c0, variant, reps, scale, nb)


def cases() -> list:
    """(m, k, n, nb, variant, ind) of the script's shapes (every variant,
    ind 1; f32 ind 4 at IND4_SHAPES) and of K1's (every variant)."""
    return ([(m, k, n, SCRIPT_NB, v, 1) for v in VARIANTS
             for (m, k, n) in SCRIPT_SHAPES]
            + [(m, k, n, SCRIPT_NB, "f32", 4) for (m, k, n) in IND4_SHAPES]
            + [(m, k, n, nb, v, 1) for v in VARIANTS
               for (m, k, n, nb) in k1_shapes()])


def label(m, k, n, nb, variant, ind) -> str:
    tag = f" ind{ind}" if ind > 1 else ""
    blocks = f" ({n // nb} chains of {nb} cols)" if nb != SCRIPT_NB else ""
    return f"[{m},{k}]x[{k},{n}] {variant}{tag}{blocks}"


def measure(case: tuple, dev: torch.device) -> dict:
    """Time one case by the slope; returns its numbers."""
    m, k, n, nb, variant, ind = case
    w, c0 = make_inputs(m, k, n, dev)
    ops = operands(w, variant, ind)
    scale = fold_scale(ind)
    base = base_reps(m, k, n)
    sl = _timing.slope(lambda r: chain(ops, c0, variant, r, scale, nb),
                       base, 4 * base, dev)
    ns = sl["step_ns"] / ind
    return {"case": label(*case), "m": m, "k": k, "n": n, "nb": nb,
            "variant": variant, "ind": ind, "reps": (base, 4 * base),
            "w_in_smem": stages_w(variant, m, k, n, nb, ind), **sl,
            "ns_per_product": ns, "tflops": 2.0 * m * k * n / ns / 1e3}


def bound(case: dict) -> dict:
    """A step's bound: its products over the peak of their type (the carry
    stays on chip; the chain's inputs and output, read and written once a
    launch, amortise to under 0.1% of a step at these reps)."""
    ops = 2.0 * case["m"] * case["k"] * case["n"] * case["ind"]
    return probes.bound({"f32": ops / probes.PEAK_F32,
                         "bf16": ops / probes.PEAK_BF16,
                         "f32_3xbf16": 3 * ops / probes.PEAK_BF16}[
                             case["variant"]])


def plain_ms(case: dict, dev: torch.device) -> float:
    w, c0 = make_inputs(case["m"], case["k"], case["n"], dev)
    ops = operands(w, case["variant"], case["ind"])
    scale = fold_scale(case["ind"])
    return _timing.graph_step_ms(
        lambda r: chain_reference(ops, c0, case["variant"], r, scale), dev)


def matmul_chain(case: dict, dev: torch.device, dt: torch.dtype,
                 scale: float):
    """The chain as ``torch.matmul`` calls on ``dt`` operands, a function
    of the steps: the library call's chain (TF32 off for f32)."""
    w, c0 = make_inputs(case["m"], case["k"], case["n"], dev)
    ws = operands(w, "f32", case.get("ind", 1))["w"].to(dt)

    def run(reps):
        c = c0.to(dt)
        for _ in range(reps):
            y = torch.matmul(ws[0], c)
            for j in range(1, ws.shape[0]):
                y = y + torch.matmul(ws[j], c)
            c = fold(y, case["k"], scale)
        return c
    return run


def library_ms(case: dict, dev: torch.device) -> float:
    """``torch.matmul`` a product: f32 (f32 and 3xbf16) or bf16 operands."""
    dt = torch.bfloat16 if case["variant"] == "bf16" else torch.float32
    return _timing.graph_step_ms(
        matmul_chain(case, dev, dt, fold_scale(case["ind"])), dev)


def compare(dev: torch.device, reps: int = 3) -> list:
    """Every case's kernel against its plain version on ``dev`` (CUDA) at
    ``reps`` steps; raises if one is outside ``tol``. Returns the errors."""
    res = []
    for case in cases():
        m, k, n, nb, variant, ind = case
        w, c0 = make_inputs(m, k, n, dev)
        ops = operands(w, variant, ind)
        scale = fold_scale(ind)
        got = launch(ops, c0, variant, reps, scale, nb)
        want = chain_reference(ops, c0, variant, reps, scale)
        res.append(probes.held(label(*case), got, want, tol(variant, reps)))
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
        where = "W in smem" if r["w_in_smem"] else "W from L2"
        print(f"{r['case']}: {r['ns_per_product']:.0f} ns/op  "
              f"{r['tflops']:.1f} TF/s  ({where})", flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
