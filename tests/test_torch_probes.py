"""The port's probes (``vmap_tpu_torch.probes``: K4 mm, K10 int8, K7
sections, K8 overlap, K9 vpu, K5 ops, K6 dma) against the JAX scripts'
own Pallas kernels (``scripts/microbench_*.py``) in interpret mode, on
the CPU.

The harness loads a script module by path, as it stands, and swaps two of
its globals: ``pl`` for a namespace whose ``pallas_call`` forces
``interpret=True``, records the kernel's output and raises ``_Stop`` (so
the script's timing loop ends after the first output), and ``jax`` for a
proxy whose ``jit`` is the identity. Then the script's own function
(``_one``, ``_chain``, ``_run``, or a section body the script's ``main``
hands to ``slope``) runs at a few steps on the scripts' own draws, and the
port's plain version runs on the same numpy inputs.

The scripts' kernels output row sums of their last carry (K8: v's row sums
plus a block sum of c). Tolerances on the carry, as the kernels are held
on the card (chip_smoke.py phase 12): f32 chains (FMA and 3xbf16) rtol
1e-5 a step, bf16 2e-3, i8 bit-equal, i8_quant 1e-6, render and ladder
1e-5; each plus n 2^-24 for the f32 rounding of a row sum of n terms in
the script, where the sums are not exact integers.

Where a row sum cannot see a part of the step, that part is held on its
own. K7's emb / ladder sections move the carry by about 2e-4 / 1e-5 of
itself a step: one step of the script's body, called on jnp arrays, gives
its section as ``sections.increment`` reads it (within the step's f32
roundings plus rtol 1e-5 of the port's plain section), and the render's
step is held elementwise. K8's c chain is about 4e-6 of the script's
output: a second run swaps the script's ``jnp.sum`` so that the kernel
writes c[:8, :128] itself, held elementwise.
"""

import ctypes
import importlib.util
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as real_pl

from vmap_tpu_torch import probes
from vmap_tpu_torch.probes import (_timing, dma, int8, mm, ops, overlap,
                                   sections, vpu)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


class _Stop(Exception):
    pass


def load_script(name: str, **jnp_over):
    """``scripts/<name>.py`` with ``pl.pallas_call`` captured and forced
    to interpret mode, and ``jax.jit`` the identity (``jnp_over``:
    functions in place of the script's ``jnp.<name>``). Returns (module,
    list the kernel outputs are appended to)."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    outputs = []

    def pallas_call(kernel, **kw):
        kw["interpret"] = True
        call = real_pl.pallas_call(kernel, **kw)

        def run(*args):
            outputs.append(np.asarray(call(*args)))
            raise _Stop
        return run

    mod.pl = types.SimpleNamespace(**{
        **{k: getattr(real_pl, k) for k in dir(real_pl)
           if not k.startswith("__")}, "pallas_call": pallas_call})
    proxy = types.ModuleType("jax_proxy")
    proxy.__dict__.update({k: getattr(jax, k) for k in dir(jax)
                           if not k.startswith("__")})
    proxy.jit = lambda f: f
    mod.jax = proxy
    if jnp_over:
        np_proxy = types.ModuleType("jnp_proxy")
        np_proxy.__dict__.update({k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
        np_proxy.__dict__.update(jnp_over)
        mod.jnp = np_proxy
    return mod, outputs


def run_captured(outputs, fn, *args) -> np.ndarray:
    with pytest.raises(_Stop):
        fn(*args)
    return outputs[-1]


def sum_tol(rtol: float, n: int) -> float:
    return rtol + n * 2.0 ** -24


# ------------------------------------------------------------------- K4
MM_SHAPE = (16, 48, 128)     # m != k: the fold repeats y's rows
MM_REPS = 3


@pytest.mark.parametrize("variant,ind", [("f32", 1), ("bf16", 1), ("f32", 4),
                                         ("bf16", 4), ("f32_3xbf16", 1)])
def test_mm_plain_matches_jax_kernel(variant, ind):
    mod, outs = load_script("microbench_mm")
    m, k, n = MM_SHAPE
    dt = jnp.bfloat16 if variant == "bf16" else jnp.float32
    got = run_captured(outs, mod._one, m, k, n, dt, MM_REPS, ind)
    w, c0 = mm.make_inputs(m, k, n, CPU)
    c = mm.chain(mm.operands(w, variant, ind), c0, variant, MM_REPS,
                 mm.fold_scale(ind))
    assert bool(torch.isfinite(c).all()) and float(c.abs().min()) > 0
    np.testing.assert_allclose(got[:, 0], c[:8].double().sum(1).numpy(),
                               rtol=sum_tol(mm.tol(variant, MM_REPS), n))


def test_mm_cases_and_operands():
    """The script's shapes in every variant, f32 ind4 at its two shapes, and
    K1's per-block products (132 chains of P = MAX_POINTS columns); the
    3xbf16 split's hi + lo within 2^-16 of W."""
    cases = mm.cases()
    assert len(cases) == 3 * 6 + 2 + 3 * 3
    assert (32, 32, 132 * 64, 64, "f32", 1) in cases
    assert (256, 256, 132 * 38, 38, "bf16", 1) in cases
    w, _ = mm.make_inputs(32, 32, 8, CPU)
    ops = mm.operands(w, "f32_3xbf16", 4)
    rebuilt = ops["hi"].float() + ops["lo"].float()
    rel = (rebuilt - ops["w"]).abs() / ops["w"].abs()
    assert float(rel.max()) < 2 ** -16
    assert torch.equal(ops["w"][1], w * np.float32(1.001))
    assert mm.base_reps(1280, 1280, 1280) == 40
    assert mm.base_reps(512, 512, 1280) == 200


def test_w_goes_to_shared_memory_where_every_block_stays_resident():
    """W stays in shared memory for the whole chain wherever it fits
    beside the carry with every block of the plan resident: the script's
    [128, 384] f32 on a block plan (W 192 KB beside a 16-column slab),
    [512, 512] bf16 on a cluster plan (a 128 KB panel of 128 rows a block,
    32 clusters of 4),
    K1's h=32 / 128 products; streamed from L2 each step only where a
    panel cannot fit (1280^2 f32 and 3xbf16: 320 KB; K1's h=256 in f32 and
    3xbf16: 256 KB)."""
    p = mm.plan("f32", 128, 384, 1280)
    assert (p["grid"], p["w_resident"], p["slabs"]) == (0, 1, 80)
    assert mm.smem_bytes(p, "f32") == 4 * (384 * 128 + 384 * 16) + 256
    p = mm.plan("bf16", 512, 512, 1280)
    assert (p["grid"], p["w_resident"], p["rows"], p["panels"],
            p["slabs"]) == (2, 1, 128, 4, 32)
    assert mm.plan("f32", 128, 128, 132 * 56, 56)["w_resident"]
    assert mm.plan("bf16", 32, 32, 132 * 64, 64)["w_resident"]
    for v in ("f32", "f32_3xbf16"):
        assert not mm.plan(v, 1280, 1280, 1280)["w_resident"]
        assert not mm.plan(v, 256, 256, 132 * 38, 38)["w_resident"]
    assert mm.plan("bf16", 256, 256, 132 * 38, 38)["w_resident"]
    assert mm.plan("i8_quant", 128, 128, 1280)["grid"]
    assert not mm.plan("i8", 128, 128, 1280)["grid"]
    assert mm.plan("i8", 128, 128, 1280, exchange=True)["grid"]


def _all_chain_cases():
    """(variant, m, k, n, nb, ind, exchange) of every case phase 12 runs:
    K4's, K10's (f32 on K4's kernel) and K5's fwd_mm pair."""
    out = [(v, m, k, n, nb, ind, False) for m, k, n, nb, v, ind in mm.cases()]
    for m, k, n, nb, mode in int8.cases():
        out.append((mode, m, k, n, nb if isinstance(nb, int)
                    else mm.SCRIPT_NB, 1, nb == int8.GRID))
    out += [(v, 128, 384, ops.T, mm.SCRIPT_NB, 1, False)
            for v in ("f32", "bf16")]
    return out


@pytest.mark.parametrize("case", _all_chain_cases(),
                         ids=lambda c: "-".join(map(str, c)))
def test_chain_plan_fits_covers_and_stays_resident(case):
    """Every case's plan (``mm.plan``, the mirror of csrc/chain.cuh's,
    at 132 SMs): it fits a block's shared memory; a grid plan's blocks are
    all resident (one an SM, 132 at most); a kernel is built for it; W's
    panels cover each row once; the slabs cover n once; and it meets
    chain.cuh's plan_ok limits."""
    v, m, k, n, nb, ind, exchange = case
    p = mm.plan(v, m, k, n, nb, ind, exchange=exchange)
    assert mm.plan_checks(p, v) == {"fits": True, "resident": True,
                                    "built": True, "rows_once": True,
                                    "cols_once": True}
    ring = p["grid"] == 1 or not p["w_resident"]
    assert (not ring) or (p["k"] % p["kc"] == 0
                          and p["kc"] % mm.kstep(v) == 0
                          and 1 <= p["stages"] <= 8)
    if v != "f32":
        assert p["N"] in mm.TC_WIDTHS and p["rows"] % 64 == 0
        assert p["ind"] == 1 and p["N"] <= 80 or v in ("bf16", "f32_3xbf16")
        assert p["threads"] == 2 * p["rows"] * (max(1, p["N"] // 128)
                                                 if p["grid"] == 1 else 1)
    else:
        tpr = p["threads"] // (p["rows"] // 4)
        assert -(-(p["N"] // 4) // tpr) <= (1 if ind > 1 else 4)
        assert p["threads"] % 32 == 0 and p["threads"] <= 512
        assert p["grid"] != 2
    if p["grid"]:
        assert p["panels"] * p["slabs"] <= mm.N_SMS
        assert p["kc"] == 64 and p["k"] % p["m"] == 0
    if p["grid"] == 2:
        assert v not in ("i8_quant", "f32") and not exchange
        assert p["panels"] <= 8 and p["w_resident"] and p["stages"] == 0
        assert p["rows"] in (64, 128) and p["N"] <= 128
    if v == "i8_quant" and p["grid"]:
        assert p["w_resident"] and p["grid"] == 1
    if ind > 1:
        assert p["w_resident"]
    if nb != mm.SCRIPT_NB:
        assert not p["grid"] and p["slabs"] == mm.N_SMS


def _tc_off(r, d, depth, ck):
    """csrc/chain.cuh tc_off."""
    return (r // 8) * 8 * depth + (d // ck) * 8 * ck + (r % 8) * ck + d % ck


@pytest.mark.parametrize("variant", ["f32", "bf16", "f32_3xbf16", "i8",
                                     "i8_quant"])
def test_chain_layouts_put_each_element_where_the_kernel_reads_it(variant):
    """``w_layout`` and ``carry_layout`` against the offsets the kernels
    read (chain.cuh's tc_off and chunk order; mm.cu's W^T and [kc][N]
    chunks), on a grid plan with streamed chunks and a block plan, every
    element."""
    gen = torch.Generator().manual_seed(1)
    m, k, n = 128, 128, 96
    w = torch.rand(m, k, generator=gen)
    c = torch.rand(k, n, generator=gen)
    plans = [mm.plan(variant, m, k, n, 48), mm.plan(variant, m, k, n,
                                                    exchange=True)]
    if variant != "i8_quant":
        plans[1] = {**plans[1], "w_resident": 0, "grid": 1}
    if variant not in ("f32", "i8_quant"):
        plans.append({**plans[1], "w_resident": 1, "grid": 2})
    for p in plans:
        if variant == "f32":
            copies = [w[None]]
        elif variant in ("i8", "i8_quant"):
            copies = [int8.quantised_weights(w)]
        else:
            hi = w.to(torch.bfloat16)
            copies = [hi] + ([(w - hi.float()).to(torch.bfloat16)]
                             if variant == "f32_3xbf16" else [])
        wl = mm.w_layout(copies, p).reshape(-1)
        cl = mm.carry_layout(c, p, variant).reshape(-1)
        rows, S, N, ncols = p["rows"], p["slabs"], p["N"], p["ncols"]
        kw = k if p["w_resident"] else p["kc"]
        kcc = p["kc"] if p["grid"] else k
        rr, dd = torch.meshgrid(torch.arange(m), torch.arange(k),
                                indexing="ij")
        panel, r = rr // rows, rr % rows
        if variant == "f32":
            off = (panel * k + dd) * rows + r
            assert torch.equal(wl[off.reshape(-1)], w.reshape(-1))
        else:
            ck = 16 // copies[0].element_size()
            q, d = dd // kw, dd % kw
            for i, x in enumerate(copies):
                off = (((panel * (k // kw) + q) * len(copies) + i) * rows * kw
                       + _tc_off(r, d, kw, ck))
                assert torch.equal(wl[off.reshape(-1)], x.reshape(-1))
        kk, cc = torch.meshgrid(torch.arange(k), torch.arange(n),
                                indexing="ij")
        s, col = cc // ncols, cc % ncols
        q, d = kk // kcc, kk % kcc
        if p["grid"] == 2:   # [slab][k-chunk]
            chunk = s * (k // kcc) + q
        else:
            chunk = q * S + s
        if variant in ("f32", "i8_quant"):
            off = (chunk * kcc + d) * N + col
            assert torch.equal(cl[off.reshape(-1)], c.reshape(-1))
        elif variant == "i8":
            off = chunk * N * kcc + _tc_off(col, d, kcc, 16)
            want = torch.clamp(c * 100.0, -127, 127).to(torch.int8)
            assert torch.equal(cl[off.reshape(-1)], want.reshape(-1))
        else:
            split = 2 if variant == "f32_3xbf16" else 1
            hi = c.to(torch.bfloat16)
            base = chunk * split * N * kcc + _tc_off(col, d, kcc, 8)
            assert torch.equal(cl[base.reshape(-1)], hi.reshape(-1))
            if split == 2:
                lo = (c - hi.float()).to(torch.bfloat16)
                assert torch.equal(cl[(base + N * kcc).reshape(-1)],
                                   lo.reshape(-1))


# ------------------------------------------------------------------ K10
I8_SHAPE = (16, 128, 64)
I8_REPS = 2


@pytest.mark.parametrize("mode", int8.MODES)
def test_int8_plain_matches_jax_kernel(mode):
    mod, outs = load_script("microbench_int8")
    m, k, n = I8_SHAPE
    got = run_captured(outs, mod._chain, m, k, n, mode, I8_REPS)
    w, c0 = mm.make_inputs(m, k, n, CPU)
    c = int8.chain(w, c0, mode, I8_REPS)
    want = c[:8].double().sum(1).numpy()
    if mode == "i8":
        assert float(c.abs().max()) > 0
        np.testing.assert_array_equal(got[:, 0], want)
    else:
        assert float(c.abs().min()) > 0
        np.testing.assert_allclose(got[:, 0], want,
                                   rtol=sum_tol(int8.tol(mode, I8_REPS), n))


def test_int8_quant_scale_spans_each_group():
    """i8_quant's per-tensor scale: one over the whole carry (groups 1), or
    one per chain of K1's layout (groups = chains), each the abs-max of its
    own columns."""
    w, c0 = mm.make_inputs(16, 32, 16, CPU)
    c0[:, 8:] *= 100.0
    whole = int8.chain_reference(w, c0, "i8_quant", 1)
    split = int8.chain_reference(w, c0, "i8_quant", 1, groups=2)
    both = torch.cat([int8.chain_reference(w, c0[:, :8].contiguous(),
                                           "i8_quant", 1),
                      int8.chain_reference(w, c0[:, 8:].contiguous(),
                                           "i8_quant", 1)], 1)
    assert torch.equal(split, both)
    assert not torch.equal(whole[:, :8], split[:, :8])
    assert int8.groups(1280, None) == 1 and int8.groups(1280, int8.GRID) == 1
    assert int8.groups(132 * 56, 56) == 132
    assert int8.chain(w, c0, "i8_quant", 1, nb=8).equal(split)


# ------------------------------------------------------------------- K7
SEC_REPS = 2


def section_bodies():
    """{case: (body, shapes)} as the script's main hands them to slope."""
    mod, outs = load_script("microbench_sections")
    bodies = {}

    def capture(body, shapes, reps):
        bodies[case] = (body, shapes)
        return 0.0

    mod.slope = capture
    for case in ("render", "emb_cat", "emb_split", "ladder"):
        mod.main.__globals__["sys"] = types.SimpleNamespace(argv=["", case])
        mod.main()
    return mod, outs, bodies


@pytest.mark.parametrize("case", ["render", "emb_cat", "emb_split", "ladder"])
def test_sections_plain_match_jax_kernel(case):
    mod, outs, bodies = section_bodies()
    body, shapes = bodies[case]
    assert tuple(map(tuple, shapes)) == sections.SHAPES[case]
    got = run_captured(outs, mod._one, body, shapes, SEC_REPS)
    ins = sections.make_inputs(case, CPU)
    c = sections.chain(case, ins, SEC_REPS)
    np.testing.assert_allclose(
        got[:, 0], c[:8].double().sum(1).numpy(),
        rtol=sum_tol(sections.tol(case, SEC_REPS), c.shape[1]))
    # one step of the script's body itself, from the kernel's first carry
    c0 = ins[0] * 1.0001
    out = torch.from_numpy(np.array(body(
        [jnp.asarray(x.numpy()) for x in ins], jnp.asarray(c0.numpy()), 0)))
    if case == "render":
        torch.testing.assert_close(out, sections.render_step(ins, c0),
                                   rtol=1e-5, atol=0)
    else:
        inc, atol = sections.increment(case, c0, out)
        want = sections.section(case, ins, c0)
        # the step's roundings resolve a section to 0.12 at worst: far
        # below one emb band (6% of y, about 5) or one ladder level (~1)
        assert float(atol.max()) < 0.125
        probes.held(case, inc, want, sections.SECTION_RTOL, atol)


def test_ladder_sinpi_is_the_ladder_within_f32():
    """The port's sinpif per band and the double-angle ladder compute the
    same section (the sum of 12 sines and cosines) to f32 accuracy on these
    inputs (2.5e-05 apart at worst, against levels of size 1: the ladder's
    5 doublings amplify the f32 rounding of pi c up to 32x)."""
    ins = sections.make_inputs("ladder", CPU)
    c = ins[0] * 1.0001
    torch.testing.assert_close(sections.section("ladder", ins, c),
                               sections.section("ladder_sinpi", ins, c),
                               rtol=0, atol=5e-5)


def test_emb_plan_fits_covers_and_stays_resident():
    """K7's emb plan on a 132-SM card (``sections.emb_plan``, the mirror of
    csrc/sections.cu emb_plan_ok): a cluster of 2 blocks a slab of 20
    columns, each block keeping 64 rows of both W^T (192 KiB) beside the
    slab's two carry buffers within a block's shared memory; its panels
    cover y's 128 rows once (all of both products, rows 96-127 included)
    and its slabs the 1280 columns once; its 128 blocks all resident, one
    an SM. A card with too few SMs has no plan."""
    p = sections.emb_plan(132)
    assert p == {"cluster": 2, "rows": 64, "N": 20, "slabs": 64,
                 "threads": 128}
    assert all(sections.emb_plan_checks(p, 132).values())
    assert sections.emb_smem_bytes(p) == (
        4 * (384 * 2 * 64 + 2 * 96 * 20) + 24) <= mm.BLOCK_SMEM
    assert p["cluster"] * p["slabs"] == 128
    with pytest.raises(ValueError, match="no emb plan"):
        sections.emb_plan(100)
    assert not sections.emb_plan_checks({**p, "cluster": 4, "rows": 32},
                                        132)["built"]


def test_emb_w_layout_puts_each_element_where_the_kernel_reads_it():
    """``emb_w_layout``: block ``panel`` reads W1^T[k][r] at (k 2 + 0) rows
    + r and W2^T[k][r] at (k 2 + 1) rows + r of its panel (csrc/sections.cu
    emb_kernel's Wb), every element."""
    ins = sections.make_inputs("emb_cat", CPU)
    p = sections.emb_plan(132)
    rows = p["rows"]
    wl = sections.emb_w_layout(ins[1], ins[2], p).reshape(-1)
    rr, kk = torch.meshgrid(torch.arange(128), torch.arange(384),
                            indexing="ij")
    panel, r = rr // rows, rr % rows
    for prod, w in enumerate(ins[1:3]):
        off = ((panel * 384 + kk) * 2 + prod) * rows + r
        assert torch.equal(wl[off.reshape(-1)], w.reshape(-1))


@pytest.mark.parametrize("case", ["emb_cat", "emb_split"])
def test_emb_side_output_is_the_last_steps_rows_96_to_127(case):
    """The plain side output the kernel's rows 96-127 are held to: (w1 @
    emb + w2 @ emb)[96:] at the last step's carry, from the script's
    inputs, against numpy in f64 within the f32 rounding of a sum of 768
    positive terms (768 2^-24)."""
    reps = 3
    ins = sections.make_inputs(case, CPU)
    side = sections.side_reference(case, ins, reps)
    assert tuple(side.shape) == (32, sections.T)
    c = sections.chain_reference(case, ins, reps - 1).double().numpy()
    emb = np.concatenate([c, c * 0.5, c * 0.25, c * 0.125], 0)
    w1, w2 = (x.double().numpy() for x in ins[1:3])
    want = (w1 @ emb + w2 @ emb)[96:]
    np.testing.assert_allclose(side.double().numpy(), want,
                               rtol=768 * 2.0 ** -24)
    # and the carry the chain ends on is the step after it
    last = sections.chain_reference(case, ins, reps)
    torch.testing.assert_close(
        last, sections.step_reference(case, ins, torch.from_numpy(c).float()),
        rtol=0, atol=0)


def test_render_layout_round_trip():
    """The render kernel's layout ([OG, R, S]) and back is the identity on
    the script's [OG, S R] arrays (what the wrapper does around it)."""
    x = sections.make_inputs("render", CPU)[0] + torch.arange(
        sections.T, dtype=torch.float32)
    port = x.reshape(sections.OG, sections.S, sections.R).transpose(1, 2)
    assert float(port[3, 5, 2]) == float(x[3, 2 * sections.R + 5])
    assert torch.equal(port.transpose(1, 2).reshape(sections.OG, sections.T),
                       x)


def test_render_lane_order_stays_within_the_plain_chain():
    """The render kernel's order (``render_step_lanes``: a ray on two
    lanes, two-lane scans for the transmittance and the backward suffix,
    the halves' sums added, the row sums by the warps' butterflies) against
    the plain ``render_step`` over 3 steps, within ``tol("render", 3)``,
    and not equal to it: the reorder is seen and fits."""
    ins = sections.make_inputs("render", CPU)
    c = lanes = ins[0] * 1.0001
    for _ in range(3):
        c = sections.render_step(ins, c)
        lanes = sections.render_step_lanes(ins, lanes)
    probes.held("render lanes", lanes, c, sections.tol("render", 3))
    assert not torch.equal(lanes, c)


# ------------------------------------------------------------------- K8
OV_REPS = 2


@pytest.mark.parametrize("mode", ["vpu", "mxu", "both"])
def test_overlap_plain_matches_jax_kernel(mode):
    mod, outs = load_script("microbench_overlap")
    got = run_captured(outs, mod._run, mode, OV_REPS)
    v, c = overlap.chain(overlap.make_inputs(CPU), mode, OV_REPS)
    # the script kernel's [8, 128] output: v's row sums plus a block sum
    # of c
    v, c = v.double(), c.double()
    want = (v.sum(1, keepdim=True).expand(8, 128) + c[:8, :128].sum()).numpy()
    np.testing.assert_allclose(got, want, rtol=sum_tol(
        overlap.tol(OV_REPS), overlap.T))
    # the same kernel writing c[:8, :128] itself: v's row sums give 0, the
    # block sum of c gives the block
    mod, outs = load_script("microbench_overlap", sum=lambda x, *axis, **kw:
                            x if not axis and "axis" not in kw
                            else jnp.zeros_like(jnp.sum(x, *axis, **kw)))
    got = run_captured(outs, mod._run, mode, OV_REPS)
    assert float(np.abs(got).min()) > 0
    np.testing.assert_allclose(got, c[:8, :128].numpy(),
                               rtol=overlap.tol(OV_REPS))


@pytest.mark.parametrize("mode", ["vpu_bal", "both_bal"])
def test_overlap_balanced_plain_matches_jax_steps(mode):
    """The balanced case has no kernel in the script: its chains are the
    script's own ``vpu_step`` (BAL_ROUNDS / 4 calls a step) and
    ``mxu_step``, called on jnp arrays, held elementwise."""
    mod, _ = load_script("microbench_overlap")
    x = overlap.make_inputs(CPU)
    j = {k: jnp.asarray(x[k].numpy()) for k in ("a", "b", "w1", "w2", "c")}
    v, c = j["a"] * 1.0001, j["c"] * 1.0001
    for _ in range(OV_REPS):
        for _ in range(overlap.BAL_ROUNDS // 4):
            v = mod.vpu_step(v, j["a"], j["b"])
        if mode == "both_bal":
            c = mod.mxu_step(c, j["w1"], j["w2"])
    pv, pc = overlap.chain(x, mode, OV_REPS)
    assert float(pc.abs().min()) > 0
    np.testing.assert_allclose(np.asarray(v), pv.numpy(),
                               rtol=overlap.tol(OV_REPS))
    np.testing.assert_allclose(np.asarray(c), pc.numpy(),
                               rtol=overlap.tol(OV_REPS))


def test_overlap_layouts_put_each_element_where_the_kernel_reads_it():
    """K8's operands as csrc/overlap.cu reads them (chain.cuh tc_off,
    depth 128): W1 hi, W1 lo, W2 hi, W2 lo, element (r, d) of each at piece
    i's tc_off(r, d); the initial carry's hi / lo, element (d, column) of
    slab s at [s][hi, lo] tc_off(column - 16 s, d), where the fold writes
    each product's carry. The slab is 16 columns on a 132-SM card."""
    x = overlap.make_inputs(CPU)
    nb = overlap.plan(132)
    assert nb == 16 and overlap.plan(80) == 16 and overlap.plan(40) == 32
    wl = overlap.w_layout(x)
    assert tuple(wl.shape) == (4, 128 * 128)
    rr, dd = torch.meshgrid(torch.arange(128), torch.arange(128),
                            indexing="ij")
    off = _tc_off(rr, dd, 128, 8).reshape(-1)
    for i, name in enumerate(("w1_hi", "w1_lo", "w2_hi", "w2_lo")):
        assert torch.equal(wl[i][off], x[name].reshape(-1))
    c = x["c"] * 1.0001
    cl = overlap.carry_layout(c, nb)
    assert tuple(cl.shape) == (overlap.T // nb, 2, nb * 128)
    hi = c.to(torch.bfloat16)
    lo = (c - hi.float()).to(torch.bfloat16)
    dd, cc = torch.meshgrid(torch.arange(128), torch.arange(overlap.T),
                            indexing="ij")
    at = _tc_off(cc % nb, dd, 128, 8)
    assert torch.equal(cl[cc // nb, 0, at], hi)
    assert torch.equal(cl[cc // nb, 1, at], lo)


def test_overlap_fraction_is_the_scripts():
    assert overlap.overlap_fraction({"vpu": 2.0, "mxu": 3.0,
                                     "both": 3.0}) == 1.0
    assert overlap.overlap_fraction({"vpu": 2.0, "mxu": 3.0,
                                     "both": 5.0}) == 0.0
    assert overlap.overlap_fraction({"vpu": 9.0, "vpu_bal": 3.0, "mxu": 4.0,
                                     "both_bal": 5.5}, balanced=True) == 0.5
    # whole vpu_steps of 4 rounds (so an even count, half in each product)
    assert overlap.BAL_ROUNDS % 4 == 0


# ------------------------------------------------------------------- K9
VPU_REPS = 3


def _jnp(t: torch.Tensor):
    """A jnp copy of a CPU tensor (its own buffer, never an alias of
    torch's memory)."""
    return jnp.asarray(t.numpy().copy())


@pytest.fixture(scope="module")
def vpu_script():
    """microbench_vpu with its module-level REPS set to VPU_REPS: its
    ``make_kernel(rows, dt, op)(x)`` then returns the whole last tile."""
    mod, outs = load_script("microbench_vpu")
    mod.REPS = VPU_REPS
    return mod, outs


@pytest.mark.parametrize("rows", vpu.ROWS)
@pytest.mark.parametrize("op,route", [("mul", "f32"), ("mul", "bf16"),
                                      ("mixed", "f32"), ("mixed", "bf16"),
                                      ("sigmoid", "f32")])
def test_vpu_plain_matches_jax_kernel(vpu_script, rows, op, route):
    """The whole [rows, 1280] output of the script's kernel: bf16
    bit-equal to the port's plain per-op chain (JAX rounds after every
    operation, as torch does), f32 within rtol 1e-6 a step."""
    mod, outs = vpu_script
    x = vpu.make_inputs(rows, CPU)
    dt = jnp.float32 if route == "f32" else jnp.bfloat16
    got = run_captured(outs, mod.make_kernel(rows, dt, op), _jnp(x))
    want = vpu.chain(x, op, route, VPU_REPS).numpy()
    assert got.shape == (rows, vpu.T) and np.isfinite(got).all()
    if route == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want,
                                   rtol=vpu.F32_RTOL * VPU_REPS, atol=0)


@pytest.mark.parametrize("op", ["mul", "mixed"])
def test_vpu_bf16_fma_is_another_function(op):
    """bf16_fma rounds b a + a once a step: within one bf16 ulp a step of
    the exact (f64) chain on the same bf16 inputs (a, b0 = bf16(a
    bf16(1.0001)), bf16(a bf16(0.1))), yet not the script's function (it
    differs from the per-op chain), so ``vpu.hold`` tells them apart."""
    x = vpu.make_inputs(8, CPU)
    fma = vpu.chain(x, op, "bf16_fma", VPU_REPS)
    per_op = vpu.chain(x, op, "bf16", VPU_REPS)
    assert not torch.equal(fma, per_op)
    case = (8, op, "bf16")
    with pytest.raises(AssertionError):
        vpu.hold(case, fma, per_op, VPU_REPS)
    vpu.hold((8, op, "bf16_fma"), fma, fma, VPU_REPS)
    ab = x.to(torch.bfloat16)
    a = ab.double()
    tenth = (ab * torch.tensor(0.1, dtype=torch.bfloat16)).double()
    exact = (ab * torch.tensor(1.0001, dtype=torch.bfloat16)).double()
    for _ in range(VPU_REPS):
        exact = exact * a + a
        if op == "mixed":
            exact = torch.maximum(exact, tenth)
    assert float(((fma.double() - exact).abs()
                  / probes.ulp(exact, 8)).max()) <= VPU_REPS


@pytest.mark.parametrize("op", ["mul", "mixed"])
def test_vpu_timed_plain_chain_is_the_f32_torch_chain(op):
    """The plain bf16_fma chain that is timed (``exact`` off) sums b a + a
    in f32 before it rounds to bf16: within a bf16 ulp a step of the
    exact value the kernels are held to."""
    x = vpu.make_inputs(8, CPU)
    fast = vpu.chain_reference(x, op, "bf16_fma", VPU_REPS, exact=False)
    exact = vpu.chain_reference(x, op, "bf16_fma", VPU_REPS)
    vpu.hold((8, op, "bf16_fma"), fast, exact, VPU_REPS)


# ------------------------------------------------------------------- K5
def _record(name: str, rec: dict):
    """jnp.<name> that also records each concrete (untraced) result."""
    real = getattr(jnp, name)

    def fn(*args, **kw):
        out = real(*args, **kw)
        if not isinstance(out, jax.core.Tracer):
            rec.setdefault(name, []).append(np.asarray(out))
        return out
    return fn


@pytest.fixture(scope="module")
def ops_script():
    """microbench_ops with each case's body captured as its main hands it
    to ``run_kernel``, and jnp.dot / jnp.concatenate recording what a
    body computes when called on jnp arrays (lanesum_dot's whole product,
    strided_sum's and serial_tiles' increments)."""
    rec: dict = {}
    mod, outs = load_script("microbench_ops",
                            dot=_record("dot", rec),
                            concatenate=_record("concatenate", rec))
    bodies = {}

    def capture(body, shapes, reps):
        bodies[case] = (body, tuple(map(tuple, shapes)), reps)
        return 0.0

    mod.run_kernel = capture
    for case in ops.CASES:
        mod.main.__globals__["sys"] = types.SimpleNamespace(argv=["", case])
        mod.main()
    return mod, outs, bodies, rec


@pytest.mark.parametrize("case", ops.CASES)
def test_ops_plain_step_matches_jax_body(ops_script, case):
    """The script's body, called on jnp arrays for 1 and 3 steps, against
    the port's plain chain elementwise (``ops.tol``), and the work the
    carry cannot see: lanesum_dot's whole [8, 128] product, strided_sum's
    and serial_tiles' increments (the body's concat), and those
    increments read from one step of the body as ``probes.increment``
    reads them."""
    _, _, bodies, rec = ops_script
    body, shapes, reps = bodies[case]
    assert shapes == ops.SHAPES[case] and reps == ops.REPS[case]
    ins = ops.make_inputs(case, CPU)
    j = [_jnp(x) for x in ins]
    c0 = ins[0] * 1.0001
    for n in (1, 3):
        c = _jnp(c0)
        for _ in range(n):
            rec.clear()
            c = body(j, c, 0)
        want, work = ops.chain_reference(case, ins, n)
        assert float(want.abs().min()) > 0
        np.testing.assert_allclose(np.asarray(c), want.numpy(),
                                   rtol=ops.tol(case, n), atol=0)
        if case == "lanesum_dot":
            np.testing.assert_allclose(rec["dot"][-1], work.numpy(),
                                       rtol=ops.tol(case, n), atol=0)
        if case in ops.KEEP:
            np.testing.assert_allclose(
                rec["concatenate"][-1], ops.increment_of(case, work).numpy(),
                rtol=ops.tol(case, n), atol=0)
    if case in ops.KEEP:
        out = torch.from_numpy(np.array(body(j, _jnp(c0), 0)))
        inc, atol = probes.increment(ops.KEEP[case], ops.WORK_SCALE, c0, out)
        want = ops.increment_of(case, ops.step_reference(case, ins, c0)[1])
        probes.held(case, inc, want, ops.RTOL, atol)


@pytest.mark.parametrize("case", ops.CASES)
def test_ops_plain_matches_jax_kernel_row_sums(ops_script, case):
    """The script's kernel (``_one``, 3 reps): its row sums of c[:8]."""
    mod, outs, bodies, _ = ops_script
    body, shapes, _ = bodies[case]
    got = run_captured(outs, mod._one, body, shapes, 3)
    c, _ = ops.chain(case, ops.make_inputs(case, CPU), 3)
    np.testing.assert_allclose(got[:, 0], c[:8].double().sum(1).numpy(),
                               rtol=sum_tol(ops.tol(case, 3), c.shape[1]))


def test_ops_cpu_run_reports_the_pair_spread(monkeypatch, capsys):
    """Every case is timed, dep_fma and ind_fma RUNS times each, and their
    difference is printed against their spread."""
    monkeypatch.setattr(ops, "REPS", {c: 1 for c in ops.CASES})
    res = ops.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "plain PyTorch version, not a device time" in out
    assert "dep_fma - ind_fma:" in out
    assert [r["case"] for r in res] == list(ops.CASES)
    assert [len(r.get("ns_per_op_runs", ())) for r in res[:2]] == [
        ops.RUNS] * 2


@pytest.mark.parametrize("sms", [132, 6])
def test_lanesum_plan_fits_covers_and_stays_resident(sms):
    """lanesum_dot's plan (``ops.lanesum_plan``, the mirror of csrc/ops.cu
    ls_plan_ok): on 132 SMs a cluster of 8 blocks, each keeping 160 rows
    of m (80 KB) beside c's slice, the warps' and the block's partials; on
    6 SMs a cluster of 4 (320 rows, 160 KB). The panels cover m's 1280
    rows once, every block's shared memory fits, the cluster is a size
    the kernel is built for and no larger than the card, 8 warps a block.
    Too few SMs: no plan."""
    p = ops.lanesum_plan(sms)
    cluster = 8 if sms >= 8 else 4
    assert p == {"cluster": cluster, "rows": 1280 // cluster, "warps": 8}
    assert all(ops.lanesum_plan_checks(p, sms).values())
    assert ops.lanesum_smem_bytes(p) == 4 * (
        p["rows"] * 128 + p["rows"] * 8 + 8 * 8 * 128 + 2 * 8 * 128
        + 2 * cluster * 8) + 24
    assert ops.lanesum_smem_bytes(p) <= 227 * 1024 == mm.BLOCK_SMEM
    assert p["cluster"] in ops.LANESUM_BUILT and p["cluster"] <= sms
    assert not ops.lanesum_plan_checks({**p, "cluster": 2, "rows": 640},
                                       sms)["built"]
    assert not ops.lanesum_plan_checks({**p, "rows": p["rows"] - 8},
                                       sms)["rows_once"]
    assert not ops.lanesum_plan_checks({**p, "warps": 4}, sms)["warps"]
    with pytest.raises(ValueError, match="no lanesum_dot plan"):
        ops.lanesum_plan(3)


def test_lanesum_m_layout_puts_each_element_where_the_kernel_reads_it():
    """``lanesum_m_layout``: block b reads m[b rows + k][n] at k 128 + n of
    its panel (csrc/ops.cu lanesum_kernel's bulk copy of panel b, then lane
    n // 4 of the warp owning k), every element, without a copy."""
    m = ops.make_inputs("lanesum_dot", CPU)[1]
    for sms in (132, 6):
        p = ops.lanesum_plan(sms)
        wl = ops.lanesum_m_layout(m, p)
        assert tuple(wl.shape) == (p["cluster"], p["rows"], 128)
        assert wl.data_ptr() == m.data_ptr()
        b, k, n = torch.meshgrid(torch.arange(p["cluster"]),
                                 torch.arange(p["rows"]), torch.arange(128),
                                 indexing="ij")
        flat = wl.reshape(-1)
        off = (b * p["rows"] + k) * 128 + n
        assert torch.equal(flat[off.reshape(-1)],
                           m[(b * p["rows"] + k).reshape(-1),
                             n.reshape(-1)])


@pytest.mark.parametrize("sms", [132, 6])
def test_lanesum_cluster_order_stays_within_the_plain_chain(sms):
    """y in the kernel's order (``ops.lanesum_y_cluster``: each warp's rows
    of m by FMA in order, the warps' partials in warp order, the blocks'
    in block order), fed back as the kernel does (c <- y[:, 0]) for 3
    steps, against ``ops.chain_reference``: the carry and the last step's
    whole y within ``ops.tol``."""
    ins = ops.make_inputs("lanesum_dot", CPU)
    p = ops.lanesum_plan(sms)
    c = ins[0] * 1.0001
    for _ in range(3):
        y = ops.lanesum_y_cluster(c, ins[1], p)
        c = y[:, :1].expand_as(c).contiguous()
    want, want_y = ops.chain_reference("lanesum_dot", ins, 3)
    probes.held("lanesum carry", c, want, ops.tol("lanesum_dot", 3))
    probes.held("lanesum y", y, want_y, ops.tol("lanesum_dot", 3))
    assert not torch.equal(y, want_y)


def test_ind_fma_tree_order_stays_within_the_plain_chain():
    """ind_fma in the kernel's order (``ops.ind_fma_tree``: each term one
    FMA, the 8 terms added as a 3-level tree, then / 8) for 3 steps against
    ``ops.chain_reference`` (the terms rounded twice and added in order)
    within ``ops.tol``, and not equal to it: the reorder is seen and
    fits."""
    ins = ops.make_inputs("ind_fma", CPU)
    c = ins[0] * 1.0001
    for _ in range(3):
        c = ops.ind_fma_tree(ins, c)
    want, _ = ops.chain_reference("ind_fma", ins, 3)
    probes.held("ind_fma tree", c, want, ops.tol("ind_fma", 3))
    assert not torch.equal(c, want)


# ------------------------------------- K7's ladders and K5's elementwise
# name: (its plan on sms SMs, its items, its plan on 132 SMs)
SPREADS = {
    "ladder": (sections.ladder_plan, 96 * 1280, (132, 480, 2)),
    "ew_8": (lambda sms: ops.ew_plan("ind_fma", sms), 8 * 1280, (132, 96, 1)),
    "sincos": (lambda sms: ops.ew_plan("sincos", sms), 96 * 1280,
               (132, 480, 2)),
    "vpu_f32_8": (lambda sms: vpu.plan((8, "mul", "f32"), sms), 10_240,
                  (132, 96, 1)),
    "vpu_f32_96": (lambda sms: vpu.plan((96, "sigmoid", "f32"), sms),
                   122_880, (132, 480, 2)),
    "vpu_pairs_8": (lambda sms: vpu.plan((8, "mul", "bf16_fma"), sms),
                    5_120, (132, 64, 1)),
    "vpu_pairs_96": (lambda sms: vpu.plan((96, "mixed", "bf16"), sms),
                     61_440, (132, 480, 1)),
    "vpu_fma_96": (lambda sms: vpu.plan((96, "mul", "bf16_fma"), sms),
                   61_440, (132, 256, 2))}


@pytest.mark.parametrize("sms", [132, 114, 66, 8])
@pytest.mark.parametrize("which", sorted(SPREADS))
def test_elementwise_spread_covers_once_in_whole_warps(which, sms):
    """The ladders', K5's elementwise cases' and K9's spread (``probes.
    spread_plan``, the mirror of csrc/probe_common.cuh spread_ok /
    spread_first): every one of the items (122,880 / 10,240 elements of
    the [96, 1280] / [8, 1280] carries; K9's bf16 pairs 61,440 / 5,120)
    once, each warp holding whole units of 32 x items (so a vote over its
    lanes is valid), a block within the kernels' 512 threads, the blocks
    within one unit of each other and as many on every SM. On 132 SMs one
    block an SM: 15 warps of two elements a lane for the [96, 1280]
    carries (14 or 15 of them holding elements, where the old grid's 480
    blocks put 3 or 4 on an SM), 15 of one pair for K9's [96, 1280]
    pairs (8 of two for bf16_fma's mul), 3 warps of one for the [8, 1280]
    ones (at most one a scheduler,
    where the old grid ran them on 40 SMs), 2 for K9's [8, 1280] pairs
    (on 20)."""
    plan_of, n, at_132 = SPREADS[which]
    p = plan_of(sms)
    assert all(probes.spread_plan_checks(p, n, sms).values())
    per = [len(e) // (32 * p["items"]) for e in probes.spread_elements(p, n)]
    units = n // (32 * p["items"])
    if sms == 132:
        assert p == dict(zip(probes.SPREAD_FIELDS, at_132))
        assert max(per) == -(-units // 132) and min(per) == units // 132
    assert sum(per) == units
    # a lane's elements 32 apart: the first warp of block 0 holds unit 0
    first = probes.spread_elements(p, n)[0][:32 * p["items"]]
    assert first == list(range(32 * p["items"]))
    assert not probes.spread_plan_checks({**p, "threads": 32}, n,
                                         sms)["once"]
    with pytest.raises(ValueError, match="whole units"):
        probes.spread_plan(n + 32, p["items"], sms) if p["items"] == 2 \
            else probes.spread_plan(n + 16, 1, sms)


def test_fast_check_ranges_count_their_floats():
    """``sections.FAST_CHECKS`` report the floats of each fast path's range
    (csrc/probe_common.cuh rcp_fast_ok, trig_fast_ok, sincospi_fast_ok,
    sigmoid_fast_ok), counted here from the bit patterns: exponent fields
    1-252 of both signs; |x| < 105615 of both signs; 0 < a < 2^21; c > -87
    (+0 to +inf, -0 to the float above -87)."""
    def bits(x):
        return int(np.float32(x).view(np.uint32))
    got = {k: v[1] for k, v in sections.FAST_CHECKS.items()}
    assert got["render reciprocal"] == 2 * (bits(2.0 ** 126) - bits(2.0 ** -126))
    assert got["sin / cos"] == 2 * bits(105615.0)
    assert got["sinpi / cospi"] == bits(2.0 ** 21) - 1
    assert got["sigmoid reciprocal"] == bits(np.inf) + 1 + bits(87.0)
    assert sorted(v[0] for v in sections.FAST_CHECKS.values()) == [0, 1, 2, 3]


SASS = """
\t\tFunction : _Z3fooPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 EXIT ;                        /* 0x000000000000094d */
        /*0020*/                   FFMA R2, R2, R3, R4 ;
        /*0030*/                   BSSY B0, 0x60 ;
        /*0040*/               @P1 CALL.REL.NOINC 0x90 ;
        /*0050*/                   BSYNC B0 ;
        /*0060*/               @P0 BRA 0x20 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
        /*0090*/                   RET.REL.NODEC R20 0x0 ;
        /*00a0*/                   NOP;
\t\tFunction : _Z3barv
        /*0000*/                   EXIT ;
"""


def test_sass_counts_kernels_loops_and_paths():
    """``probes.sass`` on cuobjdump's layout: a function a ``Function :``
    header; the step loop (0x20-0x60, a backward branch's span) with its
    call and convergence region; the self-branch padding and NOPs left
    out; ``path_count`` a span less another."""
    from vmap_tpu_torch.probes import sass
    funcs = sass.split_functions(SASS)
    assert list(funcs) == ["_Z3fooPf", "_Z3barv"]
    c = sass.count(funcs["_Z3fooPf"])
    assert (c["instructions"], c["branches"], c["calls"], c["bssy"]) == \
        (9, 1, 1, 1)
    assert [(lp["start"], lp["end"], lp["instructions"]) for lp in
            c["loops"]] == [("0020", "0060", 5)]
    assert sass.path_count(funcs["_Z3fooPf"], (0x20, 0x60),
                           ((0x40, 0x40),))["instructions"] == 4
    assert sass.count(funcs["_Z3barv"])["instructions"] == 1


def test_sass_same_code_tells_split_builds_apart():
    """``probes.sass.same_code``: two builds whose kernels have the same
    instructions are the same, whatever the encodings; a changed
    instruction or a kernel one build lacks is reported with both builds'
    instruction counts. The build without the split flags hashes apart."""
    from vmap_tpu_torch.kernels import _build
    from vmap_tpu_torch.probes import sass
    funcs = sass.split_functions(SASS)
    split = {name: (name, lines) for name, lines in funcs.items()}
    recoded = {name: (name, [ln.split("/* 0x")[0] for ln in lines])
               for name, lines in funcs.items()}
    assert sass.same_code(split, recoded) == {"kernels": [2, 2], "same": 2,
                                              "differ": {}}
    changed = dict(recoded, _Z3fooPf=("_Z3fooPf", [
        ln.replace("FFMA", "FMUL") for ln in funcs["_Z3fooPf"]]))
    del changed["_Z3barv"]
    assert sass.same_code(split, changed) == {
        "kernels": [2, 1], "same": 0,
        "differ": {"_Z3barv": [1, None], "_Z3fooPf": [9, 9]}}
    assert _build.NVCC_FLAGS[:len(_build.BASE_FLAGS)] == _build.BASE_FLAGS
    assert probes.LIBRARY.source_hash() != probes.LIBRARY.source_hash(
        flags=_build.BASE_FLAGS)


# ------------------------------------------------------------------- K6
DMA_N = 40


@pytest.mark.parametrize("n_live", [1, 8])
def test_dma_plain_matches_jax_kernel_and_its_race(n_live):
    """The script's kernel checksums a race: it waits on copy i, starts
    copy i + n_live into the same slot, then reads the slot. In interpret
    mode a copy completes when it starts, so it sums word 0 of copy i +
    n_live for i < n - n_live and of copy i for the last n_live. That sum,
    computed from the port's row sequence, is held equal to JAX's output
    of ``build(n, n_live)`` (the port's addressing against the script's);
    the port's defined checksum to the same rows' own words; its n_live
    final slots to the last n_live copies' rows."""
    mod, outs = load_script("microbench_dma")
    src = dma.make_source(4096, CPU)
    got = run_captured(outs, mod.build(DMA_N, n_live),
                       jnp.asarray(src.numpy().view(np.uint32).copy()))
    case = "bulk" if n_live == dma.LIVE else "bulk_live1"
    assert dma.LIVE_OF.get(case, dma.LIVE) == n_live
    plain = dma.run_case(case, src, DMA_N)
    rows = plain["rows"][0].tolist()
    words = [int(src[r, 0]) for r in rows]
    racy = (sum(words[n_live:]) + sum(words[-n_live:])) & dma.MASK
    assert int(got[0, 0]) == racy
    assert int(plain["sums"][0]) == sum(words) & dma.MASK != racy
    assert plain["slots"].shape == (1, n_live, 8, dma.COLS)
    for i in range(DMA_N - n_live, DMA_N):
        assert torch.equal(plain["slots"][0, i % n_live],
                           src[rows[i]:rows[i] + 8])


@pytest.mark.parametrize("live", [1, 3, 8])
def test_dma_warps_take_every_copy_and_byte_once(live):
    """The kernels' layout (csrc/dma.cu: a warp a slot): the slots' warps
    make every copy once, warp s the copies i with i mod live = s in
    order, so each slot ends with the last such copy, as the plain
    version's slots say; the cp_async route's 16-byte chunks, spread over
    the slot's warps (the block's 8 at one in flight, else one, at most 8
    in a block), cover a copy's 4 KB once, word 0, the one the
    checksum reads, in the reader's (the group's thread 0) own chunk;
    and the warps' partial checksums added in slot order are the plain
    checksum."""
    per = dma.slot_copies(DMA_N, live)
    assert sorted(i for copies in per for i in copies) == list(range(DMA_N))
    assert all(c == sorted(c) and all(i % live == s for i in c)
               for s, c in enumerate(per))
    chunks = dma.chunk_writes(live)
    got = sorted(b for _, first in chunks for b in range(first, first + 16))
    assert got == list(range(dma.COPY_BYTES))
    assert [t for t, first in chunks if first == 0] == [0]
    assert live * dma.group_warps(live) <= 8
    assert len({t for t, _ in chunks}) == 32 * dma.group_warps(live)
    src = dma.make_source(4096, CPU)
    plain = dma.chain_reference(src, DMA_N, live=live)
    words = src[plain["rows"][0], 0].long()
    parts = [int(words[c].sum()) & dma.MASK for c in per]
    assert sum(parts) & dma.MASK == int(plain["sums"][0])
    for s, c in enumerate(per):
        last = int(plain["rows"][0, c[-1]])
        assert torch.equal(plain["slots"][0, s], src[last:last + 8])


def test_dma_blocks_take_their_own_stretch_of_the_rows():
    """Block b continues the row sequence at copy b n; each block's
    checksum and slots are its own rows'."""
    src = dma.make_source(4096, CPU)
    many = dma.chain_reference(src, DMA_N, 3)
    assert many["rows"][1, 0] == DMA_N * 37 % (4096 - 8)
    for b in range(3):
        words = src[many["rows"][b], 0].long()
        assert int(many["sums"][b]) == int(words.sum()) & dma.MASK
        last = int(many["rows"][b, -1])
        assert torch.equal(many["slots"][b, (DMA_N - 1) % 8],
                           src[last:last + 8])


@pytest.mark.parametrize("grain_rows", [(1, 4096), (8, 8 * 3 * DMA_N + 8)])
def test_dma_row_sequence_and_its_grain(grain_rows):
    """Grain 1 is the script's (i 37) mod (rows - 8); grain 8 on a source
    of 8 blocks n + 8 rows puts every copy of a launch on its own 8 rows,
    so no byte is read twice."""
    grain, rows = grain_rows
    seq = dma.copy_rows(rows, DMA_N, 3, grain)
    if grain == 1:
        assert seq[0].tolist() == [i * 37 % (rows - 8) for i in range(DMA_N)]
        return
    assert bool((seq % 8 == 0).all())
    assert len(set(seq.reshape(-1).tolist())) == 3 * DMA_N
    assert int(seq.max()) + 8 <= rows
    src = dma.make_source(rows, CPU)
    many = dma.chain_reference(src, DMA_N, 3, grain)
    for b in range(3):
        last = int(seq[b, -1])
        assert torch.equal(many["slots"][b, (DMA_N - 1) % 8],
                           src[last:last + 8])


def test_dma_bound_counts_each_byte_once():
    """K6's bound: distinct source bytes over the HBM rate, or a copy's
    4 KB into one SM's shared memory. The 2 MiB source is read whole by
    the first 4000 copies (no new byte a copy: the shared-memory term);
    bulk_hbm's 16000 copies and bulk_hbm_132's 132 x 16000 read distinct
    rows (4 KB a copy of each block at 3.35 TB/s)."""
    smem = dma.COPY_BYTES / probes.SMEM_BYTES_PER_SM * 1e3
    hbm = dma.COPY_BYTES / probes.PEAK_BYTES * 1e3
    # rows 0 .. 4094: a copy starts at most at row 4087
    assert dma.unique_bytes("bulk", dma.N1) == dma.unique_bytes(
        "bulk", dma.N2) == 4095 * 128 * 4
    for case in ("bulk", "cp_async", "bulk_hbm"):
        assert dma.bound({"case": case}) == {"bound_ms": smem,
                                             "bound_by": "bytes"}
    assert dma.unique_bytes("bulk_hbm", dma.N2) == dma.N2 * dma.COPY_BYTES
    assert dma.unique_bytes("bulk_hbm_132", dma.N2) == (
        132 * dma.N2 * dma.COPY_BYTES)
    got = dma.bound({"case": "bulk_hbm_132"})
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(132 * hbm, rel=1e-12)


def test_probe_bounds_count_the_step():
    """Each probe module's ``bound`` (the kernels line's bound_ms): a few
    cases against the count by hand."""
    f32_ops, sfu = probes.PEAK_F32 / 2, 132 * 16 * 1.98e9
    assert mm.bound({"m": 128, "k": 128, "n": 1280, "ind": 1,
                     "variant": "bf16"})["bound_ms"] == pytest.approx(
        2.0 * 128 * 128 * 1280 / 989e12 * 1e3)
    assert int8.bound({"m": 128, "k": 128, "n": 1280, "mode": "i8"})[
        "bound_ms"] == pytest.approx(2.0 * 128 * 128 * 1280 / 1979e12 * 1e3)
    assert vpu.bound({"rows": 96, "op": "mul", "route": "bf16"}) == {
        "bound_ms": pytest.approx(2 * 96 * 1280 / (2 * f32_ops) * 1e3),
        "bound_by": "operations"}
    assert vpu.bound({"rows": 8, "op": "sigmoid", "route": "f32"})[
        "bound_ms"] == pytest.approx(2 * 8 * 1280 / sfu * 1e3)
    assert ops.bound({"case": "dep_fma"})["bound_ms"] == pytest.approx(
        8 * 1280 / f32_ops * 1e3)
    assert sections.bound({"case": "emb_cat"})["bound_by"] == "operations"
    assert overlap.bound({"case": "mxu"})["bound_ms"] == pytest.approx(
        2 * 3 * 2.0 * 128 * 128 * 1280 / 989e12 * 1e3)


def test_timed_library_columns_name_one_call_or_none():
    """Where no single PyTorch call computes a step, ``library_ms`` is
    None without timing anything (K9's per-op bf16 chain: addcmul rounds
    once; mixed; K5's elementwise chains; K7; K8; K10's i8_quant)."""
    assert vpu.library_ms({"op": "mul", "route": "bf16"}, CPU) is None
    assert vpu.library_ms({"op": "mixed", "route": "f32"}, CPU) is None
    assert ops.library_ms({"case": "strided_sum"}, CPU) is None
    assert sections.library_ms({"case": "render"}, CPU) is None
    assert overlap.library_ms({"case": "both"}, CPU) is None
    assert int8.library_ms({"mode": "i8_quant"}, CPU) is None


class _Calls(torch.overrides.TorchFunctionMode):
    """Counts the torch functions a chain calls, by name."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["emb_cat", "emb_split", "mxu"])
def test_library_chains_are_one_matmul_a_product(case):
    """K7's emb cases and K8's mxu name ``torch.matmul`` as their library
    call (the docstring says so), and the chain ``library_ms`` times is
    ``torch.matmul`` a product (two a step) computing the plain chain's
    function within its tolerance, here on the CPU."""
    reps = 2
    mod = overlap if case == "mxu" else sections
    assert "torch.matmul" in mod.library_ms.__doc__
    if case == "mxu":
        x = overlap.make_inputs(CPU)
        run = overlap.library_chain(x)
        want = overlap.chain_reference(x, "mxu", reps)[1]
        rtol = overlap.tol(reps)
    else:
        ins = sections.make_inputs(case, CPU)
        run = sections.library_chain(ins)
        want = sections.chain_reference(case, ins, reps)
        rtol = sections.tol(case, reps)
    with _Calls() as rec:
        got = run(reps)
    assert rec.calls.get("matmul") == 2 * reps
    assert not {"__matmul__", "mm", "bmm"} & set(rec.calls)
    probes.held(case, got, want, rtol)


def test_dep_fma_library_chain_is_one_addcmul_a_step():
    """K5's dep_fma names ``torch.addcmul`` as its library call (the
    docstring says so), and the chain ``library_ms`` times is one
    ``torch.addcmul`` a step computing the plain chain's function within
    its tolerance, here on the CPU."""
    reps = 3
    assert "torch.addcmul" in ops.library_chain.__doc__
    ins = ops.make_inputs("dep_fma", CPU)
    with _Calls() as rec:
        got = ops.library_chain("dep_fma", ins)(reps)
    assert rec.calls.get("addcmul") == reps
    probes.held("dep_fma", got, ops.chain_reference("dep_fma", ins, reps)[0],
                ops.tol("dep_fma", reps))


class _FastCheckLibrary:
    """Stands in for the probe library: its fast check adds ``counts``
    (mismatches, floats admitted) to the two counters it is given."""

    def __init__(self, counts):
        self.counts = counts

    def load(self):
        return self

    def check(self, code, what):
        assert code == 0, what

    def vmap_probe_fast_check(self, kind, count, sms, stream):
        arr = (ctypes.c_int64 * 2).from_address(count.value)
        arr[0] += self.counts[0]
        arr[1] += self.counts[1]
        return 0


@pytest.mark.parametrize("mismatches,short,raises", [
    (0, 0, None), (0, 1, "admitted"), (2, 0, "2 of")])
def test_fast_check_raises_unless_the_card_counts_the_range(
        monkeypatch, mismatches, short, raises):
    """``sections.fast_check`` takes the floats covered from the card's
    count, not from FAST_CHECKS: it raises where the range test admitted
    other floats than the range's, or where any float differs, and
    reports the counted floats and mismatches."""
    name = "sin / cos"
    floats = sections.FAST_CHECKS[name][1]
    monkeypatch.setattr(probes, "LIBRARY",
                        _FastCheckLibrary((mismatches, floats - short)))
    monkeypatch.setattr(probes, "stream", lambda dev: ctypes.c_void_p(None))
    if raises:
        with pytest.raises(AssertionError, match=raises):
            sections.fast_check(name, CPU)
    else:
        r = sections.fast_check(name, CPU)
        assert (r["floats"], r["mismatches"]) == (floats, 0)


# ------------------------------------------------------- entry points
@pytest.mark.parametrize("name", ["mm", "int8", "sections", "overlap",
                                  "vpu", "ops", "dma"])
def test_probe_needs_cuda_unless_asked_for_the_cpu(name):
    mod = {"mm": mm, "int8": int8, "sections": sections,
           "overlap": overlap, "vpu": vpu, "ops": ops, "dma": dma}[name]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])


def test_cpu_run_is_labelled_plain(monkeypatch, capsys):
    monkeypatch.setattr(sections, "BASE_REPS", 1)
    res = sections.main(["ladder", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "plain PyTorch version, not a device time" in out
    assert res[0]["case"] == "ladder" and res[0]["reps"] == (1, 4)


def test_slope_is_the_two_point_rep_slope(monkeypatch):
    times = {10: 2.0, 40: 5.0}
    monkeypatch.setattr(_timing, "launch_ms",
                        lambda run, reps, dev: times[reps])
    assert _timing.slope(None, 10, 40, CPU)["step_ns"] == pytest.approx(
        (5.0 - 2.0) / 30 * 1e6)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """On a CPU tensor a probe runs its plain version and counts no launch;
    a CUDA launch path refuses CPU tensors."""
    before = dict(probes.LAUNCHES)
    w, c0 = mm.make_inputs(16, 16, 8, CPU)
    mm.chain(mm.operands(w, "f32", 1), c0, "f32", 1, 0.5)
    assert probes.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        probes.check_cuda(c0)


@pytest.mark.parametrize("name", ["vpu", "ops", "dma"])
def test_new_probe_launchers_refuse_cpu_tensors(name):
    """The launchers take CUDA tensors only: on a CPU tensor they raise
    before any library is built (the chains' CPU path is the plain
    version), and count no launch."""
    before = dict(probes.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if name == "vpu":
            vpu.launch(vpu.make_inputs(8, CPU), "mul", "bf16", 1)
        elif name == "ops":
            ops.launch("lanesum_dot", ops.make_inputs("lanesum_dot", CPU), 1)
        else:
            dma.launch(dma.make_source(4096, CPU), 8, 0)
    assert probes.LAUNCHES == before


def test_probe_imports_stay_jax_free():
    """Importing every probe module (and running a plain chain) imports
    neither jax nor the JAX package."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from vmap_tpu_torch.probes import (mm, int8, sections, overlap,\n"
        "                                   vpu, ops, dma)\n"
        "w, c = mm.make_inputs(16, 32, 32, torch.device('cpu'))\n"
        "int8.chain(w, c, 'i8_quant', 1)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vmap_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'vmap_tpu.')))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
