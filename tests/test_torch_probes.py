"""The port's probes (``vmap_tpu_torch.probes``: K4 mm, K10 int8, K7
sections, K8 overlap) against the JAX scripts' own Pallas kernels
(``scripts/microbench_*.py``) in interpret mode, on the CPU.

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
from vmap_tpu_torch.probes import _timing, int8, mm, overlap, sections

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


class _Stop(Exception):
    pass


def load_script(name: str, jnp_sum=None):
    """``scripts/<name>.py`` with ``pl.pallas_call`` captured and forced
    to interpret mode, and ``jax.jit`` the identity (``jnp_sum``: in
    place of the script's ``jnp.sum``). Returns (module, list the kernel
    outputs are appended to)."""
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

    mod.pl = types.SimpleNamespace(pallas_call=pallas_call,
                                   BlockSpec=real_pl.BlockSpec)
    proxy = types.ModuleType("jax_proxy")
    proxy.__dict__.update({k: getattr(jax, k) for k in dir(jax)
                           if not k.startswith("__")})
    proxy.jit = lambda f: f
    mod.jax = proxy
    if jnp_sum is not None:
        np_proxy = types.ModuleType("jnp_proxy")
        np_proxy.__dict__.update({k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
        np_proxy.sum = jnp_sum
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
    """W's copy is staged where it fits beside the carry with the whole
    grid resident: the script's [128, 128] (160 blocks, 72 KB each) and
    K1's h=32 / 128 products; not [128, 384] in f32 (two blocks of 209 KB
    an SM would be needed) nor K1's h=256 in f32 (W alone 256 KB), where
    the kernel reads W from L2."""
    assert mm.smem_bytes("f32", 128, 384, 8, 1, True) == 4 * (
        384 * 8 + 128 * 8 + 384 * 128)
    assert mm.smem_bytes("f32_3xbf16", 256, 256, 38, 1, False) == (
        4 * 256 * 40 + 2 * 2 * 264 * 40)
    assert mm.stages_w("f32", 128, 128, 1280, 8, 1)
    assert not mm.stages_w("f32", 128, 384, 1280, 8, 1)
    assert mm.stages_w("f32", 128, 128, 132 * 56, 56, 1)
    assert not mm.stages_w("f32", 256, 256, 132 * 38, 38, 1)
    assert mm.stages_w("bf16", 256, 256, 132 * 38, 38, 1)
    assert int8.stages_w("i8_quant", 128, 128, 1280, 80)
    assert not int8.stages_w("i8", 512, 512, 1280, 8)


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
    assert int8.layout("i8_quant", 1280) == (80, 16)
    assert int8.layout("i8", 1280) == (8, 1)
    assert int8.layout("i8_quant", 132 * 56, 56) == (56, 1)


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


def test_render_layout_round_trip():
    """The render kernel's layout ([OG, R, S]) and back is the identity on
    the script's [OG, S R] arrays (what the wrapper does around it)."""
    x = sections.make_inputs("render", CPU)[0] + torch.arange(
        sections.T, dtype=torch.float32)
    port = x.reshape(sections.OG, sections.S, sections.R).transpose(1, 2)
    assert float(port[3, 5, 2]) == float(x[3, 2 * sections.R + 5])
    assert torch.equal(port.transpose(1, 2).reshape(sections.OG, sections.T),
                       x)


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
    mod, outs = load_script("microbench_overlap", jnp_sum=lambda x, *axis, **kw:
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


def test_overlap_fraction_is_the_scripts():
    assert overlap.overlap_fraction({"vpu": 2.0, "mxu": 3.0,
                                     "both": 3.0}) == 1.0
    assert overlap.overlap_fraction({"vpu": 2.0, "mxu": 3.0,
                                     "both": 5.0}) == 0.0
    assert overlap.overlap_fraction({"vpu": 9.0, "vpu_bal": 3.0, "mxu": 4.0,
                                     "both_bal": 5.5}, balanced=True) == 0.5
    # whole vpu_steps of 4 rounds (so an even count, half in each product)
    assert overlap.BAL_ROUNDS % 4 == 0


# ------------------------------------------------------- entry points
@pytest.mark.parametrize("name", ["mm", "int8", "sections", "overlap"])
def test_probe_needs_cuda_unless_asked_for_the_cpu(name):
    mod = {"mm": mm, "int8": int8, "sections": sections,
           "overlap": overlap}[name]
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


def test_probe_imports_stay_jax_free():
    """Importing every probe module (and running a plain chain) imports
    neither jax nor the JAX package."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from vmap_tpu_torch.probes import mm, int8, sections, overlap\n"
        "w, c = mm.make_inputs(16, 32, 32, torch.device('cpu'))\n"
        "int8.chain(w, c, 'i8_quant', 1)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vmap_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'vmap_tpu.')))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
