"""The field kernels' tensor-core route (vmap_tpu_torch/kernels/csrc/
ensemble.cu: K2 field_fwd, K3 field_bwd + field_wgrad), on the CPU: the
plain versions of what they compute, and their geometry.

* the field forward with every MLP product through three bf16 passes of
  two-piece operands (``mm_bf16_pieces``, the kernels' mma_pieces<2>)
  within chip_smoke.py phase 6's tiers of the f32 plain version (alpha
  atol 3e-4, colour 2e-5) at h = 32 / 128 / 256, and one bf16 pass outside
  them;
* K3's route (the forward on three pieces, six passes; the input
  gradients W^T d and the weight gradients d x^T over the points on two,
  three passes; the band fold and the bias and dirs gradients in f32)
  within phase 6's K3 bar (chip_smoke.field_grad_error) of the f32 plain
  gradient, where a three-pass forward misses it (its ReLU masks fall
  elsewhere than the f32 plain version's);
* the staged pieces (``staged_pieces_reference``, field_stage_kernel's
  plain version) in K1's staged layout, and ``unstage_grads`` its inverse
  for K3's gradients;
* the staged pieces' cache (``ensemble.stage``): two ``prepare_params``
  calls on one bank never share a key;
* the kernels' plan, the library's own (``csrc/field_plan.cuh``, built
  here alone with g++): the shared memory of every block within the
  232,448 bytes a block may use and its blocks an SM within the SM's, at
  every width, the tiles, and the grids: enough blocks for the H100's 132
  SMs at the use_pallas_train tiles, phase 6's shapes and the meshing
  launch; the arguments the kernels refuse;
* chip_smoke.py's field bound on the route.
"""

import ctypes
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vmap_tpu_torch import kernels
from vmap_tpu_torch.core.bank import init_bank
from vmap_tpu_torch.kernels import ensemble as E
from vmap_tpu_torch.kernels import train_step as K
from vmap_tpu_torch.probes import SMS   # the H100 SXM's 132 SMs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import chip_smoke as C  # noqa: E402
from test_torch_k1_design import mm_bf16_pieces  # noqa: E402

WIDTHS = (32, 128, 256)
SMEM_LIMIT = 232448        # the most shared memory a block may use
SM_SMEM = 233472           # an SM's, 1 KB of it taken by each block
CSRC = os.path.join(REPO, "vmap_tpu_torch", "kernels", "csrc")
EMB1, EMB2 = E.EMB1, E.EMB2
# (objects, points) at each width: small, but wide enough for the errors
SIZES = {32: (2, 2048), 128: (1, 4096), 256: (1, 4096)}


def embed(p: dict, pts: torch.Tensor) -> tuple:
    """(xs, proj, emb_a [O, M, 87], emb_b [O, M, 42]), f32, as
    field_eval_reference computes them (the same embedding, so that the
    products' route alone separates the two: a pre-activation within
    rounding of 0 that another embedding's rounding puts on the other side
    of the ReLU moves a gradient by a whole element's share)."""
    xs = pts / p["scale"][:, :, None]
    proj = xs @ p["dirs"].transpose(1, 2)
    sins = [torch.sin(proj * 2.0 ** k * math.pi) for k in range(6)]
    return (xs, proj, torch.cat([xs] + sins[:4], dim=-1),
            torch.cat(sins[4:], dim=-1))


def forward(p: dict, emb_a, emb_b, mm) -> dict:
    """The MLP chain with every product ``mm(x, W^T)``: the activations
    and the heads' outputs."""
    def lin(x, w, b, x2=None, w2=None):
        y = mm(x, w.transpose(1, 2)) + b.transpose(1, 2)
        if x2 is not None:
            y = y + mm(x2, w2.transpose(1, 2))
        return y

    a = {}
    a["h1"] = torch.relu(lin(emb_a, p["w_in"][..., :EMB1], p["b_in"]))
    a["h2"] = torch.relu(lin(a["h1"], p["w_mid1"], p["b_mid1"]))
    a["h3"] = torch.relu(lin(a["h2"], p["w_cat_h"], p["b_cat"], emb_a,
                             p["w_cat_x"][..., :EMB1]))
    a["h4"] = torch.relu(lin(a["h3"], p["w_mid2"], p["b_mid2"]))
    a["alpha"] = lin(a["h4"], p["w_alpha"], p["b_alpha"])[..., 0] * 10.0
    a["c"] = torch.relu(lin(a["h4"], p["w_col_h"], p["b_col"], emb_b,
                            p["w_col_x"][..., :EMB2]))
    a["logits"] = lin(a["c"], p["w_out"], p["b_out"])
    a["colour"] = torch.sigmoid(a["logits"].double()).float()
    return a


def exact(x, w):
    return x @ w


def pieces(n):
    """A [.., M, K] @ [.., K, N] product on n-piece operands (the kernels'
    route: n = 2, three passes)."""
    return lambda x, w: mm_bf16_pieces(x, w, n)


@pytest.fixture(scope="module")
def operands():
    """phase 6's operands (chip_smoke.field_operands: init_bank, weights
    x0.5, points in the cube of the scale, normal cotangents) at small
    sizes, on the CPU."""
    out = {}
    for h in WIDTHS:
        O, M = SIZES[h]
        prepared, pts, g_a, g_c = C.field_operands(O, h, M, 5.0, 3, "cpu")
        out[h] = (prepared, pts, g_a, g_c)
    return out


@pytest.mark.parametrize("h", WIDTHS)
def test_three_passes_hold_phase6_tiers_one_pass_does_not(operands, h):
    prepared, pts, _, _ = operands[h]
    _, _, emb_a, emb_b = embed(prepared, pts)
    ref = forward(prepared, emb_a, emb_b, exact)
    three = forward(prepared, emb_a, emb_b, pieces(2))
    one = forward(prepared, emb_a, emb_b, pieces(1))
    err = {k: float((three[k] - ref[k]).abs().max())
           for k in ("alpha", "colour")}
    assert err["alpha"] <= 3e-4 and err["colour"] <= 2e-5, err
    # 8 to 33 x inside at phase 6's sizes
    assert err["alpha"] <= 3e-4 / 4 and err["colour"] <= 2e-5 / 4, err
    err1 = {k: float((one[k] - ref[k]).abs().max())
            for k in ("alpha", "colour")}
    assert err1["alpha"] > 3e-4 or err1["colour"] > 2e-5, err1


def route_grads(p: dict, pts, g_a, g_c, fwd_pieces: int = 3) -> dict:
    """K3 as the kernels compute it: the forward on ``fwd_pieces`` pieces;
    d alpha-layer = 10 g_alpha, d logits = g_c s (1 - s); each input
    gradient W^T d on two pieces (the ReLU masks from the activations; the
    alpha head's rank-one term in f32); each weight gradient d x^T over
    the points on two pieces (field_wgrad); the bias gradients the sums of
    d, the bands folded through pi 2^b cos(pi 2^b proj), the dirs gradient
    dproj^T xs, f32."""
    mm = pieces(2)
    xs, proj, emb_a, emb_b = embed(p, pts)
    a = forward(p, emb_a, emb_b, pieces(fwd_pieces))
    s = torch.sigmoid(a["logits"].double()).float()
    dal = 10.0 * g_a[..., None]                     # [O, M, 1]
    dlog = g_c * s * (1.0 - s)                      # [O, M, 3]

    def back(d, w):                                  # d [O, M, n] W [n, k]
        return mm(d, w)

    def wgrad(d, x):                                 # sum_p d[p, i] x[p, k]
        return mm(d.transpose(1, 2), x)

    g = {"w_out": wgrad(dlog, a["c"]), "b_out": dlog.sum(1)[..., None],
         "w_alpha": wgrad(dal, a["h4"]), "b_alpha": dal.sum(1)[..., None]}
    dc = back(dlog, p["w_out"]) * (a["c"] > 0)
    g["w_col_h"] = wgrad(dc, a["h4"])
    g["w_col_x"] = wgrad(dc, emb_b)
    g["b_col"] = dc.sum(1)[..., None]
    dh4 = (back(dc, p["w_col_h"]) + dal * p["w_alpha"]) * (a["h4"] > 0)
    band = [back(dc, p["w_col_x"][..., :EMB2])]      # bands 4, 5
    g["w_mid2"] = wgrad(dh4, a["h3"])
    g["b_mid2"] = dh4.sum(1)[..., None]
    dh3 = back(dh4, p["w_mid2"]) * (a["h3"] > 0)
    g["w_cat_h"] = wgrad(dh3, a["h2"])
    g["w_cat_x"] = wgrad(dh3, emb_a)
    g["b_cat"] = dh3.sum(1)[..., None]
    dh2 = back(dh3, p["w_cat_h"]) * (a["h2"] > 0)
    trunk = back(dh3, p["w_cat_x"][..., :EMB1])[..., 3:]
    g["w_mid1"] = wgrad(dh2, a["h1"])
    g["b_mid1"] = dh2.sum(1)[..., None]
    dh1 = back(dh2, p["w_mid1"]) * (a["h1"] > 0)
    trunk = trunk + back(dh1, p["w_in"][..., :EMB1])[..., 3:]
    g["w_in"] = wgrad(dh1, emb_a)
    g["b_in"] = dh1.sum(1)[..., None]
    dproj = torch.zeros_like(proj)
    for b in range(6):
        gb = (trunk[..., 21 * b:21 * b + 21] if b < 4
              else band[0][..., 21 * (b - 4):21 * (b - 4) + 21])
        f = 2.0 ** b * math.pi
        dproj = dproj + (f * torch.cos(proj.double() * f)).float() * gb
    g["dirs"] = dproj.transpose(1, 2) @ xs
    for n, used in (("w_in", EMB1), ("w_cat_x", EMB1), ("w_col_x", EMB2)):
        g[n] = torch.nn.functional.pad(g[n], (0, E.EMB_PAD - used))
    return g


def k3_misses(operands, h: int, fwd_pieces: int) -> list:
    """The gradients where K3's route with a forward on ``fwd_pieces``
    pieces misses phase 6's bar."""
    prepared, pts, g_a, g_c = operands[h]
    g_r = E.field_grad_reference(prepared, pts, g_a, g_c)
    g_d = E.field_grad_reference(
        {k: v.double() for k, v in prepared.items()}, pts.double(),
        g_a.double(), g_c.double())
    got = route_grads(prepared, pts, g_a, g_c, fwd_pieces)
    missed = []
    for n in E.W_NAMES:
        assert got[n].shape == g_r[n].shape, n
        gmax = float(g_r[n].abs().max())
        err, held = C.field_grad_error(got[n], g_r[n], g_d[n], gmax)
        if held is None:
            missed.append((n, err, gmax))
    return missed


@pytest.mark.parametrize("h", WIDTHS)
def test_k3_route_holds_phase6_bar(operands, h):
    """The forward on three pieces (six passes), the gradients on two."""
    assert not k3_misses(operands, h, 3)


def test_k3_three_pass_forward_misses_phase6_bar(operands):
    """With the forward on two pieces (three passes) at h=256, some of its
    ReLU masks fall on the other side of 0 than the f32 plain version's,
    and each such point moves a gradient by its whole share: the bar is
    missed (in w_in, b_in and more)."""
    missed = {n for n, _, _ in k3_misses(operands, 256, 2)}
    assert {"w_in", "b_in"} <= missed, missed


@pytest.mark.parametrize("h", WIDTHS)
def test_staged_pieces_are_k1_staged_layout(h):
    """field_stage_kernel's plain version gives K1's staged layout and
    pieces (train_step.stage_weights) of the same bank: the two kernels'
    weights share one layout."""
    bank = init_bank(torch.Generator().manual_seed(h), 3, h)
    pe, mlp = bank.spec.unflatten(bank.flat)
    prepared = E.prepare_params(pe, mlp, bank.scale, h)
    got = E.staged_pieces_reference(prepared, h)
    assert got.shape == (3, E.STAGED_PIECES, K.staged_layout(h)[1])
    assert torch.equal(got, K.stage_weights(bank.flat, bank.spec))


@pytest.mark.parametrize("h", WIDTHS)
def test_prepare_params_calls_never_share_a_stage_key(h):
    """The staged pieces' cache key: K1 writes a bank through a raw
    pointer, which moves no version counter, and most prepared tensors
    of a stacked bank are views of it; each prepare_params call pads
    w_in, w_cat_x and w_col_x into new tensors, so a second call on the
    same bank (its weights rewritten in between or not) misses the
    first's pieces. Its own key still hits, and an in-place change
    through torch misses."""
    bank = init_bank(torch.Generator().manual_seed(h), 2, h)
    pe, mlp = bank.spec.unflatten(bank.flat)
    p1 = E.prepare_params(pe, mlp, bank.scale, h)
    k1 = E._weights_key(p1, h)
    assert E._same(k1, E._weights_key(p1, h))
    p2 = E.prepare_params(pe, mlp, bank.scale, h)
    assert not E._same(k1, E._weights_key(p2, h))
    fresh = [n for n in E.W_NAMES
             if p1[n].untyped_storage().data_ptr()
             != bank.flat.untyped_storage().data_ptr()]
    assert set(fresh) >= {"w_in", "w_cat_x", "w_col_x"}, fresh
    p1["b_in"].add_(1.0)
    assert not E._same(k1, E._weights_key(p1, h))


@pytest.mark.parametrize("h", WIDTHS)
def test_unstage_inverts_the_staged_gradient_layout(plan_lib, h):
    """K3's rows (the weights staged, the biases and dirs in rest_layout)
    -> the prepared shapes: every gradient where it belongs, the padded
    columns 0."""
    rng = np.random.default_rng(h)
    O = 2
    shapes = E.prepared_shapes(h)
    want = {n: torch.from_numpy(rng.standard_normal((O,) + shapes[n])
                                .astype(np.float32)) for n in E.W_NAMES}
    for n, used in (("w_in", EMB1), ("w_cat_x", EMB1), ("w_col_x", EMB2)):
        want[n][..., used:] = 0.0
    staged = E.staged_pieces_reference(want, h)   # the layout, as pieces
    wgrad = staged[:, 0].float() + staged[:, 1].float()
    rest_floats = plan_lib(h, O, 1)["rest_floats"]
    rest = torch.zeros((O, rest_floats))
    off = 0
    for n, size in E.rest_layout(h):
        rest[:, off:off + size] = want[n].reshape(O, -1)
        off += size
    assert off == 63 + 5 * h + 4 <= rest_floats
    got = E.unstage_grads(wgrad, rest, h)
    for n in E.W_NAMES:
        tol = 2.0 ** -16 * float(want[n].abs().max()) if n.startswith(
            "w_") else 0.0
        assert got[n].shape == want[n].shape, n
        assert float((got[n] - want[n]).abs().max()) <= tol, n


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/field_plan.cuh built alone with g++, its field_plan exported:
    plan(h, O, M, tile_m, sms) -> the library's plan (ensemble.plan_dict)
    at ``sms`` SMs (132 unless given), as the card's library states it
    through vmap_field_plan."""
    d = tmp_path_factory.mktemp("field_plan")
    src, so = d / "plan.cpp", d / "libplan.so"
    src.write_text('#include "field_plan.cuh"\n'
                   'extern "C" int plan(int h, int sms, int O, int M, '
                   'int tile_m, int* out) {\n'
                   '  return field_plan(h, sms, O, M, tile_m, out);\n}\n')
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))

    def plan(h, O, M, tile_m=E.TILE_M, sms=SMS, code=0):
        out = (ctypes.c_int * len(E.PLAN))()
        assert lib.plan(h, sms, O, M, tile_m, out) == code
        return E.plan_dict(out, O)
    return plan


@pytest.mark.parametrize("kernel", ["field_fwd", "field_bwd", "field_wgrad"])
@pytest.mark.parametrize("h", WIDTHS)
def test_shared_memory_plans_fit(plan_lib, kernel, h):
    """Each block's plan within the 232,448 bytes a block may use, the
    blocks an SM its launch bound asks for within the SM's shared memory,
    the tiles whole 16-point mma steps of every warp tile (the header's
    static_asserts hold the same at compile time)."""
    plan = plan_lib(h, 1, 65536)
    key = {"field_fwd": "fwd", "field_bwd": "bwd",
           "field_wgrad": "wgrad"}[kernel]
    smem, per_sm = plan[f"{key}_smem_bytes"], plan[f"{key}_blocks_per_sm"]
    assert 0 < smem <= SMEM_LIMIT
    assert per_sm * (smem + 1024) <= SM_SMEM
    if kernel != "field_wgrad":
        assert plan[f"{key}_points"] % 16 == 0
    # every warp busy in field_bwd's products: its 16 warps' units
    assert plan["bwd_threads"] == 512
    # h=32's K2 tile and weights leave room for two blocks an SM
    assert plan["fwd_blocks_per_sm"] == (2 if h == 32 else 1)


def test_grids_fill_the_card(plan_lib):
    """The library's grids at the use_pallas_train tiles (phase 8: each
    shape's iteration batch and its field_tile), at phase 6's shapes and
    at the meshing launches, on 132 SMs: field_bwd one wave of at most 132
    blocks (one an SM), all its objects' tiles at 132 objects or more, and
    within one object's blocks of filling 132 SMs otherwise; field_wgrad
    one wave of 132 x its blocks an SM that one more split would overflow
    (or every unit split, or one split already filling it), each split a
    run of whole units of tile_m or one of its halves."""
    cases = [(cap, h, n_per * S, K.field_tile(n_per * S))
             for _, cap, _, h, n_per, S, _ in C.SHAPES]
    cases += [(O, h, M, E.TILE_M) for _, O, h, M, _ in C.FIELD_SHAPES]
    for O, h, M, tile_m in cases:
        plan = plan_lib(h, O, M, tile_m)
        target = SMS * plan["wgrad_blocks_per_sm"]
        per_split = plan["wgrad_tiles"] * O
        n_units = -(-plan["Mp"] // plan["unit"])
        assert (plan["bwd_blocks"] <= SMS and plan["bwd_blocks"] + O > SMS
                or plan["blocks_per_object"] == plan["Mp"]
                // plan["bwd_points"] or O >= SMS), (O, h, M, plan)
        assert (plan["wgrad_blocks"] <= target < plan["wgrad_blocks"]
                + per_split or plan["splits"] == n_units
                or (plan["splits"] == 1 and per_split >= target)), plan
        assert plan["Mp"] % plan["bwd_points"] == 0 and plan["Mp"] >= M
        assert plan["Mp"] % 32 == 0 and tile_m % 32 == 0
        assert tile_m % plan["unit"] == 0 and plan["unit"] % 32 == 0
        assert 1 <= plan["splits"] <= n_units
        assert plan["blocks_per_object"] <= plan["Mp"] // plan["bwd_points"]
    # phase 8's tiles, by the numbers: (field_bwd blocks, field_wgrad
    # blocks): 104 / 728 at h=32 (104 objects, a block each), 132 / 126 at
    # h=128 (9 tiles x 14 splits of 768-point units), 132 / 130 at h=256
    # (26 x 5)
    got = [plan_lib(h, cap, n_per * S, K.field_tile(n_per * S))
           for _, cap, _, h, n_per, S, _ in C.SHAPES]
    assert [(g["bwd_blocks"], g["wgrad_blocks"]) for g in got] == [
        (104, 728), (132, 126), (132, 130)]
    # K2: meshing's launches and phase 6's fill all 132 SMs, two blocks an
    # SM at h=32
    for O, h, M in ((128, 32, 65536), (1, 128, 65536), (1, 256, 65536),
                    (8, 32, 65573), (1, 128, 131072), (1, 256, 131072)):
        plan = plan_lib(h, O, M)
        assert plan["fwd_blocks"] == SMS * plan["fwd_blocks_per_sm"]
    # fewer tiles than the card's blocks: one block a tile
    assert plan_lib(32, 1, 100)["fwd_blocks"] == 2
    # the grids follow the card's SM count
    assert plan_lib(128, 1, 131072, sms=114)["fwd_blocks"] == 114


@pytest.mark.parametrize("args", [
    (64, 1, 1024, 512), (32, 0, 1024, 512), (32, 65536, 1024, 512),
    (128, 1, 0, 512), (128, 1, 1024, 48), (256, 1, 1024, 16)])
def test_plan_refuses_what_the_kernels_refuse(plan_lib, args):
    """A width without kernels, objects outside 1..65535, no points, or a
    tile_m that is not a multiple of 32 points: cudaErrorInvalidValue."""
    h, O, M, tile_m = args
    plan_lib(h, O, M, tile_m, code=1)


def test_chip_smoke_field_bound_is_the_route():
    """phase 6's bound: the products at 989 TFLOP/s in the passes the
    kernels run (K2 three; K3 six for its recomputed forward, 2 x 3 for
    its input and weight gradients), the PE's projection (and K3's dirs
    gradient) at the FP32 rate; K2's 0.0364 / 0.0748 / 0.2535 ms at phase
    6's shapes; the FP32-rate figure beside it PR 5's bound."""
    assert C.FIELD_PASSES == {"field_fwd": 3, "field_bwd": 12}
    fwd_ms = (0.0364, 0.0748, 0.2535)
    pr5 = {"fwd": (0.1754, 0.3668, 1.2463), "bwd": (0.5261, 1.1005, 3.7388)}
    for i, (_, O, h, M, _) in enumerate(C.FIELD_SHAPES):
        n_w = O * (1 + sum(math.prod(s) for s in
                           E.prepared_shapes(h).values()))   # and scale
        pts = O * M
        macs = C.mlp_macs(h) - C.PE_MACS
        for bwd, passes, pe in ((False, 3, 1), (True, 12, 2)):
            b = C.field_bound(O, M, h, n_w, bwd)
            want = (passes * 2 * macs * pts / 989e12
                    + pe * 2 * C.PE_MACS * pts / 67e12) * 1e3
            assert b["bound_by"] == "operations"
            assert b["bound_ms"] == pytest.approx(want, rel=1e-9)
            f32 = C.field_bound(O, M, h, n_w, bwd, fp32_rate=True)
            assert f32["bound_ms"] == pytest.approx(
                pr5["bwd" if bwd else "fwd"][i], abs=6e-5)
        assert C.field_bound(O, M, h, n_w, False)["bound_ms"] == \
            pytest.approx(fwd_ms[i], abs=6e-5)
