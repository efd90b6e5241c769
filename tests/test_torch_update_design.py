"""K1's update kernels (vmap_tpu_torch/kernels/csrc: train_step.cu
``adamw_kernel``, train_step_q8.cu ``quant_weights_kernel``), on the CPU:
their plan and the plain versions of what they compute.

* the plan, the library's own (``csrc/update_plan.cuh``, built here alone
  with g++): train_quant_w's 32-row bands cover every ``QW_NAMES``
  tensor's elements, its copy's and its transpose's bytes (padding
  included) exactly once at h = 32 / 128 / 256; its clusters at most 8
  blocks (portable), both kernels' shared memory within a block's and
  their blocks an SM within an SM's; every 16-byte store aligned;
  train_adamw's runs cover every row position once, in whole 64-byte
  bulk copies; the grids at the H100's 132 SMs; the arguments the
  kernels refuse;
* ``grad_row_param`` (the position -> parameter index train_adamw reads
  by) inverts ``grad_row_index``, -1 exactly on the padding;
* ``row_sum`` (train_adamw's stated summation order) within n_rows 2^-24
  sum |g| of the f64 sum and close to torch's own sum; ``loss_sum`` the
  kernel's warp order (``apply_adamw`` on any gradient against the JAX
  package's: tests/test_torch_bank_pool.py);
* chip_smoke.py's bounds of train_adamw (the function's, and with K1's
  partial rows).
"""

import ctypes
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vmap_tpu_torch.core.bank import BankSpec
from vmap_tpu_torch.kernels import train_step as K
from vmap_tpu_torch.ops import quant as Q
from vmap_tpu_torch.probes import SMS   # the H100 SXM's 132 SMs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import chip_smoke as C  # noqa: E402
from _torch_parity import n, t  # noqa: E402

WIDTHS = (32, 128, 256)
SMEM_LIMIT = 232448        # the most shared memory a block may use
SM_SMEM = 233472           # an SM's, 1 KB of it taken by each block
CSRC = os.path.join(REPO, "vmap_tpu_torch", "kernels", "csrc")
# update_plan.cuh quant_band's fields, in order
BAND = ("t", "col0", "cols", "fold", "row0", "src_rows", "copy_rows",
        "copy_off", "copy_bytes", "tr_off", "tr_stride", "tr_rows")
# the source matrices (update_plan.cuh QMat) and the parameters they are
MATRICES = ("w_in", "w_mid1", "w_cat", "w_mid2", "w_alpha", "w_col",
            "w_col_out")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/update_plan.cuh built alone with g++, its plan, bands and runs
    exported."""
    d = tmp_path_factory.mktemp("update_plan")
    src, so = d / "plan.cpp", d / "libplan.so"
    src.write_text(
        '#include "update_plan.cuh"\n'
        'extern "C" {\n'
        'int plan(int h, int sms, int cap, int n_rows, int* out) {\n'
        '  return update_plan(h, sms, cap, n_rows, out);\n}\n'
        'int band(int h, int m, int k, int* out) {\n'
        '  return quant_band(h, m, k, out);\n}\n'
        'int run_len(int h, int r) { return adam_run_len(h, r); }\n'
        'int sizes(int* out) {\n'
        '  out[0] = UP_N; out[1] = QB_N; out[2] = NQM; out[3] = NQW;\n'
        '  return 0;\n}\n'
        '}\n')
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    sizes = (ctypes.c_int * 4)()
    lib.sizes(sizes)
    assert tuple(sizes) == (len(K.UPDATE_PLAN), len(BAND), len(MATRICES),
                            len(Q.QW_NAMES))

    def plan(h, cap, n_rows, sms=SMS, code=0):
        out = (ctypes.c_int * len(K.UPDATE_PLAN))()
        assert lib.plan(h, sms, cap, n_rows, out) == code
        return dict(zip(K.UPDATE_PLAN, out))

    def band(h, m, k):
        out = (ctypes.c_int * (2 * len(BAND)))()
        nt = lib.band(h, m, k, out)
        return [dict(zip(BAND, out[i * len(BAND):(i + 1) * len(BAND)]))
                for i in range(nt)]

    return SimpleNamespace(plan=plan, band=band, run_len=lib.run_len)


@pytest.mark.parametrize("h", WIDTHS)
def test_plan_is_the_wrappers_layout(plan_lib, h):
    """The plan's row and s8 sizes are the wrapper's grad_row_size and
    q8_layout; every width's band is 32 rows, its cluster h / 32."""
    p = plan_lib.plan(h, 1, 20)
    assert p["grad_row"] == K.grad_row_size(h)
    assert p["q8_size"] == K.q8_layout(h)[1]
    assert p["quant_band_rows"] == 32 and p["quant_cluster"] == h // 32


@pytest.mark.parametrize("h", WIDTHS)
def test_bands_cover_each_tensor_once(plan_lib, h):
    """Over a cluster's blocks, each QW tensor's elements are read once
    (from the source matrix's rows and its own columns, with its fold),
    and its copy's and its transpose's bytes, padding included, written
    once; together the slot's q8_size bytes, once each."""
    layout, size = K.q8_layout(h)
    spec = BankSpec.create(h)
    shapes = {name: shape for _, name, shape, _, _ in spec.names}
    slot = np.zeros(size, np.int32)
    seen = set()
    for m, mat in enumerate(MATRICES):
        n_out, ld = shapes[mat]
        bands = [plan_lib.band(h, m, k) for k in range(h // 32)]
        assert plan_lib.band(h, m, h // 32) == []   # none past the cluster
        for i in range(len(bands[0])):
            b0 = bands[0][i]
            name, t_out, t_in, off, off_t = layout[b0["t"]]
            seen.add(name)
            assert (t_out, t_in) == (n_out, b0["cols"])
            assert b0["fold"] == {"w_in": 1, "w_cat_x": 1,
                                  "w_col_x": 2}.get(name, 0)
            src = np.zeros((n_out, ld), np.int32)
            copy = np.zeros(_up(t_out, 16) * _up(t_in, 32), np.int32)
            tr = np.zeros(_up(t_in, 16) * _up(t_out, 32), np.int32)
            for bands_k in bands:
                b = bands_k[i]
                assert b["t"] == b0["t"] and b["col0"] == b0["col0"]
                src[b["row0"]:b["row0"] + b["src_rows"],
                    b["col0"]:b["col0"] + b["cols"]] += 1
                lo = b["copy_off"] - off
                copy[lo:lo + b["copy_bytes"]] += 1
                slot[b["copy_off"]:b["copy_off"] + b["copy_bytes"]] += 1
                if b["tr_off"] < 0:
                    assert b["tr_rows"] == 0
                    continue
                assert b["tr_stride"] == _up(t_out, 32)
                assert b["tr_rows"] == _up(t_in, 16)
                for c in range(b["tr_rows"]):
                    at = b["tr_off"] + c * b["tr_stride"]
                    tr[at - off_t:at - off_t + 32] += 1
                    slot[at:at + 32] += 1
            cols = src[:, b0["col0"]:b0["col0"] + t_in]
            assert (cols == 1).all(), name
            assert (copy == 1).all() and (tr == 1).all(), name
    assert seen == set(Q.QW_NAMES)
    assert (slot == 1).all()
    # the source columns of a two-tensor matrix split between its tensors
    assert [b["col0"] for b in plan_lib.band(h, 2, 0)] == [0, h]


@pytest.mark.parametrize("h", WIDTHS)
def test_clusters_and_shared_memory_fit(plan_lib, h):
    """train_quant_w's clusters at most 8 blocks (the portable size), its
    block's shared memory within 232,448 bytes and its blocks an SM within
    the SM's; train_adamw's ring within the 48 KB of static shared memory
    and its six blocks within the SM's."""
    p = plan_lib.plan(h, 104, 20)
    assert 1 <= p["quant_cluster"] <= 8
    assert 0 < p["quant_smem_bytes"] <= SMEM_LIMIT
    assert p["quant_blocks_per_sm"] >= 1
    assert (p["quant_blocks_per_sm"] * (p["quant_smem_bytes"] + 1024)
            <= SM_SMEM)
    assert p["quant_blocks_per_sm"] * p["quant_threads"] <= 2048
    # 64 registers a thread at the blocks an SM the launch bound asks for
    assert p["quant_blocks_per_sm"] * p["quant_threads"] * 64 <= 65536
    assert p["adam_smem_bytes"] <= 48 * 1024
    assert p["adam_blocks_per_sm"] * (p["adam_smem_bytes"] + 1024) <= SM_SMEM
    # the ring holds its stages of adam_rows_a_stage rows of a run
    assert p["adam_smem_bytes"] >= (4 * p["adam_stages"]
                                    * p["adam_rows_a_stage"] * p["adam_run"])


@pytest.mark.parametrize("h", WIDTHS)
def test_every_16_byte_store_is_aligned(plan_lib, h):
    """train_quant_w's copy bands and transpose slices start on 16-byte
    boundaries of a slot and are whole 16 bytes, and a slot is (so every
    slot's are in the bank); train_adamw's staged-piece stores (4 bf16 a
    thread) start on 8-byte boundaries of a plane, whose size is a
    multiple of 8 bytes, and its rows and runs on 64-byte ones."""
    p = plan_lib.plan(h, 1, 20)
    assert p["q8_size"] % 16 == 0
    for m in range(len(MATRICES)):
        for k in range(h // 32):
            for b in plan_lib.band(h, m, k):
                assert b["copy_off"] % 16 == 0 and b["copy_bytes"] % 16 == 0
                if b["tr_off"] >= 0:
                    assert b["tr_off"] % 16 == 0
                    assert b["tr_stride"] % 16 == 0
    ns = K.staged_layout(h)[1]
    assert (2 * ns) % 8 == 0 and (2 * 4 * p["adam_threads"]) % 8 == 0
    assert (4 * p["grad_row"]) % 64 == 0 and (4 * p["adam_run"]) % 64 == 0


@pytest.mark.parametrize("h", WIDTHS)
def test_adamw_runs_cover_each_position_once(plan_lib, h):
    """The runs of a slot's row cover its grad_row positions once, in
    order, each a whole number of 64-byte bulk copies of at most one run,
    and a thread's 4 positions all product weights or none."""
    p = plan_lib.plan(h, 1, 300)
    assert p["adam_run"] == 4 * p["adam_threads"]
    seen = np.zeros(p["grad_row"], np.int32)
    for r in range(p["adam_runs"]):
        length = plan_lib.run_len(h, r)
        assert 0 < length <= p["adam_run"] and (4 * length) % 64 == 0
        seen[r * p["adam_run"]:r * p["adam_run"] + length] += 1
    assert (seen == 1).all()
    # two stages of 8 rows of 2 KB
    assert (p["adam_stages"], p["adam_rows_a_stage"], 4 * p["adam_run"]) == (
        2, 8, 2048)
    assert p["adam_chunks"] == -(-300 // p["adam_rows_a_stage"])
    assert K.staged_layout(h)[1] % 4 == 0


def test_grids_fill_the_card(plan_lib):
    """At phase 3's shapes on 132 SMs: train_adamw one wave of 132 x 6
    blocks where the bank has more runs of 512 positions (the object
    bank's 104 x 26), one block a run where it has fewer (the
    background's 198, the iMAP field's 651); train_quant_w one cluster a
    unit
    (slot, matrix) where the units fit a wave (the object bank's 728
    blocks, the background's 7 clusters of 4, the iMAP field's 7 of 8);
    the grids follow the card's SM count."""
    got = [plan_lib.plan(h, cap, K.frame_geometry(h, S, n_per, cap).blocks)
           for _, cap, _, h, n_per, S, _ in C.SHAPES]
    assert [g["adam_threads"] for g in got] == [128, 128, 128]
    assert [g["adam_runs"] for g in got] == [26, 198, 651]
    assert [g["adam_blocks"] for g in got] == [792, 198, 651]
    # and before them a warp a slot for the losses
    assert [g["adam_loss_blocks"] for g in got] == [26, 1, 1]
    assert [g["quant_clusters"] for g in got] == [728, 7, 7]
    assert [g["quant_cluster"] * g["quant_clusters"] for g in got] == [
        728, 28, 56]
    assert [g["quant_threads"] for g in got] == [128, 256, 512]
    assert plan_lib.plan(32, 104, 20, sms=114)["adam_blocks"] == 684
    # more units than a wave: a wave of clusters, each taking several
    big = plan_lib.plan(128, 104, 1)
    assert big["quant_clusters"] == SMS * big["quant_blocks_per_sm"] // 4


@pytest.mark.parametrize("args", [(64, 1, 20), (32, 0, 20), (128, 1, 0)])
def test_plan_refuses_what_the_kernels_refuse(plan_lib, args):
    """A width without kernels, no slots or no rows: cudaErrorInvalidValue
    (1)."""
    plan_lib.plan(*args, code=1)


@pytest.mark.parametrize("h", WIDTHS)
def test_grad_row_param_inverts_grad_row_index(h):
    """The parameter at each row position: grad_row_index's inverse, -1
    on exactly the positions no parameter takes (the staged layout's zero
    padding and the row's tail)."""
    spec = BankSpec.create(h)
    idx = K.grad_row_index(spec).long()
    inv = K.grad_row_param(spec)
    assert inv.dtype == torch.int32 and inv.shape == (K.grad_row_size(h),)
    assert torch.equal(inv[idx], torch.arange(spec.n_params,
                                              dtype=torch.int32))
    pad = torch.ones(K.grad_row_size(h), dtype=torch.bool)
    pad[idx] = False
    assert torch.equal(inv < 0, pad) and bool((inv[pad] == -1).all())
    assert int(pad.sum()) == K.grad_row_size(h) - spec.n_params


@pytest.mark.parametrize("n_rows", [20, 132, 300])
def test_row_sum_is_the_stated_order_within_its_bound(rng, n_rows):
    """row_sum adds each position's rows in row order from 0 (bit for bit
    numpy's serial f32 loop), within n_rows 2^-24 sum |g| of the f64 sum
    and of torch's own sum over the rows (the rows of phase 3's three
    shapes: 20, 300 and 132 a slot)."""
    x = (rng.standard_normal((3, n_rows, 96))
         * rng.uniform(1e-4, 1e2, (3, 1, 96))).astype(np.float32)
    got = n(K.row_sum(t(x)))
    serial = np.zeros((3, 96), np.float32)
    for r in range(n_rows):
        serial = serial + x[:, r]
    np.testing.assert_array_equal(got, serial)
    bound = n_rows * 2.0 ** -24 * np.abs(x.astype(np.float64)).sum(1)
    exact = x.astype(np.float64).sum(1)
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(got - n(t(x).sum(1))) <= 2 * bound).all()


def test_loss_sum_is_the_warp_order(rng):
    """loss_sum: 32 lane sums (lane l rows l, l + 32, ... in order), then
    halves added to halves, bit for bit; within its bound of the sum."""
    for rows in (1, 20, 132, 300):
        x = rng.uniform(0, 2, (4, rows)).astype(np.float32)
        lanes = np.zeros((4, 32), np.float32)
        for k in range(0, rows, 32):
            part = np.zeros((4, 32), np.float32)
            part[:, :min(32, rows - k)] = x[:, k:k + 32]
            lanes = lanes + part
        while lanes.shape[1] > 1:
            lanes = lanes[:, :lanes.shape[1] // 2] + lanes[:, lanes.shape[1]
                                                           // 2:]
        got = n(K.loss_sum(t(x)))
        np.testing.assert_array_equal(got, lanes[:, 0])
        assert (np.abs(got - x.astype(np.float64).sum(1))
                <= rows * 2.0 ** -24 * np.abs(x).sum(1)).all()


def test_chip_smoke_adamw_bounds():
    """chip_smoke.adamw_bound at phase 3's shapes: the function's bytes (7
    floats a parameter) and, with K1's partial rows, the rows, p / m / v
    read and written, the staged pieces and the row index: 139.32 /
    124.56 / 186.89 MB under float32, at 3.35 TB/s."""
    want_mb = (139.32, 124.56, 186.89)
    for (_, cap, n_act, h, n_per, S, _), mb in zip(C.SHAPES, want_mb):
        active = torch.zeros(cap, dtype=torch.bool)
        active[:n_act] = True
        bank = SimpleNamespace(active=active, spec=BankSpec.create(h))
        rows = K.frame_geometry(h, S, n_per, cap).blocks
        b = C.adamw_bound(bank, rows)
        assert b["bound_ms"] == pytest.approx(
            4 * 7 * n_act * bank.spec.n_params / 3.35e12 * 1e3)
        assert b["rows_bytes"] / 1e6 == pytest.approx(mb, abs=0.01)
        assert b["rows_bound_ms"] == pytest.approx(
            b["rows_bytes"] / 3.35e12 * 1e3)
        no_pieces = C.adamw_bound(bank, rows, pieces=False)["rows_bytes"]
        assert b["rows_bytes"] - no_pieces == (
            6 * n_act * K.staged_layout(h)[1])
