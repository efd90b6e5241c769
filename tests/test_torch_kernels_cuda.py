"""The CUDA kernels against their plain PyTorch versions, on the card, at
the shapes of the port's main paths (the vMAP object and background banks,
the iMAP scene field at hidden 256): the train-frame kernels
(chip_smoke.py phase 3: each kernel alone, then whole frames at n_iter=1,
rtol 2e-3, and n_iter=20, finite, rtol 0.25 on the final summed loss,
inactive slots bit-identical), the field kernels K2 / K3 (phase 6: alpha
atol 3e-4, colour atol 2e-5, gradients rtol 2e-3 + 2e-3 max(1, |g|max))
and the frame through them with use_pallas_train (phase 8, the phase 3
tiers); the train-frame kernels under the bwd_bf16 and bfloat16 matmul
policies (phase 10: n_iter=1 gradients per tensor within 1e-2 of scale and
at least 10x closer to the plain policy than plain f32 is, n_iter=20
finite within rtol 0.25), under the int8 policies (phase 11: the same
tiers with 5e-2 of scale; also at ragged shapes) and under sample_reuse
4, bit-identical to the tiled batch; K2 at the meshing launch and at
ragged point counts, K3 at the use_pallas_train tiles bit-equal across
two launches and within the JAX bar across two tile_m, the field kernels'
plan on the card's SM count; the forloop ablation against the vectorised
frame at the bench shape and ``OccupancyField``'s query against its plain
version (phase 14); K1, K2 and K3 at h=16 and h=64 in the same tiers, and
the Mapper under ``tpu.fused_train_step`` false launching no K1 (phase
18); and the probe
kernels
(``vmap_tpu_torch.probes``: K4 mm, K10 int8, K7 sections, K8 overlap,
K9 vpu, K5 ops, K6 dma) in every variant and shape against their plain
versions at 3 steps (K6 at 4000 copies;
phase 12's tolerances), their entry points refusing what they do not
take. Skips where CUDA is
not available (no interpret mode exists for a CUDA kernel). Run on the
card, where jax is not installed, without tests/conftest.py (it imports
jax):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import ctypes
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["obj", "bg", "imap"])
def test_kernels_match_plain_on_card(cuda_device, shape):
    sys.path.insert(0, REPO)
    import chip_smoke
    shapes = [s for s in chip_smoke.SHAPES if s[0] == shape]
    stats = {}
    chip_smoke.check_kernels(cuda_device, stats, shapes)
    assert stats["train_grad"][f"{shape}/float32"]["ms"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["obj", "bg", "imap"])
def test_policy_kernels_match_plain_on_card(cuda_device, shape):
    sys.path.insert(0, REPO)
    import chip_smoke
    shapes = [s for s in chip_smoke.SHAPES if s[0] == shape]
    stats = {}
    chip_smoke.check_policies(cuda_device, stats, shapes)
    for policy in chip_smoke.BF16_POLICIES:
        assert stats["train_grad"][f"{shape}/{policy}"]["ms"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["obj", "bg", "imap"])
def test_int8_policy_kernels_match_plain_on_card(cuda_device, shape):
    """The int8 instances (and train_quant_w's quantised weight copy)
    against the plain ops.quant frame, in phase 11's tiers."""
    sys.path.insert(0, REPO)
    import chip_smoke
    shapes = [s for s in chip_smoke.SHAPES if s[0] == shape]
    stats = {}
    chip_smoke.check_policies(cuda_device, stats, shapes,
                              chip_smoke.INT8_POLICIES, "11")
    for policy in chip_smoke.INT8_POLICIES:
        assert stats["train_grad"][f"{shape}/{policy}"]["ms"] > 0


# ragged shapes for the float policies' tensor-core tile: n_per not a
# multiple of the tile's rays (the last tile 2, 1 and 1 rays), S such that
# the tile's points are no multiple of 16 (63, 52, 22), the last slots
# inactive: (name, cap, n_active, hidden, rays per iteration, samples,
# scale)
RAGGED = (("ragged32", 5, 3, 32, 121, 9, 2.0),
          ("ragged128", 3, 2, 128, 53, 13, 5.0),
          ("ragged256", 2, 1, 256, 31, 11, 5.0))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["float32", "bwd_bf16", "bfloat16"])
def test_float_tile_ragged_matches_plain_on_card(cuda_device, policy):
    """K1 under each float policy at ragged shapes: float32 in phase 3's
    tiers (the gradient alone, then frames at n_iter 1 and 20), bwd_bf16 /
    bfloat16 in phase 10's."""
    sys.path.insert(0, REPO)
    import chip_smoke
    if policy == "float32":
        stats = {}
        chip_smoke.check_kernels(cuda_device, stats, RAGGED)
        assert all(v["ms"] > 0 for v in stats["train_grad"].values())
        return
    failures = []
    for name, cap, n_act, h, n_per, S, scale in RAGGED:
        bank = chip_smoke.conditioned_bank(cap, n_act, h, scale, 0,
                                           cuda_device)
        chip_smoke.check_policy_tiers(name, bank, S, n_per, cuda_device,
                                      policy, failures)
    assert not failures, failures


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["int8", "int8_fwd", "int8_static",
                                    "int8_static_fwd"])
def test_int8_tile_ragged_matches_plain_on_card(cuda_device, policy):
    """K1 under each int8 policy at the ragged shapes, in phase 11's tiers:
    int8 tiles of 63, 52 and 33 points (tile_rays at S 9 / 13 / 11), none a
    multiple of 32, the last tile 2, 1 and 1 rays, the last slots
    inactive; train_quant_w's s8 copy equal to plain."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from vmap_tpu_torch.kernels import train_step as K
    failures = []
    for name, cap, n_act, h, n_per, S, scale in RAGGED:
        bank = chip_smoke.conditioned_bank(cap, n_act, h, scale, 0,
                                           cuda_device)
        assert (K.frame_geometry(h, S, n_per, cap, policy).rays_per_tile
                * S) % 32
        chip_smoke.check_policy_tiers(name, bank, S, n_per, cuda_device,
                                      policy, failures, "11")
        fl = K.FrameLaunch(bank, chip_smoke.random_batch(cap, n_per, S, 1,
                                                         cuda_device),
                           1, n_per, chip_smoke.CS, chip_smoke.OSC, policy)
        bad = chip_smoke.quantised_copy_errors(bank, fl, bank.flat)
        assert not bad, f"{name}/{policy}: train_quant_w differs in {bad}"
    assert not failures, failures


# the widths K1, K2 and K3 gained (chip_smoke.py phase 18): ragged shapes
# at h=16 and h=64 beside phase 18's own (the last tile 1 ray, tiles of
# 63 and 52 points, the last slots inactive)
WIDTH_RAGGED = (("ragged16", 5, 3, 16, 121, 9, 2.0),
                ("ragged64", 3, 2, 64, 53, 13, 5.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["obj16", "bg64"])
def test_width_kernels_match_plain_on_card(cuda_device, shape):
    """K1 at h=16 (the object shape) and h=64 (the background shape):
    float32 in phase 3's tiers with train_adamw, the bf16 and int8
    policies in phase 10's and 11's with train_quant_w, sample_reuse 4
    bit-identical to the tiled batch (chip_smoke.py phase 18 runs every
    shape at both widths)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    shapes = [s for s in chip_smoke.WIDTH_SHAPES if s[0] == shape]
    stats = {}
    chip_smoke.check_kernels(cuda_device, stats, shapes, phase="18",
                             grad_atol=chip_smoke.WIDTH_GRAD_ATOL)
    chip_smoke.check_policies(cuda_device, stats, shapes,
                              chip_smoke.BF16_POLICIES, "18")
    chip_smoke.check_policies(cuda_device, stats, shapes,
                              chip_smoke.INT8_POLICIES, "18")
    chip_smoke.check_reuse_bit_identity(cuda_device, shapes[0], "18")
    for policy in chip_smoke.POLICIES:
        assert stats["train_grad"][f"{shape}/{policy}"]["ms"] > 0
    assert stats["train_quant_w"][shape]["ms"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["float32", "bwd_bf16", "int8",
                                    "int8_static_fwd"])
def test_width_tiles_ragged_match_plain_on_card(cuda_device, policy):
    """K1 at h=16 and h=64 at ragged shapes: float32 in phase 3's tiers,
    the other policies in phase 10's and 11's."""
    sys.path.insert(0, REPO)
    import chip_smoke
    if policy == "float32":
        stats = {}
        chip_smoke.check_kernels(cuda_device, stats, WIDTH_RAGGED, "18",
                                 chip_smoke.WIDTH_GRAD_ATOL)
        assert all(v["ms"] > 0 for v in stats["train_grad"].values())
        return
    failures = []
    for name, cap, n_act, h, n_per, S, scale in WIDTH_RAGGED:
        bank = chip_smoke.conditioned_bank(cap, n_act, h, scale, 0,
                                           cuda_device)
        chip_smoke.check_policy_tiers(name, bank, S, n_per, cuda_device,
                                      policy, failures, "18")
    assert not failures, failures


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["obj16", "bg64"])
def test_width_field_kernels_match_plain_on_card(cuda_device, shape):
    """K2 and K3 at h=16 and h=64, in phase 6's tiers."""
    sys.path.insert(0, REPO)
    import chip_smoke
    shapes = [s for s in chip_smoke.WIDTH_FIELD_SHAPES if s[0] == shape]
    stats = {}
    chip_smoke.check_field_kernels(cuda_device, stats, shapes, "18")
    assert stats["field_fwd"][shape]["ms"] > 0
    assert stats["field_bwd"][shape]["ms"] > 0


@pytest.mark.cuda
def test_fused_train_step_false_launches_no_k1_on_card(cuda_device):
    """Under tpu.fused_train_step false the Mapper on the card runs the
    plain frame: no train_grad launch, the slots unrounded, within phase
    3's tier of the kernel frame at n_iter=1 (chip_smoke.py phase 18 d)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    os.makedirs(chip_smoke.OUT, exist_ok=True)
    counts, res = chip_smoke.fused_off(cuda_device, "")
    assert counts["train_grad"] == 0
    assert res["slots_off"] < res["slots_auto"]


@pytest.mark.cuda
def test_reuse_kernel_frame_is_bit_identical_on_card(cuda_device):
    sys.path.insert(0, REPO)
    import chip_smoke
    chip_smoke.check_reuse_bit_identity(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["obj", "bg", "imap"])
def test_field_kernels_match_plain_on_card(cuda_device, shape):
    """K2 and K3 at each shape."""
    sys.path.insert(0, REPO)
    import chip_smoke
    shapes = [s for s in chip_smoke.FIELD_SHAPES if s[0] == shape]
    stats = {}
    chip_smoke.check_field_kernels(cuda_device, stats, shapes)
    assert stats["field_fwd"][shape]["ms"] > 0
    assert stats["field_bwd"][shape]["ms"] > 0


# K2 at the meshing launch (mesh_all_objects' 128-object bank query of
# MESH_CHUNK points at h=32) and at ragged point counts (a partial last
# tile; at h=32 an item range crossing objects)
FIELD_FWD_CASES = ((128, 32, 65536), (3, 32, 1037), (1, 128, 65536 + 77),
                   (2, 256, 4096 + 5))


@pytest.mark.cuda
@pytest.mark.parametrize("O,h,M", FIELD_FWD_CASES)
def test_field_fwd_at_meshing_and_ragged_shapes_on_card(cuda_device, O, h,
                                                        M):
    """K2 in phase 6's tiers (alpha atol 3e-4, colour 2e-5)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from vmap_tpu_torch.kernels import ensemble as E
    prepared, pts, _, _ = chip_smoke.field_operands(O, h, M, 2.0, 5,
                                                    cuda_device)
    a_k, c_k = E.field_eval(prepared, pts)
    a_r, c_r = E.field_eval_reference(prepared, pts)
    torch.cuda.synchronize()
    chip_smoke.rel_close(a_k, a_r, 0.0, 3e-4, f"{O}x{M} h={h} alpha")
    chip_smoke.rel_close(c_k, c_r, 0.0, 2e-5, f"{O}x{M} h={h} colour")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["obj", "bg", "imap"])
def test_field_bwd_repeats_bit_for_bit_and_tile_m_on_card(cuda_device,
                                                          shape):
    """K3 at the use_pallas_train tiles (phase 8's shapes, field_tile):
    two launches on the same inputs give bit-equal gradients (no atomics,
    fixed-order sums), and a second tile_m (which reorders the weight
    gradients' sum) stays within the JAX bar (rtol 2e-3, atol 2e-3
    max(1, |g|max)) of the first."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.kernels import train_step as K
    _, cap, _, h, n_per, S, scale = next(
        s for s in chip_smoke.SHAPES if s[0] == shape)
    m = n_per * S
    prepared, pts, g_a, g_c = chip_smoke.field_operands(cap, h, m, scale, 4,
                                                        cuda_device)
    tile = K.field_tile(m)
    g1 = E.field_grad(prepared, pts, g_a, g_c, tile)
    g2 = E.field_grad(prepared, pts, g_a, g_c, tile)
    g3 = E.field_grad(prepared, pts, g_a, g_c, 128)
    torch.cuda.synchronize()
    for n in E.W_NAMES:
        assert torch.equal(g1[n], g2[n]), n
        gmax = float(g1[n].abs().max())
        err = (g3[n] - g1[n]).abs()
        assert bool((err <= 2e-3 * max(1.0, gmax)
                     + 2e-3 * g1[n].abs()).all()), (n, float(err.max()))


@pytest.mark.cuda
def test_field_train_frames_match_plain_on_card(cuda_device):
    sys.path.insert(0, REPO)
    import chip_smoke
    counts, _ = chip_smoke.check_field_train_path(cuda_device)
    assert counts["field_fwd"] == counts["field_bwd"] > 0


@pytest.mark.cuda
def test_field_plan_fills_the_card_on_card(cuda_device):
    """The library's plan (vmap_field_plan) on the card's own SM count:
    K2 one wave at the meshing launch, and at 132 SMs the phase-8 grids
    the header's rule gives on the CPU (tests/test_torch_field_design.py)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.kernels import train_step as K
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = E.field_plan(32, 128, 65536)
    assert plan["fwd_blocks"] == sms * plan["fwd_blocks_per_sm"]
    got = [E.field_plan(h, cap, n_per * S, K.field_tile(n_per * S))
           for _, cap, _, h, n_per, S, _ in chip_smoke.SHAPES]
    if sms == 132:
        assert [(g["bwd_blocks"], g["wgrad_blocks"]) for g in got] == [
            (104, 728), (132, 126), (132, 130)]
    with pytest.raises(RuntimeError):
        E.field_plan(128, 1, 1024, 48)


@pytest.mark.cuda
def test_grid_volumes_match_their_chunks_on_card(cuda_device):
    """grid_volumes with chunks in flight (pinned copies, a window of 2)
    returns exactly the occupancy of its chunks, for grids of several
    sizes in one bank."""
    import numpy as np
    from types import SimpleNamespace
    sys.path.insert(0, REPO)
    from vmap_tpu_torch.core import bank as B
    from vmap_tpu_torch.core import meshing as MS
    rng = np.random.default_rng(0)
    bank = B.init_bank(torch.Generator().manual_seed(0), 5, 32, 2.0)
    bank = bank.replace(flat=bank.flat.to(cuda_device),
                        scale=bank.scale.to(cuda_device))
    work = [(o + 1, MS.oriented_box(rng.uniform(-1, 1, 3), np.eye(3),
                                    rng.uniform(0.5, 1.5, 3)), g)
            for o, g in enumerate((9, 40, 23, 40, 2))]
    fake = SimpleNamespace(device=cuda_device, bank_obj=bank, registry={
        o + 1: SimpleNamespace(slot=o) for o in range(5)})
    prepared = MS.bank_prepared(fake, work)
    frames = MS.grid_frames(work, prepared["dirs"].shape[0], cuda_device)
    chunk = 4096
    vols = MS.grid_volumes(fake, work, prepared, chunk=chunk, window=2)
    occ = torch.cat([MS._bank_grid_chunk(prepared, *frames, s, chunk)[0]
                     for s in range(0, 40 ** 3, chunk)], dim=1).cpu().numpy()
    for o, (_, _, g) in enumerate(work):
        np.testing.assert_array_equal(vols[o], occ[o, :g ** 3].reshape(
            g, g, g))


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["mm", "int8", "sections", "overlap",
                                   "vpu", "ops", "dma"])
def test_probe_kernels_match_plain_on_card(cuda_device, probe):
    """Each probe's kernels against their plain versions (``compare``'s
    default: 3 steps; K6 the script's 4000 copies, exact), each launch
    counted on its probe."""
    import importlib
    sys.path.insert(0, REPO)
    from vmap_tpu_torch import probes
    mod = importlib.import_module(f"vmap_tpu_torch.probes.{probe}")
    before = probes.LAUNCHES[probe]
    # raises outside its tolerance
    checks = mod.compare(cuda_device)
    assert checks and all(r["used"] <= 1.0 for r in checks)
    assert probes.LAUNCHES[probe] > before


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["vpu", "ops", "dma"])
def test_new_probe_entry_points_refuse_bad_input(cuda_device, probe):
    """The C entry points of csrc/{vpu,ops,dma}.cu return an error for a
    shape they do not take (the launcher then raises), and the wrappers
    refuse a CPU tensor and a wrong shape."""
    sys.path.insert(0, REPO)
    from vmap_tpu_torch import probes
    from vmap_tpu_torch.probes import dma, ops, vpu
    lib = probes.LIBRARY.load()
    stream = probes.stream(cuda_device)
    x = torch.zeros(8, 1280, device=cuda_device)
    if probe == "vpu":
        # an odd element count for the packed bf16 route; bf16 sigmoid; 3
        # items a lane; a plan of too few warps for its elements
        fields = probes.SPREAD_FIELDS
        pairs = probes.plan_ints(vpu.plan((8, "mul", "bf16")), fields)
        f32 = vpu.plan((8, "mul", "f32"))
        three = probes.plan_ints({**f32, "items": 3}, fields)
        short = probes.plan_ints({**f32, "blocks": 1}, fields)
        codes = [lib.vmap_probe_vpu(0, 1, probes.ptr(x), probes.ptr(x),
                                    pairs, 1279, 1, stream),
                 lib.vmap_probe_vpu(2, 1, probes.ptr(x), probes.ptr(x),
                                    pairs, x.numel(), 1, stream),
                 lib.vmap_probe_vpu(0, 0, probes.ptr(x), probes.ptr(x),
                                    three, x.numel(), 1, stream),
                 lib.vmap_probe_vpu(0, 0, probes.ptr(x), probes.ptr(x),
                                    short, x.numel(), 1, stream)]
        bad = lambda: vpu.launch(x[:, :640].contiguous(), "mul", "f32", 1)
        cpu = lambda: vpu.launch(x.cpu(), "mul", "f32", 1)
    elif probe == "ops":
        # lanesum_dot on a cluster of 2 (not built); strided_sum without
        # its side output
        plan = (ctypes.c_int * 3)(2, 640, 8)
        codes = [lib.vmap_probe_lanesum(probes.ptr(x), probes.ptr(x),
                                        probes.ptr(x), probes.ptr(x),
                                        ctypes.cast(plan, ctypes.c_void_p),
                                        1, stream),
                 lib.vmap_probe_ops(5, probes.ptr(x), probes.ptr(x), None,
                                    8, 1, stream)]
        bad = lambda: ops.launch("dep_fma", [x[:4].contiguous()], 1)
        cpu = lambda: ops.launch("dep_fma", [x.cpu()], 1)
    else:
        src = torch.zeros(64, 128, dtype=torch.int32, device=cuda_device)
        sums = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        # fewer copies than live; live 0 and 9; a source of 8 rows; a
        # grain of 4 rows
        codes = [lib.vmap_probe_dma(0, probes.ptr(src), 64, 4, 8, 1, 1,
                                    probes.ptr(sums), probes.ptr(x), stream),
                 lib.vmap_probe_dma(1, probes.ptr(src), 64, 16, 0, 1, 1,
                                    probes.ptr(sums), probes.ptr(x), stream),
                 lib.vmap_probe_dma(0, probes.ptr(src), 64, 16, 9, 1, 1,
                                    probes.ptr(sums), probes.ptr(x), stream),
                 lib.vmap_probe_dma(1, probes.ptr(src), 8, 16, 8, 1, 1,
                                    probes.ptr(sums), probes.ptr(x), stream),
                 lib.vmap_probe_dma(0, probes.ptr(src), 64, 16, 8, 1, 4,
                                    probes.ptr(sums), probes.ptr(x), stream)]
        bad = lambda: dma.launch(src.float(), 16, 0)
        cpu = lambda: dma.launch(src.cpu(), 16, 0)
    for code in codes:
        assert code != 0
        with pytest.raises(RuntimeError, match="CUDA error"):
            probes.LIBRARY.check(code, f"{probe} probe launch")
    with pytest.raises(ValueError):
        bad()
    with pytest.raises(ValueError, match="CUDA"):
        cpu()


@pytest.mark.cuda
def test_forloop_matches_the_vectorised_frame_on_card(cuda_device):
    """Phase 14 (a): the forloop's slots at n_iter=1 within phase 3's tier
    of the vectorised frame at the bench shape (104 slots, 100 active),
    n_iter x 101 launches of train_grad a frame."""
    sys.path.insert(0, REPO)
    import chip_smoke
    counts, res = chip_smoke.forloop_against_vmap(cuda_device, "card",
                                                  frames=1)
    assert counts["train_grad"] == 20 * 101
    assert res["speedup"] > 1.0


@pytest.mark.cuda
def test_occupancy_field_query_matches_plain_on_card(cuda_device):
    """Phase 14 (c) at a 64^3 grid: eval_points through K2 against the
    plain query, extract_mesh non-empty."""
    sys.path.insert(0, REPO)
    import chip_smoke
    counts, res = chip_smoke.occupancy_field_meshes(cuda_device, "card",
                                                    grid=64)
    assert counts["field_fwd"] > 0 and res["h32"]["faces"] > 0
