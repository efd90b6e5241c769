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
tiers with 5e-2 of scale) and under sample_reuse 4, bit-identical to the
tiled batch; and the probe kernels (``vmap_tpu_torch.probes``: K4 mm, K10
int8, K7 sections, K8 overlap) in every variant and shape against their
plain versions at 3 steps (phase 12's tolerances). Skips where CUDA is
not available (no interpret mode exists for a CUDA kernel). Run on the
card, where jax is not installed, without tests/conftest.py (it imports
jax):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

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


@pytest.mark.cuda
def test_field_train_frames_match_plain_on_card(cuda_device):
    sys.path.insert(0, REPO)
    import chip_smoke
    counts, _ = chip_smoke.check_field_train_path(cuda_device)
    assert counts["field_fwd"] == counts["field_bwd"] > 0


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
@pytest.mark.parametrize("probe", ["mm", "int8", "sections", "overlap"])
def test_probe_kernels_match_plain_on_card(cuda_device, probe):
    import importlib
    sys.path.insert(0, REPO)
    mod = importlib.import_module(f"vmap_tpu_torch.probes.{probe}")
    checks = mod.compare(cuda_device, reps=3)      # raises outside its tol
    assert checks and all(r["used"] <= 1.0 for r in checks)
