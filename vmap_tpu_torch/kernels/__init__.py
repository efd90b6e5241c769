"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

``KERNEL_HIDDEN`` is the one statement of the hidden widths each CUDA
kernel is built for, ``KERNEL_POLICIES`` of the matmul policies
(``ops.mlp.POLICIES``) it is built under; the launchers in ``csrc/``
dispatch on the same widths and policies and refuse the others. On CUDA
tensors a wrapper raises for a width or policy outside its kernel's; the
Mapper checks a configuration against the kernels its path runs before
it allocates anything on the device.

``MAX_POINTS`` is the points of one train-frame ray tile per width under
the int8 policies (``tile_rays``): the tile is also the granularity of
their activation and gradient scales (``ops.quant``), so the plain version
of the frame reads the same constant. ``FLOAT_POINTS`` is the float
policies' tile (``float_tile_rays``), the tensor-core tile of
``csrc/train_step.cu``. The field kernels' tiles and grids are their
library's (``csrc/field_plan.cuh``; ``ensemble.field_plan``).
"""

from vmap_tpu_torch.ops.mlp import POLICIES

KERNEL_HIDDEN = {
    "train_frame": (32, 128, 256),   # K1, csrc/train_step.cu, train_step_q8.cu
    "field_fwd": (32, 128, 256),     # K2, csrc/ensemble.cu field_fwd_kernel
    "field_bwd": (32, 128, 256),     # K3, csrc/ensemble.cu field_bwd_kernel,
                                     # field_wgrad_kernel
}
KERNEL_POLICIES = {
    "train_frame": POLICIES,
    "field_fwd": ("float32",),
    "field_bwd": ("float32",),
}
# (rays per tile) * samples may not exceed this under the int8 policies,
# per hidden size: it is the granularity of their activation and gradient
# scales (ops.quant), and it sets the shared memory of one int8 train_grad
# block (csrc/train_step_q8.cu, kernels/train_step.py q8_smem_bytes: the
# tile's s8 copies, point-major for the products that read them next and,
# under int8 / int8_static, feature-major for the backward; at the shipped
# shapes 103 KB at h=32 / 120 rays x 10 samples, two blocks an SM, 169 KB
# at h=128 / 1200 x 14, 151 KB at h=256 / 4800 x 14; at most 210 KB at
# every S <= 32). A weight gradient sums s8 x s8 products over one tile's
# points in s32, exactly; the scaled sums equal ops.quant's f32 ones while
# points * 127^2 < 2^24: 64 points give 1.03 M, and a tile of more than
# 1040 points would break it.
MAX_POINTS = {32: 64, 128: 56, 256: 38}
# the float policies' tile (csrc/train_step.cu Tile<H>::FP): its f32
# activations beside the slabs of staged weights (kernels/train_step.py
# float_smem_bytes) within the 227 KB a block may use at every S <= 32;
# the products pad it to whole 16-point steps
FLOAT_POINTS = {32: 64, 128: 56, 256: 56}


def _rays(table: dict, hidden: int, n_samples: int) -> int:
    wider = [h for h in sorted(table) if h >= hidden]
    points = table[wider[0] if wider else max(table)]
    return max(1, points // n_samples)


def tile_rays(hidden: int, n_samples: int) -> int:
    """Whole rays per train_grad tile under the int8 policies. A width
    without a kernel (the plain version at a test's width) takes the tile
    of the next wider kernel width, or of the widest."""
    return _rays(MAX_POINTS, hidden, n_samples)


def float_tile_rays(hidden: int, n_samples: int) -> int:
    """Whole rays per train_grad tile under the float policies (the next
    wider kernel width's, as ``tile_rays``)."""
    return _rays(FLOAT_POINTS, hidden, n_samples)


def check_width(kernel: str, hidden: int, policy: str = "float32") -> None:
    """Raise ValueError if ``kernel`` has no CUDA instance at ``hidden``
    under the matmul ``policy``."""
    if hidden not in KERNEL_HIDDEN[kernel]:
        raise ValueError(f"CUDA {kernel} kernel is built for hidden "
                         f"{KERNEL_HIDDEN[kernel]}, not {hidden}")
    if policy not in KERNEL_POLICIES[kernel]:
        raise ValueError(f"CUDA {kernel} kernel is built for the matmul "
                         f"policies {KERNEL_POLICIES[kernel]}, not "
                         f"{policy!r}")
