"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

``KERNEL_HIDDEN`` is the one statement of the hidden widths each CUDA
kernel is built for, ``KERNEL_POLICIES`` of the matmul policies
(``ops.mlp.POLICIES``) it is built under; the launchers in ``csrc/``
dispatch on the same widths and policies and refuse the others. On CUDA
tensors a wrapper raises for a width or policy outside its kernel's; the
Mapper checks a configuration against the kernels its path runs before
it allocates anything on the device.
"""

from vmap_tpu_torch.ops.mlp import POLICIES

KERNEL_HIDDEN = {
    "train_frame": (32, 128, 256),   # K1, csrc/train_step.cu
    "field_fwd": (32, 128, 256),     # K2, csrc/ensemble.cu field_fwd_kernel
    "field_bwd": (32, 128),          # K3, csrc/ensemble.cu field_bwd_kernel
}
KERNEL_POLICIES = {
    "train_frame": POLICIES,
    "field_fwd": ("float32",),
    "field_bwd": ("float32",),
}


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
