"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

``KERNEL_HIDDEN`` is the one statement of the hidden widths each CUDA
kernel is built for (the launchers in ``csrc/`` dispatch on the same
widths and refuse the others). On CUDA tensors a wrapper raises for a
width outside its kernel's; the Mapper checks a configuration against
the kernels its path runs before it allocates anything on the device.
"""

KERNEL_HIDDEN = {
    "train_frame": (32, 128, 256),   # K1, csrc/train_step.cu
    "field_fwd": (32, 128, 256),     # K2, csrc/ensemble.cu field_fwd_kernel
    "field_bwd": (32, 128),          # K3, csrc/ensemble.cu field_bwd_kernel
}


def check_width(kernel: str, hidden: int) -> None:
    """Raise ValueError if ``kernel`` has no CUDA instance at ``hidden``."""
    if hidden not in KERNEL_HIDDEN[kernel]:
        raise ValueError(f"CUDA {kernel} kernel is built for hidden "
                         f"{KERNEL_HIDDEN[kernel]}, not {hidden}")
