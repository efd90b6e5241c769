"""vmap_tpu_torch — the PyTorch / CUDA port of vmap_tpu.

The per-frame vMAP training path (frame pool -> keyframe/pixel/z sampling
-> per-object occupancy MLPs -> volume render -> masked losses -> masked
AdamW, for a 100-slot object bank and a background field), mesh export
and checkpoints run here on PyTorch tensors, and on an NVIDIA H100 through
hand-written CUDA kernels (``kernels/csrc/``: the train-frame kernels and
the field query with its backward) in place of the JAX package's Pallas
kernels.

Module names mirror ``vmap_tpu`` so each counterpart is easy to find.
JAX-free host code (``Config``, ``data``, ``KeyframeTable``, ``geometry``,
``native``, the HTML viewer) is imported from ``vmap_tpu``, never copied.
Importing this package never imports ``jax``: ``vmap_tpu/__init__.py``
pulls in only the numpy config, and this package imports none of
``vmap_tpu.ops``, ``vmap_tpu.kernels`` or the jax-importing
``vmap_tpu.core`` modules.
"""

__version__ = "0.1.0"
