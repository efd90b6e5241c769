"""vmap_tpu_torch — the PyTorch / CUDA port of vmap_tpu.

The per-frame vMAP training path (frame pool -> keyframe/pixel/z sampling
-> per-object occupancy MLPs -> volume render -> masked losses -> masked
AdamW, for a 100-slot object bank and a background field), mesh export
and checkpoints run here on PyTorch tensors, and on an NVIDIA H100 through
hand-written CUDA kernels (``kernels/csrc/``: the train-frame kernels and
the field query with its backward) in place of the JAX package's Pallas
kernels. Dataset generation (a PyTorch ray tracer, ``data_generation``),
the evaluation protocols (``eval``) and the room pipeline that joins them
to training (``room_pipeline``) run here too.

Module names mirror ``vmap_tpu`` so each counterpart is easy to find.
The package stands alone: it imports nothing of ``vmap_tpu`` (nor
``jax``), and keeps its own copies of the host code it needs (``config``,
``data``, ``core.keyframe``, ``geometry``, ``native``, ``eval``,
``data_generation.{settings,room,writer}``, ``utils.viewer`` and
``utils.vis``), each the JAX package's module with its imports pointed
here (``Config.fused_enabled`` resolves against the device; the Replica
images through the port's own PNG codec, ``utils.png``, not OpenCV).
"""

__version__ = "0.1.0"
