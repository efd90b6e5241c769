"""Offline 3D reconstruction evaluation (Accuracy / Completion /
Completion-ratio), scene- and object-level."""

from vmap_tpu_torch.eval.metrics import (accuracy, chamfer, completion,  # noqa: F401
                                   completion_ratio)
