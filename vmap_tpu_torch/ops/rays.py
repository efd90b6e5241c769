"""Camera ray geometry (counterpart of ``vmap_tpu/ops/rays.py``).

Parity with the reference's origin_dirs_W (vmap.py:31-41) and cameraInfo
ray-direction cache (vmap.py:494-524). The package keeps the reference's
transposed (W, H) image layout: axis 0 is the horizontal pixel index u,
axis 1 the vertical index v. The frame step's sampler computes its own
directions (``core/step.py``); these are the public API.
"""

from __future__ import annotations

import torch


def ray_dirs_cache(width: int, height: int, fx: float, fy: float,
                   cx: float, cy: float,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """[W, H, 3] per-pixel camera-frame ray directions with the z-depth
    convention: [(u - cx) / fx, (v - cy) / fy, 1] (vmap.py:508-524)."""
    u = torch.arange(width, dtype=torch.float32, device=device)
    v = torch.arange(height, dtype=torch.float32, device=device)
    dirs = torch.ones((width, height, 3), dtype=torch.float32, device=device)
    dirs[:, :, 0] = ((u - cx) / fx)[:, None]
    dirs[:, :, 1] = ((v - cy) / fy)[None, :]
    return dirs


def origin_dirs_w(t_wc: torch.Tensor, dirs_c: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame ray directions to the world frame.

    t_wc: [n, 4, 4] camera-to-world poses; dirs_c: [n, m, 3].
    Returns (origins [n, 3], dirs_w [n, m, 3]) (vmap.py:31-41).
    """
    dirs_w = torch.einsum("nij,nmj->nmi", t_wc[:, :3, :3], dirs_c)
    return t_wc[:, :3, 3], dirs_w
