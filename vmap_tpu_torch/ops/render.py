"""Volume-rendering ops for occupancy fields (counterpart of
``vmap_tpu/ops/render.py``): sigmoid occupancy, shifted-cumprod
termination, weighted-sum rendering and the per-element L1 residual.
"""

from __future__ import annotations

import torch


def occupancy_activation(alpha: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(alpha)


def occupancy_to_termination(occ: torch.Tensor) -> torch.Tensor:
    """term_i = occ_i * prod_{j<i} (1 - occ_j + 1e-10), along the last axis."""
    free = 1.0 - occ + 1e-10
    shifted = torch.cat([torch.ones_like(free[..., :1]), free[..., :-1]],
                        dim=-1)
    return occ * torch.cumprod(shifted, dim=-1)


def render(termination: torch.Tensor, vals: torch.Tensor,
           dim: int = -1) -> torch.Tensor:
    return (termination * vals).sum(dim=dim)


def render_loss(rendered: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-element L1 residual (the only kind the training losses use)."""
    return torch.abs(rendered - gt)


def make_3d_grid(occ_range=(-1.0, 1.0), dim: int = 256, transform=None,
                 scale=None, device: torch.device | str = "cpu"
                 ) -> torch.Tensor:
    """[dim, dim, dim, 3] f32 grid of points in ``occ_range``, optionally
    scaled per axis then rigidly transformed by a [4, 4] pose. The axis
    values are ``start + i * step`` with the last one exactly ``stop``, as
    ``jnp.linspace`` gives them."""
    lo, hi = occ_range
    t = (lo + torch.arange(dim, dtype=torch.float32, device=device)
         * torch.tensor((hi - lo) / (dim - 1), dtype=torch.float32))
    t[-1] = hi
    grid = torch.stack(torch.meshgrid(t, t, t, indexing="ij"), dim=-1)
    if scale is not None:
        grid = grid * torch.as_tensor(scale, dtype=torch.float32,
                                      device=device)
    if transform is not None:
        tr = torch.as_tensor(transform, dtype=torch.float32, device=device)
        grid = grid @ tr[:3, :3].T + tr[:3, 3]
    return grid
