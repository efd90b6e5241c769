"""Depth-guided ray sampling, branch-free (counterpart of
``vmap_tpu/ops/sampling.py``).

The uniforms are inputs: the port draws them from a ``torch.Generator``,
and the parity tests hand in the uniforms JAX draws, so both packages see
identical samples. Per ray:
  * invalid depth (d <= min_depth): all n_cam2surface + n_bins z
    stratified in [min_depth, max over the sampled batch];
  * valid depth: the first n_cam2surface z stratified in
    [min_depth, d - eps], the last n_bins either sorted clipped
    N(d, (eps/3)^2) (this object) or stratified in [d - eps, d + stop_eps].
"""

from __future__ import annotations

import torch

OTHER_OBJ = 0
THIS_OBJ = 1
UNKNOWN_OBJ = 2


def _stratified_from_u(u: torch.Tensor, min_depth, max_depth) -> torch.Tensor:
    """Bins-major stratified samples from uniforms u [n_bins, ...]."""
    n_bins = u.shape[0]
    min_depth = torch.as_tensor(min_depth, dtype=torch.float32,
                                device=u.device)
    max_depth = torch.as_tensor(max_depth, dtype=torch.float32,
                                device=u.device)
    depth_range = max_depth - min_depth
    edges = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float32,
                           device=u.device)[:-1]
    edges = edges.reshape((n_bins,) + (1,) * (u.dim() - 1))
    lower = depth_range[None] * edges + min_depth[None]
    return lower + u * (depth_range / n_bins)[None]


def _normal_from_u(u: torch.Tensor, depth: torch.Tensor,
                   delta: float) -> torch.Tensor:
    """Bins-major sorted clipped normals from uniforms u [n_bins + 1, ...]:
    normalised exponential spacings are exact sorted uniforms, mapped
    through the normal inverse CDF."""
    e = -torch.log1p(-u)
    csum = torch.cumsum(e, dim=0)
    u_sorted = csum[:-1] / csum[-1:]
    u_sorted = torch.clamp(u_sorted, 1e-7, 1.0 - 1e-7)
    bins = torch.special.ndtri(u_sorted) * (delta / 3.0)
    bins = torch.clamp(bins, -delta, delta)
    return depth[None] + bins


def n_uniforms(n_cam2surface: int, n_bins: int) -> int:
    """Rows of uniforms ``sample_z_sm`` consumes per ray: front rows, back
    rows and the order-statistics tail draw of ``_normal_from_u``."""
    return n_cam2surface + n_bins + 1


def sample_z_sm(u: torch.Tensor, depth: torch.Tensor, state: torch.Tensor,
                min_depth: float, max_bound: torch.Tensor,
                n_cam2surface: int, n_bins: int, surface_eps: float,
                stop_eps: float, reuse: int = 1
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bins-major z samples.

    u [n_uniforms, *depth.shape]; max_bound broadcastable to depth.
    Returns (z [n_cam2surface + n_bins, *depth.shape], valid [*depth.shape]).
    One block of uniforms feeds all branches: the branches are mutually
    exclusive per ray, so sharing draws is distributionally exact.

    ``reuse > 1`` (``sample_reuse``): depth / state [..., n] are one pixel
    block that the frame cycles ``reuse`` times, u is [n_uniforms, ...,
    reuse * n] (fresh for every repetition) and depth, state and max_bound
    broadcast over the repetitions: z is [n_cam2surface + n_bins, ...,
    reuse * n], equal to calling with the tiled inputs; valid stays
    untiled ([..., n]).
    """
    valid = depth > min_depth
    if reuse > 1:
        z, _ = sample_z_sm(u.unflatten(-1, (reuse, depth.shape[-1])),
                           depth[..., None, :], state[..., None, :],
                           min_depth, max_bound[..., None], n_cam2surface,
                           n_bins, surface_eps, stop_eps)
        return z.flatten(-2), valid
    total = n_cam2surface + n_bins
    zero = torch.zeros_like(depth)
    z_invalid = _stratified_from_u(u[:total], zero + min_depth,
                                   torch.broadcast_to(max_bound, depth.shape))
    z_front = _stratified_from_u(u[:n_cam2surface], zero + min_depth,
                                 depth - surface_eps)
    z_this = _normal_from_u(u[n_cam2surface:n_cam2surface + n_bins + 1],
                            depth, surface_eps)
    z_other = _stratified_from_u(u[n_cam2surface:n_cam2surface + n_bins],
                                 depth - surface_eps, depth + stop_eps)
    is_this = state == THIS_OBJ
    z_back = torch.where(is_this[None], z_this, z_other)
    z_valid = torch.cat([z_front, z_back], dim=0)
    z = torch.where(valid[None], z_valid, z_invalid)
    return z, valid
