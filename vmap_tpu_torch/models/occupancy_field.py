"""One neural field outside the Mapper's bank (counterpart of
``vmap_tpu/models/occupancy_field.py``): offline fitting, inspection,
export.

    field = OccupancyField.create(torch.Generator().manual_seed(0),
                                  hidden=32, scale=2.0)   # on CUDA
    occ, color = field(points)                            # forward
    mesh = field.extract_mesh(bound, grid_dim=128)

An ``nn.Module`` whose PE projection and MLP weights are ``nn.Parameter``s
(``field.pe`` / ``field.mlp``, the ``ops`` functions' dicts), so
``torch.optim`` and autograd take it as it is. ``forward`` and
``raw_alpha`` are plain PyTorch; ``eval_points`` and ``extract_mesh``
query the field through ``core.meshing.eval_points``, which is the K2
``field_fwd`` kernel on CUDA (6 PE bands: ``max_deg`` 5) and its plain
version on the CPU. Architecture: the reference's OccupancyMap +
UniDirsEmbed (model.py:16-85, embedding.py:43-91).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vmap_tpu_torch.device import resolve_device
from vmap_tpu_torch.ops.embedding import embed, init_pe_params
from vmap_tpu_torch.ops.mlp import init_mlp_params, mlp_apply
from vmap_tpu_torch.ops.render import occupancy_activation


class OccupancyField(nn.Module):
    def __init__(self, pe: dict, mlp: dict, scale: float, hidden: int = 32,
                 max_deg: int = 5):
        super().__init__()
        self.pe = nn.ParameterDict({k: nn.Parameter(v)
                                    for k, v in pe.items()})
        self.mlp = nn.ParameterDict({k: nn.Parameter(v)
                                     for k, v in mlp.items()})
        dev = pe["dirs"].device
        self.register_buffer("scale", torch.tensor(float(scale),
                                                   dtype=torch.float32,
                                                   device=dev))
        self.hidden = hidden
        self.max_deg = max_deg

    @classmethod
    def create(cls, generator: torch.Generator | None = None,
               hidden: int = 32, scale: float = 2.0, max_deg: int = 5,
               device: torch.device | str = "cuda") -> "OccupancyField":
        """Fresh parameters: the PE projection at the icosahedron, the MLP
        drawn from ``generator`` (a CPU generator; seed 0 if None). On
        CUDA unless ``device`` says otherwise; raises without CUDA."""
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        return cls(init_pe_params(device),
                   init_mlp_params(gen, hidden, device=device),
                   scale, hidden=hidden, max_deg=max_deg)

    def params(self) -> tuple[dict, dict]:
        """(pe, mlp) dicts of the parameters."""
        return dict(self.pe), dict(self.mlp)

    def forward(self, points: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """points [..., 3] -> (occupancy [...], colour [..., 3])."""
        pe, mlp_p = self.params()
        alpha, color = mlp_apply(mlp_p, embed(pe, points, self.scale,
                                              self.max_deg))
        return occupancy_activation(alpha[..., 0]), color

    def raw_alpha(self, points: torch.Tensor) -> torch.Tensor:
        """points [..., 3] -> the alpha head's output [...] before the
        sigmoid."""
        pe, mlp_p = self.params()
        alpha, _ = mlp_apply(mlp_p, embed(pe, points, self.scale,
                                          self.max_deg))
        return alpha[..., 0]

    @torch.no_grad()
    def eval_points(self, points, chunk: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """(occupancy [N], colour [N, 3]) numpy arrays at ``points``
        (numpy or a tensor, [..., 3]), queried in chunks on the field's
        device: K2 on CUDA."""
        from vmap_tpu_torch.core.meshing import EVAL_CHUNK, eval_points
        if self.max_deg != 5:
            raise NotImplementedError(
                f"max_deg {self.max_deg}: the field query has the 6 PE "
                "bands of max_deg 5")
        pe, mlp_p = self.params()
        return eval_points({k: v.detach() for k, v in pe.items()},
                           {k: v.detach() for k, v in mlp_p.items()},
                           self.scale, points,
                           chunk=EVAL_CHUNK if chunk is None else chunk)

    def extract_mesh(self, bound, grid_dim: int = 128,
                     bound_extent: float = 0.9):
        """Marching-cubes mesh (level 0.5) of the field inside an
        ``OrientedBox``, its vertices coloured by the field; None where
        the level set is empty."""
        from vmap_tpu_torch.geometry.marching_cubes import marching_cubes
        from vmap_tpu_torch.geometry.mesh import Mesh
        from vmap_tpu_torch.ops.render import make_3d_grid

        scene_scale = bound.extent / (2.0 * bound_extent)
        transform = np.eye(4, dtype=np.float32)
        transform[:3, :3] = bound.R
        transform[:3, 3] = bound.center
        grid = make_3d_grid((-1.0, 1.0), grid_dim, transform=transform,
                            scale=np.asarray(scene_scale, np.float32),
                            device=self.scale.device)
        occ, _ = self.eval_points(grid.reshape(-1, 3))
        verts, faces = marching_cubes(occ.reshape(grid_dim, grid_dim,
                                                  grid_dim))
        if verts is None:
            return None
        mesh = Mesh(verts, faces)
        mesh.apply_scale(1.0 / (grid_dim - 1))
        mesh.apply_translation([-0.5, -0.5, -0.5])
        mesh.apply_scale(2.0)
        mesh.apply_scale(scene_scale)
        mesh.apply_transform(transform)
        _, colors = self.eval_points(mesh.vertices.astype(np.float32))
        mesh.vertex_colors = np.clip(colors * 255, 0, 255).astype(np.uint8)
        return mesh
