"""Self-contained geometry stack.

The reference leans on three native libraries that are intentionally NOT
dependencies here: scikit-image (marching cubes, vis.py:8), trimesh (mesh
container/IO/sampling/oriented bounds, vmap.py:292, metric/*), and Open3D
(depth unprojection, OBBs, viewer, vmap.py:270-315). This package provides
the same capabilities from scratch on numpy/scipy:

  * marching_cubes    — isosurface extraction (tetrahedra decomposition)
  * mesh              — Mesh container, OBJ/PLY IO, surface sampling,
                        concatenation, box slicing
  * obb               — minimal-volume oriented bounding boxes
  * pointcloud        — depth unprojection, voxel downsampling
"""

from vmap_tpu_torch.geometry.marching_cubes import marching_cubes  # noqa: F401
from vmap_tpu_torch.geometry.mesh import Mesh  # noqa: F401
from vmap_tpu_torch.geometry.obb import OrientedBox, oriented_bounds  # noqa: F401
