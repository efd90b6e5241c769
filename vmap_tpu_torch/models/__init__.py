"""Model families (counterpart of ``vmap_tpu/models``).

Tiny occupancy fields with icosahedral positional encoding, in three
configurations selected by config: the object field (hidden 32, scale 2),
the background (hidden 128) and the iMAP scene field (hidden 256).
``OccupancyField`` bundles init, apply and meshing for one field; the
bank's training path uses the same functions (``ops/embedding.py``,
``ops/mlp.py``) on flat buffers.
"""

from vmap_tpu_torch.models.occupancy_field import OccupancyField  # noqa: F401
