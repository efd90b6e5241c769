from vmap_tpu_torch.data_generation.settings import RenderSettings, SceneObject
from vmap_tpu_torch.data_generation.renderer import MeshRenderer
from vmap_tpu_torch.data_generation.writer import (write_replica_sequence,
                                                   write_scannet_sequence,
                                                   write_gt_submeshes)

__all__ = ["RenderSettings", "SceneObject", "MeshRenderer",
           "write_replica_sequence", "write_scannet_sequence",
           "write_gt_submeshes"]
