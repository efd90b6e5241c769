"""Split a semantic mesh into per-object-id submeshes.

Counterpart of the reference's data_generation/extract_inst_obj.py:1-47:
Replica's ``mesh_semantic.ply`` carries a per-face ``object_id`` property;
object-level evaluation needs one GT mesh per id, written as
``mesh_semantic.ply_<id>.ply``.

    python -m vmap_tpu_torch.eval.extract_objects /data/room_0/habitat/mesh_semantic.ply
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from vmap_tpu_torch.geometry.mesh import Mesh, load_ply_with_face_props


def split_by_object_id(path: str, out_dir: str | None = None,
                       prop: str = "object_id") -> list[str]:
    mesh, face_props = load_ply_with_face_props(path)
    if prop not in face_props:
        raise ValueError(
            f"{path} has no per-face '{prop}' property "
            f"(found: {sorted(face_props)})")
    obj_ids = np.asarray(face_props[prop]).astype(np.int64)
    out_dir = out_dir or os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path)
    written = []
    for oid in np.unique(obj_ids):
        sel = obj_ids == oid
        sub = Mesh(mesh.vertices, mesh.faces[sel],
                   vertex_colors=mesh.vertex_colors).remove_unreferenced()
        out = os.path.join(out_dir, f"{base}_{int(oid)}.ply")
        sub.export(out)
        written.append(out)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="split semantic mesh by object id")
    p.add_argument("mesh", help="PLY with a per-face object_id property")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--prop", default="object_id")
    args = p.parse_args(argv)
    written = split_by_object_id(args.mesh, args.out_dir, args.prop)
    print(f"wrote {len(written)} submeshes")
    return written


if __name__ == "__main__":
    main()
