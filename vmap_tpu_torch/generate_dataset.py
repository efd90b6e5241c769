"""Generate an RGB-D + instance dataset by ray-tracing a mesh scene
(counterpart of the repo's ``scripts/generate_dataset.py``).

Stand-in for the reference's Habitat-Sim generation step
(data_generation/habitat_renderer.py): renders the analytic test scene's
ground-truth meshes, or the procedurally furnished room, along a
trajectory and writes the exact Replica-vMAP or ScanNet file layout that
the loaders consume, plus GT submeshes + info_semantic.json for the
object-level eval protocol. Frames stream from render to write: no whole
sequence is held in memory.

    python -m vmap_tpu_torch.generate_dataset out_dir
        [--format Replica|ScanNet] [--scene synthetic|room] [--objects N]
        [--frames N] [--width W] [--height H] [--fx F] [--fy F]
        [--device cuda|cpu]

Renders on CUDA by default and raises without it; ``--device cpu`` asks
for the CPU. The ScanNet layout writes JPEG colour through OpenCV.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def synthetic_scene_objects(fmt: str):
    """The analytic scene (data/synthetic.py) as renderable SceneObjects.
    Class ids are chosen so the floor folds to background in each loader:
    Replica background classes include 40, ScanNet's include 1."""
    from vmap_tpu_torch.data.synthetic import SyntheticScene
    from vmap_tpu_torch.data_generation.settings import SceneObject
    scene = SyntheticScene()
    gt = scene.gt_meshes()
    floor_cls = 40 if fmt == "Replica" else 1
    return scene, [
        SceneObject(gt[0], instance_id=3, class_id=floor_cls,
                    albedo=(0.55, 0.55, 0.5)),
        SceneObject(gt[scene.SPHERE_ID], instance_id=scene.SPHERE_ID,
                    class_id=20, albedo=(0.85, 0.25, 0.2)),
        SceneObject(gt[scene.BOX_ID], instance_id=scene.BOX_ID,
                    class_id=7, albedo=(0.2, 0.4, 0.85)),
    ]


def room_settings(width: int, height: int, fx: float, fy: float):
    """The room's render settings: 512-triangle chunks, 32,768-ray tiles
    above 65,536 pixels, and a barycentric slack that closes shared-edge
    holes on the big shell faces."""
    from vmap_tpu_torch.data_generation.settings import RenderSettings
    return RenderSettings(width=width, height=height, fx=fx, fy=fy,
                          tri_chunk=512,
                          ray_chunk=32768 if width * height > 65536 else 0,
                          bary_eps=1e-5)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--format", default="Replica",
                   choices=["Replica", "ScanNet"])
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--width", type=int, default=80)
    p.add_argument("--height", type=int, default=60)
    p.add_argument("--fx", type=float, default=50.0)
    p.add_argument("--fy", type=float, default=50.0)
    p.add_argument("--invalid_pose_frames", type=int, nargs="*", default=[])
    p.add_argument("--scene", default="synthetic",
                   choices=["synthetic", "room"],
                   help="'room': Replica-scale furnished room "
                        "(data_generation/room.py)")
    p.add_argument("--objects", type=int, default=40,
                   help="furniture instance count for --scene room")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ply_furniture", action="store_true",
                   help="generate a .ply furniture library and build the "
                        "room with ~1/3 loaded-mesh instances "
                        "(data_generation/room.py write_ply_library)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from vmap_tpu_torch.data_generation import (MeshRenderer, RenderSettings,
                                                write_gt_submeshes,
                                                write_replica_sequence,
                                                write_scannet_sequence)
    from vmap_tpu_torch.data_generation.settings import orbit_trajectory
    from vmap_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.scene == "room":
        from vmap_tpu_torch.data_generation.room import (SCANNET_CLS_MAP,
                                                         make_room_scene,
                                                         room_trajectory,
                                                         write_ply_library)
        ply_dir = None
        if args.ply_furniture:
            ply_dir = os.path.join(args.out_dir, "ply_lib")
            write_ply_library(ply_dir, seed=args.seed)
        objs, shell, meta = make_room_scene(args.objects, seed=args.seed,
                                            ply_dir=ply_dir)
        objects = objs + shell
        if args.format == "ScanNet":
            # the room builder tags Replica semantics; remap to the ScanNet
            # vocabulary so the shell folds to background in that loader
            objects = [dataclasses.replace(
                o, class_id=SCANNET_CLS_MAP.get(o.class_id, o.class_id))
                for o in objects]
        traj = room_trajectory(args.frames, size=meta["size"],
                               seed=args.seed)
        st = room_settings(args.width, args.height, args.fx, args.fy)
    else:
        scene, objects = synthetic_scene_objects(args.format)
        st = RenderSettings(width=args.width, height=args.height,
                            fx=args.fx, fy=args.fy, tri_chunk=256)
        traj = orbit_trajectory(args.frames, radius=scene.orbit_radius,
                                height=scene.orbit_height)
    renderer = MeshRenderer(objects, st, device=device)
    frames = renderer.render_trajectory(traj)   # a generator: streams
    if args.format == "Replica":
        write_replica_sequence(args.out_dir, frames, traj)
    else:
        write_scannet_sequence(args.out_dir, frames, traj,
                               invalid_pose_frames=tuple(
                                   args.invalid_pose_frames),
                               intrinsics=st.intrinsics())
    # GT submeshes + info_semantic.json for the object / scene protocols
    write_gt_submeshes(os.path.join(args.out_dir, "habitat"), objects)
    print(f"wrote {args.frames} frames ({args.format}, "
          f"{renderer.n_triangles} triangles, {device}) -> {args.out_dir}")


if __name__ == "__main__":
    main()
