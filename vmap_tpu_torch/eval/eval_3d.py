"""Offline 3D evaluation CLI (scene- and object-level).

Reference surface: metric/eval_3D_scene.py and metric/eval_3D_obj.py as
``__main__`` scripts. Here one CLI covers both:

    python -m vmap_tpu_torch.eval.eval_3d scene --mesh_dir logs/run/scene_mesh \
        --gt_mesh /data/room_0/mesh.ply [--frame 1999] [--out metrics.json]

    python -m vmap_tpu_torch.eval.eval_3d object --mesh_dir logs/run/scene_mesh \
        --gt_dir /data/room_0/habitat --frame 1999
        (GT submeshes named mesh_semantic.ply_<id>.ply, eval_3D_obj.py:92;
         background = concatenation of background-class submeshes from
         info_semantic.json, eval_3D_obj.py:43-55)
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from vmap_tpu_torch.eval.mesh_eval import (compose_scene_mesh, eval_object,
                                     eval_scene, object_ids_in_dir)
from vmap_tpu_torch.geometry.mesh import Mesh, load_mesh

REPLICA_BACKGROUND_CLASSES = [5, 12, 30, 31, 40, 60, 92, 93, 95, 97, 98, 79]


def gt_background_mesh(gt_dir: str,
                       background_classes=REPLICA_BACKGROUND_CLASSES) -> Mesh:
    """Concatenate GT submeshes of background classes (eval_3D_obj.py:43-55)."""
    with open(os.path.join(gt_dir, "info_semantic.json")) as f:
        objects = json.load(f)["objects"]
    parts = []
    for obj in objects:
        if int(obj["class_id"]) in background_classes:
            p = os.path.join(gt_dir, f"mesh_semantic.ply_{int(obj['id'])}.ply")
            if os.path.exists(p):
                parts.append(load_mesh(p))
    return Mesh.concatenate(parts)


def run_scene(args) -> dict:
    rec = compose_scene_mesh(args.mesh_dir, args.frame)
    gt = load_mesh(args.gt_mesh)
    m = eval_scene(rec, gt, n=args.n_points)
    print("Acc | Comp | Ratio@1cm | Ratio@5cm")
    print(f"{m['accuracy']:.4f} | {m['completion']:.4f} | "
          f"{m['completion_ratio_1cm']:.4f} | {m['completion_ratio_5cm']:.4f}")
    return m


def run_object(args) -> dict:
    obj_ids = object_ids_in_dir(args.mesh_dir)
    id_offset = getattr(args, "id_offset", None)
    bg_classes = REPLICA_BACKGROUND_CLASSES
    if getattr(args, "format", "Replica") == "ScanNet":
        # ScanNet-format runs: the loader shifts instance ids +1 so 0 is
        # free for background (reference dataset.py:247), and the GT
        # vocabulary is the ScanNet background set, not Replica's. The
        # reference has no ScanNet object protocol (eval_3D_obj.py is
        # Replica-only); this extension keeps its Replica semantics but
        # maps ids/classes through the ScanNet conventions.
        from vmap_tpu_torch.data.scannet import BACKGROUND_CLASSES as SCANNET_BG
        bg_classes = sorted(c for c in SCANNET_BG if c > 0)
        if id_offset is None:   # default 1 only when the flag wasn't given,
            id_offset = 1       # so an explicit --id_offset 0 is honoured
    if id_offset is None:
        id_offset = 0
    per_obj, agg = {}, []
    for oid in obj_ids:
        rec_file = os.path.join(args.mesh_dir, f"frame_{args.frame}_obj{oid}.obj")
        if not os.path.exists(rec_file):
            continue
        if oid == 0:
            gt = gt_background_mesh(args.gt_dir, background_classes=bg_classes)
            n = 200000
        else:
            gt_id = oid - id_offset
            p = os.path.join(args.gt_dir, f"mesh_semantic.ply_{gt_id}.ply")
            if not os.path.exists(p):
                print(f"obj {oid}: no GT submesh (gt id {gt_id}), skipped")
                continue
            gt = load_mesh(p)
            n = args.n_points
        m = eval_object(load_mesh(rec_file), gt, n=n)
        if m is None:
            print(f"obj {oid}: empty after crop, skipped")
            continue
        per_obj[oid] = m
        agg.append([m["accuracy"], m["completion"],
                    m["completion_ratio_1cm"], m["completion_ratio_5cm"]])
        print(f"obj {oid}: acc={m['accuracy']:.4f} comp={m['completion']:.4f}")
    mean = np.mean(agg, axis=0) if agg else [float("nan")] * 4
    result = {
        "per_object": per_obj,
        "mean": {"accuracy": mean[0], "completion": mean[1],
                 "completion_ratio_1cm": mean[2],
                 "completion_ratio_5cm": mean[3]},
    }
    print("mean: Acc | Comp | Ratio@1cm | Ratio@5cm")
    print(f"{mean[0]:.4f} | {mean[1]:.4f} | {mean[2]:.4f} | {mean[3]:.4f}")
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="3D reconstruction evaluation")
    sub = p.add_subparsers(dest="mode", required=True)
    ps = sub.add_parser("scene")
    ps.add_argument("--mesh_dir", required=True)
    ps.add_argument("--gt_mesh", required=True)
    ps.add_argument("--frame", type=int, default=None)
    ps.add_argument("--n_points", type=int, default=200000)
    ps.add_argument("--out", default=None)
    po = sub.add_parser("object")
    po.add_argument("--mesh_dir", required=True)
    po.add_argument("--gt_dir", required=True)
    po.add_argument("--frame", type=int, required=True)
    po.add_argument("--n_points", type=int, default=10000)
    po.add_argument("--format", choices=["Replica", "ScanNet"],
                    default="Replica",
                    help="dataset family: ScanNet shifts recon object ids "
                         "-1 back to GT ids and uses the ScanNet "
                         "background-class vocabulary for the bg mesh")
    po.add_argument("--id_offset", type=int, default=None,
                    help="recon obj id minus GT submesh id (defaults to 1 "
                         "for ScanNet, 0 for Replica; an explicit 0 is "
                         "honoured for either)")
    po.add_argument("--out", default=None)
    args = p.parse_args(argv)

    result = run_scene(args) if args.mode == "scene" else run_object(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result


if __name__ == "__main__":
    main()
