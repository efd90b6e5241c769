"""Replica-scale acceptance run on the procedurally furnished room
(counterpart of the repo's ``scripts/room_pipeline.py``).

The reference's quality story is 2000-frame, ~50-object Replica rooms at
1200 x 680 evaluated per object and per scene (metric/eval_3D_scene.py,
eval_3D_obj.py; workload shape configs/Replica/config_replica_room0_vMAP
.json). This pipeline runs the same protocol end to end on the port:

  1. ray-trace a furnished room (``generate_dataset``, data_generation/
     room.py) at 1200 x 680 in the exact Replica vMAP layout,
  2. train through the port's CLI (``vmap_tpu_torch.train``) with the
     shipped config (configs/Replica/room0_vmap.json with only the
     dataset path, camera, pool size and export cadence repointed),
  3. run the object protocol (GT-OBB/0.9 crop, bg = background-class
     submesh concat) and the composed-scene protocol (``eval.eval_3d``).

    python -m vmap_tpu_torch.room_pipeline [--work DIR] [--frames 1000]
        [--objects 40] [--px_block_bg N] [--device cuda|cpu]
        [--skip_generate] [--out results.json]

``tpu.px_block_bg`` is 1 unless ``--px_block_bg`` says otherwise: the
reference's acceptance run drew background pixels one at a time. The
summary states it, the device, and each stage's host seconds (generate,
train, export, evaluate). Renders and trains on CUDA by default and
raises without it; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_INVALID_DEPTH = 0.15


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--work",
                   default=os.path.join(tempfile.gettempdir(), "vmap_room"))
    p.add_argument("--frames", type=int, default=1000)
    p.add_argument("--objects", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--px_block", type=int, default=None,
                   help="override tpu.px_block (default: config value)")
    p.add_argument("--px_block_bg", type=int, default=None,
                   help="override tpu.px_block_bg (default 1: the "
                        "reference's per-pixel background draw)")
    p.add_argument("--compute_dtype", default=None,
                   help="override tpu.compute_dtype (e.g. int8)")
    p.add_argument("--sample_reuse", type=int, default=None,
                   help="override tpu.sample_reuse (iteration-reuse "
                        "sampling, core/step.py)")
    p.add_argument("--train_seed", type=int, default=None,
                   help="override tpu.seed (repeat-run variance studies)")
    p.add_argument("--grid_dim", type=int, default=128)
    p.add_argument("--n_models", type=int, default=None)
    p.add_argument("--config",
                   default=os.path.join(REPO, "configs", "Replica",
                                        "room0_vmap.json"),
                   help="shipped config to train with (e.g. the iMAP or "
                        "ScanNet family)")
    p.add_argument("--format", default="Replica",
                   choices=["Replica", "ScanNet"],
                   help="dataset layout to generate/train on")
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=680)
    p.add_argument("--focal", type=float, default=600.0)
    p.add_argument("--scene_only", action="store_true",
                   help="skip the object protocol (iMAP: single field)")
    p.add_argument("--tag", default=None, help="override the run tag")
    p.add_argument("--ply_furniture", action="store_true",
                   help="~1/3 of furniture from a generated .ply library")
    p.add_argument("--save_ckpt", action="store_true",
                   help="save per-object + full-state checkpoints at the "
                        "export cadence")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.KEY=VALUE",
                   help="generic config override applied after the named "
                        "flags, e.g. --set model.keyframe_buffer_size=40 "
                        "(repeatable; values parsed as JSON, falling back "
                        "to string)")
    p.add_argument("--skip_generate", action="store_true",
                   help="reuse an already-generated dataset in --work")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def run_tag(args) -> str:
    tag = f"px{args.px_block}" if args.px_block is not None else "default"
    if args.px_block_bg is not None:
        tag += f"_bg{args.px_block_bg}"
    if args.compute_dtype is not None:
        tag += f"_{args.compute_dtype}"
    if args.sample_reuse is not None:
        tag += f"_reuse{args.sample_reuse}"
    if args.train_seed is not None:
        tag += f"_seed{args.train_seed}"
    return args.tag if args.tag is not None else tag


def invalid_depth_share(data_dir: str) -> tuple[float, int]:
    """Mean share of zero-depth pixels over up to 5 evenly spaced depth
    frames, and the number probed. The room shell is watertight, so rays
    miss only through generator faults (a stale regeneration once held
    31-44% escapes)."""
    from vmap_tpu_torch.utils.png import read_png
    depth_dir = os.path.join(data_dir, "depth")
    if not os.path.isdir(depth_dir):
        return 0.0, 0
    files = sorted(os.listdir(depth_dir))
    probe = files[:: max(len(files) // 5, 1)][:5]
    fracs = [float((read_png(os.path.join(depth_dir, f)) == 0).mean())
             for f in probe]
    return (float(np.mean(fracs)) if fracs else 0.0), len(fracs)


def generate(args, data_dir: str, device) -> float:
    """Ray-trace the room of ``args`` (frames, objects, seed, camera,
    layout) into ``data_dir`` on ``device``; returns the host seconds."""
    print(f"[1/3] generating {args.frames}-frame room "
          f"({args.objects} objects, {args.width}x{args.height}) ...",
          flush=True)
    from vmap_tpu_torch.generate_dataset import main as gen_main
    t0 = time.time()
    gen_main([data_dir, "--format", args.format, "--scene", "room",
              "--objects", str(args.objects), "--seed", str(args.seed),
              "--frames", str(args.frames),
              "--width", str(args.width), "--height", str(args.height),
              "--fx", str(args.focal), "--fy", str(args.focal),
              "--device", str(device)]
             + (["--ply_furniture"] if args.ply_furniture else []))
    seconds = time.time() - t0
    print(f"  generated in {seconds:.1f}s", flush=True)
    return seconds


def room_config(args, data_dir: str, n_frames: int) -> dict:
    """The shipped config with the dataset path, camera, pool size, export
    cadence and the named overrides repointed at the generated sequence."""
    with open(args.config) as f:
        cfg = json.load(f)
    cfg["dataset"]["path"] = data_dir
    # camera must match the generated resolution (ScanNet reads fx/fy/cx/cy
    # from the dataset's intrinsic txt, but w/h/margins come from the config)
    cfg["camera"]["w"] = args.width
    cfg["camera"]["h"] = args.height
    if args.format == "Replica":
        cfg["camera"]["fx"] = cfg["camera"]["fy"] = args.focal
        cfg["camera"]["cx"] = (args.width - 1) / 2.0
        cfg["camera"]["cy"] = (args.height - 1) / 2.0
    # ~40 objects x 20-keyframe buffers with ~1.6x frame sharing -> ~500
    # distinct frames at steady state; 512 matches the shipped room0 config
    cfg["tpu"]["frame_pool_size"] = 512
    cfg["vis"]["n_vis_iter"] = max(n_frames - 1, 1)
    cfg["vis"]["grid_dim"] = args.grid_dim
    cfg["tpu"]["px_block_bg"] = (1 if args.px_block_bg is None
                                 else args.px_block_bg)
    if args.px_block is not None:
        cfg["tpu"]["px_block"] = args.px_block
    if args.n_models is not None:
        cfg["trainer"]["n_models"] = args.n_models
    if args.compute_dtype is not None:
        cfg["tpu"]["compute_dtype"] = args.compute_dtype
    if args.sample_reuse is not None:
        cfg["tpu"]["sample_reuse"] = args.sample_reuse
    if args.train_seed is not None:
        cfg["tpu"]["seed"] = args.train_seed
    for ov in args.overrides:
        path, eq, raw = ov.partition("=")
        sec, dot, key = path.partition(".")
        if not (eq and dot and sec and key):
            raise SystemExit(f"--set expects SECTION.KEY=VALUE, got {ov!r}")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        cfg.setdefault(sec, {})[key] = val
    return cfg


def main(argv=None) -> dict:
    """Run the stages; returns the summary (also written to ``--out``)."""
    args = parse_args(argv)
    from vmap_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    data_dir = os.path.join(args.work, "data")
    tag = run_tag(args)
    logdir = os.path.join(args.work, f"run_{tag}")
    os.makedirs(args.work, exist_ok=True)
    stage_s = {}

    t0 = time.time()
    if not args.skip_generate:
        stage_s["generate"] = generate(args, data_dir, device)

    share, probed = invalid_depth_share(data_dir)
    if share > MAX_INVALID_DEPTH:
        raise SystemExit(
            f"dataset sanity check FAILED: mean invalid-depth fraction "
            f"{share:.2f} over {probed} probed frames — the room dataset "
            f"in {data_dir} has ray escapes (stale or buggy generation). "
            f"Regenerate without --skip_generate.")

    n_frames = args.max_frames or args.frames
    cfg = room_config(args, data_dir, n_frames)
    cfg_path = os.path.join(args.work, f"room_config_{tag}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)

    if not args.skip_train:
        print(f"[2/3] training {n_frames} frames through "
              f"vmap_tpu_torch.train ({cfg_path}) ...", flush=True)
        from vmap_tpu_torch import train
        train_argv = ["--config", cfg_path, "--logdir", logdir,
                      "--device", str(device)]
        if args.max_frames:
            train_argv += ["--max_frames", str(args.max_frames)]
        if args.save_ckpt:
            train_argv += ["--save_ckpt"]
        timings: dict = {}
        t2 = time.time()
        train.run(train_argv, timings=timings)
        # train.run whole (Mapper, kernel library and dataset set-up
        # included) less its mesh exports
        stage_s["train"] = time.time() - t2 - timings["export_s"]
        stage_s["export"] = timings["export_s"]
        print(f"  trained in {stage_s['train']:.1f}s, exported in "
              f"{stage_s['export']:.1f}s", flush=True)

    print("[3/3] evaluating ...", flush=True)
    t3 = time.time()
    from vmap_tpu_torch.eval.eval_3d import main as eval_main
    from vmap_tpu_torch.geometry.mesh import Mesh, load_mesh
    last_frame = n_frames - 1
    mesh_dir = os.path.join(logdir, "scene_mesh")
    gt_dir = os.path.join(data_dir, "habitat")
    obj_m = None
    if not args.scene_only:
        obj_path = os.path.join(args.work, f"metrics_obj_{tag}.json")
        obj_m = eval_main(["object", "--mesh_dir", mesh_dir,
                           "--gt_dir", gt_dir, "--format", args.format,
                           "--frame", str(last_frame), "--out", obj_path])
    parts = [load_mesh(os.path.join(gt_dir, f))
             for f in sorted(os.listdir(gt_dir)) if f.endswith(".ply")]
    # rebuilt every run: a cache by existence went stale when the dataset
    # was regenerated with another --objects or --seed into one --work
    gt_scene_path = os.path.join(args.work, "gt_scene.obj")
    Mesh.concatenate(parts).export(gt_scene_path)
    scene_path = os.path.join(args.work, f"metrics_scene_{tag}.json")
    scene_m = eval_main(["scene", "--mesh_dir", mesh_dir,
                         "--gt_mesh", gt_scene_path,
                         "--frame", str(last_frame), "--out", scene_path])
    stage_s["evaluate"] = time.time() - t3

    summary = {"tag": tag, "frames": n_frames, "objects": args.objects,
               "grid_dim": args.grid_dim, "config": args.config,
               "device": str(device),
               "px_block_bg": cfg["tpu"]["px_block_bg"],
               "invalid_depth_share": share,
               "object_mean": obj_m["mean"] if obj_m else None,
               "per_object": obj_m["per_object"] if obj_m else None,
               "bg": obj_m["per_object"].get(0) if obj_m else None,
               "scene": scene_m, "stage_s": stage_s,
               "total_s": time.time() - t0}
    out = args.out or os.path.join(args.work, f"room_study_{tag}.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2, default=float)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "per_object"}, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
