"""Training CLI of the port (counterpart of the repo's ``train.py``).

    python -m vmap_tpu_torch.train --config configs/Replica/room0_vmap.json \
        --logdir logs/room0 [--max_frames N] [--device cpu]

Per frame: ingest -> one training step over every object and the
background; ``<logdir>/train_log.jsonl`` gets one line per frame, flushed
every 25 frames. Every ``n_vis_iter`` frames and on the last frame (from
frame 10 on): every object's mesh to ``<logdir>/scene_mesh`` and, with
``--save_ckpt``, per-object and full-state checkpoints to
``<logdir>/ckpt``. ``--resume`` takes a full-state checkpoint (a
``state_frame_<N>.pt`` file or its directory) and continues after frame N.
Each export prints its host seconds per stage (``meshing.STAGE_S``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="vmap_tpu_torch multi-object mapping")
    p.add_argument("--config", default="configs/synthetic_vmap.json")
    p.add_argument("--logdir", default="./logs/debug")
    p.add_argument("--save_ckpt", action="store_true")
    p.add_argument("--resume", default=None,
                   help="full-state checkpoint (.pt file or its directory)")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: train through the CUDA "
                        "kernels; raises without CUDA) or cpu")
    return p.parse_args(argv)


def main(argv=None, draw_source=None):
    """Run the loop; returns the Mapper. ``draw_source`` is handed to the
    Mapper (tests inject sampler draws through it)."""
    return run(argv, draw_source)[0]


def run(argv=None, draw_source=None, timings: dict | None = None):
    """``main``, returning (Mapper, the dataset it was fed). ``timings``,
    where given, gets the host seconds of the mesh exports
    (``export_s``)."""
    args = parse_args(argv)

    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.data.loader import PrefetchIterator, make_dataset
    from vmap_tpu_torch.core import checkpoint as ckpt_lib
    from vmap_tpu_torch.core import meshing
    from vmap_tpu_torch.core.mapper import FrameSample, Mapper

    cfg = Config.from_json(args.config)
    mapper = Mapper(cfg, device=args.device, draw_source=draw_source)
    dataset = make_dataset(cfg)
    n_frames = len(dataset)
    if args.max_frames is not None:
        n_frames = min(n_frames, args.max_frames)
    start_frame = 0
    if args.resume:
        start_frame = ckpt_lib.load_full_checkpoint(mapper, args.resume) + 1
        print(f"resumed at frame {start_frame}")

    os.makedirs(args.logdir, exist_ok=True)
    shutil.copy(args.config, args.logdir)
    log_every = 25
    pending: list = []
    t_start = time.time()
    export_s = 0.0
    it = iter(PrefetchIterator(dataset))
    with open(os.path.join(args.logdir, "train_log.jsonl"), "a") as log_f:
        for frame_idx in range(n_frames):
            try:
                sample = next(it)
            except StopIteration:
                break
            if sample is None or frame_idx < start_frame:
                continue
            mapper.ingest_frame(FrameSample(
                image=sample["image"], depth=sample["depth"],
                inst=sample["obj"], bbox_dict=sample["bbox_dict"],
                t_wc=sample["T"], frame_id=sample["frame_id"]))
            metrics = mapper.train_frame()
            # keep the device scalar; read it at the logging cadence
            pending.append((frame_idx, metrics))
            if (frame_idx % log_every == log_every - 1
                    or frame_idx == n_frames - 1):
                loss = float("nan")
                for fidx, met in pending:
                    loss = float(met.get("loss", float("nan")))
                    if loss > 1e5:
                        print(f"WARNING: loss explosion at frame {fidx}: "
                              f"{loss:.3e}")
                    log_f.write(json.dumps({
                        "frame": fidx, "loss": loss,
                        "n_objects": mapper.n_objects,
                        "pool_used": mapper.pool.n_used,
                        "step_time_s": met.get("step_time_s"),
                    }) + "\n")
                pending.clear()
                fps = ((frame_idx + 1 - start_frame)
                       / max(time.time() - t_start, 1e-9))
                print(f"frame {frame_idx}/{n_frames} loss={loss:.3f} "
                      f"objs={mapper.n_objects} pool={mapper.pool.n_used} "
                      f"fps={fps:.2f}")
                log_f.flush()
            is_vis = ((frame_idx % cfg.n_vis_iter == 0
                       or frame_idx == n_frames - 1) and frame_idx >= 10)
            if is_vis:
                mesh_dir = os.path.join(args.logdir, "scene_mesh")
                t_export = time.perf_counter()
                paths = mapper.export_meshes(mesh_dir, frame_idx)
                t_export = time.perf_counter() - t_export
                export_s += t_export
                stages = ", ".join(f"{k} {v:.3f}" for k, v in
                                   meshing.STAGE_S.items())
                print(f"frame {frame_idx}: exported {len(paths)} meshes "
                      f"-> {mesh_dir} in {t_export:.3f} s ({stages})")
                if args.save_ckpt:
                    ckpt_dir = os.path.join(args.logdir, "ckpt")
                    for obj_id in sorted(mapper.registry):
                        ckpt_lib.save_object_checkpoint(
                            mapper, obj_id,
                            os.path.join(ckpt_dir, str(obj_id)), frame_idx)
                    ckpt_lib.save_full_checkpoint(
                        mapper, os.path.join(ckpt_dir, "state"), frame_idx)
    if timings is not None:
        timings["export_s"] = export_s
    print(f"done: {mapper.n_objects} objects, {mapper.frames_ingested} "
          f"frames, {time.time() - t_start:.1f}s")
    return mapper, dataset


if __name__ == "__main__":
    main()
