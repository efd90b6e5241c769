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

With ``tpu.mesh_axes`` set, start one process a rank of the mesh, each
with ``VMAP_COORDINATOR`` (host:port of rank 0), ``VMAP_NUM_PROCESSES``
and ``VMAP_PROCESS_ID`` (``parallel/distributed.py``); every rank runs
this loop on ``cuda:(rank % cards)`` (or the CPU with ``--device cpu``),
and only rank 0 writes the log, meshes and checkpoints (the others log to
``os.devnull``). ``--trace DIR`` then writes ``DIR_p<rank>``.

``--profile`` prints, every frame, the ms of each stage run since the last
report (``data``, ``ingest``, ``train``, ``mesh``, ``ckpt``, as the JAX
CLI names them; the last frame's export once more after the loop); on the
card each stage ends with a ``torch.cuda.synchronize``, so its time is the
card's work and not only its launches. ``--trace DIR`` records the loop
with ``torch.profiler`` (CPU and CUDA activity, each frame a ``frame``
range) and writes a Chrome trace to ``DIR/trace.json``
(``utils/profiling.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

# a logged frame loss above this warns as a loss explosion
EXPLOSION_LOSS = 1e5


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
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings each frame")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the loop to "
                        "DIR/trace.json (Chrome trace format)")
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

    import contextlib

    import torch

    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.data.loader import PrefetchIterator, make_dataset
    from vmap_tpu_torch.core import checkpoint as ckpt_lib
    from vmap_tpu_torch.core import meshing
    from vmap_tpu_torch.core.mapper import FrameSample, Mapper
    from vmap_tpu_torch.parallel.distributed import (init_from_env,
                                                     rank_device)
    from vmap_tpu_torch.utils.profiling import StageTimer, device_trace

    # several ranks: one process each, all on this loop over the same
    # frame stream; no-op without VMAP_COORDINATOR
    rank, world = init_from_env()
    primary = rank == 0
    cfg = Config.from_json(args.config)
    mapper = Mapper(cfg, device=rank_device(args.device),
                    draw_source=draw_source)
    dataset = make_dataset(cfg)
    n_frames = len(dataset)
    if args.max_frames is not None:
        n_frames = min(n_frames, args.max_frames)
    start_frame = 0
    if args.resume:
        start_frame = ckpt_lib.load_full_checkpoint(mapper, args.resume) + 1
        if primary:
            print(f"resumed at frame {start_frame}")

    if primary:
        os.makedirs(args.logdir, exist_ok=True)
        shutil.copy(args.config, args.logdir)
    if args.trace and world > 1:   # a trace directory a rank
        args.trace = f"{args.trace}_p{rank}"
    timer = StageTimer(enabled=args.profile,
                       sync=(torch.cuda.synchronize
                             if mapper.device.type == "cuda" else None))
    trace = (device_trace(args.trace) if args.trace
             else contextlib.nullcontext())
    log_every = 25
    pending: list = []
    t_start = time.time()
    export_s = 0.0
    it = iter(PrefetchIterator(dataset))
    log_path = (os.path.join(args.logdir, "train_log.jsonl") if primary
                else os.devnull)
    with open(log_path, "a") as log_f, trace:
        for frame_idx in range(n_frames):
            # the range the trace's idle share is read over; no dispatcher
            # call when the loop is not traced
            with (torch.profiler.record_function("frame") if args.trace
                  else contextlib.nullcontext()):
                with timer("data"):
                    try:
                        sample = next(it)
                    except StopIteration:
                        break
                if sample is None or frame_idx < start_frame:
                    continue
                with timer("ingest"):
                    mapper.ingest_frame(FrameSample(
                        image=sample["image"], depth=sample["depth"],
                        inst=sample["obj"], bbox_dict=sample["bbox_dict"],
                        t_wc=sample["T"], frame_id=sample["frame_id"]))
                with timer("train"):
                    metrics = mapper.train_frame()
                # keep the device scalar; read it at the logging cadence
                pending.append((frame_idx, metrics))
                if (frame_idx % log_every == log_every - 1
                        or frame_idx == n_frames - 1):
                    loss = float("nan")
                    for fidx, met in pending:
                        # every rank reads: a sharded loss is a collective
                        loss = float(met.get("loss", float("nan")))
                        if loss > EXPLOSION_LOSS and primary:
                            print(f"WARNING: loss explosion at frame "
                                  f"{fidx}: {loss:.3e}")
                        log_f.write(json.dumps({
                            "frame": fidx, "loss": loss,
                            "n_objects": mapper.n_objects,
                            "pool_used": mapper.pool.n_used,
                            "step_time_s": met.get("step_time_s"),
                        }) + "\n")
                    pending.clear()
                    fps = ((frame_idx + 1 - start_frame)
                           / max(time.time() - t_start, 1e-9))
                    if primary:
                        print(f"frame {frame_idx}/{n_frames} "
                              f"loss={loss:.3f} objs={mapper.n_objects} "
                              f"pool={mapper.pool.n_used} fps={fps:.2f}")
                    log_f.flush()
                timer.report()
                is_vis = ((frame_idx % cfg.n_vis_iter == 0
                           or frame_idx == n_frames - 1) and frame_idx >= 10)
                if is_vis:
                    mesh_dir = os.path.join(args.logdir, "scene_mesh")
                    t_export = time.perf_counter()
                    with timer("mesh"):
                        paths = mapper.export_meshes(mesh_dir, frame_idx)
                    t_export = time.perf_counter() - t_export
                    export_s += t_export
                    stages = ", ".join(f"{k} {v:.3f}" for k, v in
                                       meshing.STAGE_S.items())
                    if primary:
                        print(f"frame {frame_idx}: exported {len(paths)} "
                              f"meshes -> {mesh_dir} in {t_export:.3f} s "
                              f"({stages})")
                    if args.save_ckpt:
                        with timer("ckpt"):
                            ckpt_dir = os.path.join(args.logdir, "ckpt")
                            for obj_id in sorted(mapper.registry):
                                ckpt_lib.save_object_checkpoint(
                                    mapper, obj_id,
                                    os.path.join(ckpt_dir, str(obj_id)),
                                    frame_idx)
                            ckpt_lib.save_full_checkpoint(
                                mapper, os.path.join(ckpt_dir, "state"),
                                frame_idx)
    timer.report()   # the last frame's mesh and ckpt stages
    if args.trace and primary:
        print(f"device trace written to {args.trace}")
    if timings is not None:
        timings["export_s"] = export_s
    if primary:
        print(f"done: {mapper.n_objects} objects, {mapper.frames_ingested} "
              f"frames, {time.time() - t_start:.1f}s")
    return mapper, dataset


if __name__ == "__main__":
    main()
    from vmap_tpu_torch.parallel.distributed import shutdown
    shutdown()
