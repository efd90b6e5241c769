#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port trains on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: nvcc compiles vmap_tpu_torch/kernels/csrc/*.cu for sm_90a;
  3. train-frame kernels against plain on the card, at the object shape
     (104 slots, 100 active, h=32, 120 rays x 10 samples), the
     background shape (1 slot, h=128, 1200 rays x 14 samples) and the
     iMAP shape (1 slot, h=256, 4800 rays x 14 samples; each float
     instance's tile points, rows per slot, scratch of partial gradient
     rows and dynamic shared memory are printed): each kernel alone (one
     iteration's gradient; one AdamW step on every partial row filled with
     seeded random values, held to apply_adamw on the plain fixed-order
     sum ``row_sum``, two launches bit-equal, the losses equal to
     ``loss_sum``, its update plan, bounds and read rate printed beside
     torch.sum over the same rows; the update kernels timed launched
     back to back behind a device-side sleep, ``time_device``), then
     whole frames at n_iter=1
     (losses / parameters / moments within rtol 2e-3) and at n_iter=20
     (finite; final summed loss within rtol 0.25); inactive slots
     bit-identical;
  4. end to end: ``vmap_tpu_torch.train.main`` for 12 frames of
     configs/Replica/room0_vmap.json with dataset.format Synthetic
     (1200x680 analytic frames) and --save_ckpt: finite losses, 2 x n_iter
     x 2 train-kernel launches per frame, the last frame's meshes of the
     background, sphere and box (field kernel launched, sphere vertices
     within 0.15 m median of the analytic sphere), the export's host
     seconds per stage, then --resume from the checkpoint for 2 more
     frames with finite losses (its last frame meshed at RESUME_VIS);
  5. full-width frames: the bench-shaped vMAP workload (104 slots, 100
     active, a random 16-slot 1200x680 pool, px_block_bg 4) and the iMAP
     frame of configs/Replica/room0_imap.json (one h=256 field, 4800 rays
     x 14 samples, the same pool), 3 frames each through the kernel path
     and the plain path, timed with CUDA events; the iMAP frame's device
     time split by torch.profiler into train_grad, train_adamw and the
     rest;
  6. field kernels against plain: K2 (alpha atol 3e-4, colour atol 2e-5)
     at 8 objects x 65,573 points (h=32), 1 object x 131,072 points
     (h=128) and 1 x 131,072 (h=256), and K3 at the same three (every
     weight gradient within rtol 2e-3, atol 2e-3 x max(1, |g|max) of the
     f32 plain version; where the f32 plain version misses that bar
     against the f64 one, K3 within twice its error of the f64 one; twice,
     bit for bit the same, and again at 4 x TILE_M), timed with CUDA
     events, each width's tiles, grids and shared memory printed (the
     library's plan, vmap_field_plan), the staged bf16 pieces
     (field_stage) equal to their plain version and the staging timed
     alone and with K2 (the time a change of weights costs K2);
  7. meshing at full width: a 100-object h=32 bank over 128^3 grid points
     per object, one h=128 background over 256^3 and one h=256 iMAP scene
     field over 256^3 (mesh_all_objects' chunks of 65,536), per-chunk and
     whole-grid times of the kernel and the plain query, and the
     occupancy's max abs difference between them; grid_volumes (chunks in
     flight) equal to its chunks, and its time and peak device memory with
     every object at 256^3;
  8. the field-kernel training path: object-, background- and iMAP-shape
     frames through the plain frame with StepStatics.use_pallas_train,
     held to the tiers of phase 3 (K3 launched at h = 32, 128 and 256);
     field_bwd (and its two kernels alone) and one iteration's gradient
     timed at each shape's own backward tile against their plain
     versions;
  9. the iMAP trainer: ``vmap_tpu_torch.train`` on room0_imap.json with
     dataset.format Synthetic and vis.html_viewer false for 11 frames with
     --save_ckpt: finite losses, n_iter launches of each train-frame
     kernel per frame (one bank; each train_grad launch is the 132 blocks
     of frame_geometry), field_fwd launched, frame_10_obj0.obj written,
     the learned occupancy on the analytic sphere's surface above that at
     empty points, the export's host seconds per stage, then --resume
     from the checkpoint (one h=256 bank, no background) for 1 frame with
     a finite loss, meshed at RESUME_VIS. If the run nears the time limit,
     this phase is shortened first;
 10. the matmul policies and sample_reuse: train_grad under bwd_bf16 and
     bfloat16 against its plain version at the shapes of phase 3 (n_iter=1:
     each gradient tensor, read from the first moment, within 1e-2 of its
     scale, and its error at least 10x smaller in norm than the policy's
     effect, plain policy against plain f32; losses within rtol 2e-3;
     n_iter=20: finite, final loss within rtol 0.25), each timed against
     its plain version; the kernel frame under sample_reuse 4 (untiled
     pixels) bit-identical to the kernel frame on the tiled batch; the
     full-width vMAP frame of phase 5 under float32, float32 + reuse 4,
     bwd_bf16 + reuse 4 and bfloat16 + reuse 4, timed with CUDA events;
     then ``vmap_tpu_torch.train`` on room0_vmap.json (analytic scene)
     with tpu.sample_reuse 4 and tpu.compute_dtype bwd_bf16 for 6 frames:
     finite, falling losses, 2 x n_iter bwd_bf16 train_grad launches per
     frame;
 11. the int8 matmul policies (int8, int8_fwd, int8_static,
     int8_static_fwd; csrc/train_step_q8.cu, s8 tensor cores): train_grad
     under each against the plain ops.quant frame at the shapes of phase
     3, in the tiers of phase 10 with each tensor's largest error within
     5e-2 of its scale (each int8 tile's points, rows per slot, scratch and
     dynamic shared memory printed, the latter held to the library's),
     and train_quant_w's s8 weights and transposes equal to the plain
     ones (also the copy made before the first iteration), both update
     kernels timed against their plain versions, bounds and rates; the
     full-width vMAP frame under float32 with and without
     sample_reuse 4, each int8 policy with reuse 4, and int8 / int8_static
     without it; the iMAP frame under float32 and int8_static; then
     ``vmap_tpu_torch.train`` on room0_vmap.json under int8 for 6 frames:
     finite, falling losses, 2 x n_iter int8 train_grad launches and as
     many train_quant_w launches per frame;
 12. the probes (``vmap_tpu_torch.probes``, their own library built from
     probes/csrc/*.cu, ptxas registers printed): K4 ``mm`` (f32 FMA, bf16
     and 3xbf16 mma.sync, f32 ind4), K10 ``int8`` (f32, i8, i8_quant), K7
     ``sections`` (render, emb_cat, emb_split, ladder and the port's
     sinpif ladder), K8 ``overlap`` (vpu, mxu, both, and the balanced
     vpu_bal / both_bal), K9 ``vpu`` (mul / mixed in f32, per-op bf16 and
     bf16_fma, sigmoid f32, at [8, 1280] and [96, 1280]), K5 ``ops`` (the
     script's nine cases) and K6 ``dma`` (bulk, cp_async, bulk_hbm,
     bulk_hbm_132), every variant and shape held against its plain
     version at 3 steps (rtol 1e-5 a step for f32 chains, 1e-6 a step for
     K9's f32, 2e-3 bf16 products, bit-equal i8 and K9's per-op bf16, one
     bf16 ulp a step for bf16_fma, 1e-6 i8_quant, 1e-5 render and ladder;
     K6 at 4000 copies, checksum and 8 final slots bit-equal), each emb /
     ladder section and K5's strided_sum / serial_tiles work read from one
     kernel step (within that step's f32 roundings plus rtol 1e-5), K5's
     side outputs (lanesum_dot's whole product, the tile sums and running
     products) held elementwise; then each probe's entry point run at the
     scripts' shapes and reps (and K1's per-block products for mm and
     int8; K8's modes and K5's dep_fma / ind_fma pair 5 times), with the
     plain version's and the library call's (torch.matmul, torch._int_mm,
     torch.sigmoid, torch.addcmul, torch.index_select) device time a
     step, each chain replayed as a CUDA graph, beside each kernel's; the
     sampler's pool gather on phase 5's vMAP frame beside K6, with the
     least time any fetch of its 8-byte elements could take; and the
     probes' launches counted on their own path ``probes``;
 13. the room protocol end to end (``vmap_tpu_torch.room_pipeline``):
     the procedural room of 40 objects (5,812 triangles) at 1200 x 680,
     frame 0 ray-traced on the card and one tile of 32,768 of its rays
     held against the same function on the CPU (inst / cls equal but on
     at most 1e-3 of the rays, depth within rtol 1e-5 and rgb within 1
     where the winners agree; the render's ms a frame), then the pipeline
     for 24 frames: the Replica files written without cv2 (invalid-depth
     share under 0.15, frame 0 read back through the port's loader equal
     to the render), room0_vmap.json as the pipeline rewrites it
     (px_block_bg 1) trained on the card with finite losses and 2 x 20 x
     24 launches of train_grad / train_adamw, the export at the last frame
     at grid_dim 128 (field_stage and field_fwd launched), then the object
     and scene protocols: a finite row for every meshed object with a GT
     submesh, the objects' mean, the background and the scene printed,
     and each stage's host seconds (no quality bar: 24 frames are not the
     protocol's 1,000).
 14. the runtime modes at full width: (a) the forloop ablation
     (``step.forloop_frame``: a capacity-1 K1 frame per active slot, then
     the background) against the vectorised frame on phase 5's workload,
     the same draws cut per slot: n_iter=1 slots within phase 3's tier,
     n_iter=20 finite, n_iter x 101 launches of train_grad a frame, both
     strategies' frame times (CUDA events, 3 frames) and their ratio;
     (b) ``run_live`` on phase 4's configuration, frames pushed by a
     producer thread that then stops: every tick trains (2 x n_iter
     launches a tick), one idle export through K2, finite losses; (c)
     ``OccupancyField`` at h=32 and h=128: its 128^3 query through K2
     against the plain query (phase 6's tiers) and ``extract_mesh``; (d)
     the trainer's ``--profile`` and ``--trace`` on 3 frames of phase 4's
     configuration: the stage times, and from the trace the device time by
     kernel and the device's idle share of the frames' window;
 15. the ScanNet layout without OpenCV: the room generated at scene0000's
     640 x 480 camera for 12 frames (frame 5's pose invalid) in the
     ScanNet layout (JPEG colour through the port's encoder), trained by
     ``vmap_tpu_torch.train`` on configs/ScanNet/scene0000_vmap.json
     pointed at it: finite losses, the invalid frame skipped, 2 x n_iter
     launches a trained frame, one export through K2; the loader's host
     ms a frame and its JPEG decode (also at ScanNet's 1296 x 968);
 16. the sharded path (``tpu.mesh_axes``, ``vmap_tpu_torch/parallel/``),
     ranks launched as processes of one gloo world on this one card
     (time-slicing it): (a) phase 5's workload on phase 14 (a)'s
     half-unknown pool at {"obj": 2, "data": 2}, 4 ranks, each running
     its object rows and the background through K1 (``--rank-frames``):
     at n_iter=1 every slot and the background, gathered, within phase
     3's tier of the one-process kernel frame on the same draws, the loss
     summed over the obj group within rtol 2e-3; at n_iter=20 finite, the
     final loss within rtol 0.25; (b) ``vmap_tpu_torch.train`` as 2 ranks
     {"obj": 2} on phase 4's configuration for 12 frames with
     --save_ckpt, then --resume for 2: all 14 per-frame losses within
     rtol 2e-3 of an uninterrupted one-process run of 14 frames, meshes,
     log and checkpoints written by rank 0 only; each rank's launch
     counts and frame time printed;
 17. int8 calibration: ``vmap_tpu_torch.calibrate_int8_scales`` on phase
     13's room (24 frames) through room0_imap.json, probes at 3 frames;
     then phase 11's iMAP frame (n_iter=1) under int8_static at the
     defaults and at the suggested scales, each gradient's error against
     float32 in norm and their ratio, and train_grad under int8_static at
     the suggested scales against its plain version in phase 11's tiers;
 18. the widths K1, K2 and K3 gained (h=16, h=64) and the port's script
     entry points: (a) K1 at h=16 and h=64 at each of phase 3's shapes
     under the seven policies in the tiers of phases 3, 10 and 11,
     train_adamw and train_quant_w against their plain versions, each
     timed beside its bound, sample_reuse 4 bit-identical to the tiled
     batch at the object shape; (b) K2 and K3 at both widths at phase 6's
     object (8 x 65,573 points) and background (1 x 131,072) shapes in
     its tiers, timed, their plans printed;
     (c) ``vmap_tpu_torch.train`` on configs/Replica/fixture_room_vmap.json
     and its committed data (objects h=16, background h=32) for 8 frames:
     finite losses, 2 objects, n_iter train_grad launches a frame at each
     width, an export through K2 at both; (d) phase 4's configuration
     with ``tpu.fused_train_step`` false at n_iter=1: no train_grad
     launch, the slots unrounded (100, where "auto" rounds to 104), the
     frame within phase 3's tier of the kernel frame on the same banks and
     draws; (e) ``vmap_tpu_torch.remesh`` on phase 4's checkpoint at its
     grid cap: the meshes byte-equal to phase 4's export of that frame;
     (f) ``vmap_tpu_torch.quality_study`` at its default sizes, its five
     variants side by side on the card: finite metrics, bg_rays320_h64
     launching K1 and K2 at h=64, the table printed beside
     docs/quality_study.json's JAX rows (no bar).

Every kernel's entry in the JSON line carries its bound (the larger of
its bytes over 3.35 TB/s and its operations over the peak of their type:
67 TFLOP/s FP32, 989 TFLOP/s bf16, 1979 TOP/s int8; elementwise FP32 and
packed bf16 at 128 and 256 results per SM a clock, the SFU at 16; K6's
distinct source bytes over 3.35 TB/s, or a copy's 4 KB into one SM's
shared memory at 128 B a clock), computed from this run's shapes; K1 on the
route its kernel takes (``grad_bound``'s ``PASSES``): bf16 tensor-core
passes under the float policies (float32 three, bwd_bf16's forward six),
s8 ones under the int8 policies (the _fwd halves' backward float32's
three bf16 passes); K2 and K3 on theirs (``FIELD_PASSES``: K2 three bf16
passes, K3 six for its recomputed forward and 2 x 3 for its gradients),
each beside its bound at the FP32 rate (``bound_fp32_ms``).
Prints that JSON line of per-kernel results, the nvidia-smi line, and as
the last line {"ok": true, "device": {...}}; before them it checks that
neither jax, nor any module of the JAX package ``vmap_tpu``, nor OpenCV
(``cv2``) was imported.
Without CUDA it exits non-zero and prints no result. Scratch output goes
to smoke_out/ (gitignored).

    python3 chip_smoke.py --sections

times train_grad's sections at phase 3's shapes under every policy in
place of the phases (``k1_sections``).

    git archive <parent> | tar -x -C dev/parent
    python3 chip_smoke.py --update-ab dev/parent . . dev/parent

times the update kernels (train_adamw, train_quant_w) and the int8 vMAP
frame of each checkout in turn on the same timers, each in a process of
its own, in place of the phases (``update_ab``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "smoke_out")
LR, WD, CS, OSC = 1e-3, 0.013, 5.0, 10.0
RTOL_SEM, RTOL_FULL = 2e-3, 0.25
# the --resume runs of phases 4 and 9 mesh their last frame at a coarse
# grid, without the HTML viewer: the export at full size is the first
# run's, and the resume checks that the restored state trains and meshes
RESUME_VIS = {"grid_dim": 64, "html_viewer": False}
# K1's matmul policies (tpu.compute_dtype; ops.mlp.POLICIES): float32, the
# bf16 ones (phase 10) and the int8 ones (phase 11)
POLICIES = ("float32", "bwd_bf16", "bfloat16", "int8", "int8_fwd",
            "int8_static", "int8_static_fwd")
BF16_POLICIES, INT8_POLICIES = POLICIES[1:3], POLICIES[3:]
# (name, cap, n_active, hidden, rays per iteration, samples, scale)
SHAPES = (("obj", 104, 100, 32, 120, 10, 2.0),
          ("bg", 1, 1, 128, 1200, 14, 5.0),
          ("imap", 1, 1, 256, 4800, 14, 5.0))
# field kernels: (name, objects, hidden, points per object, scale); the
# object shape's M leaves a ragged tail
FIELD_SHAPES = (("obj", 8, 32, 65536 + 37, 2.0),
                ("bg", 1, 128, 131072, 5.0),
                ("imap", 1, 256, 131072, 5.0))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_device(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches queued behind
    a device-side sleep (probes/_timing.py HOLD_CYCLES), so that they run
    back to back: the device's time even where a launch is shorter than
    the host's Python wrapper (the update kernels); best of 3."""
    import torch
    from vmap_tpu_torch.probes._timing import HOLD_CYCLES
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


PE_MACS = 63    # the PE's dirs projection (21 x 3) per point, always f32


def mlp_macs(hidden: int) -> int:
    """Multiply-adds of one point's forward products: the PE's dirs
    projection (PE_MACS) and the seven MLP layers (emb 87 / 42)."""
    h = hidden
    return (PE_MACS + 87 * h + h * h + (h + 87) * h + h * h + h
            + (h + 42) * h + 3 * h)


def bound(nbytes: float, fwd_flops: float = 0.0, bwd_flops: float = 0.0,
          f32_flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the products (``fwd_flops``, ``bwd_flops``,
    ``f32_flops``) over the FP32 peak (the tensor-core routes:
    ``grad_bound``, ``field_bound``)."""
    from vmap_tpu_torch.probes import PEAK_BYTES, PEAK_F32
    t_ops = (fwd_flops + bwd_flops + f32_flops) / PEAK_F32
    t_mem = nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "library_ms": None}


# the tensor-core passes of each policy's forward and backward products in
# train_grad, (bf16 forward, bf16 backward, s8 forward, s8 backward): the
# float policies' bf16 passes (csrc/train_step.cu fwd_pieces / bwd_pieces:
# two pieces a pass pair but the small one, three pieces six passes); the
# int8 policies' products one s8 pass each (csrc/train_step_q8.cu), the
# _fwd halves' f32 backward float32's three bf16 passes
PASSES = {"float32": (3, 3, 0, 0), "bwd_bf16": (6, 1, 0, 0),
          "bfloat16": (1, 1, 0, 0),
          **{p: (0, 3, 1, 0) if p.endswith("_fwd") else (0, 0, 1, 1)
             for p in INT8_POLICIES}}


def grad_bound(bank, n_per: int, S: int, policy: str = "float32",
               fp32_rate: bool = False) -> dict:
    """train_grad's bound for one iteration (launch): the work of the
    function, one gradient of the active slots, whatever the kernel's own
    scratch. Products: the active slots' points through the forward and
    the backward's two (weight and input gradients). Bytes: the active
    slots' parameters, their rays (origin and direction 6, depth, colour
    and masks 7, S z samples) and their loss normalisers and scale in,
    one gradient row and a loss per active slot out. The products are
    bounded on the route the kernel takes, its ``PASSES`` of tensor-core
    products: bf16 at 989 TFLOP/s (float32's f32-accurate products as
    three passes), s8 at 1979 TOP/s (the int8 policies' products; the _fwd
    halves' f32 backward as float32's three bf16 passes); the PE's
    projection and its gradient (63 of about 11,000 multiply-adds a point
    at h=32), which it runs on the FMA pipe, at the FP32 rate.
    ``fp32_rate``: the products at the FP32 rate instead (the phase-3
    log's second figure)."""
    from vmap_tpu_torch.probes import (PEAK_BF16, PEAK_BYTES, PEAK_F32,
                                       PEAK_INT8)
    n_act = int(bank.active.sum())
    n_params = bank.spec.n_params
    pts = n_act * n_per * S
    fwd = 2.0 * (mlp_macs(bank.spec.hidden) - PE_MACS) * pts
    pe = 2.0 * PE_MACS * pts
    nbytes = 4 * n_act * (2 * n_params + n_per * (6 + 7 + S) + 5)
    if fp32_rate:
        return bound(nbytes, fwd, 2 * fwd, f32_flops=3 * pe)
    pf, pb, qf, qb = PASSES[policy]
    t_ops = ((pf + 2 * pb) * fwd / PEAK_BF16
             + (qf + 2 * qb) * fwd / PEAK_INT8 + 3 * pe / PEAK_F32)
    t_mem = nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "library_ms": None}


# the bf16 tensor-core passes of the field kernels' products
# (csrc/ensemble.cu): K2's forward three (two pieces); K3's recomputed
# forward six (three pieces), its input and weight gradients three each
FIELD_PASSES = {"field_fwd": 3, "field_bwd": 6 + 2 * 3}


def field_bound(O: int, M: int, hidden: int, n_w: int, bwd: bool,
                fp32_rate: bool = False) -> dict:
    """K2's (``bwd`` False) or K3's bound on O objects x M points of
    hidden ``hidden``: bytes, the points in (and K3's cotangents), the
    prepared parameters in (n_w floats; K3 also their gradients out), K2's
    alpha and colour out; products on the route the kernels take, their
    FIELD_PASSES of bf16 passes at 989 TFLOP/s, the PE's projection (and
    K3's dirs gradient) at the FP32 rate. ``fp32_rate``: every product at
    the FP32 rate (the log's second figure; PR 5's bound)."""
    from vmap_tpu_torch.probes import PEAK_BF16, PEAK_BYTES, PEAK_F32
    pts = O * M
    fwd = 2.0 * (mlp_macs(hidden) - PE_MACS) * pts
    pe = 2.0 * PE_MACS * pts
    nbytes = 4 * (pts * 7 + (2 if bwd else 1) * n_w)
    if fp32_rate:
        flops = fwd + pe
        return bound(nbytes, flops, 2 * flops if bwd else 0.0)
    passes = FIELD_PASSES["field_bwd" if bwd else "field_fwd"]
    t_ops = passes * fwd / PEAK_BF16 + (2 if bwd else 1) * pe / PEAK_F32
    t_mem = nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "library_ms": None}


def adamw_bound(bank, n_rows: int, pieces: bool = True) -> dict:
    """train_adamw's bounds. ``bound_ms``: the function's, the active
    slots' parameters and moments read and written and one gradient row
    each read (the kernel's partial rows are K1's scratch, not the
    function's work). ``rows_bound_ms``: what the kernel must move while
    K1 writes partial rows, its ``rows_bytes``: the active slots' n_rows
    partial rows read, parameters and moments read and written, the staged
    bf16 pieces written (``pieces``: not under int8 / int8_static) and the
    row index read once."""
    from vmap_tpu_torch.kernels import train_step as K
    from vmap_tpu_torch.probes import PEAK_BYTES
    n_act, h = int(bank.active.sum()), bank.spec.hidden
    row = K.grad_row_size(h)
    nbytes = (4 * n_act * (n_rows * row + 6 * bank.spec.n_params) + 4 * row
              + (2 * K.STAGED_PIECES * n_act * K.staged_layout(h)[1]
                 if pieces else 0))
    return {**bound(4 * n_act * bank.spec.n_params * 7),
            "rows_bytes": nbytes, "rows_bound_ms": nbytes / PEAK_BYTES * 1e3}


def adamw_rate(st: dict) -> str:
    """train_adamw's read rate over its rows_bytes, TB/s, and its times."""
    st["tb_s"] = st["rows_bytes"] / (st["ms"] * 1e-3) / 1e12
    return (f"train_adamw ms kernel/plain/bound/rows bound "
            f"{st['ms']:.4f}/{st['plain_ms']:.4f}/{st['bound_ms']:.5f}/"
            f"{st['rows_bound_ms']:.5f}, {st['tb_s']:.3f} TB/s over "
            f"{st['rows_bytes']} bytes")


# ---------------------------------------------------------------- phase 3
def conditioned_bank(cap, n_active, hidden, scale, seed, dev):
    """Bank with active slots, weights x0.3 (unsaturated occupancy), small
    random moments and step 3, as tests/test_train_kernel.py conditions
    its state."""
    import torch
    from vmap_tpu_torch.core import bank as B
    gen = torch.Generator().manual_seed(seed)
    bank = B.init_bank(gen, cap, hidden, default_scale=scale)
    for s in range(n_active):
        B.activate_slot(bank, s, gen, scale + 0.01 * s)
    bank = bank.replace(
        flat=bank.flat * 0.3,
        m=torch.randn(bank.m.shape, generator=gen) * 1e-4,
        v=torch.rand(bank.v.shape, generator=gen) * 1e-6,
        step=torch.where(bank.active, 3, 0).to(torch.int32))
    return bank.replace(**{f: getattr(bank, f).to(dev) for f in
                           ("flat", "m", "v", "step", "active", "scale")})


def random_batch(cap, n_rays, S, seed, dev):
    """Ray-major batch like tests/test_train_kernel.py::make_batch."""
    import torch
    g = torch.Generator().manual_seed(seed)
    depth = torch.rand(cap, n_rays, generator=g) * 2.5 + 0.5
    depth[torch.rand(cap, n_rays, generator=g) < 0.15] = 0.0
    z = torch.sort(torch.rand(cap, n_rays, S, generator=g) * 3.4 + 0.1,
                   dim=-1).values
    batch = {"rgb": torch.rand(cap, n_rays, 3, generator=g), "depth": depth,
             "state": torch.randint(0, 3, (cap, n_rays), generator=g),
             "valid": depth > 0, "z": z,
             "origins": torch.randn(cap, n_rays, 3, generator=g) * 0.1,
             "dirs": torch.randn(cap, n_rays, 3, generator=g) * 0.3}
    return {k: v.to(dev) for k, v in batch.items()}


def rel_close(a, b, rtol, atol, what):
    import torch
    a, b = a.double(), b.double()
    bad = (a - b).abs() > atol + rtol * b.abs()
    err = float((a - b).abs().max())
    if bool(bad.any()) or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"rtol {rtol} atol {atol}; max abs err {err}")
    return err


def check_kernels(dev, stats: dict, shapes=SHAPES, phase: str = "3",
                  grad_atol: float = 1e-4) -> None:
    """K1 against its plain version at ``shapes``: one iteration's
    gradient alone (rtol 2e-3 plus ``grad_atol`` of the gradient's scale;
    where that is above 1e-4, the elements beyond 1e-4 of scale are
    logged), the update kernel alone, then whole frames (``frame_tiers``)."""
    import torch
    from vmap_tpu_torch.core.bank import apply_adamw
    from vmap_tpu_torch.kernels import train_step as K

    for name, cap, n_act, h, n_per, S, scale in shapes:
        bank = conditioned_bank(cap, n_act, h, scale, 0, dev)
        inact = ~bank.active

        # kernel A alone: one iteration's gradient and per-slot loss
        batch = random_batch(cap, n_per, S, 1, dev)
        per_ref, g_ref = K.iteration_loss_grad(bank, batch, CS, OSC)
        fl = K.FrameLaunch(bank, batch, 1, n_per, CS, OSC)
        fl.grad(bank.flat, 0)
        act = bank.active              # inactive slots' partials are unset
        g_k = fl.grad_part[act][..., fl.row_index].sum(dim=1)
        gscale = float(g_ref.abs().max())
        err_g = rel_close(g_k, g_ref[act], RTOL_SEM, grad_atol * gscale,
                          f"{name} train_grad gradient")
        if grad_atol > 1e-4:
            beyond = ((g_k - g_ref[act]).abs()
                      > 1e-4 * gscale + RTOL_SEM * g_ref[act].abs())
            cols = set(torch.nonzero(beyond)[:, 1].tolist())
            where = sorted({nm for _, nm, _, off, size in bank.spec.names
                            if any(off <= c < off + size for c in cols)})
            log(f"[{phase}] {name}: {int(beyond.sum())} gradient elements "
                f"beyond 1e-4 of scale, in {where}")
        rel_close(fl.loss_part[act].sum(dim=1), per_ref[act], RTOL_SEM, 1e-6,
                  f"{name} train_grad per-slot loss")
        # kernel B alone: every partial row seeded, held to apply_adamw on
        # the rows' plain fixed-order sum (K.row_sum, the kernel's order)
        gen = torch.Generator(device=dev).manual_seed(2)
        rows = fl.grad_part.shape[1]
        fl.grad_part.copy_(torch.randn(fl.grad_part.shape, generator=gen,
                                       device=dev) * (gscale / rows))
        fl.loss_part.copy_(torch.rand(fl.loss_part.shape, generator=gen,
                                      device=dev))
        g_sum = K.row_sum(fl.grad_part)[:, fl.row_index]
        ref = apply_adamw(bank, g_sum, LR, WD)
        runs = []
        for _ in range(2):   # two launches from the same state: bit-equal
            p, m, v = bank.flat.clone(), bank.m.clone(), bank.v.clone()
            losses = torch.empty(cap, 1, device=dev)
            fl.adamw(p, m, v, losses, 0, LR, WD)
            runs.append((p, m, v, losses, fl.ws.clone()))
        assert all(torch.equal(a, b) for a, b in zip(*runs)), \
            f"{name}: two train_adamw launches differ"
        # same f32 update up to FMA contraction: an ulp of each tensor's
        # scale
        err_b = max(rel_close(got, want, 1e-5,
                              1e-6 * float(want.abs().max()),
                              f"{name} adamw {what}")
                    for got, want, what in ((p, ref.flat, "p"),
                                            (m, ref.m, "m"),
                                            (v, ref.v, "v")))
        for got, was, what in ((p, bank.flat, "p"), (m, bank.m, "m"),
                               (v, bank.v, "v")):
            assert torch.equal(got[inact], was[inact]), \
                f"inactive {what} moved"
        want_l = torch.where(bank.active, K.loss_sum(fl.loss_part), 0.0)
        assert torch.equal(losses[:, 0], want_l), \
            f"{name}: train_adamw's losses are not loss_sum's"
        assert torch.equal(fl.ws, K.stage_weights(p, bank.spec)), \
            f"{name}: train_adamw's staged weights are not the update's"
        geom = fl.geom
        smem = K.float_smem_bytes(h, geom.rays_per_tile, S)   # float32
        key = f"{name}/float32"
        stats.setdefault("train_grad", {})[key] = {
            "max_abs_err": err_g, "blocks_per_slot": geom.blocks,
            "n_tiles": geom.n_tiles, "scratch_bytes": geom.scratch_bytes,
            "tile_points": geom.rays_per_tile * S, "smem_bytes": smem,
            **grad_bound(bank, n_per, S)}
        stats.setdefault("train_adamw", {})[name] = {
            "max_abs_err": err_b, **adamw_bound(bank, rows)}
        log(f"[{phase}] {name}: the update kernels' plan {fl.plan}")
        log(f"[{phase}] {name}: train_grad geometry {geom.rays_per_tile} "
            f"rays per tile ({geom.rays_per_tile * S} points), "
            f"{geom.n_tiles} tiles over {geom.blocks} blocks per slot; "
            f"partial-gradient scratch "
            f"{geom.rows} rows, {geom.scratch_bytes} bytes "
            f"({geom.scratch_bytes / 2**20:.1f} MiB); dynamic shared memory "
            f"{smem} bytes a block")
        # the other float instances' plans at this shape (phase 10 runs
        # them): the same tile, their own slabs
        for pol in BF16_POLICIES:
            g = K.frame_geometry(h, S, n_per, cap, pol)
            log(f"[{phase}] {name}/{pol}: {g.rays_per_tile * S} points a "
                f"tile, {g.blocks} blocks per slot, scratch {g.scratch_bytes} "
                f"bytes, dynamic shared memory "
                f"{K.float_smem_bytes(h, g.rays_per_tile, S, pol)} bytes")

        # per-kernel times at this shape, against the plain version
        sl = K._slice_iter(batch, 0, n_per)
        stats["train_grad"][key]["ms"] = time_cuda(
            lambda: fl.grad(bank.flat, 0), 20)
        stats["train_grad"][key]["plain_ms"] = time_cuda(
            lambda: K.iteration_loss_grad(bank, sl, CS, OSC), 20)
        ad = stats["train_adamw"][name]
        ad["ms"] = time_device(
            lambda: fl.adamw(p, m, v, losses, 0, LR, WD), 50)
        # the plain version as a user would write it; row_sum's fixed
        # order is the correctness reference above, not a plain cost
        ad["plain_ms"] = time_cuda(lambda: apply_adamw(
            bank, fl.grad_part.sum(1)[:, fl.row_index], LR, WD), 20)
        # a reference point, not the function: one library call reading
        # the same rows
        ad["torch_sum_ms"] = time_cuda(lambda: fl.grad_part.sum(dim=1), 50)
        log(f"[{phase}] {name}: train_grad max_abs_err {err_g:.3e} "
            f"(grad scale {gscale:.3e}), train_adamw max_abs_err "
            f"{err_b:.3e}; ms kernel/plain/bound: grad "
            f"{stats['train_grad'][key]['ms']:.4f}/"
            f"{stats['train_grad'][key]['plain_ms']:.4f}/"
            f"{stats['train_grad'][key]['bound_ms']:.4f} (FP32 rate "
            f"{grad_bound(bank, n_per, S, fp32_rate=True)['bound_ms']:.4f})"
            f"; {adamw_rate(ad)}; torch.sum over the rows "
            f"{ad['torch_sum_ms']:.4f} ms")

        # whole frames, two tiers
        frame_tiers(phase, name, bank, S, n_per, dev,
                    lambda bank, batch, n_iter: K.fused_frame(
                        bank, batch, n_iter, n_per, LR, WD, CS, OSC))


SECTIONS = ("pe", "forward", "render", "weight_grads", "input_grads",
            "rest", "quant")


def k1_sections(dev, gpu: str) -> None:
    """``--sections``: where a train_grad launch spends its time, at phase
    3's shapes, banks and batches, under each policy. The kernel library is
    built once more with ``-DK1_PROFILE`` (``csrc/train_step.cuh``
    K1_MARK; the library the port runs never has the counters): block (0,
    0)'s thread 0 then adds the clocks of each section of every tile it
    runs, the block synchronised at both ends of a section: points and PE,
    the forward products, render and losses, the weight gradients, the
    input gradients, the rest (bias gradients, band folds, activation
    reloads, the dirs gradient) and, in the int8 tile
    (``csrc/train_step_q8.cu``, its own counters), the quantisation passes
    and scale reductions (the s8 copies, the abs-max and the bias sums in
    registers; a product's epilogue up to its abs-max counts with the
    product). The synchronisation adds its own wait to each section, so
    the launch runs slower than the port's; the shares are what this
    reads. Prints one JSON line per (shape, policy): ms a launch
    (``time_cuda``, 10), the tiles of block 0, its clocks a tile and each
    section's share."""
    import ctypes
    import torch
    from vmap_tpu_torch.kernels import _build
    from vmap_tpu_torch.kernels import train_step as K
    t0 = time.perf_counter()
    lib = _build.KERNELS.load(defines=("K1_PROFILE",))
    for fn in (lib.vmap_k1_profile, lib.vmap_k1_profile_q8):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    log(f"[sections] built the K1_PROFILE library in "
        f"{time.perf_counter() - t0:.1f} s")
    clocks = (ctypes.c_ulonglong * 8)()
    for policy in POLICIES:
        read = (lib.vmap_k1_profile_q8 if policy in INT8_POLICIES
                else lib.vmap_k1_profile)
        for name, cap, n_act, h, n_per, S, scale in SHAPES:
            bank = conditioned_bank(cap, n_act, h, scale, 0, dev)
            fl = K.FrameLaunch(bank, random_batch(cap, n_per, S, 1, dev), 1,
                               n_per, CS, OSC, policy, lib=lib)
            torch.cuda.synchronize()
            _build.check(lib, read(clocks), "zero clocks")
            ms = time_cuda(lambda: fl.grad(bank.flat, 0), 10)
            _build.check(lib, read(clocks), "read clocks")
            g = fl.geom
            tiles = -(-g.n_tiles // g.blocks)    # of block 0, a launch
            total = sum(clocks[:len(SECTIONS)])
            print(json.dumps({
                "gpu": gpu, "shape": name, "policy": policy, "hidden": h,
                "tile_points": g.rays_per_tile * S,
                "blocks_per_slot": g.blocks, "ms": ms,
                "tiles_of_block0": tiles,
                # time_cuda's warm-up launch and its 10
                "clocks_a_tile": total / (11 * tiles),
                "share": {sec: clocks[i] / max(total, 1)
                          for i, sec in enumerate(SECTIONS)}}), flush=True)


def frame_tiers(phase, name, bank, S, n_per, dev, kernel_frame) -> None:
    """A frame through ``kernel_frame(bank, batch, n_iter)`` against the
    plain autograd frame: n_iter=1 losses / parameters / moments within
    rtol 2e-3, n_iter=20 finite with the final summed loss within rtol
    0.25; inactive slots bit-identical."""
    import torch
    from vmap_tpu_torch.kernels import train_step as K
    inact = ~bank.active
    cap = bank.flat.shape[0]
    for n_iter in (1, 20):
        batch = random_batch(cap, n_iter * n_per, S, 2, dev)
        rb, rl = K.fused_frame_reference(bank, batch, n_iter, n_per, LR, WD,
                                         CS, OSC)
        kb, kl = kernel_frame(bank, batch, n_iter)
        torch.cuda.synchronize()
        for t in (kb.flat, kb.m, kb.v, kl):
            assert bool(torch.isfinite(t).all()), f"{name}: non-finite"
        for f in ("flat", "m", "v"):
            assert torch.equal(getattr(kb, f)[inact],
                               getattr(bank, f)[inact]), \
                f"{name}: inactive {f} not bit-identical"
        assert torch.equal(kb.step, rb.step)
        if n_iter == 1:
            rel_close(kl, rl, RTOL_SEM, 1e-6, f"{name} losses n_iter=1")
            # atol: 1e-3 of each tensor's scale. A ReLU pre-activation
            # within rounding of 0 can fall on either side in the two
            # paths (FMA contraction, summation order), moving one
            # point's term in or out of a gradient: one element of m
            # (b_mid2) differed by 2e-4 of m's scale on the H100
            for f in ("flat", "m", "v"):
                want = getattr(rb, f)
                err = rel_close(getattr(kb, f), want, RTOL_SEM,
                                1e-3 * float(want.abs().max()),
                                f"{name} {f}")
                col = int(((getattr(kb, f) - want).abs().max(0)
                           .values.argmax()))
                worst = next(nm for _, nm, _, off, size in bank.spec.names
                             if off <= col < off + size)
                log(f"[{phase}] {name} n_iter=1 {f}: max abs err {err:.3e} "
                    f"(scale {float(want.abs().max()):.3e}, worst in "
                    f"{worst})")
            detail = float(((kl - rl).abs()
                            / rl.abs().clamp_min(1e-9)).max())
        else:
            a, b = float(kl[:, -1].sum()), float(rl[:, -1].sum())
            detail = abs(a - b) / max(abs(b), 1e-9)
            if not detail < RTOL_FULL:
                raise AssertionError(f"{name} n_iter=20 final loss "
                                     f"{a} vs plain {b}")
        log(f"[{phase}] {name} frame n_iter={n_iter}: loss rel diff "
            f"{detail:.3e} (kernel {float(kl[:, -1].sum()):.6f}, "
            f"plain {float(rl[:, -1].sum()):.6f}) ok")


# ---------------------------------------------------------------- phase 6
def field_operands(O, hidden, M, scale, seed, dev):
    """Prepared params of O freshly initialised fields (weights x0.5 so the
    occupancy is not saturated), points in [-scale, scale]^3 and random
    cotangents."""
    import torch
    from vmap_tpu_torch.core import bank as B
    from vmap_tpu_torch.kernels import ensemble as E
    gen = torch.Generator().manual_seed(seed)
    bank = B.init_bank(gen, O, hidden, default_scale=scale)
    pe, mlp_p = bank.spec.unflatten(bank.flat * 0.5)
    scales = scale + 0.05 * torch.arange(O, dtype=torch.float32)
    prepared = {k: v.to(dev) for k, v in
                E.prepare_params(pe, mlp_p, scales, hidden).items()}
    pts = ((torch.rand(O, M, 3, generator=gen) * 2 - 1) * scale).to(dev)
    g_a = torch.randn(O, M, generator=gen).to(dev)
    g_c = torch.randn(O, M, 3, generator=gen).to(dev)
    return prepared, pts, g_a, g_c


def field_grad_error(g_k, g_r, g_d, gmax: float) -> tuple:
    """K3's gradient ``g_k`` against the f32 plain version ``g_r`` by the
    JAX bar (rtol 2e-3, atol 2e-3 max(1, |g|max)). Over 131,072 points at
    h=256 the f32 plain version itself misses that bar against the f64
    plain version ``g_d`` (sums of 10^5 terms in another order, and ReLU
    ties: a pre-activation within rounding of 0 falls on either side).
    Where it does, the kernel is held to ``g_d`` instead: its largest
    error and its error norm each at most twice the f32 plain version's.
    Returns (max abs error against ``g_r``, "f32" or "f64" for the
    reference that held it, or None)."""
    import torch
    a, b, d = g_k.double(), g_r.double(), g_d.double()
    atol = 2e-3 * max(1.0, gmax)
    err = float((a - b).abs().max())

    def within(x, y) -> bool:
        return bool(((x - y).abs() <= atol + 2e-3 * y.abs()).all())

    if not bool(torch.isfinite(a).all()):
        return err, None
    if within(a, b):
        return err, "f32"
    if within(b, d):      # the f32 plain version meets the bar: so must K3
        return err, None
    ek, er = a - d, b - d
    ok = (float(ek.abs().max()) <= 2 * float(er.abs().max())
          and float(ek.norm()) <= 2 * float(er.norm()))
    return err, "f64" if ok else None


def check_field_kernels(dev, stats: dict, shapes=FIELD_SHAPES,
                        phase: str = "6") -> None:
    """K2 and K3 against their plain versions (JAX bar,
    tests/test_pallas_kernel.py:55-56 and :103-108; K3 by
    ``field_grad_error``); K3 at the widths it is built for, twice (bit
    for bit the same) and at a second tile_m. Each width's tiles, grids
    and shared memory (the library's plan) are printed; field_stage's
    pieces are held equal to their plain version, and the staging
    (packing and split) timed alone and with K2: K2's ``ms`` reuses the
    pieces (meshing's ~256 launches a grid on one bank's weights),
    ``ms_fresh_stage`` makes them anew each launch (FieldTrain's forward,
    whose weights change every iteration)."""
    import torch
    from vmap_tpu_torch.kernels import KERNEL_HIDDEN, _build
    from vmap_tpu_torch.kernels import ensemble as E
    lib = _build.load()
    for name, O, h, M, scale in shapes:
        prepared, pts, g_a, g_c = field_operands(O, h, M, scale, 3, dev)
        a_k, c_k = E.field_eval(prepared, pts)
        a_r, c_r = E.field_eval_reference(prepared, pts)
        torch.cuda.synchronize()
        err_a = rel_close(a_k, a_r, 0.0, 3e-4, f"{name} field_fwd alpha")
        err_c = rel_close(c_k, c_r, 0.0, 2e-5, f"{name} field_fwd colour")
        _, ws = E._STAGED["value"]
        ws_r = E.staged_pieces_reference(prepared, h)
        if not torch.equal(ws, ws_r):
            raise AssertionError(f"{name}: field_stage's pieces differ from "
                                 "their plain version")
        n_w = sum(v.numel() for v in prepared.values())
        plan = E.field_plan(h, O, M)
        log(f"[{phase}] {name} field_fwd plan: {plan['fwd_points']} points a "
            f"tile, {plan['fwd_blocks']} blocks of {plan['fwd_threads']} "
            f"threads ({plan['fwd_blocks_per_sm']} an SM), "
            f"{plan['fwd_smem_bytes']} B dynamic shared memory")
        stg = stats.setdefault("field_stage", {})[name] = {
            "max_abs_err": float((ws.float() - ws_r.float()).abs().max()),
            **stage_bound(O, h),
            "ms": time_cuda(lambda: restage(E, lib, prepared, h), 10),
            "plain_ms": time_cuda(lambda: (
                E._packed(prepared, h),
                E.staged_pieces_reference(prepared, h)), 10)}
        fwd = stats.setdefault("field_fwd", {})[name] = {
            "max_abs_err": max(err_a, err_c),
            **field_bound(O, M, h, n_w, False),
            "bound_fp32_ms": field_bound(O, M, h, n_w, False,
                                         fp32_rate=True)["bound_ms"],
            "ms": time_cuda(lambda: E.field_eval(prepared, pts), 10),
            "ms_fresh_stage": time_cuda(lambda: (
                restage(E, lib, prepared, h),
                E.field_eval(prepared, pts)), 10),
            "plain_ms": time_cuda(
                lambda: E.field_eval_reference(prepared, pts), 10),
            "plan": plan}
        msg = (f"[{phase}] {name} ({O} x {M} points, h={h}): field_fwd "
               f"alpha err {err_a:.3e} colour err {err_c:.3e}, ms "
               f"kernel/plain/bound {fwd['ms']:.4f}/{fwd['plain_ms']:.4f}/"
               f"{fwd['bound_ms']:.4f} "
               f"(bound at the FP32 rate {fwd['bound_fp32_ms']:.4f}), with "
               f"the weights staged anew {fwd['ms_fresh_stage']:.4f}; "
               f"field_stage ms kernel/plain/bound {stg['ms']:.4f}/"
               f"{stg['plain_ms']:.4f}/{stg['bound_ms']:.4f}")
        if h not in KERNEL_HIDDEN["field_bwd"]:
            log(msg + f"; no field_bwd kernel at h={h}")
            continue
        g_k = E.field_grad(prepared, pts, g_a, g_c)
        g_k2 = E.field_grad(prepared, pts, g_a, g_c)
        g_t = E.field_grad(prepared, pts, g_a, g_c, 4 * E.TILE_M)
        g_r = E.field_grad_reference(prepared, pts, g_a, g_c)
        g_d = E.field_grad_reference(
            {k: v.double() for k, v in prepared.items()}, pts.double(),
            g_a.double(), g_c.double())
        torch.cuda.synchronize()
        if not all(torch.equal(g_k[n], g_k2[n]) for n in E.W_NAMES):
            raise AssertionError(f"{name} field_bwd: two launches differ")
        err_g, worst, to_f64 = 0.0, "", []
        for n in E.W_NAMES:
            gmax = float(g_r[n].abs().max())
            for got, tag in ((g_k[n], ""), (g_t[n], " (tile_m x4)")):
                e, held = field_grad_error(got, g_r[n], g_d[n], gmax)
                if held is None:
                    raise AssertionError(
                        f"{name} field_bwd{tag} d{n}: max abs err {e} "
                        "against the f32 plain version, beyond its bar, and "
                        "not within twice the f32 plain version's own error "
                        "against the f64 one")
                if held == "f64" and n not in to_f64:
                    to_f64.append(n)
                if e / max(1.0, gmax) >= err_g:
                    err_g, worst = e / max(1.0, gmax), n + tag
        if to_f64:
            log(f"[{phase}] {name} field_bwd: d{', d'.join(to_f64)} held to "
                "the f64 plain version (the f32 plain version misses the bar "
                "there too)")
        scratch_mib = (O * 2 * plan["scratch_pieces"] * plan["scratch_rows"]
                       * plan["Mp"] / 2**20)
        log(f"[{phase}] {name} field_bwd plan: {plan['bwd_points']} points a "
            f"tile, {plan['bwd_blocks']} blocks of {plan['bwd_threads']} "
            f"threads, {plan['bwd_smem_bytes']} B; field_wgrad "
            f"{plan['wgrad_blocks']} blocks ({plan['wgrad_tiles']} tiles x "
            f"{plan['splits']} splits x {O}, {plan['wgrad_blocks_per_sm']} "
            f"an SM), {plan['wgrad_smem_bytes']} B; scratch "
            f"{scratch_mib:.1f} MiB")
        bwd = stats.setdefault("field_bwd", {})[name] = {
            "max_abs_err": err_g, "held_to_f64": to_f64,
            "bit_equal_launches": True,
            **field_bound(O, M, h, n_w, True),
            "bound_fp32_ms": field_bound(O, M, h, n_w, True,
                                         fp32_rate=True)["bound_ms"],
            "ms": time_cuda(lambda: E.field_grad(prepared, pts, g_a, g_c), 3),
            "plain_ms": time_cuda(
                lambda: E.field_grad_reference(prepared, pts, g_a, g_c), 3),
            "plan": plan}
        log(msg + f"; field_bwd worst err/scale {err_g:.3e} (d{worst}), "
            f"ms kernel/plain/bound {bwd['ms']:.4f}/{bwd['plain_ms']:.4f}/"
            f"{bwd['bound_ms']:.4f} (at the FP32 rate "
            f"{bwd['bound_fp32_ms']:.4f}), two launches bit-equal")


def stage_bound(O: int, hidden: int) -> dict:
    """field_stage's bound (``ensemble.stage``): the prepared tensors read
    and packed into one f32 row an object, and the seven product weights'
    three bf16 pieces written (the staged layout), over the HBM rate."""
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.kernels import train_step as K
    n_params = E._offsets(hidden)[2]
    return bound(O * (4 * 2 * n_params
                      + 2 * E.STAGED_PIECES * K.staged_layout(hidden)[1]))


def restage(E, lib, prepared: dict, hidden: int) -> None:
    """The staging a change of weights costs: the packed rows and the
    split kernel's pieces made anew."""
    import ctypes
    offs, _, _ = E._offsets(hidden)
    E._STAGED.clear()
    E.stage(prepared, hidden, lib, (ctypes.c_int * len(offs))(*offs))


# ---------------------------------------------------------------- phase 4
def reset_counts() -> None:
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.kernels import train_step as K
    for counts in (K.LAUNCHES, E.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.kernels import train_step as K
    return {**K.LAUNCHES, **E.LAUNCHES}


def sphere_error(obj_path: str, scene) -> float:
    """Median distance of the mesh's vertices from the analytic sphere of
    the synthetic scene the trainer rendered its frames from."""
    import numpy as np
    from vmap_tpu_torch.core.meshing import read_obj_vertices
    v = read_obj_vertices(obj_path)
    d = np.linalg.norm(v - scene.sphere_center, axis=1)
    return float(np.median(np.abs(d - scene.sphere_radius)))


def drive_trainer(phase: str, config: str, tag: str, n_frames: int,
                  n_resume: int, check, vis: dict | None = None,
                  tpu: dict | None = None) -> tuple:
    """``configs/<config>`` with dataset.format Synthetic (and the ``vis``
    and ``tpu`` entries) through the CLI on the card for ``n_frames``
    frames with --save_ckpt (the last frame takes the mesh-and-checkpoint
    branch from frame 10 on), then, if ``n_resume``, --resume for
    ``n_resume`` more, with a cheap export on its last frame (RESUME_VIS:
    the first run's export is the full-size one); both runs' losses
    finite. ``check(mapper, dataset,
    logdir, launches, n_iter, losses)`` checks the first run and returns
    a line of detail for the log. Returns (launch counts of the first
    run, the export's host seconds per stage)."""
    import numpy as np
    from vmap_tpu_torch import train
    from vmap_tpu_torch.core import meshing

    with open(os.path.join(REPO, "configs", config)) as f:
        raw = json.load(f)
    raw["dataset"]["format"] = "Synthetic"
    raw["vis"].update(vis or {})
    raw["tpu"].update(tpu or {})
    cfg_path = os.path.join(OUT, f"{tag}.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    logdir = os.path.join(OUT, f"train_{tag}")
    if os.path.isdir(logdir):
        shutil.rmtree(logdir)
    log_path = os.path.join(logdir, "train_log.jsonl")

    reset_counts()
    meshing.STAGE_S.clear()    # a run under 11 frames exports nothing
    t0 = time.perf_counter()
    mapper, dataset = train.run(["--config", cfg_path, "--logdir", logdir,
                                 "--max_frames", str(n_frames), "--device",
                                 "cuda", "--save_ckpt"])
    wall = time.perf_counter() - t0
    launches = read_counts()
    stages = dict(meshing.STAGE_S)
    rows = [json.loads(line) for line in open(log_path)]
    assert len(rows) == n_frames, rows
    losses = [r["loss"] for r in rows]
    assert all(np.isfinite(losses)), losses
    detail = check(mapper, dataset, logdir, launches,
                   raw["render"]["iters_per_frame"], losses)
    log(f"[{phase}] trainer: {n_frames} frames in {wall:.1f} s, losses "
        f"{[round(x, 4) for x in losses]}, launches {launches}; {detail}")
    if stages:
        log(f"[{phase}] frame {n_frames - 1} mesh export, host s per stage: "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        sorted(stages.items(), key=lambda kv: -kv[1])))

    if not n_resume:
        return launches, stages
    raw["vis"].update(RESUME_VIS)
    cfg_path = os.path.join(OUT, f"{tag}_resume.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    reset_counts()
    train.main(["--config", cfg_path, "--logdir", logdir, "--max_frames",
                str(n_frames + n_resume), "--device", "cuda", "--resume",
                os.path.join(logdir, "ckpt", "state")])
    rows = [json.loads(line) for line in open(log_path)][n_frames:]
    assert [r["frame"] for r in rows] == list(
        range(n_frames, n_frames + n_resume)), rows
    assert all(np.isfinite([r["loss"] for r in rows])), rows
    last = os.path.join(logdir, "scene_mesh",
                        f"frame_{n_frames + n_resume - 1}_obj0.obj")
    if not os.path.getsize(last) > 0:
        raise AssertionError(f"{last} is empty")
    log(f"[{phase}] resumed for {n_resume} frame(s): losses "
        f"{[round(r['loss'], 4) for r in rows]}, launches {read_counts()}")
    return launches, stages


def check_launches(launches: dict, want: int, why: str) -> None:
    """Each train-frame kernel launched ``want`` times, field_fwd at least
    once (mesh export)."""
    for k in ("train_grad", "train_adamw"):
        if launches[k] != want:
            raise AssertionError(f"{k}: {launches[k]} launches; expected "
                                 f"{want} ({why})")
    if not launches["field_fwd"] > 0:
        raise AssertionError("mesh export launched no field_fwd kernel")


def run_trainer(n_frames: int, n_resume: int = 2) -> tuple:
    """room0_vmap: the object bank and the background, each one launch of
    each train-frame kernel per iteration; the meshes of the background,
    the sphere and the box, the sphere's against the analytic one."""

    def check(mapper, dataset, logdir, launches, n_iter, losses):
        check_launches(launches, 2 * n_iter * n_frames,
                       f"2 banks x {n_iter} per frame")
        for obj_id in (0, 1, 2):     # background, sphere, box
            rec = mapper.registry[obj_id]
            bank = mapper.bank_bg if rec.is_bg else mapper.bank_obj
            assert bool(bank.active[rec.slot]), f"object {obj_id} inactive"
            path = os.path.join(logdir, "scene_mesh",
                                f"frame_{n_frames - 1}_obj{obj_id}.obj")
            if not os.path.getsize(path) > 0:
                raise AssertionError(f"{path} is empty")
        err = sphere_error(os.path.join(
            logdir, "scene_mesh", f"frame_{n_frames - 1}_obj1.obj"),
            dataset.scene)
        if not err < 0.15:    # the bar of tests/test_meshing.py
            raise AssertionError(f"sphere mesh median error {err} m")
        state = os.path.join(logdir, "ckpt", "state")
        return (f"objects {sorted(mapper.registry)}; sphere mesh median "
                f"error {err:.4f} m; checkpoint {sorted(os.listdir(state))}")

    return drive_trainer("4", "Replica/room0_vmap.json", "room0_synthetic",
                         n_frames, n_resume, check)


# ---------------------------------------------------------------- phase 5
def bench_workload(dev, unknown: float | None = None):
    """bench.py::build_workload's shapes on the port: 104 slots (100
    active) at h=32, background h=128, a random 16-slot 1200x680 pool.
    ``unknown``: the share of pixels whose instance is 0 ("unknown"),
    the others drawn over the 100 objects; by default every id of
    [0, 100] is equally likely."""
    import numpy as np
    import torch
    from vmap_tpu_torch.core import bank as B
    from vmap_tpu_torch.core.step import StepStatics
    cap, slots, W, H, KF, POOL = 100, 104, 1200, 680, 20, 16
    st = StepStatics(n_iter=20, win=5, n_px=24, n_b2s=1, n_bins=9,
                     do_bg=True, win_bg=10, n_px_bg=120, n_b2s_bg=5,
                     fx=600.0, fy=600.0, cx=599.5, cy=339.5, px_block=1,
                     px_block_bg=4)
    gen = torch.Generator().manual_seed(0)
    bank_obj = B.init_bank(gen, slots, 32, 2.0, device=dev)
    bank_obj.active[:cap] = True
    bank_bg = B.init_bank(gen, 1, 128, 5.0, device=dev)
    B.activate_slot(bank_bg, 0, gen, 5.0)
    rng = np.random.default_rng(0)
    depth_mm = rng.integers(500, 7500, (POOL, W, H)).astype(np.uint32)
    inst_b = (rng.integers(-1, cap, (POOL, W, H)) + 1).astype(np.uint32)
    if unknown is not None:
        inst_b = np.where(rng.random((POOL, W, H)) < unknown, 0,
                          rng.integers(1, cap + 1, (POOL, W, H))
                          ).astype(np.uint32)
    rgbw = rng.integers(0, 2 ** 24, (POOL, W, H)).astype(np.uint32)
    packed = np.stack([rgbw, depth_mm | (inst_b << 16)], -1).view(np.int32)
    pool = (torch.from_numpy(packed).to(dev),
            torch.eye(4, device=dev).repeat(POOL, 1, 1))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    kf_pool = t(rng.integers(0, POOL, (slots, KF)).astype(np.int32))
    bbox = t(np.tile(np.array([100, 500, 100, 400], np.float32),
                     (slots, KF, 1)))
    n_kf = t(np.full(slots, KF - 1, np.int32))
    latest2 = t(np.tile(np.array([KF - 3, KF - 2], np.int32), (slots, 1)))
    obj_tab = (kf_pool, bbox, n_kf, latest2)
    bg_tab = (kf_pool[:1], t(np.tile(np.array([0, W, 0, H], np.float32),
                                     (1, KF, 1))), n_kf[:1], latest2[:1])
    obj_ids = torch.arange(slots, dtype=torch.int32, device=dev)
    return st, bank_obj, bank_bg, pool, obj_tab, obj_ids, bg_tab


def frame_runs(st, bank_obj, bank_bg, pool, obj_tab, obj_ids, bg_tab,
               draws, frames: int) -> tuple[dict, list]:
    """``frames`` frames of ``ST.frame_step`` on the plain and the kernel
    path in turns (plain, kernel, kernel, plain; each run warms up on one
    more frame first), each timed with CUDA events around the frame and a
    data-dependent readback of its loss. ``draws(f)`` -> (obj, bg) draws
    of frame f. Returns ({"plain" / "kernel": {"frame_ms", "losses",
    "median_frame_ms"}}, the loss rel diff per frame); raises when the
    first frame's losses differ by more than RTOL_FULL."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST

    def run(kernel: bool):
        s = dataclasses.replace(st, use_fused_frame=kernel)
        bo, bb = bank_obj, bank_bg
        times, losses = [], []
        for f in range(frames + 1):              # frame 0 warms up
            d_o, d_b = draws(f)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            bo, bb, met = ST.frame_step(s, bo, bb, *pool, obj_tab, obj_ids,
                                        bg_tab, d_o, d_b)
            loss = float(met["loss"])            # data-dependent readback
            t1.record()
            torch.cuda.synchronize()
            if f:
                times.append(t0.elapsed_time(t1))
            losses.append(loss)
        return times, losses

    res = {}
    for label, kernel in (("plain", False), ("kernel", True),
                          ("kernel", True), ("plain", False)):
        times, losses = run(kernel)
        assert all(math.isfinite(x) for x in losses), losses
        res.setdefault(label, {"frame_ms": [], "losses": losses})
        res[label]["frame_ms"] += times
    for label in ("kernel", "plain"):
        ms = sorted(res[label]["frame_ms"])
        res[label]["median_frame_ms"] = ms[len(ms) // 2]
    rel = [abs(a - b) / max(abs(b), 1e-9) for a, b in
           zip(res["kernel"]["losses"], res["plain"]["losses"])]
    if not rel[0] < RTOL_FULL:
        raise AssertionError(f"frame 0 loss rel diff {rel[0]}")
    return res, rel


def full_width(dev, gpu: str, frames: int = 3) -> dict:
    import torch
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.kernels import train_step as K

    st, bo0, bb0, pool, obj_tab, obj_ids, bg_tab = bench_workload(dev)
    gen = torch.Generator(device=dev)

    def draws(seed):
        gen.manual_seed(seed)
        d_o = ST.torch_draws(gen, ST.draw_shapes(
            104, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, 1), dev)
        d_b = ST.torch_draws(gen, ST.draw_shapes(
            1, st.n_iter * st.win_bg, st.n_px_bg, st.n_b2s_bg, st.n_bins,
            st.px_block_bg), dev)
        return d_o, d_b

    res, rel = frame_runs(st, bo0, bb0, pool, obj_tab, obj_ids, bg_tab,
                          draws, frames)

    # kernel-only: one bank's 20-iteration frame on a fixed batch
    d_o, d_b = draws(100)
    n_fr, n_fr_bg = st.n_iter * st.win, st.n_iter * st.win_bg
    b_o = ST._sample_bank(*pool, *obj_tab, obj_ids, n_fr, st.n_px, st.n_b2s,
                          st, d_o, px_block=1)
    b_b = ST._sample_bank(*pool, *bg_tab, obj_ids[:1] * 0, n_fr_bg,
                          st.n_px_bg, st.n_b2s_bg, st, d_b,
                          px_block=st.px_block_bg)
    for bname, bank, batch, n_per in (("obj", bo0, b_o, st.win * st.n_px),
                                      ("bg", bb0, b_b,
                                       st.win_bg * st.n_px_bg)):
        for label, fn in (("kernel", K.fused_frame),
                          ("plain", K.fused_frame_reference)):
            res[f"{bname}_bank_frame_{label}_ms"] = time_cuda(
                lambda: fn(bank, batch, st.n_iter, n_per, LR, WD, CS, OSC),
                3)
    log(f"[5] full-width frame on {gpu}: kernel path median "
        f"{res['kernel']['median_frame_ms']:.3f} ms/frame "
        f"{[round(x, 3) for x in res['kernel']['frame_ms']]}, plain path "
        f"median {res['plain']['median_frame_ms']:.3f} ms/frame "
        f"{[round(x, 3) for x in res['plain']['frame_ms']]}; "
        f"loss rel diff per frame {[f'{x:.2e}' for x in rel]}")
    for bname in ("obj", "bg"):
        log(f"[5] {bname} bank 20-iteration frame on {gpu}: kernel "
            f"{res[f'{bname}_bank_frame_kernel_ms']:.3f} ms, plain "
            f"{res[f'{bname}_bank_frame_plain_ms']:.3f} ms")
    return res


def imap_workload(dev):
    """The iMAP frame of configs/Replica/room0_imap.json on the port: its
    StepStatics (one h=256 field, 4800 rays x 14 samples, 20 iterations,
    no background), the field's slot active, and a random 16-slot
    1200x680 pool in which every pixel belongs to the scene field (iMAP
    ingests instance 0 everywhere), keyframes over the whole frame."""
    import numpy as np
    import torch
    from vmap_tpu_torch.core import bank as B
    from vmap_tpu_torch.core.mapper import Config, step_statics
    cfg = Config.from_json(os.path.join(REPO, "configs", "Replica",
                                        "room0_imap.json"))
    st = step_statics(cfg, use_fused=True)
    W, H, KF, POOL = cfg.W, cfg.H, 20, 16
    gen = torch.Generator().manual_seed(0)
    bank = B.init_bank(gen, 1, cfg.hidden_feature_size, cfg.obj_scale,
                       device=dev)
    B.activate_slot(bank, 0, gen, cfg.obj_scale)
    rng = np.random.default_rng(0)
    depth_mm = rng.integers(500, 7500, (POOL, W, H)).astype(np.uint32)
    rgbw = rng.integers(0, 2 ** 24, (POOL, W, H)).astype(np.uint32)
    packed = np.stack([rgbw, depth_mm | (1 << 16)], -1).view(np.int32)
    pool = (torch.from_numpy(packed).to(dev),
            torch.eye(4, device=dev).repeat(POOL, 1, 1))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    tab = (t(rng.integers(0, POOL, (1, KF)).astype(np.int32)),
           t(np.tile(np.array([0, W, 0, H], np.float32), (1, KF, 1))),
           t(np.full(1, KF - 1, np.int32)),
           t(np.array([[KF - 3, KF - 2]], np.int32)))
    return st, bank, pool, tab, torch.zeros(1, dtype=torch.int32, device=dev)


def device_split(fn) -> dict | None:
    """Device ms of one call of ``fn()`` (after a warm-up call) by kernel:
    train_grad, train_adamw, train_quant_w and everything else, from
    torch.profiler's CUDA activity; None when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"train_grad": 0.0, "train_adamw": 0.0, "train_quant_w": 0.0,
             "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = ("train_grad" if "train_grad_" in e.name else
             "train_adamw" if "adamw_kernel" in e.name else
             "train_quant_w" if "quant_weights_kernel" in e.name else
             "other")
        split[k] += e.time_range.elapsed_us() / 1e3
    split["total"] = sum(split.values())
    return split if split["total"] > 0 else None


def imap_full_width(dev, gpu: str, frames: int = 3) -> dict:
    """The iMAP frame at full width: ``frames`` frames through the kernel
    path and the plain path (CUDA events), and the kernel path's device
    time per kernel (torch.profiler)."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST
    st, bank, pool, tab, obj_ids = imap_workload(dev)
    gen = torch.Generator(device=dev)

    def draws(seed):
        gen.manual_seed(seed)
        return ST.torch_draws(gen, ST.draw_shapes(
            1, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins,
            st.px_block), dev), None

    res, rel = frame_runs(st, bank, None, pool, tab, obj_ids, None, draws,
                          frames)
    kst = dataclasses.replace(st, use_fused_frame=True)
    d_o, _ = draws(100)
    res["device_ms"] = device_split(lambda: ST.frame_step(
        kst, bank, None, *pool, tab, obj_ids, None, d_o, None))
    res["rays_per_iteration"] = st.win * st.n_px
    log(f"[5] iMAP frame on {gpu} ({st.win * st.n_px} rays x "
        f"{st.n_b2s + st.n_bins} samples, h={bank.spec.hidden}, "
        f"{st.n_iter} iterations): kernel path median "
        f"{res['kernel']['median_frame_ms']:.3f} ms/frame "
        f"{[round(x, 3) for x in res['kernel']['frame_ms']]}, plain path "
        f"median {res['plain']['median_frame_ms']:.3f} ms/frame "
        f"{[round(x, 3) for x in res['plain']['frame_ms']]}; loss rel diff "
        f"per frame {[f'{x:.2e}' for x in rel]}")
    split = res["device_ms"]
    log("[5] iMAP frame device ms (torch.profiler): " + (
        ", ".join(f"{k} {v:.3f}" for k, v in split.items()) if split
        else "not measured (the profiler recorded no device time)"))
    return res


# ---------------------------------------------------------------- phase 7
def time_grid(chunk_fn, n_chunks: int, ref_fn=None) -> dict:
    """ms of one chunk and of the whole grid (CUDA events), for
    ``chunk_fn(i)`` -> occupancy; with ``ref_fn``, the max abs difference
    of the occupancy of every chunk against it."""
    import torch
    res = {"chunk_ms": time_cuda(lambda: chunk_fn(0), 5),
           "grid_ms": time_cuda(
               lambda: [chunk_fn(i) for i in range(n_chunks)], 1)}
    if ref_fn is not None:
        diff = torch.zeros((), device="cuda")
        for i in range(n_chunks):
            diff = torch.maximum(diff, (chunk_fn(i) - ref_fn(i)).abs().max())
        res["occ_max_abs_diff"] = float(diff)
    return res


def grid_chunk_fn(prepared, frames, chunk: int, fn):
    """i -> occupancy of grid chunk i of mesh_all_objects' bank query, with
    ``fn`` as the field query (the kernel or its plain version)."""
    from vmap_tpu_torch.core import meshing as MS
    from vmap_tpu_torch.kernels import ensemble as E

    def run(i):
        MS.field_eval = fn
        try:
            return MS._bank_grid_chunk(prepared, *frames, i * chunk,
                                       chunk)[0]
        finally:
            MS.field_eval = E.field_eval
    return run


def mesh_full_width(dev, gpu: str) -> dict:
    """Meshing queries at full width, kernel against plain: a 100-object
    h=32 bank over a 128^3 grid per object (the bank padded to 128
    objects, as mesh_all_objects pads it), one h=128 background over the
    256^3 grid of room0_vmap.json, and the h=256 scene field of
    room0_imap.json over 256^3 through mesh_all_objects' chunks (one
    object, 65,536 points per query)."""
    import numpy as np
    import torch
    from types import SimpleNamespace
    from vmap_tpu_torch.core import bank as B
    from vmap_tpu_torch.core import meshing as MS
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.ops.render import make_3d_grid

    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(7)
    res = {}
    with torch.no_grad():
        # objects: one [128, 65536] query per chunk, 32 chunks
        n_obj, gd, chunk = 100, 128, MS.MESH_CHUNK
        bank = B.init_bank(gen, n_obj, 32, 2.0)
        bank = bank.replace(flat=bank.flat.to(dev), scale=bank.scale.to(dev))
        work = [(o + 1, MS.oriented_box(
                    rng.uniform(-2, 2, 3),
                    np.linalg.qr(rng.normal(size=(3, 3)))[0],
                    rng.uniform(0.2, 1.5, 3)), gd)
                for o in range(n_obj)]
        fake = SimpleNamespace(device=dev, bank_obj=bank, registry={
            o + 1: SimpleNamespace(slot=o) for o in range(n_obj)})
        prepared = MS.bank_prepared(fake, work)
        frames = MS.grid_frames(work, prepared["dirs"].shape[0], dev)
        n_chunks = -(-gd ** 3 // chunk)

        def obj_chunk(fn):
            return grid_chunk_fn(prepared, frames, chunk, fn)

        res["obj_plain"] = time_grid(obj_chunk(E.field_eval_reference),
                                     n_chunks)
        res["obj_kernel"] = time_grid(obj_chunk(E.field_eval), n_chunks,
                                      obj_chunk(E.field_eval_reference))
        res["obj_points"] = n_obj * gd ** 3
        res["obj_points_queried"] = (prepared["dirs"].shape[0] * n_chunks
                                     * chunk)

        # grid_volumes (chunks in flight, pinned copies) gives exactly the
        # chunks' occupancy
        vols = MS.grid_volumes(fake, work, prepared)
        direct = torch.cat([obj_chunk(E.field_eval)(i)
                            for i in range(n_chunks)], dim=1)
        direct = direct[:n_obj, :gd ** 3].cpu().numpy()
        res["grid_volumes_vs_chunks_max_abs_diff"] = max(
            float(np.abs(v.ravel() - direct[o]).max())
            for o, v in enumerate(vols))
        diff = res["grid_volumes_vs_chunks_max_abs_diff"]
        if diff != 0.0:
            raise AssertionError(f"grid_volumes differs from its chunks by "
                                 f"{diff}")
        del vols, direct

        # grid_volumes, as mesh_all_objects runs it, at room0's largest
        # grid (every object at grid_dim 256): wall time, peak device
        # memory above what was allocated before, host bytes of the volumes
        work256 = [(oid, b, 256) for oid, b, _ in work]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vols = MS.grid_volumes(fake, work256, prepared)
        res["obj256_grid_volumes_s"] = time.perf_counter() - t0
        res["obj256_device_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                           - base)
        res["obj256_host_volume_bytes"] = sum(v.nbytes for v in vols)
        assert all(v.shape == (256,) * 3 and np.isfinite(v).all()
                   for v in vols[:2])
        del vols

        # background: 256^3 points of one h=128 field, EVAL_CHUNK per query
        bg = B.init_bank(gen, 1, 128, 5.0)
        pe, mlp_p = bg.spec.unflatten(bg.flat.to(dev))
        prep_bg = E.prepare_params(pe, mlp_p, bg.scale.to(dev), 128)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        grid = make_3d_grid((-1.0, 1.0), 256, transform=T,
                            scale=np.array([4.0, 1.5, 4.0]),
                            device=dev).reshape(1, -1, 3)
        bchunk = MS.EVAL_CHUNK
        n_bchunks = grid.shape[1] // bchunk

        def bg_chunk(fn):
            return lambda i: torch.sigmoid(
                fn(prep_bg, grid[:, i * bchunk:(i + 1) * bchunk])[0])

        res["bg_plain"] = time_grid(bg_chunk(E.field_eval_reference),
                                    n_bchunks)
        res["bg_kernel"] = time_grid(bg_chunk(E.field_eval), n_bchunks,
                                     bg_chunk(E.field_eval_reference))
        res["bg_points"] = grid.shape[1]

        # iMAP: one h=256 scene field over a room-sized 256^3 grid, as
        # mesh_all_objects queries it
        scene = B.init_bank(gen, 1, 256, 5.0)
        scene = scene.replace(flat=scene.flat.to(dev),
                              scale=scene.scale.to(dev))
        work1 = [(0, MS.oriented_box(np.zeros(3), T[:3, :3],
                                     np.array([8.0, 3.0, 8.0])), 256)]
        fake1 = SimpleNamespace(device=dev, bank_obj=scene,
                                registry={0: SimpleNamespace(slot=0)})
        prep1 = MS.bank_prepared(fake1, work1)
        frames1 = MS.grid_frames(work1, 1, dev)
        n_ichunks = 256 ** 3 // chunk
        res["imap_plain"] = time_grid(
            grid_chunk_fn(prep1, frames1, chunk, E.field_eval_reference),
            n_ichunks)
        res["imap_kernel"] = time_grid(
            grid_chunk_fn(prep1, frames1, chunk, E.field_eval), n_ichunks,
            grid_chunk_fn(prep1, frames1, chunk, E.field_eval_reference))
        res["imap_points"] = 256 ** 3
    for k in ("obj", "bg", "imap"):
        kern, plain = res[f"{k}_kernel"], res[f"{k}_plain"]
        log(f"[7] {k} meshing grid on {gpu}: {res[f'{k}_points']} points; "
            f"kernel {kern['chunk_ms']:.4f} ms/chunk, "
            f"{kern['grid_ms']:.3f} ms/grid; plain "
            f"{plain['chunk_ms']:.4f} ms/chunk, {plain['grid_ms']:.3f} "
            f"ms/grid; occupancy max abs diff {kern['occ_max_abs_diff']:.3e}")
        if not kern["occ_max_abs_diff"] < 1e-4:
            raise AssertionError(f"{k} occupancy differs from plain by "
                                 f"{kern['occ_max_abs_diff']}")
    log(f"[7] grid_volumes of {n_obj} objects at 256^3 on {gpu}: "
        f"{res['obj256_grid_volumes_s']:.3f} s, device peak "
        f"{res['obj256_device_peak_bytes'] / 2**20:.1f} MiB above the "
        f"bank, host volumes {res['obj256_host_volume_bytes'] / 2**20:.1f} "
        "MiB")
    return res


# ---------------------------------------------------------------- phase 8
def check_field_train_path(dev) -> dict:
    """Object-shape, background-shape and iMAP-shape bank frames through
    the plain frame with StepStatics.use_pallas_train (field through K2 /
    K3), against the autograd frame, in the two tiers of phase 3. Then, at
    each shape's own backward tile (the JAX tile rule), field_bwd against
    its plain version and one iteration's gradient through the field
    kernels against the autograd one (CUDA events). Returns (the launch
    counts of the frames, the times)."""
    import dataclasses
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.kernels import KERNEL_HIDDEN
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.kernels import train_step as K
    st = ST.StepStatics(lr=LR, wd=WD, color_scaling=CS, opacity_scaling=OSC,
                        use_pallas_train=True)
    counts: dict = {}
    times: dict = {}
    for name, cap, n_act, h, n_per, S, scale in SHAPES:
        if h not in KERNEL_HIDDEN["field_bwd"]:
            continue
        bank = conditioned_bank(cap, n_act, h, scale, 0, dev)
        reset_counts()
        frame_tiers("8", name, bank, S, n_per, dev,
                    lambda bank, batch, n_iter: ST._train_bank(
                        bank, batch, n_per,
                        dataclasses.replace(st, n_iter=n_iter)))
        for k, v in read_counts().items():
            counts[k] = counts.get(k, 0) + v

        m = n_per * S
        tile = K.field_tile(m)
        prepared, pts, g_a, g_c = field_operands(cap, h, m, scale, 4, dev)
        sl = random_batch(cap, n_per, S, 5, dev)
        plan = E.field_plan(h, cap, m, tile)
        t = times[name] = {
            "objects": cap, "points": m, "tile_m": tile,
            "blocks": plan["bwd_blocks"], "wgrad_blocks": plan["wgrad_blocks"],
            "field_bwd_ms": time_cuda(
                lambda: E.field_grad(prepared, pts, g_a, g_c, tile), 10),
            **field_bwd_split_ms(prepared, pts, g_a, g_c, tile),
            "field_bwd_plain_ms": time_cuda(
                lambda: E.field_grad_reference(prepared, pts, g_a, g_c), 10),
            "iteration_field_kernels_ms": time_cuda(
                lambda: K.iteration_loss_grad(bank, sl, CS, OSC,
                                              field_kernel=True), 10),
            "iteration_autograd_ms": time_cuda(
                lambda: K.iteration_loss_grad(bank, sl, CS, OSC), 10)}
        log(f"[8] {name}: {cap} x {m} points, tile_m {tile} "
            f"({t['blocks']} field_bwd blocks, {t['wgrad_blocks']} "
            f"field_wgrad blocks); field_bwd "
            f"{t['field_bwd_ms']:.4f} ms (its kernels alone: field_bwd "
            f"{t['field_bwd_kernel_ms']:.4f}, field_wgrad "
            f"{t['field_wgrad_kernel_ms']:.4f}), plain "
            f"{t['field_bwd_plain_ms']:.4f} ms; one iteration's gradient "
            f"through the field kernels "
            f"{t['iteration_field_kernels_ms']:.4f} ms, autograd "
            f"{t['iteration_autograd_ms']:.4f} ms")
    for k in ("field_stage", "field_fwd") + tuple(
            f"field_bwd.{h}" for h in sorted({s[3] for s in SHAPES})
            if h in KERNEL_HIDDEN["field_bwd"]):
        if not counts[k] > 0:
            raise AssertionError(f"use_pallas_train frames launched no {k}")
    log(f"[8] use_pallas_train frames: launches {counts} (field_stage "
        f"{counts['field_stage']} for {counts['field_fwd']} forwards and "
        f"{counts['field_bwd']} backwards)")
    return counts, times


def field_bwd_split_ms(prepared, pts, g_a, g_c, tile_m: int) -> dict:
    """K3's two kernels timed alone (CUDA events) on the same operands:
    field_bwd_kernel (forward, input gradients, the scratch) and
    field_wgrad_kernel (the weight gradients from it)."""
    from vmap_tpu_torch.kernels import ensemble as E
    k3 = E._BwdLaunch(prepared, pts, g_a, g_c, tile_m)
    k3.bwd()
    return {"field_bwd_kernel_ms": time_cuda(k3.bwd, 10),
            "field_wgrad_kernel_ms": time_cuda(k3.wgrad, 10)}


# ---------------------------------------------------------------- phase 9
def scene_occupancy(mapper, scene, frames) -> tuple:
    """(occupancy on the analytic sphere's surface, occupancy at empty
    points) of the iMAP scene field (object 0), through the port's field
    query. For each frame f of ``frames``: the sphere's surface point
    facing the camera, and the point halfway along the camera's ray to it
    (free space the frame observed)."""
    import numpy as np
    from vmap_tpu_torch.core.meshing import eval_points
    eyes = np.stack([scene.pose(f, 64)[:3, 3] for f in frames])
    u = eyes - scene.sphere_center
    surf = scene.sphere_center + scene.sphere_radius * (
        u / np.linalg.norm(u, axis=1, keepdims=True))
    empty = eyes + 0.5 * (surf - eyes)
    params = mapper.object_params(0)
    return eval_points(*params, surf)[0], eval_points(*params, empty)[0]


def obj_vertex_count(path: str) -> int:
    """The ``v`` lines of an exported ``.obj`` (its first line is a
    comment), counted on the bytes: parsing the 2.2 M-vertex scene mesh
    into a Mesh took about half a minute on the host."""
    with open(path, "rb") as f:
        return f.read().count(b"\nv ")


def run_imap_trainer(n_frames: int = 11, n_resume: int = 1) -> tuple:
    """room0_imap (no HTML viewer: phase 4 covers it): one bank, so one
    launch of each train-frame kernel per iteration, each train_grad
    launch the blocks of frame_geometry; the scene mesh, and the learned
    occupancy on the sphere above that in empty space."""
    from vmap_tpu_torch.kernels import train_step as K

    def check(mapper, dataset, logdir, launches, n_iter, losses):
        assert mapper.bank_bg is None and mapper.n_objects == 1
        st = mapper.statics
        geom = K.frame_geometry(mapper.hidden, st.n_b2s + st.n_bins,
                                st.win * st.n_px, mapper.slots)
        check_launches(launches, n_iter * n_frames,
                       f"1 bank x {n_iter} per frame, each train_grad "
                       f"launch {geom.blocks} blocks x {mapper.slots} slot "
                       f"over {geom.n_tiles} tiles of {geom.rays_per_tile} "
                       "rays")
        path = os.path.join(logdir, "scene_mesh",
                            f"frame_{n_frames - 1}_obj0.obj")
        if not os.path.getsize(path) > 0:
            raise AssertionError(f"{path} is empty")
        occ_s, occ_e = scene_occupancy(mapper, dataset.scene,
                                       range(n_frames))
        if not occ_s.mean() > occ_e.mean():
            raise AssertionError(f"scene field: occupancy on the sphere "
                                 f"{occ_s} not above empty space {occ_e}")
        return (f"{n_iter} launches per frame of train_grad / train_adamw, "
                f"each train_grad launch {geom.blocks} blocks over "
                f"{geom.n_tiles} tiles of {geom.rays_per_tile} rays; scene "
                f"mesh {obj_vertex_count(path)} vertices; "
                f"occupancy on the sphere mean {occ_s.mean():.4f}, at empty "
                f"points {occ_e.mean():.4f}")

    return drive_trainer("9", "Replica/room0_imap.json",
                         "room0_imap_synthetic", n_frames, n_resume, check,
                         vis={"html_viewer": False})


# --------------------------------------------------------------- phase 13
ROOM_OBJECTS, ROOM_FRAMES = 40, 24
ROOM_W, ROOM_H, ROOM_F = 1200, 680, 600.0
RENDER_TILE = 32768           # one ray tile of the room's render settings
RENDER_TIE_SHARE = 1e-3       # pixels whose winner may differ (edge ties)
RENDER_DEPTH_RTOL = 1e-5      # depth where the winners agree
METRICS = ("accuracy", "completion", "completion_ratio_1cm",
           "completion_ratio_5cm")


def render_checks(dev, objects, settings, pose) -> tuple:
    """Frame 0 of the room rendered on the card, one ray tile of it held
    against the same function on the CPU (``inst`` / ``cls`` equal but on
    at most RENDER_TIE_SHARE of the rays, ``depth`` within
    RENDER_DEPTH_RTOL and ``rgb`` within 1 where the winners agree), and
    the render's ms a frame (CUDA events, 3 frames). The tile is the whole
    tile of the frame with the most pixels on an instance boundary, where
    the edge ties are. Returns the frame (numpy, (W, H) layout) and the
    numbers."""
    import numpy as np
    from vmap_tpu_torch.data_generation.renderer import MeshRenderer
    gpu = MeshRenderer(objects, settings, device=dev)
    frame = gpu.render(pose)
    inst = frame["inst"]
    edge = np.zeros(inst.shape, bool)
    edge[1:] |= inst[1:] != inst[:-1]
    edge[:, 1:] |= inst[:, 1:] != inst[:, :-1]
    n_tiles = inst.size // RENDER_TILE
    per_tile = edge.reshape(-1)[:n_tiles * RENDER_TILE].reshape(
        n_tiles, RENDER_TILE).sum(1)
    best = int(per_tile.argmax())
    tile = slice(best * RENDER_TILE, (best + 1) * RENDER_TILE)
    cpu = MeshRenderer(objects, settings, device="cpu")
    d, o = cpu.rays(pose)
    t0 = time.perf_counter()
    want = [x.numpy() for x in cpu.trace(d[tile], o)]
    cpu_s = time.perf_counter() - t0
    got = [frame[k].reshape((-1,) + frame[k].shape[2:])[tile]
           for k in ("rgb", "depth", "inst", "cls")]
    tile_inst = len(np.unique(got[2]))
    tile_edges = int(per_tile[best])
    agree = got[2] == want[2]
    inst_share = 1.0 - float(agree.mean())
    cls_share = float((got[3] != want[3]).mean())
    if max(inst_share, cls_share) > RENDER_TIE_SHARE:
        raise AssertionError(f"render: inst / cls differ from the CPU on "
                             f"{inst_share:.2e} / {cls_share:.2e} of a tile")
    rel = (np.abs(got[1][agree] - want[1][agree])
           / np.maximum(np.abs(want[1][agree]), 1e-30))
    if rel.size and rel.max() > RENDER_DEPTH_RTOL:
        raise AssertionError(f"render: depth rel error {rel.max():.3e}")
    rgb_err = int(np.abs(got[0].astype(np.int32) - want[0].astype(
        np.int32))[agree].max(initial=0))
    if rgb_err > 1:
        raise AssertionError(f"render: rgb differs by {rgb_err}")
    ms = time_cuda(lambda: gpu.render_tensors(pose), 3)
    res = {"render_ms": ms, "triangles": gpu.n_triangles,
           "tile_rays": RENDER_TILE, "tile_start": tile.start,
           "tile_instances": tile_inst, "tile_edge_pixels": tile_edges,
           "inst_mismatch": inst_share,
           "cls_mismatch": cls_share,
           "depth_max_rel": float(rel.max()) if rel.size else 0.0,
           "rgb_max_err": rgb_err, "cpu_tile_s": cpu_s,
           "ray_triangle_tests": ROOM_W * ROOM_H * gpu.n_triangles}
    log(f"[13] render: {gpu.n_triangles} triangles at {ROOM_W}x{ROOM_H}, "
        f"{ms:.1f} ms a frame on the card (CUDA events, 3 frames; "
        f"{res['ray_triangle_tests'] / ms / 1e6:.2f} G ray-triangle tests "
        f"a s); the tile of {RENDER_TILE} rays from ray {tile.start} "
        f"({tile_inst} instances, {tile_edges} pixels on an instance "
        f"boundary, the most of the frame's {n_tiles} whole tiles) against "
        f"the CPU ({cpu_s:.1f} s there): inst / cls mismatch "
        f"{inst_share:.2e} / "
        f"{cls_share:.2e} (tier {RENDER_TIE_SHARE:g}), depth max rel "
        f"{res['depth_max_rel']:.2e} (tier {RENDER_DEPTH_RTOL:g}), rgb max "
        f"{rgb_err} (tier 1)")
    return frame, res


def dataset_checks(data_dir: str, frame: dict, cfg_path: str) -> dict:
    """Frame 0 read back through the port's Replica loader (no cv2): the
    colour equal to the render, the depth equal to the render's after the
    mm rounding, the masks equal; the PNG read time a frame, and the
    native row reconstruction's time for the frame's colour and depth
    under Paeth (the slowest filter libpng writes; the port writes none)."""
    import numpy as np
    from vmap_tpu_torch import native
    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.data.replica import ReplicaDataset
    from vmap_tpu_torch.data.transforms import depth_filter, depth_scale
    from vmap_tpu_torch.utils.png import read_png
    cfg = Config.from_json(cfg_path)
    mm = np.clip(np.round(frame["depth"] * 1000.0), 0, 65535).astype(
        np.uint16)
    files = {"depth": ("depth", mm), "semantic_instance": (
        "semantic_instance", frame["inst"].astype(np.uint16)),
        "semantic_class": ("semantic_class", frame["cls"].astype(np.uint16))}
    for sub, (name, want) in files.items():
        got = read_png(os.path.join(data_dir, sub, f"{name}_0.png"))
        if not np.array_equal(got, want.T):
            raise AssertionError(f"{sub}_0.png differs from the render")
    t0 = time.perf_counter()
    sample = ReplicaDataset(cfg)[0]
    read_s = time.perf_counter() - t0
    if not np.array_equal(sample["image"], frame["rgb"]):
        raise AssertionError("rgb_0.png read back differs from the render")
    want = depth_filter(depth_scale(mm.astype(np.float32), cfg.depth_scale),
                        cfg.max_depth)
    if not np.array_equal(sample["depth"], want):
        raise AssertionError("depth_0.png read back differs from the "
                             "render's mm rounding")
    t0 = time.perf_counter()
    read_png(os.path.join(data_dir, "rgb", "rgb_0.png"))
    rgb_s = time.perf_counter() - t0
    paeth_ms = {}
    for name, img, bpp in (("rgb", frame["rgb"].transpose(1, 0, 2), 3),
                           ("depth", mm.T.astype(">u2"), 2)):
        raw = np.ascontiguousarray(img).view(np.uint8).reshape(
            img.shape[0], -1)
        rows = np.concatenate([np.full((len(raw), 1), 4, np.uint8), raw], 1)
        t0 = time.perf_counter()
        native.png_unfilter(rows, bpp)
        paeth_ms[name] = (time.perf_counter() - t0) * 1e3
    log(f"[13] frame 0 read back through the port's Replica loader equal "
        f"to the render (depth after the mm rounding); the loader took "
        f"{read_s * 1e3:.1f} ms for the frame (4 PNGs, host), rgb_0.png "
        f"alone {rgb_s * 1e3:.1f} ms; every row under Paeth, the native "
        f"reconstruction takes {paeth_ms['rgb']:.1f} ms (rgb) / "
        f"{paeth_ms['depth']:.1f} ms (depth) a frame")
    return {"loader_ms": read_s * 1e3, "rgb_png_read_ms": rgb_s * 1e3,
            "paeth_unfilter_ms": paeth_ms}


def room_protocol(dev, gpu: str) -> tuple:
    """The room protocol end to end on the card, through the port's
    pipeline (``vmap_tpu_torch.room_pipeline``): the room of ROOM_OBJECTS
    objects at 1200 x 680 for ROOM_FRAMES frames, trained with the shipped
    room0_vmap.json as the pipeline rewrites it (px_block_bg 1, the export
    at the last frame at grid_dim 128), evaluated by the object and the
    scene protocols. Returns (launch counts of the pipeline's run, the
    numbers)."""
    import numpy as np
    from vmap_tpu_torch import room_pipeline
    from vmap_tpu_torch.data_generation.room import (make_room_scene,
                                                     room_trajectory)
    from vmap_tpu_torch.generate_dataset import room_settings

    objs, shell, meta = make_room_scene(ROOM_OBJECTS, seed=0)
    traj = room_trajectory(ROOM_FRAMES, size=meta["size"], seed=0)
    settings = room_settings(ROOM_W, ROOM_H, ROOM_F, ROOM_F)
    frame, res = render_checks(dev, objs + shell, settings, traj[0])

    work = os.path.join(OUT, "room")
    if os.path.isdir(work):
        shutil.rmtree(work)
    reset_counts()
    summary = room_pipeline.main([
        "--work", work, "--frames", str(ROOM_FRAMES), "--objects",
        str(ROOM_OBJECTS), "--width", str(ROOM_W), "--height", str(ROOM_H),
        "--focal", str(ROOM_F), "--grid_dim", "128", "--device", str(dev),
        "--out", os.path.join(OUT, "room_summary.json")])
    launches = read_counts()
    want = 2 * 20 * ROOM_FRAMES
    check_launches(launches, want, f"2 banks x 20 per frame x "
                   f"{ROOM_FRAMES} frames")
    if not launches["field_stage"] > 0:
        raise AssertionError("mesh export launched no field_stage kernel")
    if summary["px_block_bg"] != 1 or summary["device"] != str(dev):
        raise AssertionError(f"pipeline ran with px_block_bg "
                             f"{summary['px_block_bg']} on "
                             f"{summary['device']}")
    if not summary["invalid_depth_share"] < 0.15:
        raise AssertionError(f"invalid-depth share "
                             f"{summary['invalid_depth_share']}")
    logdir = os.path.join(work, "run_default")
    rows = [json.loads(line)
            for line in open(os.path.join(logdir, "train_log.jsonl"))]
    losses = [r["loss"] for r in rows]
    if len(rows) != ROOM_FRAMES or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    res.update(dataset_checks(os.path.join(work, "data"), frame, os.path.join(
        work, "room_config_default.json")))

    gt_dir = os.path.join(work, "data", "habitat")
    mesh_dir = os.path.join(logdir, "scene_mesh")
    last = ROOM_FRAMES - 1
    meshed = sorted(int(f[len(f"frame_{last}_obj"):-4])
                    for f in os.listdir(mesh_dir)
                    if f.startswith(f"frame_{last}_obj") and f.endswith(
                        ".obj"))
    with_gt = [o for o in meshed if o == 0 or os.path.exists(
        os.path.join(gt_dir, f"mesh_semantic.ply_{o}.ply"))]
    per = summary["per_object"]
    missing = sorted(set(with_gt) - set(per))
    if missing:
        raise AssertionError(f"meshed objects with a GT submesh but no "
                             f"metrics row: {missing}")
    table = [summary["object_mean"], summary["bg"], summary["scene"],
             *per.values()]
    if not all(np.isfinite(row[m]) for row in table for m in METRICS):
        raise AssertionError(f"a metric is not finite: {summary}")
    fmt = lambda row: " | ".join(f"{row[m]:.4f}" for m in METRICS)  # noqa
    log(f"[13] training: {ROOM_FRAMES} frames, losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}")
    log(f"[13] {len(meshed)} meshes at frame {last}, {len(per)} rows "
        f"(every meshed object with a GT submesh); Acc | Comp | Ratio@1cm "
        f"| Ratio@5cm, {ROOM_FRAMES} frames (not the protocol's 1,000):")
    log(f"[13] objects mean ({len(set(per) - {0})} objects): "
        f"{fmt(summary['object_mean'])}")
    log(f"[13] background: {fmt(summary['bg'])}")
    log(f"[13] scene: {fmt(summary['scene'])}")
    log("[13] host s per stage: " + ", ".join(
        f"{k} {v:.1f}" for k, v in summary["stage_s"].items())
        + f" ({gpu})")
    res.update({k: summary[k] for k in ("object_mean", "bg", "scene",
                                        "stage_s", "invalid_depth_share",
                                        "px_block_bg")})
    res["rows"] = len(per)
    return launches, res


# --------------------------------------------------------------- phase 14
def slot_draws(d, slot: int):
    """One slot's capacity-1 cut of a bank's ``Draws``."""
    from vmap_tpu_torch.core.step import Draws
    return Draws(**{k: getattr(d, k)[slot:slot + 1].contiguous()
                    for k in ("kf", "u", "v", "z")})


def forloop_against_vmap(dev, gpu: str, frames: int = 3) -> tuple:
    """(a) The forloop ablation (``step.forloop_frame``) against the
    vectorised frame on phase 5's bench-shaped workload (104 slots, 100
    active, h=32, 120 rays x 10 samples; the h=128 background): at
    n_iter=1 each slot's parameters and moments, trained on its cut of the
    bank's draws, within phase 3's tier of the vectorised frame's; at
    n_iter=20 every slot finite and train_grad launched n_iter x (active +
    1) times a frame; then both strategies' frame times (CUDA events
    around a frame and its loss readback, ``frames`` frames after one
    warm-up each) and their ratio, the vectorised speedup. Returns (the
    timed forloop frames' launch counts, results).

    The vectorised frame zeroes a loss term for every slot where any
    active slot's mask for it is empty (the reference's cross-object
    quirk, ``ops/losses.py``); a forloop slot trains alone. Phase 5's
    pool draws each pixel's instance over [0, 100], so about 9% of the
    slots see none of their own or unknown pixels in 120 rays and the
    two strategies train different losses. The checks therefore run on
    the same shapes with half the pool's pixels unknown (no slot's mask
    empty); the timing runs on phase 5's pool itself."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST

    st0, bo, bb, pool, obj_tab, obj_ids, bg_tab = bench_workload(
        dev, unknown=0.5)
    n_active = int(bo.active.sum())
    gen = torch.Generator(device=dev)

    def draws(st, seed):
        gen.manual_seed(seed)
        d_o = ST.torch_draws(gen, ST.draw_shapes(
            bo.capacity, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins,
            st.px_block, st.sample_reuse), dev)
        d_b = ST.torch_draws(gen, ST.draw_shapes(
            1, st.n_iter * st.win_bg, st.n_px_bg, st.n_b2s_bg, st.n_bins,
            st.px_block_bg), dev)
        return d_o, d_b

    def source(d_o, d_bg1):
        slots = iter(torch.nonzero(bo.active).flatten().tolist())
        return lambda bank, shapes: (slot_draws(d_o, next(slots))
                                     if bank == "obj" else d_bg1)

    res = {}
    for n_iter in (1, 20):
        st = dataclasses.replace(st0, n_iter=n_iter, use_fused_frame=True)
        d_o, d_b = draws(st, 7)
        # the forloop's background call takes the object statics' shapes
        d_bg1 = ST.torch_draws(gen, ST.draw_shapes(
            1, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, st.px_block,
            st.sample_reuse), dev)
        vo, _, _ = ST.frame_step(st, bo, bb, *pool, obj_tab, obj_ids, bg_tab,
                                 d_o, d_b)
        reset_counts()
        lo, lb, loss = ST.forloop_frame(st, bo, bb, *pool, obj_tab, obj_ids,
                                        bg_tab, source(d_o, d_bg1))
        torch.cuda.synchronize()
        c = read_counts()
        for k in ("train_grad", "train_adamw"):
            if c[k] != n_iter * (n_active + 1):
                raise AssertionError(f"forloop n_iter={n_iter}: {k} launched "
                                     f"{c[k]} times, expected "
                                     f"{n_iter * (n_active + 1)}")
        act = bo.active
        for f in ("flat", "m", "v"):
            got = getattr(lo, f)
            assert bool(torch.isfinite(got).all()), f"forloop {f} non-finite"
            assert torch.equal(got[~act], getattr(bo, f)[~act]), \
                f"forloop: inactive {f} changed"
            if n_iter == 1:
                want = getattr(vo, f)[act]
                err = rel_close(got[act], want, RTOL_SEM,
                                1e-3 * float(want.abs().max()),
                                f"forloop vs vmap n_iter=1 {f}")
                res[f"n_iter1_{f}_max_abs_err"] = err
        assert math.isfinite(loss) and bool(torch.isfinite(lb.flat).all())
        res[f"n_iter{n_iter}_loss"] = loss
        log(f"[14] forloop vs vmap n_iter={n_iter}: {n_active} slot calls "
            f"+ background, train_grad {c['train_grad']} launches, loss "
            f"{loss:.4f}" + ("; slots within rtol 2e-3 + 1e-3 of scale "
                             f"(flat {res['n_iter1_flat_max_abs_err']:.3e}, "
                             f"m {res['n_iter1_m_max_abs_err']:.3e}, v "
                             f"{res['n_iter1_v_max_abs_err']:.3e})"
                             if n_iter == 1 else "; every slot finite"))

    st0, bo, bb, pool, obj_tab, obj_ids, bg_tab = bench_workload(dev)
    st = dataclasses.replace(st0, use_fused_frame=True)
    times = {"vmap": [], "forloop": []}
    counts = None
    for label in ("vmap", "forloop"):
        for f in range(frames + 1):      # frame 0 warms up
            d_o, d_b = draws(st, 100 + f)
            d_bg1 = ST.torch_draws(gen, ST.draw_shapes(
                1, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins,
                st.px_block, st.sample_reuse), dev)
            if label == "forloop" and f == 1:
                reset_counts()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            if label == "vmap":
                _, _, met = ST.frame_step(st, bo, bb, *pool, obj_tab, obj_ids,
                                          bg_tab, d_o, d_b)
                loss = float(met["loss"])
            else:
                _, _, loss = ST.forloop_frame(st, bo, bb, *pool, obj_tab,
                                              obj_ids, bg_tab,
                                              source(d_o, d_bg1))
            t1.record()
            torch.cuda.synchronize()
            assert math.isfinite(loss)
            if f:
                times[label].append(t0.elapsed_time(t1))
    counts = read_counts()
    want = frames * st.n_iter * (n_active + 1)
    if counts["train_grad"] != want:
        raise AssertionError(f"timed forloop frames: train_grad "
                             f"{counts['train_grad']} launches, expected "
                             f"{want}")
    for label in times:
        ms = sorted(times[label])
        res[f"{label}_frame_ms"] = times[label]
        res[f"{label}_median_frame_ms"] = ms[len(ms) // 2]
    res["speedup"] = (res["forloop_median_frame_ms"]
                      / res["vmap_median_frame_ms"])
    log(f"[14] forloop vs vmap frame on {gpu} (n_iter 20, {n_active} "
        f"active slots): vmap median {res['vmap_median_frame_ms']:.3f} ms "
        f"{[round(x, 3) for x in times['vmap']]}, forloop median "
        f"{res['forloop_median_frame_ms']:.3f} ms "
        f"{[round(x, 3) for x in times['forloop']]}; vectorised speedup "
        f"{res['speedup']:.2f}x; forloop launches a frame "
        f"{counts['train_grad'] // frames} train_grad, "
        f"{counts['train_adamw'] // frames} train_adamw")
    return counts, res


def synthetic_room0(vis: dict | None = None):
    """room0_vmap.json on the analytic scene (dataset.format Synthetic,
    1200 x 680), its ``vis`` entries updated: (Config, raw dict)."""
    from vmap_tpu_torch.config import Config
    with open(os.path.join(REPO, "configs", "Replica",
                           "room0_vmap.json")) as f:
        raw = json.load(f)
    raw["dataset"]["format"] = "Synthetic"
    raw["vis"].update(vis or {})
    return Config.from_dict(raw), raw


def live_run(dev, gpu: str, n_frames: int = 6) -> tuple:
    """(b) ``run_live`` on phase 4's configuration (no HTML viewer, the
    idle export at RESUME_VIS's grid): frame 0 is queued before the loop,
    a producer thread pushes frames 1..n_frames-1 about every 50 ms and
    stops; keep_alive 0.5 s, and the loop stops after its first idle
    export. Every tick trains (2 x n_iter launches of each update kernel
    a tick), one export runs on idle through K2, the losses are finite.
    Returns (launch counts, results)."""
    import threading
    import numpy as np
    from vmap_tpu_torch.core.live import FrameQueue, run_live
    from vmap_tpu_torch.core.mapper import FrameSample, Mapper
    from vmap_tpu_torch.data.loader import make_dataset

    cfg, raw = synthetic_room0(RESUME_VIS)
    mapper = Mapper(cfg, device=dev)
    dataset = make_dataset(cfg)

    def sample(i):
        s = dataset[i]
        return FrameSample(image=s["image"], depth=s["depth"], inst=s["obj"],
                           bbox_dict=s["bbox_dict"], t_wc=s["T"],
                           frame_id=s["frame_id"])

    frames = [sample(i) for i in range(n_frames)]
    q = FrameQueue()
    q.push(frames[0])

    def produce():
        for fs in frames[1:]:
            time.sleep(0.05)
            q.push(fs)

    tick_end = []

    def stop_after_export(stats):
        tick_end.append((time.perf_counter(), stats.meshes_exported))
        if stats.meshes_exported:
            q.close()

    mesh_dir = os.path.join(OUT, "live_mesh")
    shutil.rmtree(mesh_dir, ignore_errors=True)
    producer = threading.Thread(target=produce)
    reset_counts()
    t0 = time.perf_counter()
    producer.start()
    stats = run_live(mapper, q, keep_alive=0.5, mesh_dir=mesh_dir,
                     max_ticks=400, on_tick=stop_after_export)
    wall = time.perf_counter() - t0
    producer.join()
    c = read_counts()
    n_iter = cfg.n_iter_per_frame
    trained = len(stats.losses)
    if trained != stats.ticks:
        raise AssertionError(f"{stats.ticks} ticks, {trained} trained")
    for k in ("train_grad", "train_adamw"):
        if c[k] != 2 * n_iter * trained:
            raise AssertionError(f"live: {k} {c[k]} launches, expected "
                                 f"2 x {n_iter} x {trained}")
    if stats.meshes_exported != 1 or not c["field_fwd"]:
        raise AssertionError(f"live: {stats.meshes_exported} exports, "
                             f"{c['field_fwd']} field_fwd launches")
    if not np.isfinite(stats.losses).all():
        raise AssertionError(f"live losses {stats.losses}")
    meshes = sorted(os.listdir(mesh_dir))
    # host ms of each tick (its train_frame and loss readback; the export
    # tick also its export), from one on_tick call to the next
    ms = [1000.0 * (b[0] - a[0]) for a, b in zip(tick_end, tick_end[1:])]
    export_tick = next(i for i, (_, e) in enumerate(tick_end) if e) - 1
    train_ms = sorted(m for i, m in enumerate(ms) if i != export_tick)
    res = {"ticks": stats.ticks, "idle_ticks": stats.idle_ticks,
           "frames_ingested": stats.frames_ingested, "wall_s": wall,
           "tick_ms": ms, "median_tick_ms": train_ms[len(train_ms) // 2],
           "export_tick_ms": ms[export_tick],
           "losses": stats.losses[:3] + stats.losses[-3:]}
    log(f"[14] run_live on {gpu}: {stats.ticks} ticks ({stats.idle_ticks} "
        f"idle), {stats.frames_ingested} of {n_frames} frames ingested, "
        f"every tick trained, one idle export ({len(meshes)} files); "
        f"{wall:.1f} s, a tick {res['median_tick_ms']:.1f} ms (median, "
        f"host clock), the export's tick {res['export_tick_ms']:.0f} ms; "
        f"launches {c}; losses first/last "
        f"{[round(x, 3) for x in res['losses']]}")
    return c, res


def occupancy_field_meshes(dev, gpu: str, grid: int = 128) -> tuple:
    """(c) ``OccupancyField`` at h=32 and h=128: its ``eval_points`` over
    the grid ``extract_mesh`` queries (grid^3 points, through K2) against
    the plain query on the same points (phase 6's tiers: occupancy within
    the sigmoid of alpha atol 3e-4, colour atol 2e-5), then
    ``extract_mesh`` at that grid: a non-empty mesh with finite vertices
    and coloured vertices. Returns (launch counts, results)."""
    import numpy as np
    import torch
    from vmap_tpu_torch.geometry.obb import OrientedBox
    from vmap_tpu_torch.kernels import ensemble as E
    from vmap_tpu_torch.models import OccupancyField
    from vmap_tpu_torch.ops.render import make_3d_grid

    res = {}
    reset_counts()
    for hidden, scale in ((32, 2.0), (128, 5.0)):
        field = OccupancyField.create(torch.Generator().manual_seed(hidden),
                                      hidden=hidden, scale=scale, device=dev)
        box = OrientedBox([0.1, -0.2, 0.05], np.eye(3), [1.0, 1.2, 0.8])
        tr = np.eye(4, dtype=np.float32)
        tr[:3, 3] = box.center
        pts = make_3d_grid((-1.0, 1.0), grid, transform=tr,
                           scale=np.asarray(box.extent / 1.8, np.float32),
                           device=dev).reshape(-1, 3)
        with torch.no_grad():   # the 0.5 level set through the box
            field.mlp["b_alpha"] -= field.raw_alpha(pts).median() / 10.0
        occ, col = field.eval_points(pts)
        pe, mlp_p = field.params()
        prepared = E.prepare_params({k: v.detach() for k, v in pe.items()},
                                    {k: v.detach() for k, v in mlp_p.items()},
                                    field.scale, hidden)
        with torch.no_grad():
            a_r, c_r = E.field_eval_reference(prepared, pts[None])
        occ_r = torch.sigmoid(a_r[0]).cpu().numpy()
        e_occ = float(np.abs(occ - occ_r).max())
        e_col = float(np.abs(col - c_r[0].cpu().numpy()).max())
        if not (e_occ <= 3e-4 * 0.25 + 1e-7 and e_col <= 2e-5):
            raise AssertionError(f"OccupancyField h={hidden}: occupancy "
                                 f"{e_occ}, colour {e_col} off plain")
        t0 = time.perf_counter()
        mesh = field.extract_mesh(box, grid_dim=grid)
        mesh_s = time.perf_counter() - t0
        if mesh is None or not len(mesh.faces) or \
                not np.isfinite(mesh.vertices).all() or \
                mesh.vertex_colors is None:
            raise AssertionError(f"OccupancyField h={hidden}: no mesh")
        res[f"h{hidden}"] = {"occ_max_abs_err": e_occ,
                             "colour_max_abs_err": e_col,
                             "faces": int(len(mesh.faces)),
                             "mesh_s": mesh_s}
        log(f"[14] OccupancyField h={hidden} on {gpu}: {grid}^3 query "
            f"through K2 against plain: occupancy max abs err {e_occ:.3e} "
            f"(tier 7.5e-5, the sigmoid of alpha atol 3e-4), colour "
            f"{e_col:.3e} (tier 2e-5); extract_mesh {len(mesh.faces)} faces "
            f"in {mesh_s:.2f} s")
    c = read_counts()
    if not c["field_fwd"]:
        raise AssertionError("OccupancyField launched no field_fwd")
    return c, res


def profile_and_trace(gpu: str, n_frames: int = 3) -> tuple:
    """(d) The trainer's ``--profile`` (stage times printed by the CLI)
    and ``--trace`` (no --profile, so no stage syncs) on ``n_frames``
    frames of phase 4's configuration; from the trace, the device time by
    kernel name and the device's idle share of the frames' window
    (``utils.profiling.trace_summary``). Returns (the traced run's launch
    counts, results)."""
    from vmap_tpu_torch import train
    from vmap_tpu_torch.utils.profiling import TRACE_FILE, trace_summary

    _, raw = synthetic_room0()
    cfg_path = os.path.join(OUT, "room0_profile.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    base = ["--config", cfg_path, "--max_frames", str(n_frames),
            "--device", "cuda"]
    log(f"[14] --profile, {n_frames} frames (each stage ends with a "
        "cuda synchronize):")
    train.main(base + ["--logdir", os.path.join(OUT, "train_profile"),
                       "--profile"])
    trace_dir = os.path.join(OUT, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    reset_counts()
    train.main(base + ["--logdir", os.path.join(OUT, "train_trace"),
                       "--trace", trace_dir])
    c = read_counts()
    s = trace_summary(os.path.join(trace_dir, TRACE_FILE), "frame")
    if not s["kernels"]:
        log("[14] the trace holds no device activity: device time and "
            "idle share not measured")
    else:
        top = ", ".join(f"{k[:60]} {v:.3f} ms ({s['launches'][k]})"
                        for k, v in list(s["kernels"].items())[:12])
        log(f"[14] --trace on {gpu}: {n_frames} frames, window "
            f"{s['window_ms']:.3f} ms, device busy {s['device_ms']:.3f} ms, "
            f"idle share {s['idle_share']:.4f}; device ms by kernel "
            f"(launches): {top}")
    return c, s


# --------------------------------------------------------------- phase 15
SCANNET_CAM = (640, 480, 577.59, 578.73)   # scene0000's depth camera


def scannet_layout(dev, gpu: str, n_frames: int = 12,
                   invalid: int = 5) -> tuple:
    """The ScanNet layout on the card, without OpenCV: the room (40
    objects) ray-traced at scene0000's 640 x 480 camera for ``n_frames``
    frames with frame ``invalid``'s pose -inf (``generate_dataset
    --format ScanNet``), then ``vmap_tpu_torch.train`` on
    configs/ScanNet/scene0000_vmap.json pointed at it (vis at RESUME_VIS:
    one export, at the last frame): finite losses, 2 x n_iter launches of
    each update kernel per trained frame, the invalid frame skipped, the
    export through K2; the loader's host ms a frame and the JPEG decode
    alone, at the layout's 640 x 480 and at ScanNet's 1296 x 968 colour
    (its decode and resize). Returns (launch counts, results)."""
    import numpy as np
    from vmap_tpu_torch import generate_dataset, train
    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.data.scannet import ScanNetDataset
    from vmap_tpu_torch.utils.image import resize_linear
    from vmap_tpu_torch.utils.jpeg import read_jpeg, write_jpeg

    w, h, fx, fy = SCANNET_CAM
    data = os.path.join(OUT, "scannet_room")
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.perf_counter()
    generate_dataset.main([data, "--format", "ScanNet", "--scene", "room",
                           "--frames", str(n_frames), "--width", str(w),
                           "--height", str(h), "--fx", str(fx), "--fy",
                           str(fy), "--invalid_pose_frames", str(invalid),
                           "--device", "cuda"])
    gen_s = time.perf_counter() - t0
    with open(os.path.join(REPO, "configs", "ScanNet",
                           "scene0000_vmap.json")) as f:
        raw = json.load(f)
    raw["dataset"]["path"] = data
    raw["vis"].update(RESUME_VIS)
    cfg_path = os.path.join(OUT, "scene0000_generated.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    logdir = os.path.join(OUT, "train_scannet")
    shutil.rmtree(logdir, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    mapper = train.main(["--config", cfg_path, "--logdir", logdir,
                         "--device", "cuda"])
    train_s = time.perf_counter() - t0
    c = read_counts()
    rows = [json.loads(line) for line in
            open(os.path.join(logdir, "train_log.jsonl"))]
    frames = [r["frame"] for r in rows]
    if frames != [i for i in range(n_frames) if i != invalid]:
        raise AssertionError(f"trained frames {frames}")
    losses = [r["loss"] for r in rows]
    if not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    n_iter = raw["render"]["iters_per_frame"]
    check_launches(c, 2 * n_iter * len(rows),
                   f"2 banks x {n_iter} x {len(rows)} trained frames")
    meshes = os.listdir(os.path.join(logdir, "scene_mesh"))
    # the loader alone: a frame, and the JPEG decode in it
    ds = ScanNetDataset(Config.from_json(cfg_path))
    t0 = time.perf_counter()
    for i in (0, 1, 2):
        ds[i]
    loader_ms = (time.perf_counter() - t0) * 1000.0 / 3
    t0 = time.perf_counter()
    for i in (0, 1, 2):
        rgb = read_jpeg(ds.color_paths[i])
    jpeg_ms = (time.perf_counter() - t0) * 1000.0 / 3
    big = os.path.join(OUT, "scannet_1296x968.jpg")
    write_jpeg(big, resize_linear(rgb, 1296, 968))
    t0 = time.perf_counter()
    for _ in range(3):
        big_rgb = read_jpeg(big)
    big_ms = (time.perf_counter() - t0) * 1000.0 / 3
    t0 = time.perf_counter()
    for _ in range(3):
        resize_linear(big_rgb, w, h)
    resize_ms = (time.perf_counter() - t0) * 1000.0 / 3
    res = {"generate_s": gen_s, "train_s": train_s, "frames": frames,
           "losses": losses, "n_objects": mapper.n_objects,
           "meshes": len(meshes), "loader_ms": loader_ms,
           "jpeg_640x480_ms": jpeg_ms, "jpeg_1296x968_ms": big_ms,
           "resize_1296x968_ms": resize_ms}
    log(f"[15] ScanNet layout on {gpu}: {n_frames} frames generated in "
        f"{gen_s:.1f} s (frame {invalid}'s pose -inf), trained frames "
        f"{frames} in {train_s:.1f} s, {mapper.n_objects} objects, losses "
        f"{[round(x, 3) for x in losses]}, launches {c}, {len(meshes)} "
        f"mesh files; loader {loader_ms:.1f} ms a frame (host), its JPEG "
        f"decode {jpeg_ms:.2f} ms at {w} x {h}; at 1296 x 968 the decode "
        f"{big_ms:.2f} ms and the resize to {w} x {h} {resize_ms:.2f} ms")
    return c, res


# --------------------------------------------------------------- phase 16
SH_AXES = {"obj": 2, "data": 2}   # (a): 4 ranks
SH_TRAINER_AXES = {"obj": 2}      # (b): 2 ranks
SH_FRAMES = 12                    # (b): then 2 resumed


def sh_draws(dev, st, cap: int):
    """Phase 16 (a)'s draws for both banks (every rank makes all of
    them, from the same seed, and keeps its rows)."""
    import torch
    from vmap_tpu_torch.core import step as ST
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    d_o = ST.torch_draws(gen, ST.draw_shapes(
        cap, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, st.px_block,
        st.sample_reuse), dev)
    d_b = ST.torch_draws(gen, ST.draw_shapes(
        1, st.n_iter * st.win_bg, st.n_px_bg, st.n_b2s_bg, st.n_bins,
        st.px_block_bg), dev)
    return d_o, d_b


def rank_frames(spec_path: str) -> int:
    """One rank of phase 16 (a): phase 14 (a)'s half-unknown workload,
    this rank's object rows of it (``parallel.sharding``, as the Mapper
    takes them) through ``step.frame_step`` on the kernel path, the loss
    summed over the obj group (``mapper.ShardedLoss``); n_iter=1 once,
    n_iter=20 three times (the last two timed, CUDA events around the
    frame and its loss's read). The object rows gathered over the group
    after each, written with the background by rank 0. Prints one JSON
    line: its rows, launch counts, frame times and any jax / vmap_tpu
    module it imported."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.core.mapper import ShardedLoss
    from vmap_tpu_torch.kernels import _build
    from vmap_tpu_torch.parallel import distributed as D
    from vmap_tpu_torch.parallel import sharding as SH
    from vmap_tpu_torch.parallel.launch import foreign_modules

    with open(spec_path) as f:
        spec = json.load(f)
    rank, _ = D.init_from_env()
    dev = D.rank_device("cuda")
    _build.load()          # the parent's build, from the cache
    mesh = SH.mesh_from_axes(spec["axes"])
    st0, bo, bb, pool, obj_tab, obj_ids, bg_tab = bench_workload(
        dev, unknown=0.5)
    lo, hi = mesh.slot_range(rank, bo.capacity)
    group = SH.obj_group(mesh, rank)
    out = {"rank": rank, "slots": [lo, hi], "frame_ms": [], "launches": {}}
    for n_iter in (1, 20):
        st = dataclasses.replace(st0, n_iter=n_iter, use_fused_frame=True)
        d_o, d_b = sh_draws(dev, st, bo.capacity)
        args = (SH.place_bank(bo, lo, hi), bb, *pool,
                SH.place_tables(obj_tab, lo, hi), obj_ids[lo:hi], bg_tab,
                SH.place_draws(d_o, lo, hi), d_b)
        reset_counts()
        for rep in range(1 if n_iter == 1 else 3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            b_o, b_b, met = ST.frame_step(st, *args)
            loss = ShardedLoss(met, group).value(0)   # a collective
            t1.record()
            torch.cuda.synchronize()
            if rep:
                out["frame_ms"].append(t0.elapsed_time(t1))
        out["launches"][str(n_iter)] = read_counts()
        gathered = {f: D.gather_rows(getattr(b_o, f), group)
                    for f in ("flat", "m", "v")}
        if rank == 0:
            torch.save({"obj": gathered,
                        "bg": {f: getattr(b_b, f) for f in ("flat", "m",
                                                             "v")},
                        "loss": loss}, spec["out"].format(n_iter=n_iter))
    out["foreign"] = foreign_modules()
    print(json.dumps(out), flush=True)
    D.shutdown()
    return 0


def sharded_frames(dev, gpu: str) -> tuple:
    """(a) Phase 5's workload on phase 14 (a)'s half-unknown pool (no
    active slot's mask empty: the empty-mask rule acts per rank, ROADMAP
    §3) at ``SH_AXES``, 4 ranks on this one card, against the one-process
    kernel frame on the same draws: at n_iter=1 every slot's and the
    background's parameters and moments within phase 3's tier, the loss
    within rtol 2e-3; at n_iter=20 finite, the final loss within rtol
    0.25; each rank launching train_grad and train_adamw twice an
    iteration (its object rows and the background). Returns (the ranks'
    summed launch counts, results)."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.parallel import launch

    st0, bo, bb, pool, obj_tab, obj_ids, bg_tab = bench_workload(
        dev, unknown=0.5)
    ref = {}
    for n_iter in (1, 20):
        st = dataclasses.replace(st0, n_iter=n_iter, use_fused_frame=True)
        d_o, d_b = sh_draws(dev, st, bo.capacity)
        ro, rb, met = ST.frame_step(st, bo, bb, *pool, obj_tab, obj_ids,
                                    bg_tab, d_o, d_b)
        ref[n_iter] = (ro, rb, float(met["loss"]))
    spec = os.path.join(OUT, "sharded_frames.json")
    with open(spec, "w") as f:
        json.dump({"axes": SH_AXES, "out": os.path.join(
            OUT, "sharded_frames_n{n_iter}.pt")}, f)
    n_ranks = SH_AXES["obj"] * SH_AXES["data"]
    t0 = time.perf_counter()
    ranks = launch.collect(launch.spawn(n_ranks, lambda r: [
        sys.executable, os.path.abspath(__file__), "--rank-frames", spec]),
        timeout=600)
    wall = time.perf_counter() - t0
    res = {"ranks": ranks, "wall_s": wall}
    for n_iter, (ro, rb, loss) in ref.items():
        got = torch.load(os.path.join(OUT, f"sharded_frames_n{n_iter}.pt"),
                         map_location=dev)
        rel = abs(got["loss"] - loss) / abs(loss)
        res[f"n_iter{n_iter}_loss"] = [got["loss"], loss]
        for bank, want in (("obj", ro), ("bg", rb)):
            for f in ("flat", "m", "v"):
                g, w = got[bank][f], getattr(want, f)
                assert bool(torch.isfinite(g).all()), f"{bank}.{f}"
                if n_iter == 1:
                    res[f"n_iter1_{bank}_{f}_max_abs_err"] = rel_close(
                        g, w, RTOL_SEM, 1e-3 * float(w.abs().max()),
                        f"sharded frame n_iter=1 {bank}.{f}")
        if not rel < (RTOL_SEM if n_iter == 1 else RTOL_FULL):
            raise AssertionError(f"sharded frame n_iter={n_iter}: loss "
                                 f"{got['loss']} against {loss}")
        log(f"[16] sharded frame n_iter={n_iter} ({SH_AXES}, {n_ranks} "
            f"ranks): loss {got['loss']:.6f} against one process "
            f"{loss:.6f} (rel {rel:.3e})" + (
                "; every slot and the background within rtol 2e-3 + 1e-3 "
                "of scale (obj flat "
                f"{res['n_iter1_obj_flat_max_abs_err']:.3e}, m "
                f"{res['n_iter1_obj_m_max_abs_err']:.3e}, v "
                f"{res['n_iter1_obj_v_max_abs_err']:.3e})"
                if n_iter == 1 else ""))
    summed = {}
    for r in ranks:
        if r["foreign"]:
            raise AssertionError(f"rank {r['rank']} imported "
                                 f"{r['foreign']}")
        for n_iter, c in r["launches"].items():
            frames = 1 if n_iter == "1" else 3
            for k in ("train_grad", "train_adamw"):
                if c[k] != 2 * int(n_iter) * frames:
                    raise AssertionError(f"rank {r['rank']} n_iter={n_iter}"
                                         f": {k} launched {c[k]} times")
            for k, v in c.items():
                summed[k] = summed.get(k, 0) + v
        log(f"[16] rank {r['rank']} (slots {r['slots']}): train_grad / "
            "train_adamw launches " + ", ".join(
                f"n_iter={n} {c['train_grad']} / {c['train_adamw']}"
                for n, c in r["launches"].items()) + "; n_iter=20 frame "
            f"{[round(x, 3) for x in r['frame_ms']]} ms, {n_ranks} ranks "
            f"time-slicing one {gpu}")
    log(f"[16] sharded frames: {n_ranks} ranks in {wall:.1f} s (start-up "
        "included)")
    return summed, res


def sharded_trainer(gpu: str) -> tuple:
    """(b) ``vmap_tpu_torch.train`` as ``SH_TRAINER_AXES`` ranks on phase
    4's configuration (its export at RESUME_VIS: the losses do not depend
    on it) for SH_FRAMES frames with --save_ckpt, each rank with a logdir
    of its own, then --resume from the primary's checkpoint for 2 more:
    all SH_FRAMES + 2 per-frame losses against an uninterrupted
    one-process run of as many frames, made here, within rtol 2e-3 (so
    the resumed frames too: a resume that lost the bank, the Adam state
    or a generator's state would part from it); the meshes, log and
    checkpoints written by rank 0 only (rank 1's logdir never made);
    every rank launching train_grad and train_adamw 2 x n_iter a frame
    and field_fwd in its export; no rank importing jax. Returns (the
    first run's launch counts summed over the ranks, results)."""
    import numpy as np
    from vmap_tpu_torch import train
    from vmap_tpu_torch.parallel import launch

    n_frames = SH_FRAMES + 2
    _, raw = synthetic_room0(RESUME_VIS)
    n_iter = raw["render"]["iters_per_frame"]
    cfg_ref = os.path.join(OUT, "sharded_reference.json")
    with open(cfg_ref, "w") as f:
        json.dump(raw, f, indent=1)
    ref_dir = os.path.join(OUT, "train_sharded_reference")
    shutil.rmtree(ref_dir, ignore_errors=True)
    t0 = time.perf_counter()
    train.main(["--config", cfg_ref, "--logdir", ref_dir, "--max_frames",
                str(n_frames), "--device", "cuda"])
    ref_s = time.perf_counter() - t0
    want = [json.loads(line)["loss"]
            for line in open(os.path.join(ref_dir, "train_log.jsonl"))]
    raw["tpu"]["mesh_axes"] = SH_TRAINER_AXES
    cfg = os.path.join(OUT, "sharded_room0.json")
    with open(cfg, "w") as f:
        json.dump(raw, f, indent=1)
    base = os.path.join(OUT, "train_sharded")
    for r in range(2):
        shutil.rmtree(f"{base}_r{r}", ignore_errors=True)
    state = os.path.join(f"{base}_r0", "ckpt", "state")

    def argv(extra: list):
        return lambda r: [sys.executable, "-m",
                          "vmap_tpu_torch.parallel.launch", base, "--config",
                          cfg, "--device", "cuda", *extra]

    n_ranks = SH_TRAINER_AXES["obj"]
    first = launch.collect(launch.spawn(n_ranks, argv([
        "--max_frames", str(SH_FRAMES), "--save_ckpt"])), timeout=900)
    second = launch.collect(launch.spawn(n_ranks, argv([
        "--max_frames", str(n_frames), "--resume", state])), timeout=600)
    for o in first + second:
        if o["foreign"]:
            raise AssertionError(f"rank {o['rank']} imported "
                                 f"{o['foreign']}")
    if os.path.exists(f"{base}_r1"):
        raise AssertionError("rank 1 wrote a logdir")
    for o in first:
        c = o["launches"]
        check_launches(c, 2 * n_iter * SH_FRAMES,
                       f"rank {o['rank']}: 2 banks x {n_iter} per frame")
        log(f"[16] trainer rank {o['rank']} (slots {o['slots']}): "
            f"{SH_FRAMES} frames in {o['wall_s']:.1f} s (start-up "
            f"included; {n_ranks} ranks time-slicing one {gpu}), launches "
            f"train_grad {c['train_grad']}, train_adamw {c['train_adamw']}"
            f", field_stage {c['field_stage']}, field_fwd {c['field_fwd']}")
    rows = [json.loads(line)
            for line in open(os.path.join(f"{base}_r0", "train_log.jsonl"))]
    if [r["frame"] for r in rows] != list(range(n_frames)):
        raise AssertionError(f"sharded log frames "
                             f"{[r['frame'] for r in rows]}")
    if len(want) != n_frames:
        raise AssertionError(f"one-process log of {len(want)} frames")
    got = [r["loss"] for r in rows]
    if not all(np.isfinite(got)):
        raise AssertionError(f"sharded losses {got}")
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if not max(rel) < RTOL_SEM:
        raise AssertionError(f"sharded trainer losses {got} against one "
                             f"process {want}")
    meshes = sorted(os.listdir(os.path.join(f"{base}_r0", "scene_mesh")))
    for f in (SH_FRAMES - 1, n_frames - 1):
        for obj in (0, 1, 2):
            p = os.path.join(f"{base}_r0", "scene_mesh",
                             f"frame_{f}_obj{obj}.obj")
            if not os.path.getsize(p) > 0:
                raise AssertionError(f"{p} is empty")
    log(f"[16] sharded trainer ({SH_TRAINER_AXES}): losses "
        f"{[round(x, 4) for x in got]}, {SH_FRAMES} frames and 2 resumed "
        f"against an uninterrupted one-process run of {n_frames} frames "
        f"({ref_s:.1f} s) rel {max(rel):.3e} at most (the resumed frames "
        f"{max(rel[SH_FRAMES:]):.3e}); rank 0 wrote {len(meshes)} mesh "
        "files, rank 1 none")
    summed = {}
    for o in first:
        for k, v in o["launches"].items():
            summed[k] = summed.get(k, 0) + v
    return summed, {"losses": got, "one_process": want, "max_rel": max(rel),
                    "max_rel_resumed": max(rel[SH_FRAMES:]),
                    "ranks": first, "resumed": second}


# --------------------------------------------------------------- phase 17
CAL_PROBES = (5, 12, 23)


def room_data(dev) -> str:
    """Phase 13's generated room (its Replica files), or the same room
    generated here when phase 13 did not run in this call."""
    data = os.path.join(OUT, "room", "data")
    if os.path.isdir(data):
        return data
    from vmap_tpu_torch.generate_dataset import main as generate
    data = os.path.join(OUT, "room17", "data")
    shutil.rmtree(data, ignore_errors=True)
    generate([data, "--scene", "room", "--objects", str(ROOM_OBJECTS),
              "--frames", str(ROOM_FRAMES), "--width", str(ROOM_W),
              "--height", str(ROOM_H), "--fx", str(ROOM_F), "--fy",
              str(ROOM_F), "--device", str(dev)])
    return data


def calibration(dev, gpu: str) -> tuple:
    """The port's int8 calibration (``vmap_tpu_torch.calibrate_int8_scales``)
    on phase 13's room (ROOM_FRAMES frames at 1200 x 680) through
    room0_imap.json (one h=256 scene field, the field phase 11's iMAP frame
    trains), probes at CAL_PROBES; then that iMAP frame (``imap_workload``,
    n_iter=1, one draw) through the kernel path under float32, under
    int8_static at the default scales and under int8_static at the
    suggested ones, each gradient's error against float32's in norm and
    their ratio; and train_grad under int8_static at the suggested scales
    against its plain version at phase 3's iMAP shape in phase 11's tiers
    (``check_policy_tiers``), both reading the scales from the
    environment. Returns (the calibration run's launch counts, results)."""
    import dataclasses
    import torch
    from vmap_tpu_torch import calibrate_int8_scales as cal
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.ops import quant as Q

    data = room_data(dev)
    with open(os.path.join(REPO, "configs", "Replica",
                           "room0_imap.json")) as f:
        raw = json.load(f)
    raw["dataset"]["path"] = data
    raw["camera"].update(w=ROOM_W, h=ROOM_H, fx=ROOM_F, fy=ROOM_F,
                         cx=(ROOM_W - 1) / 2, cy=(ROOM_H - 1) / 2)
    raw["tpu"]["frame_pool_size"] = 64
    cfg = os.path.join(OUT, "calibration_imap.json")
    with open(cfg, "w") as f:
        json.dump(raw, f, indent=1)
    reset_counts()
    t0 = time.perf_counter()
    out = cal.main(["--config", cfg, "--max_frames", str(ROOM_FRAMES),
                    "--probes", ",".join(map(str, CAL_PROBES)),
                    "--device", str(dev), "--out",
                    os.path.join(OUT, "calibration.json")])
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_iter = raw["render"]["iters_per_frame"]
    for k in ("train_grad", "train_adamw"):
        if launches[k] != n_iter * ROOM_FRAMES:
            raise AssertionError(f"calibration run: {k} launched "
                                 f"{launches[k]} times")
    sug = out["suggested"]
    if not all(math.isfinite(v) and v > 0 for v in sug.values()):
        raise AssertionError(f"suggested scales {sug}")
    log(f"[17] calibration of room0_imap on the room ({ROOM_FRAMES} "
        f"frames, probes at {list(CAL_PROBES)}) in {wall:.1f} s on {gpu}: "
        f"{json.dumps(out['summary'])}; suggested {json.dumps(sug)} "
        f"(defaults {dict(zip(Q.Q8_SCALE_VARS, Q.Q8_SCALES))})")

    st0, bank, pool, tab, obj_ids = imap_workload(dev)
    st1 = dataclasses.replace(st0, n_iter=1, use_fused_frame=True)
    gen = torch.Generator(device=dev)

    def grad(policy: str):
        gen.manual_seed(0)
        d = ST.torch_draws(gen, ST.draw_shapes(
            1, st1.win, st1.n_px, st1.n_b2s, st1.n_bins, st1.px_block), dev)
        b, _, met = ST.frame_step(dataclasses.replace(
            st1, compute_dtype=policy), bank, None, *pool, tab, obj_ids,
            None, d, None)
        return grads_from_m(b, bank.m), float(met["loss"])

    saved = {k: os.environ.get(k) for k in Q.Q8_SCALE_VARS}
    try:
        for k in Q.Q8_SCALE_VARS:
            os.environ.pop(k, None)
        g32, l32 = grad("float32")
        g_def, l_def = grad("int8_static")
        os.environ.update({k: str(v) for k, v in sug.items()})
        if Q.static_scales() != tuple(sug.values()):
            raise AssertionError("the suggested scales did not reach "
                                 "ops.quant.static_scales")
        g_sug, l_sug = grad("int8_static")
        failures: list = []
        tiers = check_policy_tiers(
            "imap", conditioned_bank(1, 1, 256, 5.0, 3, dev), 14, 4800, dev,
            "int8_static", failures, phase="17")
        if failures:
            raise AssertionError("; ".join(failures))
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    e_def = float((g_def - g32).norm() / g32.norm())
    e_sug = float((g_sug - g32).norm() / g32.norm())
    if not float((g_sug - g_def).norm()) > 0:
        raise AssertionError("the suggested scales left the frame as the "
                             "defaults do")
    res = {"summary": out["summary"], "suggested": sug, "wall_s": wall,
           "imap_grad_err_default": e_def, "imap_grad_err_suggested": e_sug,
           "ratio": e_sug / e_def,
           "imap_loss": {"float32": l32, "default": l_def,
                         "suggested": l_sug},
           "kernel_vs_plain_suggested": tiers}
    log(f"[17] iMAP frame (n_iter=1) on {gpu}: int8_static gradient error "
        f"against float32, in norm over float32's: defaults {e_def:.4e}, "
        f"suggested {e_sug:.4e}, ratio {e_sug / e_def:.4f}; loss float32 "
        f"{l32:.6f}, defaults {l_def:.6f}, suggested {l_sug:.6f}; kernel "
        f"against plain under the suggested scales: worst "
        f"{tiers['max_abs_err']:.3e} of scale, error norm "
        f"{tiers['err_over_policy_effect']:.3e} of the policy's effect")
    return launches, res


# --------------------------------------------------------------- phase 10
def grads_from_m(bank_new, m0):
    """The gradient of a one-iteration frame, read from its first AdamW
    moment m' = 0.9 m + 0.1 g."""
    return (bank_new.m.double() - 0.9 * m0.double()) / 0.1


def policy_errors(bank, got, want, ref_f32) -> dict:
    """Per parameter tensor over the active slots: the largest error
    |got - want|max over the tensor's scale |want|max, the error's norm
    |got - want|_2, and the policy's effect |ref_f32 - want|_2 with the
    norm of ``want`` for scale."""
    act = bank.active
    res = {}
    for _, nm, _, off, size in bank.spec.names:
        g, w, r = (x[act][:, off:off + size] for x in (got, want, ref_f32))
        res[nm] = {"max_rel": float((g - w).abs().max())
                   / max(float(w.abs().max()), 1e-30),
                   "err": float((g - w).norm()),
                   "effect": float((r - w).norm()),
                   "norm": float(w.norm())}
    return res


# the largest kernel-against-plain error of a gradient tensor, over its
# scale, at n_iter=1: a value within f32 noise of a rounding boundary
# rounds to neighbouring values in the two versions (sin / cos and the
# point arithmetic differ by an ulp): a 2^-8 step of one term under the bf16
# policies, one quantum (1/127 of a tensor's scale) of one element under
# the int8 ones, which then moves the products that read it
MAX_REL = {**{p: 1e-2 for p in BF16_POLICIES},
           **{p: 5e-2 for p in INT8_POLICIES}}


def check_policy_tiers(name, bank, S, n_per, dev, policy,
                       failures: list, phase: str = "10") -> dict:
    """train_grad under ``policy`` against its plain version. n_iter=1, on
    the gradients (read from the first moment): every tensor's largest
    error within MAX_REL of its scale; where the policy moves a tensor
    (plain policy against plain f32, norm above 1e-3 of the tensor's), the
    kernel's error at least 10x smaller in norm than the policy's effect,
    and over all tensors together too; losses within rtol 2e-3 and, where
    the policy quantises or rounds the forward (bfloat16, int8*), at most a
    tenth of the policy's effect on them. n_iter=20: finite, the final
    summed loss within rtol 0.25; inactive slots bit-identical. Failures of
    the tiers are appended to ``failures`` (the caller raises after every
    shape has run)."""
    import torch
    from vmap_tpu_torch.kernels import train_step as K
    cap = bank.flat.shape[0]
    inact = ~bank.active
    batch = random_batch(cap, n_per, S, 2, dev)
    f32_b, f32_l = K.fused_frame_reference(bank, batch, 1, n_per, LR, WD, CS,
                                           OSC)
    rb, rl = K.fused_frame_reference(bank, batch, 1, n_per, LR, WD, CS, OSC,
                                     policy=policy)
    kb, kl = K.fused_frame(bank, batch, 1, n_per, LR, WD, CS, OSC,
                           policy=policy)
    torch.cuda.synchronize()
    errs = policy_errors(bank, grads_from_m(kb, bank.m),
                         grads_from_m(rb, bank.m),
                         grads_from_m(f32_b, bank.m))
    tag = f"{name}/{policy}"
    bar = MAX_REL[policy]
    for nm, e in errs.items():
        ratio = e["err"] / max(e["effect"], 1e-30)
        log(f"[{phase}] {tag} d{nm}: kernel-plain max {e['max_rel']:.3e} of "
            f"scale, norm {e['err']:.3e}; policy effect norm "
            f"{e['effect']:.3e} (tensor norm {e['norm']:.3e}); ratio "
            f"{ratio:.3e}")
        if not e["max_rel"] <= bar:
            failures.append(f"{tag} d{nm}: max error {e['max_rel']:.3e} of "
                            f"scale above {bar}")
        if e["effect"] > 1e-3 * e["norm"] and not ratio <= 0.1:
            failures.append(f"{tag} d{nm}: error norm {ratio:.3e} of the "
                            "policy's effect, above 0.1")
    g_err = max(e["max_rel"] for e in errs.values())
    ratio = (math.sqrt(sum(e["err"] ** 2 for e in errs.values()))
             / math.sqrt(sum(e["effect"] ** 2 for e in errs.values())))
    if not ratio <= 0.1:
        failures.append(f"{tag}: error norm {ratio:.3e} of the policy's "
                        "effect over all tensors, above 0.1")
    l_err = float((kl - rl).abs().max())
    l_effect = float((rl - f32_l).abs().max())
    bad = (kl - rl).abs() > 1e-6 + RTOL_SEM * rl.abs()
    if bool(bad.any()):
        failures.append(f"{tag}: losses beyond rtol 2e-3 ({l_err:.3e})")
    if policy != "bwd_bf16" and not l_err <= 0.1 * l_effect:
        failures.append(f"{tag}: loss error {l_err:.3e} against the "
                        f"policy's effect {l_effect:.3e}")
    for f in ("flat", "m", "v"):
        assert torch.equal(getattr(kb, f)[inact], getattr(bank, f)[inact])

    batch20 = random_batch(cap, 20 * n_per, S, 2, dev)
    rb, rl = K.fused_frame_reference(bank, batch20, 20, n_per, LR, WD, CS,
                                     OSC, policy=policy)
    kb, kl = K.fused_frame(bank, batch20, 20, n_per, LR, WD, CS, OSC,
                           policy=policy)
    torch.cuda.synchronize()
    for t in (kb.flat, kb.m, kb.v, kl):
        assert bool(torch.isfinite(t).all()), f"{tag}: non-finite"
    a, b = float(kl[:, -1].sum()), float(rl[:, -1].sum())
    if not abs(a - b) / max(abs(b), 1e-9) < RTOL_FULL:
        failures.append(f"{tag} n_iter=20 final loss {a} vs plain {b}")
    log(f"[{phase}] {tag}: n_iter=1 gradient kernel-plain worst {g_err:.3e} "
        f"of scale, error norm {ratio:.3e} of the policy's effect; loss "
        f"kernel-plain {l_err:.3e}, policy effect {l_effect:.3e}; "
        f"n_iter=20 final loss {a:.6f} vs plain {b:.6f}")
    return {"max_abs_err": g_err, "err_over_policy_effect": ratio,
            "loss_err": l_err, "loss_policy_effect": l_effect}


def quantised_copy_errors(bank, fl, params) -> list:
    """Where train_quant_w's s8 copy (fl.wq, fl.wscale) of ``params``
    differs from the plain ``ops.quant.quant_weights`` of the same
    parameters in the kernel's layout (``kernels.train_step.stage_q8``:
    each tensor's values, its transpose and their zero padding), over the
    active slots: the same f32 operations, so they must be equal. Returns
    the names of the tensors (or "scales") that differ."""
    import torch
    from vmap_tpu_torch.kernels import train_step as K
    from vmap_tpu_torch.ops import quant as Q
    act, h = bank.active, bank.spec.hidden
    _, w = bank.spec.unflatten(params[act])
    want = Q.quant_weights(w, h)
    staged, got = K.stage_q8(want, h), fl.wq[act]
    layout, size = K.q8_layout(h)
    ends = [off for _, _, _, off, _ in layout[1:]] + [size]
    bad = [name for (name, _, _, off, _), end in zip(layout, ends)
           if not torch.equal(got[:, off:end], staged[:, off:end])]
    scales = torch.cat([want[n][1].reshape(-1, 1) for n in Q.QW_NAMES], 1)
    if not torch.equal(fl.wscale[act], scales):
        bad.append("scales")
    return bad


def quant_w_bound(bank) -> dict:
    """train_quant_w's bound on what the function (ops.quant.quant_weights)
    needs: the active slots' nine weight tensors read in f32 and written
    once as s8, and nine f32 scales written per slot. The transposes the
    kernel also writes (a layout the int8 tile reads) are not the
    function's work: ``transpose_bytes`` gives them apart."""
    n_act, h = int(bank.active.sum()), bank.spec.hidden
    n_w = 87 * h + 2 * h * h + (h + 87) * h + h + (h + 42) * h + 3 * h
    nbytes = n_act * (4 * n_w + n_w + 4 * 9)
    return {**bound(nbytes), "bytes": nbytes,
            "transpose_bytes": n_act * n_w}


def check_policies(dev, stats: dict, shapes=SHAPES,
                   policies=BF16_POLICIES, phase: str = "10") -> None:
    """Phases 10 and 11, first part: each policy at each shape of phase 3,
    in its tiers, then one iteration's train_grad timed against its plain
    version (by_shape keys ``<shape>/<policy>``); the weights' rounded
    (bf16) or quantised (int8) copy checked after an update, and under the
    int8 policies train_quant_w timed against its plain version."""
    import torch
    from vmap_tpu_torch.core.bank import apply_adamw
    from vmap_tpu_torch.kernels import train_step as K
    from vmap_tpu_torch.ops import quant as Q
    from vmap_tpu_torch.probes import PEAK_BYTES
    failures: list = []
    for name, cap, n_act, h, n_per, S, scale in shapes:
        bank = conditioned_bank(cap, n_act, h, scale, 0, dev)
        batch = random_batch(cap, n_per, S, 1, dev)
        for policy in policies:
            res = check_policy_tiers(name, bank, S, n_per, dev, policy,
                                     failures, phase)
            fl = K.FrameLaunch(bank, batch, 1, n_per, CS, OSC, policy)
            if policy in INT8_POLICIES:
                # the copy FrameLaunch makes before the first iteration
                bad = quantised_copy_errors(bank, fl, bank.flat)
                if bad:
                    failures.append(f"{name}/{policy}: train_quant_w's first "
                                    f"copy differs from plain in {bad}")
                geom = fl.geom
                smem = K.q8_smem_bytes(h, geom.rays_per_tile, S, policy)
                if fl.lib.vmap_q8_smem(h, int(Q.q8_backward(policy)), S,
                                       geom.rays_per_tile) != smem:
                    failures.append(f"{name}/{policy}: q8_smem_bytes "
                                    "disagrees with the library's")
                res.update(tile_points=geom.rays_per_tile * S,
                           blocks_per_slot=geom.blocks,
                           scratch_bytes=geom.scratch_bytes,
                           smem_bytes=smem)
                log(f"[{phase}] {name}/{policy}: int8 tile "
                    f"{geom.rays_per_tile} rays ({geom.rays_per_tile * S} "
                    f"points, the scale granularity), {geom.n_tiles} tiles "
                    f"over {geom.blocks} blocks per slot; scratch "
                    f"{geom.rows} rows, {geom.scratch_bytes} bytes "
                    f"({geom.scratch_bytes / 2**20:.1f} MiB); dynamic shared "
                    f"memory {smem} bytes a block")
            res["ms"] = time_cuda(lambda: fl.grad(bank.flat, 0), 20)
            res["plain_ms"] = time_cuda(
                lambda: K.iteration_loss_grad(bank, batch, CS, OSC,
                                              policy=policy), 20)
            res.update(grad_bound(bank, n_per, S, policy))
            stats.setdefault("train_grad", {})[f"{name}/{policy}"] = res
            # train_adamw keeps the staged bf16 pieces that train_grad
            # reads under a float policy and int8_fwd / int8_static_fwd:
            # after an update they are the updated parameters'
            # (K.stage_weights); under an int8 policy train_quant_w makes
            # the s8 copy from the updated parameters
            p, m, v = (t.clone() for t in (bank.flat, bank.m, bank.v))
            fl.grad(p, 0)
            fl.adamw(p, m, v, torch.empty(cap, 1, device=dev), 0, LR, WD)
            if fl.ws is not None and not (
                    torch.equal(fl.ws, K.stage_weights(p, bank.spec))
                    and not torch.equal(p, bank.flat)):
                failures.append(f"{name}/{policy}: train_adamw's staged "
                                "copy is not the updated parameters'")
            if policy in INT8_POLICIES:
                fl.quant_weights(p)
                bad = quantised_copy_errors(bank, fl, p)
                if bad or torch.equal(p, bank.flat):
                    failures.append(f"{name}/{policy}: train_quant_w's copy "
                                    f"differs from plain in {bad}")
                if policy == "int8":
                    _, w = bank.spec.unflatten(p)
                    qw = stats.setdefault("train_quant_w", {})[name] = {
                        "max_abs_err": 0.0 if not bad else None,
                        **quant_w_bound(bank),
                        "ms": time_device(lambda: fl.quant_weights(p), 50),
                        "host_paced_ms": time_cuda(
                            lambda: fl.quant_weights(p), 50),
                        "plain_ms": time_cuda(
                            lambda: K.stage_q8(Q.quant_weights(w, h), h),
                            50)}
                    qw["tb_s"] = qw["bytes"] / (qw["ms"] * 1e-3) / 1e12
                    # under int8 FrameLaunch makes no staged bf16 pieces
                    # and train_adamw writes none (no kernel of the policy
                    # reads them): the work that saves, the pieces made
                    # (stage_weights, once a frame) and the launch writing
                    # them, as under a float policy
                    losses = torch.empty(cap, 1, device=dev)
                    adam = lambda: fl.adamw(p, m, v, losses, 0, LR, WD)
                    ad = {**adamw_bound(bank, geom.blocks, pieces=False),
                          "ms": time_device(adam, 50),
                          "plain_ms": time_cuda(lambda: apply_adamw(
                              bank, fl.grad_part.sum(1)[:, fl.row_index],
                              LR, WD), 20)}
                    res["train_adamw"] = ad
                    res["stage_weights_ms"] = time_cuda(
                        lambda: K.stage_weights(p, bank.spec), 20)
                    fl.ws = K.stage_weights(p, bank.spec)
                    res["train_adamw_staged_ms"] = time_cuda(adam, 50)
                    fl.ws = None
                    log(f"[{phase}] {name}/int8: train_quant_w ms kernel/"
                        f"plain/bound {qw['ms']:.4f}/{qw['plain_ms']:.4f}/"
                        f"{qw['bound_ms']:.5f} (launched back to back; "
                        f"paced by the host {qw['host_paced_ms']:.4f}; "
                        f"the transposes "
                        f"{qw['transpose_bytes']} bytes more, "
                        f"{qw['transpose_bytes'] / PEAK_BYTES * 1e3:.5f} ms "
                        f"at the HBM rate), {qw['tb_s']:.3f} TB/s over the "
                        f"function's {qw['bytes']} bytes; plan "
                        f"{fl.plan}; "
                        f"{adamw_rate(ad)}, writing the staged "
                        f"pieces {res['train_adamw_staged_ms']:.4f}; "
                        f"stage_weights {res['stage_weights_ms']:.4f} ms")
            log(f"[{phase}] {name}/{policy}: train_grad ms kernel/plain/bound "
                f"{res['ms']:.4f}/{res['plain_ms']:.4f}/"
                f"{res['bound_ms']:.4f} ({res['bound_by']})")
    if failures:
        raise AssertionError("policy tiers: " + "; ".join(failures))


def check_reuse_bit_identity(dev, shape=SHAPES[0], phase: str = "10") -> None:
    """The kernel frame under sample_reuse 4 on the untiled batch (pixels
    for 5 of 20 iterations, z for all 20) against the kernel frame on the
    same batch tiled: losses, parameters and moments bit-identical, at
    ``shape`` (the object shape), f32 and bwd_bf16."""
    import torch
    from vmap_tpu_torch.kernels import train_step as K
    name, cap, n_act, h, n_per, S, scale = shape
    bank = conditioned_bank(cap, n_act, h, scale, 0, dev)
    n_iter, R = 20, 4
    full = random_batch(cap, n_iter * n_per, S, 6, dev)
    n_eff = n_iter // R * n_per
    untiled = {k: (v if k == "z" else v[:, :n_eff].contiguous())
               for k, v in full.items()}
    tiled = {k: (v if k == "z" else
                 v.repeat(1, R, *([1] * (v.dim() - 2))))
             for k, v in untiled.items()}
    for policy in ("float32", "bwd_bf16"):
        ub, ul = K.fused_frame(bank, untiled, n_iter, n_per, LR, WD, CS, OSC,
                               policy=policy, reuse=R)
        tb, tl = K.fused_frame(bank, tiled, n_iter, n_per, LR, WD, CS, OSC,
                               policy=policy)
        torch.cuda.synchronize()
        for what, a, b in (("losses", ul, tl), ("flat", ub.flat, tb.flat),
                           ("m", ub.m, tb.m), ("v", ub.v, tb.v)):
            if not torch.equal(a, b):
                raise AssertionError(f"reuse {R} {policy}: {what} differ "
                                     "from the tiled batch's")
        log(f"[{phase}] {name}/{policy}: sample_reuse {R} frame bit-identical "
            f"to the tiled batch's ({n_iter} iterations, final loss "
            f"{float(ul[:, -1].sum()):.6f})")


# the full-width vMAP frame's (policy, sample_reuse) configurations of
# phases 10 and 11; each phase times float32 with and without reuse beside
# its policies in the same call
BF16_FRAMES = (("float32", 1), ("float32", 4), ("bwd_bf16", 4),
               ("bfloat16", 4))
INT8_FRAMES = (("float32", 1), ("float32", 4), ("int8", 4), ("int8_fwd", 4),
               ("int8_static", 4), ("int8_static_fwd", 4), ("int8", 1),
               ("int8_static", 1))


def policy_full_width(dev, gpu: str, configs=BF16_FRAMES, frames: int = 3,
                      phase: str = "10") -> dict:
    """Phase 5's vMAP frame through the kernel path under each (policy,
    sample_reuse) of ``configs``: ``frames`` frames of each after a
    warm-up frame, in turns (the list, then the list reversed), timed with
    CUDA events around the frame and a data-dependent readback of its
    loss. Returns {config: {"frame_ms", "losses", "median_frame_ms"}} and
    the launch counts per policy."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST
    st0, bank_obj, bank_bg, pool, obj_tab, obj_ids, bg_tab = \
        bench_workload(dev)
    gen = torch.Generator(device=dev)

    def run(policy, reuse):
        st = dataclasses.replace(st0, use_fused_frame=True,
                                 compute_dtype=policy,
                                 sample_reuse=reuse)
        bo, bb = bank_obj, bank_bg
        times, losses = [], []
        for f in range(frames + 1):              # frame 0 warms up
            gen.manual_seed(f)
            d_o = ST.torch_draws(gen, ST.draw_shapes(
                104, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, 1,
                reuse), dev)
            d_b = ST.torch_draws(gen, ST.draw_shapes(
                1, st.n_iter * st.win_bg, st.n_px_bg, st.n_b2s_bg,
                st.n_bins, st.px_block_bg), dev)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            bo, bb, met = ST.frame_step(st, bo, bb, *pool, obj_tab, obj_ids,
                                        bg_tab, d_o, d_b)
            loss = float(met["loss"])
            t1.record()
            torch.cuda.synchronize()
            if f:
                times.append(t0.elapsed_time(t1))
            losses.append(loss)
        return times, losses

    reset_counts()
    res = {}
    for policy, reuse in configs + configs[::-1]:
        times, losses = run(policy, reuse)
        assert all(math.isfinite(x) for x in losses), losses
        r = res.setdefault(f"{policy}/reuse{reuse}",
                           {"frame_ms": [], "losses": losses})
        r["frame_ms"] += times
    counts = read_counts()
    for r in res.values():
        ms = sorted(r["frame_ms"])
        r["median_frame_ms"] = ms[len(ms) // 2]
    for (policy, reuse), key in zip(configs, res):
        # time against f32 without reuse; losses against f32 with the same
        # reuse (the same pixels and z): reuse itself changes what the
        # last iteration's loss measures (a block trained 4 times)
        r, base = res[key], res[f"float32/reuse{reuse}"]
        r["vs_f32_reuse1"] = (r["median_frame_ms"]
                              / res["float32/reuse1"]["median_frame_ms"]
                              - 1.0)
        rel = abs(r["losses"][0] - base["losses"][0]) / abs(base["losses"][0])
        if not rel < RTOL_FULL:
            raise AssertionError(f"{key}: first frame loss {r['losses'][0]}"
                                 f" against {base['losses'][0]} under f32")
        log(f"[{phase}] vMAP frame on {gpu}, {key}: median "
            f"{r['median_frame_ms']:.3f} ms/frame "
            f"{[round(x, 3) for x in r['frame_ms']]} "
            f"({100 * r['vs_f32_reuse1']:+.2f}% against f32 without "
            f"reuse), first-frame loss {r['losses'][0]:.6f} (f32 with the "
            f"same reuse {base['losses'][0]:.6f})")
    for policy, _ in configs:
        if not counts[f"train_grad.{policy}"] > 0:
            raise AssertionError(f"the {policy} frames launched no "
                                 f"{policy} train_grad")
    return res, counts


def policy_trainer(phase: str, tag: str, policy: str, n_frames: int = 6,
                   reuse: int = 1) -> dict:
    """``vmap_tpu_torch.train`` on room0_vmap with tpu.sample_reuse
    ``reuse`` and tpu.compute_dtype ``policy``: 2 x n_iter train_grad
    launches per frame under the policy (both banks), none under another,
    as many train_adamw; under an int8 policy n_iter train_quant_w
    launches per bank and frame (one before the first iteration, one
    after each but the last); finite losses that fall."""

    def check(mapper, dataset, logdir, launches, n_iter, losses):
        st = mapper.statics
        assert (st.sample_reuse, st.compute_dtype) == (reuse, policy), st
        want = 2 * n_iter * n_frames
        got = {p: launches[f"train_grad.{p}"] for p in POLICIES}
        want_q = want if policy in INT8_POLICIES else 0
        if (got != {p: (want if p == policy else 0) for p in POLICIES}
                or launches["train_adamw"] != want
                or launches["train_quant_w"] != want_q):
            raise AssertionError(
                f"train_grad launches by policy {got}, train_adamw "
                f"{launches['train_adamw']}, train_quant_w "
                f"{launches['train_quant_w']}; expected {want} {policy} "
                f"and {want_q} train_quant_w")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"losses do not fall: {losses}")
        return (f"statics reuse {st.sample_reuse}, {st.compute_dtype}; "
                f"train_grad launches by policy {got}, train_quant_w "
                f"{launches['train_quant_w']}")

    launches, _ = drive_trainer(phase, "Replica/room0_vmap.json", tag,
                                n_frames, 0, check,
                                tpu={"sample_reuse": reuse,
                                     "compute_dtype": policy})
    return launches


# --------------------------------------------------------------- phase 11
def imap_policy_frames(dev, gpu: str, policy: str = "int8_static",
                       frames: int = 2) -> dict:
    """The iMAP frame of phase 5 through the kernel path under float32 and
    ``policy`` in turns (f32, policy, policy, f32; each run warms up on one
    frame first), timed with CUDA events around the frame and a readback
    of its loss; then the first frame under ``policy`` through the plain
    path on the same draws, its loss within rtol 0.25 of the kernel
    path's. The policy's effect against f32 is logged, not bounded: JAX's
    default static scales were set on the vMAP objects, and on the iMAP
    field they move the first frame's loss far from f32's. Returns the
    times and the launch counts of the kernel runs."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST
    st0, bank, pool, tab, obj_ids = imap_workload(dev)
    gen = torch.Generator(device=dev)

    def frame(st, b, seed):
        gen.manual_seed(seed)
        d_o = ST.torch_draws(gen, ST.draw_shapes(
            1, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins,
            st.px_block), dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        b, _, met = ST.frame_step(st, b, None, *pool, tab, obj_ids, None,
                                  d_o, None)
        loss = float(met["loss"])
        t1.record()
        torch.cuda.synchronize()
        return b, loss, t0.elapsed_time(t1)

    reset_counts()
    res = {}
    for pol in ("float32", policy, policy, "float32"):
        st = dataclasses.replace(st0, compute_dtype=pol)
        b = bank
        r = res.setdefault(pol, {"frame_ms": [], "losses": []})
        for f in range(frames + 1):              # frame 0 warms up
            b, loss, ms = frame(st, b, f)
            if f:
                r["frame_ms"].append(ms)
            r["losses"].append(loss)
    counts = read_counts()
    for pol, r in res.items():
        assert all(math.isfinite(x) for x in r["losses"]), r
        ms = sorted(r["frame_ms"])
        r["median_frame_ms"] = ms[len(ms) // 2]
    _, plain, _ = frame(dataclasses.replace(
        st0, compute_dtype=policy, use_fused_frame=False), bank, 0)
    kern = res[policy]["losses"][0]
    rel = abs(kern - plain) / abs(plain)
    if not rel < RTOL_FULL:
        raise AssertionError(f"iMAP {policy} first frame loss {kern} through "
                             f"the kernels, {plain} through the plain path")
    if not counts[f"train_grad.{policy}"] > 0:
        raise AssertionError(f"the iMAP {policy} frames launched no "
                             f"{policy} train_grad")
    res["plain_first_loss"] = plain
    f32 = res["float32"]["losses"][0]
    log(f"[11] iMAP frame on {gpu}: float32 median "
        f"{res['float32']['median_frame_ms']:.3f} ms/frame "
        f"{[round(x, 3) for x in res['float32']['frame_ms']]}, {policy} "
        f"median {res[policy]['median_frame_ms']:.3f} ms/frame "
        f"{[round(x, 3) for x in res[policy]['frame_ms']]}; first-frame "
        f"loss {kern:.6f} (plain path {plain:.6f}, rel diff {rel:.3e}; "
        f"float32 {f32:.6f})")
    return res, counts


# --------------------------------------------------------------- phase 12
# the probes (vmap_tpu_torch.probes): name, module, source, the TPU kernel
# (script:line of its Pallas kernel function), the case whose numbers head
# the JSON entry (every case is in its by_case)
PROBES = (("probe_mm", "mm", "scripts/microbench_mm.py:27",
           "[128,128]x[128,1280] f32"),
          ("probe_int8", "int8", "scripts/microbench_int8.py:47",
           "[ 128, 128]x[ 128, 1280] i8       "),
          ("probe_sections", "sections", "scripts/microbench_sections.py:32",
           "render"),
          ("probe_overlap", "overlap", "scripts/microbench_overlap.py:60",
           "both"),
          ("probe_vpu", "vpu", "scripts/microbench_vpu.py:29",
           "[8,1280] mul f32"),
          ("probe_ops", "ops", "scripts/microbench_ops.py:41", "dep_fma"),
          ("probe_dma", "dma", "scripts/microbench_dma.py:28",
           "bulk_hbm_132"))

def pool_gather(dev, gpu: str) -> dict:
    """The sampler's pool gather (``core/step.py`` ``_sample_bank``,
    ``pool_packed[pool_ids, u, v]``) on phase 5's vMAP frame: the index
    tensors of its two gathers (object bank, background) recorded as
    ``_sample_bank`` builds them, each gather then replayed as a CUDA
    graph (``_timing.graph_step_ms``). Returns its ns an element ([2]
    int32 words, 8 B) and ms a frame, and the least time any fetch of the
    same elements could take: their 8 B each over the HBM rate (a K1 that
    fetched its own pixels could at best save the gather's time less
    that)."""
    import torch
    from vmap_tpu_torch import probes
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.probes import _timing
    st, _, _, pool, obj_tab, obj_ids, bg_tab = bench_workload(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    d_o = ST.torch_draws(gen, ST.draw_shapes(
        104, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, 1), dev)
    d_b = ST.torch_draws(gen, ST.draw_shapes(
        1, st.n_iter * st.win_bg, st.n_px_bg, st.n_b2s_bg, st.n_bins,
        st.px_block_bg), dev)
    packed = pool[0]

    class Gathers(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.index = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__ and args[0] is packed:
                self.index.append(args[1])
            return func(*args, **(kwargs or {}))

    with Gathers() as rec:
        ST._sample_bank(*pool, *obj_tab, obj_ids, st.n_iter * st.win,
                        st.n_px, st.n_b2s, st, d_o, px_block=st.px_block)
        ST._sample_bank(*pool, *bg_tab, obj_ids[:1] * 0,
                        st.n_iter * st.win_bg, st.n_px_bg, st.n_b2s_bg, st,
                        d_b, px_block=st.px_block_bg)
    if len(rec.index) != 2:
        raise AssertionError(f"expected the sampler's 2 pool gathers a "
                             f"frame, recorded {len(rec.index)}")
    ms = elements = 0
    for idx in rec.index:
        elements += packed[idx].numel() // 2
        ms += _timing.graph_step_ms(
            lambda r, idx=idx: [packed[idx] for _ in range(r)][-1], dev)
    res = {"ms_per_frame": ms, "ns_per_element": ms * 1e6 / elements,
           "elements_per_frame": elements, "bytes_per_frame": 8 * elements,
           "fetch_bound_ms_per_frame": 8 * elements / probes.PEAK_BYTES
           * 1e3}
    log(f"[12] sampler pool gather on phase 5's vMAP frame: "
        f"{res['ns_per_element']:.4f} ns an element, {ms:.4f} ms a frame "
        f"({elements} elements of 8 B); any fetch of them at least "
        f"{res['fetch_bound_ms_per_frame']:.5f} ms a frame (8 B an element "
        f"over 3.35 TB/s) ({gpu})")
    return res


def probe_path(dev, gpu: str) -> tuple:
    """Phase 12: build the probe library (ptxas registers printed), hold
    every probe's kernel, in every variant and at every case, against its
    plain version at a few steps (the launches of these checks are not the
    path's), then run the probes' entry points (``main`` of
    ``vmap_tpu_torch.probes.{mm,int8,sections,overlap,vpu,ops,dma}`` on
    the card, the scripts' shapes and reps, K1's shapes for mm and int8)
    with the launch counts set to 0 just before and read just after. Each
    case's time a step is the kernel's slope; beside it the module's
    ``plain_ms``, ``library_ms`` (None where no single call computes the
    step) and ``bound``; beside K6 the sampler's pool gather. Returns (the
    probes' JSON entries, the path's launch counts)."""
    import importlib
    from vmap_tpu_torch import probes
    t0 = time.perf_counter()
    lib_path, build_log = probes.LIBRARY.build()
    probes.LIBRARY.load()
    with open(os.path.join(OUT, "nvcc_probes.log"), "w") as f:
        f.write(build_log)
    log(f"[12] built {os.path.relpath(lib_path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[12] ptxas: {line.strip()}")
    mods = {name: importlib.import_module(f"vmap_tpu_torch.probes.{mod}")
            for name, mod, _, _ in PROBES}
    checks = {}
    for name, mod in mods.items():
        checks[name] = mod.compare(dev)
        worst = max(checks[name], key=lambda r: r["used"])
        log(f"[12] {name}: {len(checks[name])} cases held to plain, worst "
            f"{worst['case'].strip()} rel err {worst['max_rel_err']:.3e} "
            f"(rtol {worst['rtol']:.1e}), {worst['used']:.3f} of its bound")

    for k in probes.LAUNCHES:
        probes.LAUNCHES[k] = 0
    results = {name: mod.main(["--device", "cuda"])
               for name, mod in mods.items()}
    counts = dict(probes.LAUNCHES)
    log(f"[12] probe path launches {counts}")

    entries = []
    for (name, mod_name, replaces, head), mod in zip(PROBES, mods.values()):
        if not counts[mod_name] > 0:
            raise AssertionError(f"{name}: no launch on the probe path")
        res = results[name]
        cases = ([{"case": m, **r} for m, r in res["modes"].items()]
                 if name == "probe_overlap" else res)
        by_case = {}
        for case in cases:
            row = {"ms": case["step_ns"] * 1e-6,
                   "plain_ms": mod.plain_ms(case, dev),
                   "library_ms": mod.library_ms(case, dev),
                   **mod.bound(case)}
            for key in ("w_in_smem", "us_per_launch", "ns_per_op",
                        "ns_per_op_runs", "blocks", "aggregate_ns_per_copy",
                        "gb_per_s"):
                if key in case:
                    row[key] = case[key]
            by_case[case["case"].strip()] = row
        if name == "probe_overlap":
            for key in ("overlap", "overlap_bal"):
                by_case[f"{key}_fraction"] = res[key]
                by_case[f"{key}_fraction_runs"] = res[f"{key}_runs"]
        if name == "probe_dma":
            by_case["pool_gather"] = pool_gather(dev, gpu)
        top = by_case[head.strip()]
        errs = checks[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"vmap_tpu_torch/probes/csrc/{mod_name}.cu",
            "replaces": replaces, "launches": counts[mod_name],
            "max_abs_err": max(r["max_abs_err"] for r in errs),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "per": ("copy of each block" if name == "probe_dma"
                    else "step of the chain"),
            "headline_case": head.strip(), "by_case": by_case,
            "checks": errs})
        for key, row in by_case.items():
            if key == "pool_gather":
                continue
            if not isinstance(row, dict):
                log(f"[12] {name} {key}: {row} ({gpu})")
                continue
            lib = ("" if row["library_ms"] is None
                   else f", library {row['library_ms'] * 1e6:.1f}")
            log(f"[12] {name} {key}: ns a step kernel "
                f"{row['ms'] * 1e6:.1f}, plain {row['plain_ms'] * 1e6:.1f}"
                f"{lib}, bound {row['bound_ms'] * 1e6:.2f} ({gpu})")
    return entries, counts


# ------------------------------------------------------------ --update-ab
def update_times(dev) -> dict:
    """The update kernels of the checkout this process imports at phase
    3's shapes, on one yardstick: ms a launch launched back to back
    (``time_device``, 50) and paced by the host (``time_cuda``, 50).
    train_adamw under float32 on the partial rows of one train_grad
    launch, and under int8 beside train_quant_w; then phase 5's vMAP frame
    under int8 without reuse: one frame's device ms by kernel
    (``device_split``) and 5 frames on the host's clock
    (``policy_full_width``, beside float32)."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.kernels import train_step as K
    res = {}
    for name, cap, n_act, h, n_per, S, scale in SHAPES:
        bank = conditioned_bank(cap, n_act, h, scale, 0, dev)
        batch = random_batch(cap, n_per, S, 1, dev)
        for policy in ("float32", "int8"):
            fl = K.FrameLaunch(bank, batch, 1, n_per, CS, OSC, policy)
            p, m, v = (t.clone() for t in (bank.flat, bank.m, bank.v))
            losses = torch.empty(cap, 1, device=dev)
            fl.grad(p, 0)
            adam = lambda: fl.adamw(p, m, v, losses, 0, LR, WD)  # noqa: E731
            r = res.setdefault(f"{name}/{policy}", {})
            r["train_adamw"] = {"ms": time_device(adam, 50),
                                "host_paced_ms": time_cuda(adam, 50)}
            if policy == "int8":
                qw = lambda: fl.quant_weights(p)  # noqa: E731
                r["train_quant_w"] = {"ms": time_device(qw, 50),
                                      "host_paced_ms": time_cuda(qw, 50)}
    st0, bo, bb, pool, obj_tab, obj_ids, bg_tab = bench_workload(dev)
    st = dataclasses.replace(st0, use_fused_frame=True, compute_dtype="int8",
                             sample_reuse=1)
    gen = torch.Generator(device=dev).manual_seed(100)
    d_o = ST.torch_draws(gen, ST.draw_shapes(
        104, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, 1), dev)
    d_b = ST.torch_draws(gen, ST.draw_shapes(
        1, st.n_iter * st.win_bg, st.n_px_bg, st.n_b2s_bg, st.n_bins,
        st.px_block_bg), dev)
    res["int8_frame_device_ms"] = device_split(lambda: ST.frame_step(
        st, bo, bb, *pool, obj_tab, obj_ids, bg_tab, d_o, d_b))
    frames, _ = policy_full_width(dev, "", (("float32", 1), ("int8", 1)), 5,
                                  "ab")
    res["frames_ms"] = {k: r["frame_ms"] for k, r in frames.items()}
    return res


def update_ab(trees: list) -> list:
    """``--update-ab``: the update kernels of each checkout in ``trees``
    (``.`` this one; the parent's unpacked by ``git archive`` into a
    gitignored directory) on the same timers, in the order given (parent,
    change, change, parent compares two). Each distinct checkout's library
    is built first, all at once; then each entry of ``trees`` runs
    ``update_times`` in a process of its own (``--update-times --tree``).
    Logs and returns one record a run; smoke_out/update_ab.json keeps
    them."""
    trees = [os.path.abspath(t) for t in trees]
    build = ("import sys; sys.path.insert(0, '.'); "
             "from vmap_tpu_torch.kernels import _build; _build.build()")
    procs = {t: subprocess.Popen([sys.executable, "-c", build], cwd=t,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for t in dict.fromkeys(trees)}
    for t, proc in procs.items():
        out = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"build of {t} failed:\n{out[-4000:]}")
    runs = []
    for i, t in enumerate(trees):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--update-times", "--tree", t],
                              capture_output=True, text=True, timeout=900)
        tag = "UPDATE_TIMES "
        lines = [x for x in proc.stdout.splitlines() if x.startswith(tag)]
        if proc.returncode or not lines:
            raise RuntimeError(f"update_times in {t} failed "
                               f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        run = {"tree": os.path.relpath(t, REPO),
               **json.loads(lines[-1][len(tag):])}
        runs.append(run)
        for key, r in run.items():
            if "/" in key:
                log(f"[ab] {i} {run['tree']} {key}: " + ", ".join(
                    f"{k} ms {x['ms']:.4f} (host-paced "
                    f"{x['host_paced_ms']:.4f})" for k, x in r.items()))
        split = run["int8_frame_device_ms"]
        log(f"[ab] {i} {run['tree']} int8 vMAP frame device ms "
            "(torch.profiler): " + (", ".join(
                f"{k} {v:.3f}" for k, v in split.items()) if split
                else "not measured"))
        for k, ms in run["frames_ms"].items():
            log(f"[ab] {i} {run['tree']} vMAP frame {k}: median "
                f"{sorted(ms)[len(ms) // 2]:.3f} ms "
                f"{[round(x, 3) for x in ms]} (host clock)")
    with open(os.path.join(OUT, "update_ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return runs


# ---------------------------------------------------------------- phase 18
# K1 at the widths it gained (h=16: the fixture room's objects; h=64:
# quality_study's bg_rays320_h64 background) at each of phase 3's shapes,
# K2 / K3 at phase 6's object and background shapes (its iMAP shape is the
# background's at h=256): "<shape><width>"
WIDTHS = (16, 64)
WIDTH_SHAPES = tuple((f"{s[0]}{w}",) + s[1:3] + (w,) + s[4:]
                     for w in WIDTHS for s in SHAPES)
WIDTH_FIELD_SHAPES = tuple((f"{s[0]}{w}", s[1], w) + s[3:]
                           for w in WIDTHS for s in FIELD_SHAPES[:2])
# the kernel-alone gradient's atol at these shapes, the n_iter=1 tier's
# (a fraction of the gradient's scale): at h=64 on the object shape slot
# 3's colour head has a ReLU tie (unit 12 at one point, its pre-activation
# 3.2e-7 of sum |w||x|, under the three-pass route's stated error of 4.6e-5
# of it), which the kernel puts on the other side of 0 from the f32 plain
# version; that one point's term moves d b_col and a row of d w_col by up
# to 1.5e-3 (2.5e-4 of scale), while f32 and f64 plain agree within 4e-5
WIDTH_GRAD_ATOL = 1e-3
FIXTURE_CONFIG = os.path.join("configs", "Replica", "fixture_room_vmap.json")
FIXTURE_FRAMES = 8
# the JAX package's table of the same study (docs/quality_study.json)
QUALITY_JAX = os.path.join(REPO, "docs", "quality_study.json")


def width_kernels(dev, stats: dict) -> None:
    """(a) and (b): K1 at h=16 and h=64 at phase 3's shapes under the seven
    policies against the plain frame in the tiers of phases 3, 10 and 11
    (train_adamw and train_quant_w against theirs, each timed beside its
    bound), REUSE bit-identical to the tiled batch at the object shape;
    K2 and K3 in phase 6's tiers, timed, their plans printed. One
    iteration's gradient alone is held to the n_iter=1 tier, 1e-3 of
    scale (WIDTH_GRAD_ATOL)."""
    check_kernels(dev, stats, WIDTH_SHAPES, phase="18",
                  grad_atol=WIDTH_GRAD_ATOL)
    check_policies(dev, stats, WIDTH_SHAPES, BF16_POLICIES, phase="18")
    check_policies(dev, stats, WIDTH_SHAPES, INT8_POLICIES, phase="18")
    for shape in WIDTH_SHAPES:
        if shape[0].startswith("obj"):
            check_reuse_bit_identity(dev, shape, phase="18")
    check_field_kernels(dev, stats, WIDTH_FIELD_SHAPES, phase="18")


def fixture_run(gpu: str) -> tuple:
    """(c) ``vmap_tpu_torch.train`` on configs/Replica/fixture_room_vmap.json
    and its committed data (objects h=16, background h=32) for
    FIXTURE_FRAMES frames on the card: finite losses, 2 objects at the
    end, n_iter train_grad launches a trained frame at each width, then an
    export through K2 at both widths. Returns (launch counts, results)."""
    import numpy as np
    from vmap_tpu_torch import train
    with open(os.path.join(REPO, FIXTURE_CONFIG)) as f:
        raw = json.load(f)
    raw["dataset"]["path"] = os.path.join(REPO, raw["dataset"]["path"])
    cfg_path = os.path.join(OUT, "fixture_room.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    logdir = os.path.join(OUT, "train_fixture_room")
    shutil.rmtree(logdir, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    mapper, _ = train.run(["--config", cfg_path, "--logdir", logdir,
                           "--max_frames", str(FIXTURE_FRAMES), "--device",
                           "cuda"])
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in
            open(os.path.join(logdir, "train_log.jsonl"))]
    losses = [r["loss"] for r in rows]
    c = read_counts()
    n_iter = mapper.cfg.n_iter_per_frame
    if not (rows and np.isfinite(losses).all()):
        raise AssertionError(f"fixture room losses {losses}")
    if mapper.n_objects != 2:
        raise AssertionError(f"fixture room: {mapper.n_objects} objects")
    for h in (16, 32):
        if c[f"train_grad.h{h}"] != n_iter * len(rows):
            raise AssertionError(
                f"fixture room: {c[f'train_grad.h{h}']} train_grad launches "
                f"at h={h}, expected {n_iter} x {len(rows)} frames")
    mesh_dir = os.path.join(logdir, "export")
    paths = mapper.export_meshes(mesh_dir, rows[-1]["frame"])
    e = read_counts()
    for h in (16, 32):
        if not e[f"field_fwd.{h}"]:
            raise AssertionError(f"fixture room export: no field_fwd "
                                 f"launch at h={h}")
    res = {"frames": len(rows), "wall_s": wall, "losses": losses,
           "meshes": len(paths),
           "launches": {k: v for k, v in e.items() if v}}
    log(f"[18] (c) fixture room on {gpu}: {len(rows)} frames in {wall:.1f} "
        f"s, {mapper.n_objects} objects, losses "
        f"{[round(x, 4) for x in losses]}; train_grad launches h=16 "
        f"{c['train_grad.h16']}, h=32 {c['train_grad.h32']}; export "
        f"{len(paths)} meshes, field_fwd h=16 {e['field_fwd.16']}, h=32 "
        f"{e['field_fwd.32']}")
    return e, res


def fused_off(dev, gpu: str) -> tuple:
    """(d) ``tpu.fused_train_step: false`` on phase 4's configuration at
    n_iter=1: the Mapper on the card runs the plain frame (JAX's XLA step:
    no train_grad launch), keeps the configured slots unrounded (JAX's
    rule, round to 8 only where the setting is on), and from the same
    banks (conditioned as phase 3's) and draws lands within phase 3's
    tier of the kernel frame (the setting "auto"), every slot of the plain
    bank and the background.
    Returns (the plain frame's launch counts, results)."""
    import dataclasses
    import torch
    from vmap_tpu_torch.core import bank as B
    from vmap_tpu_torch.core.mapper import FrameSample, Mapper
    from vmap_tpu_torch.core.step import torch_draws
    from vmap_tpu_torch.data.loader import make_dataset

    cfg, _ = synthetic_room0()
    cfg.n_iter_per_frame = 1
    off = dataclasses.replace(cfg, fused_train_step=False)
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = {}

    def record(bank, shapes):
        draws[bank] = torch_draws(gen, shapes, dev)
        return draws[bank]

    def replay(bank, shapes):
        d = draws[bank]
        n = shapes["kf"][0]
        return type(d)(**{k: getattr(d, k)[:n].contiguous()
                          for k in ("kf", "u", "v", "z")})

    mk = Mapper(cfg, device=dev, draw_source=record)
    mo = Mapper(off, device=dev, draw_source=replay)
    if not (mk.use_fused and not mo.use_fused):
        raise AssertionError("fused_train_step false still runs K1")
    want_k = -(-cfg.max_n_models // 8) * 8 if cfg.hidden_feature_size <= 64 \
        else cfg.max_n_models
    if (mk.slots, mo.slots) != (want_k, cfg.max_n_models):
        raise AssertionError(f"slots {mk.slots} / {mo.slots}, expected "
                             f"{want_k} / {cfg.max_n_models}")
    if mo.statics.compute_dtype != "float32":
        raise AssertionError(f"the XLA step's policy: "
                             f"{mo.statics.compute_dtype}")
    s = make_dataset(cfg)[0]
    for m in (mk, mo):
        m.ingest_frame(FrameSample(image=s["image"], depth=s["depth"],
                                   inst=s["obj"], bbox_dict=s["bbox_dict"],
                                   t_wc=s["T"], frame_id=s["frame_id"]))
    # both banks conditioned as phase 3's (conditioned_bank: weights x0.3,
    # small moments, step 3), whose tier this holds: on a fresh bank's
    # first AdamW step a parameter moves by lr sign(g), and a gradient
    # within f32 noise of 0 moves it 2 lr apart in the two frames
    g = torch.Generator().manual_seed(4)
    for name in ("bank_obj", "bank_bg"):
        b = getattr(mk, name)
        setattr(mk, name, b.replace(
            flat=b.flat * 0.3,
            m=(torch.randn(b.m.shape, generator=g) * 1e-4).to(dev),
            v=(torch.rand(b.v.shape, generator=g) * 1e-6).to(dev),
            step=torch.where(b.active, 3, 0).to(torch.int32)))
    n = mo.slots
    mo.bank_obj = mk.bank_obj.replace(**{
        f: getattr(mk.bank_obj, f)[:n].clone() for f in B.FIELDS})
    mo.bank_bg = mk.bank_bg.replace(**{
        f: getattr(mk.bank_bg, f).clone() for f in B.FIELDS})
    reset_counts()
    t0 = time.perf_counter()
    met_k = mk.train_frame()
    loss_k = float(met_k["loss"])
    ms_k = 1e3 * (time.perf_counter() - t0)
    ck = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    met_o = mo.train_frame()
    loss_o = float(met_o["loss"])
    ms_o = 1e3 * (time.perf_counter() - t0)
    co = read_counts()
    if co["train_grad"] or co["train_adamw"] or not ck["train_grad"]:
        raise AssertionError(f"launches: fused off {co}, auto {ck}")
    errs = {}
    for tag, got, want in (("obj", mo.bank_obj, mk.bank_obj),
                           ("bg", mo.bank_bg, mk.bank_bg)):
        for f in ("flat", "m", "v"):
            w = getattr(want, f)[:getattr(got, f).shape[0]]
            errs[f"{tag}.{f}"] = rel_close(
                getattr(got, f), w, RTOL_SEM, 1e-3 * float(w.abs().max()),
                f"fused off {tag} {f}")
    rel_close(torch.tensor(loss_o), torch.tensor(loss_k), RTOL_SEM, 1e-6,
              "fused off loss")
    res = {"slots_auto": mk.slots, "slots_off": mo.slots,
           "loss_auto": loss_k, "loss_off": loss_o,
           "frame_ms_auto": ms_k, "frame_ms_off": ms_o,
           "max_abs_err": errs, "launches_off": co}
    log(f"[18] (d) fused_train_step false on {gpu}: slots {mo.slots} "
        f"(auto {mk.slots}), no train_grad launch, loss {loss_o:.6f} "
        f"against the kernel frame's {loss_k:.6f}; max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; host ms a frame plain {ms_o:.1f}, kernel {ms_k:.1f} (first "
        "frame, one each)")
    return co, res


def remesh_check(gpu: str) -> dict:
    """(e) ``python -m vmap_tpu_torch.remesh`` on phase 4's full-state
    checkpoint at phase 4's grid cap (without the HTML viewer): the same
    files as phase 4's export of that frame, their bytes equal (vertices,
    faces and colours). Runs phase 4's trainer (no resume) first where
    this call ran no phase 4."""
    from vmap_tpu_torch import remesh
    logdir = os.path.join(OUT, "train_room0_synthetic")
    state = os.path.join(logdir, "ckpt", "state")
    if not os.path.isdir(state):
        run_trainer(12, n_resume=0)
    with open(os.path.join(OUT, "room0_synthetic.json")) as f:
        raw = json.load(f)
    raw["vis"]["html_viewer"] = False
    cfg_path = os.path.join(OUT, "room0_remesh.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    with open(os.path.join(state, "latest.json")) as f:
        frame = json.load(f)["frame_id"]
    out = os.path.join(OUT, "remesh")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    paths = remesh.main(["--config", cfg_path, "--ckpt", state, "--out", out,
                         "--grid_dim", str(raw["vis"]["grid_dim"])])
    wall = time.perf_counter() - t0
    got = sorted(os.path.basename(p) for p in paths)
    want = sorted(f for f in os.listdir(os.path.join(logdir, "scene_mesh"))
                  if f.startswith(f"frame_{frame}_") and f.endswith(".obj"))
    if not got or got != want:
        raise AssertionError(f"remesh wrote {got}, phase 4 {want}")
    differ = [f for f in got
              if open(os.path.join(out, f), "rb").read()
              != open(os.path.join(logdir, "scene_mesh", f), "rb").read()]
    if differ:
        raise AssertionError(f"remesh: {differ} differ from phase 4's")
    log(f"[18] (e) remesh on {gpu}: frame {frame}'s {len(got)} meshes at "
        f"grid cap {raw['vis']['grid_dim']} in {wall:.1f} s, byte-equal to "
        "phase 4's export")
    return {"frame": frame, "meshes": got, "wall_s": wall}


def quality_run(gpu: str, quick: bool = False) -> tuple:
    """(f) ``vmap_tpu_torch.quality_study`` at its default sizes (128 x
    96, 16 frames x 3 passes, grid 64), its five variants' processes side
    by side on the card: every variant's metrics finite, bg_rays320_h64
    launching K1 and K2 at h=64; the table printed beside
    docs/quality_study.json's JAX rows (a quality comparison, no bar).
    Returns (bg_rays320_h64's launch counts, results)."""
    import numpy as np
    from vmap_tpu_torch import quality_study as QS
    out = os.path.join(OUT, "quality_study.json")
    QS.LAUNCHES.clear()
    t0 = time.perf_counter()
    table = QS.main(["--out", out] + (["--quick"] if quick else []))
    wall = time.perf_counter() - t0
    for tag, rows in table.items():
        vals = [v for met in rows.values() for v in met.values()]
        if not vals or not np.isfinite(vals).all():
            raise AssertionError(f"quality study {tag}: {rows}")
    # the variant's process's counts, as read_counts' keys
    h64 = {**{k: 0 for k in read_counts()},
           **QS.LAUNCHES["bg_rays320_h64"]}
    if not (h64["train_grad.h64"] and h64["field_fwd.64"]):
        raise AssertionError(f"bg_rays320_h64 launches {h64}")
    with open(QUALITY_JAX) as f:
        jax_table = json.load(f)
    log(f"[18] (f) quality study on {gpu} in {wall:.1f} s "
        f"({'--quick' if quick else 'default sizes'}); port / JAX "
        "(docs/quality_study.json) per variant and object, acc comp "
        "r@1cm r@5cm:")
    keys = ("accuracy", "completion", "completion_ratio_1cm",
            "completion_ratio_5cm")
    for tag, rows in table.items():
        for obj, met in rows.items():
            j = jax_table.get(tag, {}).get(obj, {})
            log(f"[18]   {tag:>15} {obj:>10}: port "
                + " ".join(f"{met[k]:.4f}" for k in keys) + " | JAX "
                + " ".join(f"{j[k]:.4f}" if k in j else "-" for k in keys))
    return h64, {"table": table, "jax": jax_table, "wall_s": wall,
                 "launches": dict(QS.LAUNCHES), "quick": quick}


def widths_phase(dev, gpu: str, stats: dict, paths: dict) -> dict:
    """Phase 18, (a) to (f); each path's launch counts into ``paths``."""
    width_kernels(dev, stats)
    res = {}
    paths["fixture_room"], res["fixture_room"] = fixture_run(gpu)
    paths["fused_off"], res["fused_off"] = fused_off(dev, gpu)
    res["remesh"] = remesh_check(gpu)
    paths["quality_h64"], res["quality_study"] = quality_run(gpu)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", nargs="+", type=int,
                    default=list(range(1, 19)),
                    help="phases to run (default all: 1 2 ... 18)")
    ap.add_argument("--sections", action="store_true",
                    help="in place of the phases: time train_grad's "
                    "sections under every policy (k1_sections)")
    ap.add_argument("--update-ab", nargs="+", metavar="TREE",
                    help="in place of the phases: time the update kernels "
                    "of each checkout TREE in turn (update_ab)")
    ap.add_argument("--update-times", action="store_true",
                    help=argparse.SUPPRESS)   # one run of --update-ab
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # its checkout
    ap.add_argument("--rank-frames", help=argparse.SUPPRESS)  # phase 16 a
    args = ap.parse_args(argv)
    phases = set(args.phases)
    if not os.path.isdir(os.path.join(REPO, "vmap_tpu_torch", "kernels",
                                      "csrc")):
        print("chip_smoke.py: the vmap_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    os.makedirs(OUT, exist_ok=True)
    if args.rank_frames:
        return rank_frames(args.rank_frames)

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(f"[1] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.sections:
        k1_sections(dev, gpu)
        return 0
    if args.update_ab:
        update_ab(args.update_ab)
        return 0
    if args.update_times:
        import vmap_tpu_torch
        from vmap_tpu_torch.kernels import _build
        assert vmap_tpu_torch.__file__.startswith(
            os.path.abspath(args.tree) + os.sep), vmap_tpu_torch.__file__
        _build.load()
        print("UPDATE_TIMES " + json.dumps(update_times(dev)), flush=True)
        return 0

    # 2. build
    from vmap_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path, build_log = _build.build()
    _build.load()
    with open(os.path.join(OUT, "nvcc_build.log"), "w") as f:
        f.write(build_log)
    log(f"[2] built {os.path.relpath(lib_path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[2] ptxas: {line.strip()}")

    stats: dict = {}
    paths = {}     # main-path launch counts: {path: {kernel: count}}
    probe_entries: list = []    # phase 12's kernels (their own path)
    path_tiles = {}
    for phase in sorted(phases - {1, 2}):
        t_phase = time.perf_counter()
        if phase == 3:
            check_kernels(dev, stats)
        elif phase == 4:
            paths["trainer"], stages = run_trainer(12)
            with open(os.path.join(OUT, "mesh_export_stages.json"), "w") as f:
                json.dump({"gpu": gpu, "host_s": stages}, f, indent=1)
        elif phase == 5:
            res = full_width(dev, gpu)
            res_imap = imap_full_width(dev, gpu)
            with open(os.path.join(OUT, "full_width.json"), "w") as f:
                json.dump({"gpu": gpu, **res, "imap": res_imap}, f, indent=1)
        elif phase == 6:
            check_field_kernels(dev, stats)
        elif phase == 7:
            res = mesh_full_width(dev, gpu)
            with open(os.path.join(OUT, "mesh_full_width.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1)
        elif phase == 8:
            paths["use_pallas_train"], path_tiles = \
                check_field_train_path(dev)
        elif phase == 9:
            paths["imap_trainer"], stages = run_imap_trainer()
            with open(os.path.join(OUT, "imap_export_stages.json"),
                      "w") as f:
                json.dump({"gpu": gpu, "host_s": stages}, f, indent=1)
        elif phase == 10:
            check_policies(dev, stats)
            check_reuse_bit_identity(dev)
            res, paths["policy_frames"] = policy_full_width(dev, gpu)
            with open(os.path.join(OUT, "policy_full_width.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1)
            paths["policy_trainer"] = policy_trainer(
                "10", "room0_reuse4_bwd_bf16", "bwd_bf16", reuse=4)
        elif phase == 11:
            check_policies(dev, stats, policies=INT8_POLICIES, phase="11")
            res, paths["int8_frames"] = policy_full_width(
                dev, gpu, INT8_FRAMES, phase="11")
            res_imap, paths["int8_imap_frames"] = imap_policy_frames(dev,
                                                                     gpu)
            with open(os.path.join(OUT, "int8_full_width.json"), "w") as f:
                json.dump({"gpu": gpu, **res, "imap": res_imap}, f, indent=1)
            paths["int8_trainer"] = policy_trainer("11", "room0_int8",
                                                   "int8")
        elif phase == 12:
            probe_entries, _ = probe_path(dev, gpu)
            with open(os.path.join(OUT, "probes.json"), "w") as f:
                json.dump({"gpu": gpu, "probes": probe_entries}, f, indent=1)
        elif phase == 13:
            paths["room"], res = room_protocol(dev, gpu)
            with open(os.path.join(OUT, "room.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1, default=float)
        elif phase == 14:
            res = {}
            paths["forloop"], res["forloop"] = forloop_against_vmap(dev, gpu)
            paths["live"], res["live"] = live_run(dev, gpu)
            paths["occupancy_field"], res["occupancy_field"] = \
                occupancy_field_meshes(dev, gpu)
            paths["traced_trainer"], res["trace"] = profile_and_trace(gpu)
            with open(os.path.join(OUT, "runtime_modes.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1, default=float)
        elif phase == 15:
            paths["scannet"], res = scannet_layout(dev, gpu)
            with open(os.path.join(OUT, "scannet.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1, default=float)
        elif phase == 16:
            from vmap_tpu_torch import native
            native.available()   # built once here, not by each rank
            res = {}
            paths["sharded_frames"], res["frames"] = sharded_frames(dev, gpu)
            paths["sharded_trainer"], res["trainer"] = sharded_trainer(gpu)
            with open(os.path.join(OUT, "sharded.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1, default=float)
        elif phase == 17:
            paths["calibration"], res = calibration(dev, gpu)
            with open(os.path.join(OUT, "calibration_run.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1, default=float)
        elif phase == 18:
            res = widths_phase(dev, gpu, stats, paths)
            with open(os.path.join(OUT, "widths.json"), "w") as f:
                json.dump({"gpu": gpu, **res}, f, indent=1, default=float)
        else:
            raise SystemExit(f"no phase {phase}")
        log(f"[{phase}] phase {phase} took "
            f"{time.perf_counter() - t_phase:.1f} s")

    def rows(kernel: str, policies=None) -> dict:
        per = stats.get(kernel, {})
        return per if policies is None else {
            k: v for k, v in per.items() if k.split("/")[1] in policies}

    # the top-level numbers of a kernel's entry sum phase 3 / 6 / 11's
    # shapes; phase 18's widths are rows of by_shape beside them
    main_shapes = {s[0] for s in SHAPES + FIELD_SHAPES}

    def policy_launches(policies):
        return lambda c: sum(c[f"train_grad.{p}"] for p in policies)

    # (name, source, the TPU kernel's line, its by_shape rows, the policy
    # whose rows the top-level numbers sum (None: every row), its launches
    # in a path's counts). K1's int8 paths (quant_weights, the quantised
    # forward, bwd_chunk_q8) are two kernels of train_step_q8.cu; phase 11
    # keeps the int8 instances' rows in train_grad's stats
    specs = (
        ("train_grad", "train_step.cu", "train_step.py:458",
         rows("train_grad", POLICIES[:3]), "float32",
         policy_launches(POLICIES[:3])),
        ("train_grad_q8", "train_step_q8.cu", "train_step.py:458",
         rows("train_grad", INT8_POLICIES), "int8",
         policy_launches(INT8_POLICIES)),
        ("train_quant_w", "train_step_q8.cu", "train_step.py:458",
         rows("train_quant_w"), None, lambda c: c["train_quant_w"]),
        ("train_adamw", "train_step.cu", "train_step.py:458",
         rows("train_adamw"), None, lambda c: c["train_adamw"]),
        ("field_fwd", "ensemble.cu", "ensemble.py:97", rows("field_fwd"),
         None, lambda c: c["field_fwd"]),
        ("field_bwd", "ensemble.cu", "ensemble.py:215", rows("field_bwd"),
         None, lambda c: c["field_bwd"]),
        # the weights' bf16 pieces K2 and K3 read (JAX's K2 reads f32)
        ("field_stage", "ensemble.cu", "ensemble.py:97",
         rows("field_stage"), None, lambda c: c["field_stage"]))
    must_launch = ((("train_grad", "train_adamw", "field_stage", "field_fwd",
                     "field_bwd") if {4, 8} <= phases else ())
                   + (("train_grad", "train_adamw", "field_stage",
                       "field_fwd") if 13 in phases else ())
                   + (("train_grad_q8", "train_quant_w")
                      if 11 in phases else ())
                   + (("train_grad", "train_adamw", "field_stage",
                       "field_fwd") if phases & {14, 15, 16} else ())
                   + (("train_grad", "train_adamw") if 17 in phases
                      else ())
                   + (("train_grad", "train_adamw", "field_stage",
                       "field_fwd") if 18 in phases else ()))
    kernels = []
    for name, src, replaces, per, top_policy, count in specs:
        by_path = {p: count(c) for p, c in paths.items()}
        launches = max(by_path.values(), default=0)
        if name in must_launch and not launches:
            raise AssertionError(f"{name}: no launch on the main paths")
        # the top-level numbers sum the three shapes of phases 3 / 6 / 11
        # (vMAP object and background banks, the iMAP field); the other
        # policies are the by_shape keys <shape>/<policy>
        top = {k: v for k, v in per.items()
               if (top_policy is None or k.endswith(f"/{top_policy}"))
               and k.split("/")[0] in main_shapes}
        worst = max(top.values(), key=lambda v: v["bound_ms"], default={})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"vmap_tpu_torch/kernels/csrc/{src}",
            "replaces": f"vmap_tpu/kernels/{replaces}",
            "launches": launches,
            "max_abs_err": max((v["max_abs_err"] for v in per.values()),
                               default=None),
            "ms": sum(v["ms"] for v in top.values()) if top else None,
            "plain_ms": (sum(v["plain_ms"] for v in top.values())
                         if top else None),
            "bound_ms": (sum(v["bound_ms"] for v in top.values())
                         if top else None),
            "bound_by": worst.get("bound_by"),
            "library_ms": None,
            "by_shape": per, "launches_by_path": by_path})
        if top and all("rows_bound_ms" in v for v in top.values()):
            # train_adamw: also the bound with K1's partial rows
            kernels[-1]["rows_bound_ms"] = sum(v["rows_bound_ms"]
                                               for v in top.values())
    launches_by_policy = {
        p: {pol: c[f"train_grad.{pol}"] for pol in POLICIES}
        for p, c in paths.items()}
    kernels[0]["launches_by_policy"] = kernels[1]["launches_by_policy"] = \
        launches_by_policy
    from vmap_tpu_torch.kernels import KERNEL_HIDDEN
    kernels[0]["launches_by_width"] = kernels[1]["launches_by_width"] = {
        p: {h: c[f"train_grad.h{h}"] for h in KERNEL_HIDDEN["train_frame"]}
        for p, c in paths.items()}
    for name in ("field_fwd", "field_bwd"):
        entry = next(k for k in kernels if k["name"] == name)
        entry["launches_by_width"] = {
            p: {h: c[f"{name}.{h}"] for h in KERNEL_HIDDEN[name]}
            for p, c in paths.items()}
    field_bwd = next(k for k in kernels if k["name"] == "field_bwd")
    field_bwd["at_use_pallas_train_tiles"] = path_tiles
    kernels += [{**{k: v for k, v in e.items() if k != "checks"},
                 "launches_by_path": {"probes": e["launches"]}}
                for e in probe_entries]
    for pol in (POLICIES[:3] if 10 in phases else ()) + (
            INT8_POLICIES if 11 in phases else ()):
        if not any(c[f"train_grad.{pol}"] for c in paths.values()):
            raise AssertionError(f"no {pol} train_grad launch on the main "
                                 "paths")
    if 8 in phases and not any(c["field_bwd.256"] for c in paths.values()):
        raise AssertionError("no field_bwd launch at h=256 on the main paths")
    if 18 in phases:
        for key in ("train_grad.h16", "train_grad.h64", "field_fwd.16",
                    "field_fwd.64"):
            if not any(c[key] for c in paths.values()):
                raise AssertionError(f"no {key} launch on the main paths")
    from vmap_tpu_torch.parallel.launch import foreign_modules
    bad = foreign_modules()
    if bad:
        raise AssertionError(f"the JAX package, jax or cv2 was imported: "
                             f"{bad}")
    log(f"[done] phases {sorted(phases)} in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
