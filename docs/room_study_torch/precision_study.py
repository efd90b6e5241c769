"""The room's reference-precision study, on the CPU: both packages' room
pipelines trained on one small room drawn at three precisions of the
renderer's matrix products.

Rooms (Replica format, 200 frames, 10 objects, 240 x 136, focal 120,
generation seed 0):

  exact  the port's generator (equal to the JAX renderer on the CPU,
         ``tests/test_torch_datagen.py``)
  tpu2   the JAX renderer with ``d_cam @ R.T`` and
         ``einsum('rj,cj->rc')`` on bf16 operands with f32 sums
         (``tpu_render_precision.patch``)
  tpu7   every product of the JAX renderer's ``_trace_pose`` on bf16
         operands with f32 sums: the two above, ``det``, ``uu``, ``tt`` and
         the two shading products (``tpu_render_precision_all.patch``)

A TPU runs an f32 ``dot_general`` at the default precision as one pass
over bf16 operands; which of the renderer's five geometry products XLA's
TPU pipeline keeps as dots, and which it rewrites to an f32
multiply-and-reduce, is not observable without a TPU, so ``tpu2`` and
``tpu7`` bound it from both sides. The patched renderers run in copies of
the JAX package under ``--work``; the repository is not changed.

Every training uses the same flags (``COMMON``: 16 object slots, the
background at 120 rays and width 32, grid 64) and writes its own work
directory; the study file gets each run's metrics and its per-frame
``n_objects`` / ``pool_used`` from the trainer's ``train_log.jsonl``, and for
each room whether those traces agree across every run on it.

    python docs/room_study_torch/precision_study.py --work DIR [--jobs 4]

A run whose summary is already under ``--work`` is read, not run again.
"""
import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
ROOM = ["--frames", "200", "--objects", "10", "--width", "240",
        "--height", "136"]
GENERATE = ["--format", "Replica", "--scene", "room", "--seed", "0",
            "--objects", "10", "--frames", "200", "--width", "240",
            "--height", "136", "--fx", "120", "--fy", "120"]
COMMON = ROOM + ["--focal", "120", "--grid_dim", "64",
                 "--set", "trainer.n_models=16",
                 "--set", "render.n_per_optim_bg=120",
                 "--set", "model.hidden_feature_size_bg=32"]
PATCHES = {"tpu2": "tpu_render_precision.patch",
           "tpu7": "tpu_render_precision_all.patch"}
# (room, package, training seed, compute dtype)
RUNS = [("exact", "port", 0, None), ("exact", "jax", 0, None),
        ("exact", "port", 1, None), ("exact", "jax", 1, None),
        ("exact", "jax", 0, "bfloat16"),
        ("tpu2", "port", 0, None), ("tpu2", "jax", 0, None),
        ("tpu7", "port", 0, None), ("tpu7", "jax", 0, None)]
JAX_ENV = {"JAX_PLATFORMS": "cpu"}
# one torch thread a port run: several runs side by side, each with a
# thread a core, slowed every one more than tenfold
PORT_ENV = {"OMP_NUM_THREADS": "1"}


def run_name(room, package, seed, dtype):
    return f"{room}_{package}" + (f"_{dtype}" if dtype else "") + f"_s{seed}"


def call(cmd, cwd, log, env=None):
    with open(log, "w") as f:
        subprocess.run(cmd, cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
                       env={**os.environ, **(env or {})}, check=True)


def generate(work: Path, room: str) -> None:
    """Draw ``room`` into ``work/rooms/<room>/data``."""
    base = work / "rooms" / room
    data = base / "data"
    if (data / "traj_w_c.txt").exists():
        return
    base.mkdir(parents=True, exist_ok=True)
    if room == "exact":
        call([sys.executable, "-m", "vmap_tpu_torch.generate_dataset",
              str(data), *GENERATE, "--device", "cpu"], REPO,
             base / "generate.log")
        return
    src = base / "src"
    src.mkdir(exist_ok=True)
    archive = subprocess.run(
        ["git", "archive", "HEAD", "vmap_tpu", "scripts", "configs",
         "train.py"], cwd=REPO, check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", str(src)], input=archive, check=True)
    subprocess.run(["patch", "-p1", "-i", str(HERE / PATCHES[room])],
                   cwd=src, check=True, capture_output=True)
    call([sys.executable, "scripts/generate_dataset.py", str(data),
          *GENERATE], src, base / "generate.log", JAX_ENV)


def room_differences(work: Path, room: str) -> dict:
    """How far ``room``'s frames lie from the exact room's, over all
    frames: depth (mm, as written) where both hit, and the pixels whose
    hit or instance differs."""
    sys.path.insert(0, str(REPO))
    from vmap_tpu_torch.utils.png import read_png
    rooms = work / "rooms"
    frames = len((rooms / "exact" / "data" / "traj_w_c.txt").read_text()
                 .splitlines())
    d_abs, n_both, n_hit, n_inst, n_px = [], 0, 0, 0, 0
    for i in range(frames):
        da, db = (read_png(str(rooms / r / "data" / "depth" /
                               f"depth_{i}.png")).astype(np.int64)
                  for r in ("exact", room))
        ia, ib = (read_png(str(rooms / r / "data" / "semantic_instance" /
                               f"semantic_instance_{i}.png"))
                  for r in ("exact", room))
        both = (da > 0) & (db > 0)
        d_abs.append(np.abs(da - db)[both])
        n_both += int(both.sum())
        n_hit += int(((da > 0) != (db > 0)).sum())
        n_inst += int((ia != ib).sum())
        n_px += da.size
    d = np.concatenate(d_abs)
    return {"frames": frames,
            "depth_abs_mm": {"mean": float(d.mean()),
                             "p50": float(np.percentile(d, 50)),
                             "p99": float(np.percentile(d, 99)),
                             "max": int(d.max())},
            "depth_off_5mm_share": float((d > 5).sum() / n_both),
            "hit_differs_share": n_hit / n_px,
            "instance_differs_share": n_inst / n_px}


def train(work: Path, room, package, seed, dtype) -> dict:
    name = run_name(room, package, seed, dtype)
    wd = work / "runs" / name
    summary = wd / f"room_study_{name}.json"
    if not summary.exists():
        wd.mkdir(parents=True, exist_ok=True)
        if not (wd / "data").exists():
            (wd / "data").symlink_to(work / "rooms" / room / "data")
        flags = ["--work", str(wd), "--skip_generate", *COMMON,
                 "--train_seed", str(seed), "--tag", name]
        if dtype:
            flags += ["--compute_dtype", dtype]
        if package == "port":
            cmd = [sys.executable, "-m", "vmap_tpu_torch.room_pipeline",
                   *flags, "--device", "cpu"]
            env = PORT_ENV
        else:
            cmd = [sys.executable, "scripts/room_pipeline.py", *flags,
                   "--px_block_bg", "1"]
            env = JAX_ENV
        call(cmd, REPO, wd / "pipeline.log", env)
    s = json.loads(summary.read_text())
    per_object = json.loads(
        (wd / f"metrics_obj_{name}.json").read_text())["per_object"]
    log = [json.loads(line) for line in
           (wd / f"run_{name}" / "train_log.jsonl").read_text().splitlines()]
    return {"room": room, "package": package, "train_seed": seed,
            "compute_dtype": dtype or "float32", "total_s": s["total_s"],
            "object_mean": s["object_mean"], "bg": s["bg"],
            "scene": s["scene"], "per_object": per_object,
            "trace": {"n_objects": [r["n_objects"] for r in log],
                      "pool_used": [r["pool_used"] for r in log]}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", required=True, type=Path)
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--out", type=Path,
                   default=HERE / "cpu_precision_study.json")
    args = p.parse_args(argv)
    work = args.work.resolve()
    rooms = sorted({r[0] for r in RUNS})
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(lambda r: generate(work, r), rooms))
        runs = dict(zip([run_name(*r) for r in RUNS],
                        pool.map(lambda r: train(work, *r), RUNS)))
    traces = {}
    for room in rooms:
        on_room = [r["trace"] for r in runs.values() if r["room"] == room]
        traces[room] = {
            "runs": sum(1 for r in runs.values() if r["room"] == room),
            "equal_frame_by_frame": all(t == on_room[0] for t in on_room),
            "pool_peak": max(on_room[0]["pool_used"]),
            "objects_last_frame": on_room[0]["n_objects"][-1]}
        if room != "exact":
            traces[room]["against_exact"] = room_differences(work, room)
    study = {
        "what": __doc__.split("\n\n")[0].replace("\n", " "),
        "commands": {
            "generate exact": "python -m vmap_tpu_torch.generate_dataset "
                              "<data> " + " ".join(GENERATE)
                              + " --device cpu",
            "generate tpu2 / tpu7": "JAX_PLATFORMS=cpu python "
                                    "scripts/generate_dataset.py <data> "
                                    + " ".join(GENERATE) + ", in a copy of "
                                    "the JAX package with the room's patch",
            "common": " ".join(COMMON),
            "port": "python -m vmap_tpu_torch.room_pipeline --work <run> "
                    "--skip_generate <common> --train_seed S --tag <run> "
                    "--device cpu",
            "jax": "JAX_PLATFORMS=cpu python scripts/room_pipeline.py "
                   "--work <run> --skip_generate <common> --train_seed S "
                   "--tag <run> --px_block_bg 1 [--compute_dtype bfloat16]"},
        "patches": PATCHES, "rooms": traces, "runs": runs}
    args.out.write_text(json.dumps(study, indent=1) + "\n")
    for name, r in runs.items():
        print(name, round(r["object_mean"]["completion_ratio_5cm"], 4),
              round(r["object_mean"]["accuracy"] * 100, 2), "cm",
              "bg", round(r["bg"]["completion_ratio_5cm"], 4),
              "scene", round(r["scene"]["completion_ratio_5cm"], 4))
    print(json.dumps(traces))


if __name__ == "__main__":
    main()
