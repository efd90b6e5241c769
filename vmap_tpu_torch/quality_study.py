"""Quality studies on the analytic scene (counterpart of
``scripts/quality_study.py``).

    python -m vmap_tpu_torch.quality_study [--quick] [--out table.json]
        [--device cuda|cpu]

Five variants of ``vmap_tpu_torch.eval_synthetic``, each in a process of
its own, at the JAX script's sizes (128 x 96 frames, 16 frames x 3
passes, grid 64; ``--quick``: 120 x 88, 12 x 2, grid 48):

  f32             the defaults;
  bf16            ``--dtype bfloat16``;
  px_block8       ``--px_block 8``;
  bg_rays160      ``--bg_rays 160``;
  bg_rays320_h64  ``--bg_rays 320 --bg_hidden 64`` (the background at
                  hidden 64, through K1 and K2 at that width on the card).

The table ({variant: {object: metrics, rounded to 4 places}}, or
{"error": ...} for a variant whose process failed) is printed as JSON and
written to ``--out`` (default ``quality_study.json`` in the working
directory; the JAX package's table, ``docs/quality_study.json``, is never
written). On the card the five processes run at once, sharing it (which
changes no result, only the study's wall time); on the CPU one after
another, as the JAX script runs them, so that they do not compete for the
cores. ``LAUNCHES`` keeps each variant's CUDA kernel launch counts,
from the ``kernel launches`` line its process printed (empty on the
CPU). Exits 1 if a variant failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = (("f32", []), ("bf16", ["--dtype", "bfloat16"]),
            ("px_block8", ["--px_block", "8"]),
            ("bg_rays160", ["--bg_rays", "160"]),
            ("bg_rays320_h64", ["--bg_rays", "320", "--bg_hidden", "64"]))
LAUNCHES: dict = {}
SIZES = {False: ["--frames", "16", "--passes", "3", "--grid", "64",
                 "--height", "96", "--width", "128"],
         True: ["--frames", "12", "--passes", "2", "--grid", "48",
                "--height", "88", "--width", "120"]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", default="quality_study.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def run(tag: str, extra: list, base: list, tmp: str) -> dict:
    """One variant in its own process -> its rounded metrics, or
    {"error": ...}."""
    out = os.path.join(tmp, f"quality_{tag}.json")
    args = base + extra + ["--out", out]
    print(f"=== {tag}: {' '.join(args)}", file=sys.stderr, flush=True)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [REPO] + [p for p in (os.environ.get("PYTHONPATH"),) if p])}
    r = subprocess.run([sys.executable, "-m", "vmap_tpu_torch.eval_synthetic"]
                       + args, capture_output=True, text=True, env=env,
                       timeout=3600)
    if r.returncode != 0:
        print(f"{tag} failed:\n{r.stderr[-1500:]}", file=sys.stderr,
              flush=True)
        return {"error": f"exit {r.returncode}"}
    print(r.stdout.strip(), file=sys.stderr, flush=True)
    tail = [ln for ln in r.stdout.splitlines()
            if ln.startswith("kernel launches ")]
    LAUNCHES[tag] = json.loads(tail[-1][len("kernel launches "):])
    with open(out) as f:
        return {k: {m: round(v, 4) for m, v in met.items()}
                for k, met in json.load(f).items()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    base = SIZES[args.quick] + ["--device", args.device]
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(1 if args.device == "cpu"
                               else len(VARIANTS)) as pool:
        runs = [pool.submit(run, tag, extra, base, tmp)
                for tag, extra in VARIANTS]
        table = {tag: r.result() for (tag, _), r in zip(VARIANTS, runs)}
    with open(args.out, "w") as f:
        json.dump(table, f, indent=2)
    print(json.dumps(table))
    if any("error" in v for v in table.values()):
        raise SystemExit(1)
    return table


if __name__ == "__main__":
    main()
