"""Ranks of one gloo world on this machine, each a process.

``spawn(n, argv_of)`` starts rank r as the command ``argv_of(r)``, with
``VMAP_COORDINATOR`` at a free loopback port, ``VMAP_NUM_PROCESSES`` n and
``VMAP_PROCESS_ID`` r, and the directory that holds this package on
``PYTHONPATH``; ``collect(procs, timeout)`` reads each rank's last JSON
line, in rank order, and kills every rank on a failure or a timeout, so
that no rank outlives its caller.

One trainer rank, which prints such a line::

    python -m vmap_tpu_torch.parallel.launch <logdir prefix> <train args>

runs ``vmap_tpu_torch.train`` with ``--logdir <prefix>_r<rank>`` (only
rank 0 makes its logdir) and then prints its slot rows, frames, wall
seconds, kernel launches and ``foreign_modules()``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn(n: int, argv_of, env: dict | None = None) -> list:
    """``n`` rank processes of one gloo world, run in ``ROOT``; ``env``
    (default this process's environment) is the base of every rank's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ if env is None else env)
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               VMAP_COORDINATOR=f"127.0.0.1:{port}",
               VMAP_NUM_PROCESSES=str(n))
    return [subprocess.Popen(argv_of(r), env={**env,
                                              "VMAP_PROCESS_ID": str(r)},
                             cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(n)]


def collect(procs: list, timeout: float) -> list:
    """Each rank's last JSON line, in rank order. Raises if a rank exits
    with another code than 0 or outlasts ``timeout`` seconds (each), and
    then kills every rank still running."""
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   f"{err[-4000:]}")
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def foreign_modules() -> list:
    """The modules of JAX, of the JAX package and of OpenCV that this
    process holds: none, for a run of the port."""
    return sorted(k for k in sys.modules
                  if k in ("jax", "vmap_tpu", "cv2")
                  or k.startswith(("jax.", "jaxlib", "vmap_tpu.", "cv2.")))


def train_rank(prefix: str, args: list) -> dict:
    """``vmap_tpu_torch.train`` on this rank with ``--logdir
    <prefix>_r<rank>``, then the rank's report."""
    from vmap_tpu_torch import train
    from vmap_tpu_torch.kernels import ensemble, train_step
    from vmap_tpu_torch.parallel import distributed

    rank = int(os.environ.get("VMAP_PROCESS_ID", "0"))
    t0 = time.perf_counter()
    m = train.main(["--logdir", f"{prefix}_r{rank}", *args])
    wall = time.perf_counter() - t0
    out = {"rank": rank, "slots": [m.lo, m.hi], "frames": m.frames_ingested,
           "wall_s": wall,
           "launches": {**train_step.LAUNCHES, **ensemble.LAUNCHES},
           "foreign": foreign_modules()}
    print(json.dumps(out), flush=True)
    distributed.shutdown()
    return out


if __name__ == "__main__":
    train_rank(sys.argv[1], sys.argv[2:])
