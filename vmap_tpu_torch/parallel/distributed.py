"""Multi-process execution (counterpart of
``vmap_tpu/parallel/distributed.py``).

Every rank runs the same loop over the same frame stream (SLAM input is
one deterministic stream, so no data is distributed). Start-up from the
environment, as the JAX package's::

    VMAP_COORDINATOR=127.0.0.1:29500 VMAP_NUM_PROCESSES=2 VMAP_PROCESS_ID=0 \\
        python -m vmap_tpu_torch.train --config ... --logdir ...

(one command a rank, ``VMAP_PROCESS_ID`` 0 .. n - 1). Host-side views of
the sharded state (meshing, evaluation, checkpoints) go through
``gather_rows``, a collective: every rank must reach those call sites at
the same cadence, which the Mapper's ``bank_obj`` getter and the trainer
do; only the primary rank writes files.

Backend: gloo, with every collective on host tensors. The only collective
of a frame is one loss pair, read at the trainer's logging cadence, and
the gathers come at mesh and checkpoint cadence, where their consumers
(marching cubes, ``.obj`` and checkpoint files) are on the host anyway.
NCCL refuses two ranks on one device, and that layout is the only one a
single card can check; gloo runs the same code in the CPU tests, on one
card and across cards.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_LOOPBACK = ("127.0.0.1", "localhost")


def init_from_env() -> tuple[int, int]:
    """Join the process group that ``VMAP_COORDINATOR`` (host:port of rank
    0), ``VMAP_NUM_PROCESSES`` and ``VMAP_PROCESS_ID`` describe; returns
    (rank, world size). A no-op returning (0, 1) when the coordinator is
    unset, so one-process runs are unaffected."""
    coord = os.environ.get("VMAP_COORDINATOR")
    if not coord:
        return 0, 1
    if dist.is_initialized():   # a second run in the same process
        return dist.get_rank(), dist.get_world_size()
    nproc = int(os.environ["VMAP_NUM_PROCESSES"])
    pid = int(os.environ["VMAP_PROCESS_ID"])
    if coord.rsplit(":", 1)[0] in _LOOPBACK:
        # ranks of one machine: gloo's transport on the loopback device,
        # not on whatever interface the host name resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend="gloo", init_method=f"tcp://{coord}",
                            world_size=nproc, rank=pid)
    return pid, nproc


def shutdown() -> None:
    """Leave the process group, where there is one: a barrier, so that no
    rank exits while another still uses the group (rank 0 holds its
    store), then the group's destruction. COLLECTIVE; the CLIs call it
    last."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes files (logs, meshes, checkpoints)."""
    return rank() == 0


def is_multiprocess() -> bool:
    return world_size() > 1


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:(rank % torch.cuda.device_count())``
    for a CUDA request, made the current device; the CPU where the caller
    asks for it. Raises without CUDA unless the CPU is asked for."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; refusing to fall back to the CPU")
    dev = torch.device("cuda", rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def new_group(ranks: list[int]):
    """A gloo process group of ``ranks``. COLLECTIVE: every rank of the
    world makes every group, in the same order."""
    return dist.new_group(ranks, backend="gloo")


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """All-gather of equal row blocks over ``group``, in its rank order,
    into the whole tensor on ``t``'s device (the counterpart of JAX's
    ``replicate_tree`` for one leaf). COLLECTIVE: every rank of the group
    calls it with its own block of the same shape."""
    host = t.detach().cpu().contiguous()
    if host.dtype == torch.bool:   # gloo gathers no bool
        return gather_rows(host.to(torch.uint8), group).bool().to(t.device)
    parts = [torch.empty_like(host)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts).to(t.device)


def sum_over(values: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``values`` (any device) over ``group``, on the host.
    COLLECTIVE."""
    host = values.detach().cpu().to(torch.float64).contiguous()
    dist.all_reduce(host, group=group)
    return host
