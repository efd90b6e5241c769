"""The port's mesh of ranks (``vmap_tpu_torch/parallel/``) against the JAX
package's ``parallel/`` on the conftest's 8 virtual CPU devices: each
rank's slot rows are the rows JAX's ``NamedSharding(mesh, P("obj"))``
gives the device at that rank's place, ``make_mesh`` / ``mesh_from_axes``
take JAX's shapes and raise JAX's errors, ``init_from_env`` is a no-op
without ``VMAP_COORDINATOR``, and ``launch`` starts a world's ranks and
kills them all when one fails."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from vmap_tpu.parallel import sharding as jsh
from vmap_tpu_torch.config import Config
from vmap_tpu_torch.core.mapper import Mapper
from vmap_tpu_torch.parallel import distributed, launch, sharding

import _torch_parity  # noqa: F401  (one torch thread)


@pytest.mark.parametrize("axes,slots", [
    ({"obj": 4, "data": 2}, 8), ({"obj": 4, "data": 2}, 104),
    ({"obj": 2}, 8), ({"obj": 2}, 104)])
def test_slot_rows_match_jax_named_sharding(axes, slots):
    jmesh = jsh.mesh_from_axes(axes)
    mesh = sharding.mesh_from_axes(axes, world=jmesh.devices.size)
    assert (mesh.n_obj, mesh.n_data) == (jmesh.shape["obj"],
                                         jmesh.shape["data"])
    order = list(jmesh.devices.flatten())     # rank r <-> device r
    arr = jax.device_put(jnp.arange(slots),
                         NamedSharding(jmesh, P("obj")))
    seen = set()
    for shard in arr.addressable_shards:
        r = order.index(shard.device)
        o, d = mesh.index(r)
        assert jmesh.devices[o, d] == shard.device
        assert r in mesh.obj_ranks(d)
        rows = np.asarray(shard.data)
        lo, hi = mesh.slot_range(r, slots)
        np.testing.assert_array_equal(rows, np.arange(lo, hi))
        seen.add(r)
    assert seen == set(range(mesh.n_obj * mesh.n_data))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_make_mesh_shapes(n):
    got = sharding.make_mesh(n)
    want = jsh.make_mesh(n)
    assert (got.n_obj, got.n_data) == (want.shape["obj"],
                                       want.shape["data"])
    assert got.n_obj * got.n_data == n


@pytest.mark.parametrize("axes", [{}, {"obj": 1}, {"obj": 1, "data": 1},
                                  {"data": 1}])
def test_trivial_axes_give_no_mesh(axes):
    assert sharding.mesh_from_axes(axes) is None
    assert jsh.mesh_from_axes(axes) is None


def test_mesh_larger_than_the_world_raises_jax_error():
    axes = {"obj": 8, "data": 2}
    with pytest.raises(ValueError) as want:
        jsh.mesh_from_axes(axes)          # 16 devices asked of 8
    with pytest.raises(ValueError) as got:
        sharding.mesh_from_axes(axes, world=len(jax.devices()))
    assert str(got.value) == str(want.value)
    # one process and no group: a world of 1
    with pytest.raises(ValueError, match="only 1 are visible"):
        sharding.mesh_from_axes({"obj": 2})


def test_world_larger_than_the_mesh_raises():
    with pytest.raises(ValueError, match="3 ranks were started"):
        sharding.mesh_from_axes({"obj": 2}, world=3)


def test_slots_that_do_not_divide_raise_jax_error(monkeypatch):
    """The Mapper raises the JAX Mapper's error when its slots do not
    divide over "obj" (the world faked at 3 ranks; the check comes before
    any group is made)."""
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    cfg = Config(max_n_models=4, mesh_axes={"obj": 3}, W=80, H=60)
    with pytest.raises(ValueError, match=r"max_n_models=4 must divide "
                       r"evenly over the obj mesh axis \(3\)"):
        Mapper(cfg, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        sharding.Mesh(3).slot_range(0, 4)


def test_init_from_env_is_a_noop_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("VMAP_COORDINATOR", raising=False)
    assert distributed.init_from_env() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary() and not distributed.is_multiprocess()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="refusing"):
        distributed.rank_device("cuda")


def test_place_takes_a_ranks_rows():
    from vmap_tpu_torch.core import bank as bank_lib
    from vmap_tpu_torch.core.step import Draws
    bank = bank_lib.init_bank(torch.Generator().manual_seed(0), 4, 8)
    bank.active[1] = True
    part = sharding.place_bank(bank, 1, 3)
    assert part.capacity == 2 and part.active.tolist() == [True, False]
    torch.testing.assert_close(part.flat, bank.flat[1:3])
    part.flat += 1          # a copy of its own
    assert not torch.equal(part.flat, bank.flat[1:3])
    d = Draws(*(torch.arange(4.0)[:, None].expand(4, k) for k in (1, 2, 3, 4)))
    assert all(v[:, 0].tolist() == [2.0, 3.0]
               for v in vars(sharding.place_draws(d, 2, 4)).values())
    tab = (np.arange(8).reshape(4, 2), np.arange(4))
    assert [t.tolist() for t in sharding.place_tables(tab, 0, 2)] == \
        [[[0, 1], [2, 3]], [0, 1]]


def _script(code: str):
    return lambda r: [sys.executable, "-c", code]


def test_launch_gives_each_rank_its_place_in_one_world():
    code = ("import json, os, sys\n"
            "print('a line that is not JSON')\n"
            "print(json.dumps({k: os.environ[k] for k in ("
            "'VMAP_COORDINATOR', 'VMAP_NUM_PROCESSES', 'VMAP_PROCESS_ID')}"
            " | {'path': sys.path}))\n")
    outs = launch.collect(launch.spawn(3, _script(code)), timeout=60)
    assert [o["VMAP_PROCESS_ID"] for o in outs] == ["0", "1", "2"]
    assert {o["VMAP_NUM_PROCESSES"] for o in outs} == {"3"}
    coord = {o["VMAP_COORDINATOR"] for o in outs}
    assert len(coord) == 1 and coord.pop().startswith("127.0.0.1:")
    assert all(launch.ROOT in o["path"] for o in outs)
    assert os.path.isdir(os.path.join(launch.ROOT, "vmap_tpu_torch"))


def test_launch_kills_every_rank_when_one_fails():
    code = ("import os, sys, time\n"
            "if os.environ['VMAP_PROCESS_ID'] == '0':\n"
            "    sys.exit('rank 0 gives up')\n"
            "time.sleep(120)\n")
    procs = launch.spawn(2, _script(code))
    with pytest.raises(RuntimeError, match="rank 0 exited 1"):
        launch.collect(procs, timeout=60)
    assert [p.returncode for p in procs][1] not in (None, 0)


def test_launch_kills_every_rank_after_its_timeout():
    procs = launch.spawn(2, _script("import time; time.sleep(120)"))
    with pytest.raises(subprocess.TimeoutExpired):
        launch.collect(procs, timeout=1)
    assert all(p.returncode not in (None, 0) for p in procs)


def test_foreign_modules_lists_jax():
    # this test process holds JAX; the ranks of the sharded tests hold none
    assert "jax" in launch.foreign_modules()
    assert "vmap_tpu.parallel.sharding" in launch.foreign_modules()
