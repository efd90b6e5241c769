"""The ("obj", "data") mesh of ranks and the row layout of sharded state
(counterpart of ``vmap_tpu/parallel/sharding.py``).

Rank r sits at (obj index, data index) = (r // n_data, r % n_data), the
order in which the JAX package's ``Mesh(devs.reshape(n_obj, n_data))``
places device r, and holds the contiguous block of object slots of its
obj index: the rows ``NamedSharding(mesh, P("obj"))`` gives that device.
The object bank, its Adam state, the keyframe tables, the object ids and
the sampler's object draws take those rows (``place_*``); the pool and the
background bank stay whole on every rank. The ranks that share a data
index form the obj group, over which the object parts of the loss are
summed and the bank is gathered.
"""

from __future__ import annotations

from dataclasses import dataclass

from vmap_tpu_torch.core.bank import FIELDS
from vmap_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """The shape of the rank mesh: ``n_obj`` x ``n_data`` ranks."""
    n_obj: int
    n_data: int = 1

    def index(self, rank: int) -> tuple[int, int]:
        """(obj index, data index) of ``rank``."""
        return rank // self.n_data, rank % self.n_data

    def obj_ranks(self, data: int) -> list[int]:
        """The ranks of data index ``data``, in obj order (an obj group)."""
        return [o * self.n_data + data for o in range(self.n_obj)]

    def slot_range(self, rank: int, slots: int) -> tuple[int, int]:
        """[lo, hi) of the object slots ``rank`` holds."""
        if slots % self.n_obj:
            raise ValueError(f"{slots} slots do not divide over the obj "
                             f"mesh axis ({self.n_obj})")
        per = slots // self.n_obj
        o = self.index(rank)[0]
        return o * per, (o + 1) * per


def make_mesh(n: int) -> Mesh:
    """The JAX package's default mesh of n devices: (n / 2, 2) for an even
    n of at least 4, else (n, 1)."""
    if n >= 4 and n % 2 == 0:
        return Mesh(n // 2, 2)
    return Mesh(n, 1)


def mesh_from_axes(axes: dict, world: int | None = None) -> Mesh | None:
    """The mesh of the config's ``tpu.mesh_axes`` (e.g. ``{"obj": 4,
    "data": 2}``) over ``world`` ranks (default: the process group's size,
    1 without one); None for a trivial spec. The world must be exactly the
    mesh: a smaller one raises as the JAX package does, a larger one too
    (a rank outside the mesh would hold no rows)."""
    n_obj = int(axes.get("obj", 1))
    n_data = int(axes.get("data", 1))
    if n_obj * n_data <= 1:
        return None
    world = distributed.world_size() if world is None else world
    if world < n_obj * n_data:
        raise ValueError(
            f"tpu.mesh_axes asks for obj={n_obj} x data={n_data} = "
            f"{n_obj * n_data} devices but only {world} are visible")
    if world > n_obj * n_data:
        raise ValueError(
            f"tpu.mesh_axes asks for obj={n_obj} x data={n_data} = "
            f"{n_obj * n_data} devices but {world} ranks were started")
    return Mesh(n_obj, n_data)


def obj_group(mesh: Mesh, rank: int):
    """The process group of ``rank``'s obj group. COLLECTIVE: every rank
    makes every group, in data order, as ``torch.distributed.new_group``
    requires."""
    groups = [distributed.new_group(mesh.obj_ranks(d))
              for d in range(mesh.n_data)]
    return groups[mesh.index(rank)[1]]


def place_bank(bank, lo: int, hi: int):
    """The bank's slots [lo, hi) (parameters, moments, steps, activity and
    scales) as tensors of their own."""
    return bank.replace(**{f: getattr(bank, f)[lo:hi].clone()
                           for f in FIELDS})


def place_tables(tab: tuple, lo: int, hi: int) -> tuple:
    return tuple(a[lo:hi] for a in tab)


def place_draws(draws, lo: int, hi: int):
    """The object draws of slots [lo, hi) (every field is per slot)."""
    return type(draws)(**{k: v[lo:hi] for k, v in vars(draws).items()})

