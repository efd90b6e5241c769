"""Object meshing: oriented bounds and field -> mesh extraction
(counterpart of ``vmap_tpu/core/meshing.py``).

  * ``object_bound``: per-object OBB from the union of masked depth
    back-projections over every stored keyframe, with a 10 cm extent floor
    and ``None`` for degenerate point sets;
  * ``eval_points``: chunked no-grad field queries through ``field_eval``
    (the K2 kernel on CUDA, its plain version on the CPU);
  * ``mesh_object``: an oriented [-1, 1]^3 grid (scaled by extent / 0.9,
    or / 0.995 for the background), occupancy -> marching cubes at level
    0.5 -> scene frame, vertex colours by re-querying the field;
  * ``mesh_all_objects``: every object's grid through one [O, chunk] field
    query per chunk, the grid built from index arithmetic on the device.

Marching cubes, ``Mesh``, ``obb_from_points`` and ``unproject_depth`` are
the JAX package's JAX-free host code, imported.

As in the JAX version, ``mesh_all_objects`` keeps at most ``window`` grid
chunks in flight: each chunk's occupancy is copied to the host (on CUDA,
asynchronously into a pinned staging buffer) as soon as it is queued, and
the host waits only on the oldest, so the device holds about
``window`` x O x chunk floats whatever the grid size, and each object's
host volume is its own grid_dim^3.

``STAGE_S`` holds the host seconds of each stage of the latest
``Mapper.export_meshes`` (device work included: every stage ends in a
transfer to the host).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from vmap_tpu_torch.geometry.marching_cubes import marching_cubes
from vmap_tpu_torch.geometry.mesh import Mesh, load_mesh
from vmap_tpu_torch.geometry.obb import OrientedBox, obb_from_points
from vmap_tpu_torch.geometry.pointcloud import unproject_depth
from vmap_tpu_torch.kernels.ensemble import field_eval, prepare_params
from vmap_tpu_torch.ops.render import make_3d_grid, occupancy_activation

EVAL_CHUNK = 1 << 17   # points per field query in eval_points
MESH_CHUNK = 1 << 16   # points per object per chunk in mesh_all_objects
LEVEL = 0.5            # occupancy level of the surface
# grid half-extent as a share of the bound (trainer.py:21-24 of the
# reference): objects 0.9, the background 0.995
BOUND_EXTENT_OBJ = 0.9
BOUND_EXTENT_BG = 0.995
WINDOW = 3             # grid chunks in flight in grid_volumes

STAGE_S: dict[str, float] = {}


@contextmanager
def stage(name: str):
    """Add the host seconds of the block to ``STAGE_S[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STAGE_S[name] = STAGE_S.get(name, 0.0) + time.perf_counter() - t0


def object_kind(mapper, obj_id: int) -> str:
    return "background" if mapper.registry[obj_id].is_bg else "objects"


def read_obj_vertices(path: str) -> np.ndarray:
    """Vertices [V, 3] of an exported ``.obj`` mesh."""
    return load_mesh(path).vertices


def oriented_box(center, rotation, extent) -> OrientedBox:
    """A bound: ``center`` [3], ``rotation`` [3, 3] (columns are the box
    axes), full ``extent`` [3] along them."""
    return OrientedBox(center, rotation, extent)


@torch.no_grad()
def eval_points(pe: dict, mlp_p: dict, scale, points,
                chunk: int = EVAL_CHUNK) -> tuple[np.ndarray, np.ndarray]:
    """(occupancy [N], colour [N, 3]) numpy arrays of one object's field at
    ``points`` (numpy or a tensor, [..., 3]), queried on the parameters'
    device in chunks; results come back in one transfer."""
    dev = pe["dirs"].device
    hidden = mlp_p["w_mid1"].shape[-1]
    prepared = prepare_params(pe, mlp_p, scale, hidden)
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev).reshape(-1, 3)
    occs, cols = [], []
    for s in range(0, len(pts), chunk):
        alpha, color = field_eval(prepared, pts[None, s:s + chunk])
        occs.append(occupancy_activation(alpha[0]))
        cols.append(color[0])
    return (torch.cat(occs).cpu().numpy(), torch.cat(cols).cpu().numpy())


def slot_unpack_cache(mapper, slots) -> dict:
    """Unpack the given pool slots once (one transfer) -> {pool_slot:
    (depth_m f32 [W, H], inst i32 [W, H])}, plus the pose table under key
    "twc". The same values as the per-slot ``FramePool`` views."""
    slots = sorted(set(slots))
    cache = {"twc": mapper.pool.twc.cpu().numpy()}
    if slots:
        depth, inst = mapper.pool.unpack_depth_inst(slots)
        cache.update({s: (depth[i], inst[i]) for i, s in enumerate(slots)})
    return cache


def object_points(mapper, obj_id: int, stride: int = 4,
                  cache: dict | None = None) -> np.ndarray:
    """World points from masked depth over every stored keyframe of an
    object, subsampled by ``stride``. ``cache`` (from slot_unpack_cache)
    avoids one transfer per keyframe when meshing many objects."""
    cfg = mapper.cfg
    rec = mapper.registry[obj_id]
    table = mapper.bg_table if rec.is_bg else mapper.obj_table
    t = table.objects[rec.slot]
    twc_pool = (cache["twc"] if cache is not None
                else mapper.pool.twc.cpu().numpy())
    pts = []
    for _local, pool_slot in t.all_slots():
        if cache is not None and pool_slot in cache:
            depth, inst_map = cache[pool_slot]
        else:
            depth = mapper.pool.slot_depth_m(pool_slot)
            inst_map = mapper.pool.slot_inst(pool_slot)
        mask = inst_map == obj_id
        if not mask.any():
            continue
        d = depth[::stride, ::stride]
        m = mask[::stride, ::stride]
        pts.append(unproject_depth(d, cfg.fx / stride, cfg.fy / stride,
                                   cfg.cx / stride, cfg.cy / stride,
                                   t_wc=twc_pool[pool_slot], mask=m))
    if not pts:
        return np.zeros((0, 3))
    return np.concatenate(pts)


def object_bound(mapper, obj_id: int, stride: int = 4,
                 cache: dict | None = None) -> OrientedBox | None:
    """Minimal OBB over the object's observed surface points (extents
    floored at 10 cm); None when fewer than 10 points or degenerate."""
    pts = object_points(mapper, obj_id, stride=stride, cache=cache)
    if len(pts) < 10:
        return None
    return obb_from_points(pts, min_extent=0.10)


def _to_scene(verts, faces, grid_dim: int, scene_scale,
              transform: np.ndarray) -> Mesh:
    """Marching-cubes index coordinates -> [0, 1] -> [-1, 1] -> scene."""
    mesh = Mesh(verts, faces)
    mesh.apply_scale(1.0 / (grid_dim - 1))
    mesh.apply_translation([-0.5, -0.5, -0.5])
    mesh.apply_scale(2.0)
    mesh.apply_scale(scene_scale)
    mesh.apply_transform(transform)
    return mesh


def _colour(mesh: Mesh, colors: np.ndarray, kind: str) -> None:
    mesh.vertex_colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    with stage(f"{kind} vertex normals"):
        mesh.compute_vertex_normals()


def mesh_object(mapper, obj_id: int, bound: OrientedBox,
                grid_dim: int = 256) -> Mesh | None:
    """A coloured mesh of one object's field inside ``bound``; None when
    no grid point is occupied or the level set is empty."""
    kind = object_kind(mapper, obj_id)
    pe, mlp_p, scale = mapper.object_params(obj_id)
    bound_extent = BOUND_EXTENT_BG if obj_id == 0 else BOUND_EXTENT_OBJ
    scene_scale = bound.extent / (2.0 * bound_extent)
    transform = bound.transform().astype(np.float32)
    with stage(f"{kind} grid query"):
        grid = make_3d_grid((-1.0, 1.0), grid_dim, transform=transform,
                            scale=scene_scale, device=mapper.device)
        occ, _ = eval_points(pe, mlp_p, scale, grid)
    if occ.max() == 0:   # "no occ" (trainer.py:92-94 of the reference)
        return None
    with stage(f"{kind} marching cubes"):
        verts, faces = marching_cubes(occ.reshape((grid_dim,) * 3),
                                      level=LEVEL)
    if verts is None:
        return None
    mesh = _to_scene(verts, faces, grid_dim, scene_scale, transform)
    with stage(f"{kind} vertex colours"):
        _, colors = eval_points(pe, mlp_p, scale,
                                mesh.vertices.astype(np.float32))
    _colour(mesh, colors, kind)
    return mesh


def adaptive_grid_dim(bound: OrientedBox, voxel_size: float,
                      max_dim: int = 256) -> int:
    """Grid resolution from physical extent (train.py:351 of the
    reference)."""
    return int(min(np.max(bound.extent) // voxel_size + 1, max_dim))


# ------------------------------------------------------------------------ #
# Bank-vectorised meshing: every object's grid chunk through one
# [O, chunk] field query, per-object grid points from index arithmetic.
# ------------------------------------------------------------------------ #
def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@torch.no_grad()
def _bank_grid_chunk(prepared: dict, rot, center, sscale, gd, start: int,
                     chunk: int):
    """Occupancy [O, chunk] (0 past an object's gd^3 points) and colour
    [O, chunk, 3] of grid points start .. start+chunk of every object.
    rot [O, 3, 3], center [O, 3], sscale [O, 3], gd [O] int64."""
    f = start + torch.arange(chunk, dtype=torch.int64,
                             device=rot.device)[None, :]        # [1, C]
    g = torch.clamp(gd, min=2)[:, None]                          # [O, 1]
    idx = torch.stack([f // (g * g), (f // g) % g, f % g],
                      dim=-1).to(torch.float32)                  # [O, C, 3]
    step = 2.0 / (g.to(torch.float32) - 1.0)
    local = (-1.0 + idx * step[:, :, None]) * sscale[:, None, :]
    pts = torch.einsum("ocj,oij->oci", local, rot) + center[:, None, :]
    alpha, color = field_eval(prepared, pts)
    valid = (f < g * g * g).to(torch.float32)
    return occupancy_activation(alpha) * valid, color


def mesh_work(mapper, obj_ids) -> list:
    """[(obj_id, bound, grid_dim)] of the objects with a bound, from one
    unpack of every keyframe slot they use."""
    cfg = mapper.cfg
    used = set()
    for oid in obj_ids:
        t = mapper.obj_table.objects.get(mapper.registry[oid].slot)
        if t is not None:
            used.update(ps for _l, ps in t.all_slots())
    with stage("objects pool unpack"):
        cache = slot_unpack_cache(mapper, used)
    work = []
    for oid in obj_ids:
        with stage("objects bounds"):
            bound = object_bound(mapper, oid, cache=cache)
        if bound is not None:
            gd = adaptive_grid_dim(bound, cfg.live_voxel_size, cfg.grid_dim)
            work.append((oid, bound, max(gd, 2)))
    return work


def bank_prepared(mapper, work) -> dict:
    """Prepared params of the work's slots, the object axis padded to a
    power of two (repeating the last slot)."""
    bank = mapper.bank_obj
    O = len(work)
    Op = 1 << (O - 1).bit_length()
    slots = [mapper.registry[oid].slot for oid, _, _ in work]
    idx = torch.as_tensor(slots + slots[-1:] * (Op - O), device=bank.device)
    pe, mlp_p = bank.spec.unflatten(bank.flat[idx])
    return prepare_params(pe, mlp_p, bank.scale[idx], bank.spec.hidden)


def grid_frames(work, n_obj: int, device) -> tuple:
    """(rot [n, 3, 3], center [n, 3], sscale [n, 3], gd [n]) tensors of
    the work items' grids, padded to n objects by repeating the last."""
    def frames(a, dtype):
        a = np.stack(a)
        a = np.concatenate([a, np.repeat(a[-1:], n_obj - len(a), axis=0)])
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (frames([b.R for _, b, _ in work], torch.float32),
            frames([b.center for _, b, _ in work], torch.float32),
            frames([b.extent / (2.0 * BOUND_EXTENT_OBJ) for _, b, _ in work],
                   torch.float32),
            frames([np.int64(g) for _, _, g in work], torch.int64))


def grid_volumes(mapper, work, prepared: dict, chunk: int = MESH_CHUNK,
                 window: int = WINDOW) -> list:
    """Occupancy volume [gd, gd, gd] (numpy) of each work item. At most
    ``window`` chunks are in flight; on CUDA each chunk's copy to the host
    is queued behind it into one of ``window`` + 1 pinned buffers, so the
    host waits only on the oldest chunk while later ones run."""
    dev = torch.device(mapper.device)
    O = len(work)
    frames = grid_frames(work, prepared["dirs"].shape[0], dev)
    sizes = [g ** 3 for _, _, g in work]
    vols = [np.empty(n, np.float32) for n in sizes]
    staging = ([torch.empty((O, chunk), dtype=torch.float32,
                            pin_memory=True) for _ in range(window + 1)]
               if dev.type == "cuda" else None)
    inflight = []            # (first grid index, host chunk, copy event)

    def drain(keep: int) -> None:
        while len(inflight) > keep:
            s, host, done = inflight.pop(0)
            if done is not None:
                done.synchronize()
            occ = host.numpy()
            for o, n in enumerate(sizes):
                if s < n:
                    vols[o][s:s + chunk] = occ[o, :min(chunk, n - s)]

    for i, s in enumerate(range(0, _round_up(max(sizes), chunk), chunk)):
        occ = _bank_grid_chunk(prepared, *frames, s, chunk)[0][:O]
        done = None
        if staging is not None:
            host = staging[i % len(staging)]
            host.copy_(occ, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = occ
        inflight.append((s, host, done))
        drain(window)
    drain(0)
    return [v.reshape(g, g, g) for v, (_, _, g) in zip(vols, work)]


@torch.no_grad()
def mesh_all_objects(mapper, obj_ids=None, chunk: int = MESH_CHUNK) -> dict:
    """Batched mesh extraction for many objects: {obj_id: Mesh | None}.

    Every non-background object's occupancy grid goes through one [O,
    chunk] field query per chunk (objects padded to a power of two);
    marching cubes runs per object on the host; vertex colours come from
    one more bank query over every mesh's vertices.
    """
    if obj_ids is None:
        obj_ids = [oid for oid in sorted(mapper.registry)
                   if not mapper.registry[oid].is_bg]
    out = {oid: None for oid in obj_ids}
    work = mesh_work(mapper, obj_ids)
    if not work:
        return out
    prepared = bank_prepared(mapper, work)
    with stage("objects grid query"):
        volumes = grid_volumes(mapper, work, prepared, chunk)
    meshes = {}
    for (oid, bound, gd), vol in zip(work, volumes):
        if vol.max() == 0:   # "no occ"
            continue
        with stage("objects marching cubes"):
            verts, faces = marching_cubes(vol, level=LEVEL)
        if verts is None:
            continue
        meshes[oid] = _to_scene(verts, faces, gd,
                                bound.extent / (2.0 * BOUND_EXTENT_OBJ),
                                bound.transform().astype(np.float32))

    # vertex colours: one [O, Vmax] query over every mesh
    if meshes:
        Op = prepared["dirs"].shape[0]
        slot_of = {oid: o for o, (oid, _, _) in enumerate(work)}
        vmax = _round_up(max(len(m.vertices) for m in meshes.values()), 512)
        pts = np.zeros((Op, vmax, 3), np.float32)
        for oid, mesh in meshes.items():
            pts[slot_of[oid], :len(mesh.vertices)] = mesh.vertices
        with stage("objects vertex colours"):
            _, colors = field_eval(prepared,
                                   torch.from_numpy(pts).to(mapper.device))
            colors = colors.cpu().numpy()
        for oid, mesh in meshes.items():
            _colour(mesh, colors[slot_of[oid], :len(mesh.vertices)],
                    "objects")
    out.update(meshes)
    return out
