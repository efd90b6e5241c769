"""Checkpoints (counterpart of ``vmap_tpu/core/checkpoint.py``).

Two layers:

  * **Per-object artifacts**: one ``.npz`` per object holding epoch, MLP +
    PE parameters, object id, 3D bound and scale, in exactly the JAX
    package's format, so a file written by either package loads into the
    other.
  * **Full-state checkpoint** for resume, the port's own format:
    ``state_frame_<N>.pt`` (``torch.save`` of both banks with their Adam
    moments and steps, the frame pool and the states of the Mapper's two
    generators) plus ``state_frame_<N>.json`` (keyframe tables, registry,
    counters and pool accounting, as plain JSON) and a ``latest.json``
    pointer. A resumed run continues the uninterrupted run's random
    stream. The JAX package's orbax checkpoints do not load here.

With several ranks (``parallel/``) every rank reaches the gathers of the
sharded object bank (``Mapper.bank_obj``) before any returns, and only the
primary writes; on resume every rank loads the whole state and keeps its
rows.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from vmap_tpu_torch.core.keyframe import KeyframeTable, ObjectKF
from vmap_tpu_torch.geometry.obb import OrientedBox
from vmap_tpu_torch.core import bank as bank_lib
from vmap_tpu_torch.core.bank import FIELDS, BankSpec, BankState
from vmap_tpu_torch.parallel.distributed import is_primary


# ---------------- per-object artifacts ---------------------------------- #
def save_object_checkpoint(mapper, obj_id: int, path: str, epoch: int) -> str:
    """``<path>/obj_<id>_frame_<epoch>.npz``; "" on a rank but the
    primary, which reads the object (a collective) and writes nothing."""
    pe, mlp_p, scale = mapper.object_params(obj_id)
    bound = mapper.get_bound(obj_id)
    if not is_primary():
        return ""
    os.makedirs(path, exist_ok=True)

    def host(v):
        return v.detach().cpu().numpy()

    out = {f"mlp/{k}": host(v) for k, v in mlp_p.items()}
    out |= {f"pe/{k}": host(v) for k, v in pe.items()}
    out["epoch"] = np.int64(epoch)
    out["obj_id"] = np.int64(obj_id)
    out["obj_scale"] = np.float64(scale)
    if bound is not None:
        out["bound_center"] = bound.center
        out["bound_R"] = bound.R
        out["bound_extent"] = bound.extent
    file = os.path.join(path, f"obj_{obj_id}_frame_{epoch}.npz")
    np.savez_compressed(file, **out)
    return file


def load_object_checkpoint(file: str) -> dict:
    """-> {"mlp": params, "pe": params, "obj_id", "epoch", "obj_scale",
    "bound": OrientedBox | None} (numpy arrays)."""
    z = np.load(file)
    bound = None
    if "bound_center" in z.files:
        bound = OrientedBox(z["bound_center"], z["bound_R"], z["bound_extent"])
    return {
        "mlp": {k[4:]: z[k] for k in z.files if k.startswith("mlp/")},
        "pe": {k[3:]: z[k] for k in z.files if k.startswith("pe/")},
        "obj_id": int(z["obj_id"]), "epoch": int(z["epoch"]),
        "obj_scale": float(z["obj_scale"]), "bound": bound,
    }


def restore_object_into_mapper(mapper, ckpt: dict) -> None:
    """Write a loaded per-object checkpoint into the object's bank slot."""
    rec = mapper.registry[ckpt["obj_id"]]
    bank = mapper.bank_bg if rec.is_bg else mapper.bank_obj
    bank_lib.set_slot_params(bank, rec.slot, ckpt["pe"], ckpt["mlp"])
    bank.scale[rec.slot] = ckpt["obj_scale"]
    if not rec.is_bg:   # a sharded bank_obj is a gathered copy
        mapper.bank_obj = bank


# ---------------- full-state resume checkpoint -------------------------- #
def _kf_to_plain(t: ObjectKF) -> dict:
    st = t.rng.getstate()
    return {
        "buffer_size": t.buffer_size, "keyframe_step": t.keyframe_step,
        "pool_slot": [int(x) for x in t.pool_slot],
        "bbox": [np.asarray(b, np.float32).tolist() for b in t.bbox],
        "order": [int(x) for x in t.order],
        "latest_q": [int(x) for x in t.latest_q],
        "n_kf": int(t.n_kf), "frame_cnt": int(t.frame_cnt),
        "kf_pointer": t.kf_pointer,
        "buffer_full": bool(t.buffer_full),
        "rng_state": [st[0], list(st[1]), st[2]],
    }


def _kf_from_plain(d: dict) -> ObjectKF:
    t = ObjectKF(buffer_size=int(d["buffer_size"]),
                 keyframe_step=int(d["keyframe_step"]))
    t.pool_slot = [int(x) for x in d["pool_slot"]]
    t.bbox = [np.asarray(b, np.float32) for b in d["bbox"]]
    t.order = [int(x) for x in d["order"]]
    t.latest_q = [int(x) for x in d["latest_q"]]
    t.n_kf = int(d["n_kf"])
    t.frame_cnt = int(d["frame_cnt"])
    t.kf_pointer = None if d["kf_pointer"] is None else int(d["kf_pointer"])
    t.buffer_full = bool(d["buffer_full"])
    t.rng = random.Random()
    v, internal, gauss = d["rng_state"]
    t.rng.setstate((v, tuple(internal), gauss))
    return t


def _table_to_plain(table: KeyframeTable) -> dict:
    return {"capacity": table.capacity, "buffer_size": table.buffer_size,
            "objects": {str(slot): _kf_to_plain(t)
                        for slot, t in table.objects.items()}}


def _table_from_plain(d: dict) -> KeyframeTable:
    table = KeyframeTable(int(d["capacity"]), int(d["buffer_size"]))
    table.objects = {int(s): _kf_from_plain(t)
                     for s, t in d["objects"].items()}
    table.mark_dirty()
    return table


def _bank_tensors(bank: BankState | None):
    return None if bank is None else {f: getattr(bank, f)
                                      for f in FIELDS}


def _bank_from(tensors: dict | None, hidden: int | None,
               device: torch.device) -> BankState | None:
    if tensors is None:
        return None
    return BankState(spec=BankSpec.create(hidden),
                     **{f: tensors[f].to(device) for f in FIELDS})


def save_full_checkpoint(mapper, path: str, frame_id: int) -> str:
    """Write the full mapper state for resume; returns the ``.pt`` path
    (the primary's, on every rank)."""
    stem = os.path.join(path, f"state_frame_{frame_id}")
    bank_obj = mapper.bank_obj   # a collective with several ranks
    if not is_primary():
        return stem + ".pt"
    os.makedirs(path, exist_ok=True)
    torch.save({
        "bank_obj": _bank_tensors(bank_obj),
        "bank_bg": _bank_tensors(mapper.bank_bg),
        "pool_packed": mapper.pool.packed, "pool_twc": mapper.pool.twc,
        "init_gen": mapper.init_gen.get_state(),
        "draw_gen": mapper.draw_gen.get_state(),
    }, stem + ".pt")
    pool = mapper.pool
    host = {
        "frame_id": frame_id,
        "obj_table": _table_to_plain(mapper.obj_table),
        "bg_table": _table_to_plain(mapper.bg_table),
        "registry": {str(oid): vars(r) for oid, r in mapper.registry.items()},
        "slot_objid": mapper._slot_objid.tolist(),
        "next_slot": mapper._next_slot,
        "frames_ingested": mapper.frames_ingested,
        "models_full_events": mapper.models_full_events,
        "pool_force_released": mapper.pool_force_released,
        "pool_refcount": pool.refcount.tolist(),
        "pool_frame_id": pool.frame_id.tolist(),
        "pool_write_seq": pool.write_seq.tolist(),
        "pool_seq": pool._seq,
        "bank_obj_hidden": bank_obj.spec.hidden,
        "bank_bg_hidden": (None if mapper.bank_bg is None
                           else mapper.bank_bg.spec.hidden),
    }
    with open(stem + ".json", "w") as f:
        json.dump(host, f)
    with open(os.path.join(path, "latest.json"), "w") as f:
        json.dump({"frame_id": frame_id,
                   "file": os.path.basename(stem) + ".pt"}, f)
    return stem + ".pt"


def load_full_checkpoint(mapper, file: str) -> int:
    """Restore a full-state checkpoint into ``mapper`` (a ``.pt`` file, or
    a directory holding ``latest.json``); returns its frame id. A rank of
    a sharded Mapper keeps its rows of the object bank."""
    from vmap_tpu_torch.core.mapper import ObjectRecord
    if os.path.isdir(file):
        with open(os.path.join(file, "latest.json")) as f:
            file = os.path.join(file, json.load(f)["file"])
    with open(file[:-len(".pt")] + ".json") as f:
        host = json.load(f)
    dev = mapper.device
    state = torch.load(file, map_location="cpu", weights_only=True)
    mapper.bank_obj = _bank_from(state["bank_obj"], host["bank_obj_hidden"],
                                 dev)
    mapper.bank_bg = _bank_from(state["bank_bg"], host["bank_bg_hidden"], dev)
    pool = mapper.pool
    pool.packed = state["pool_packed"].to(dev)
    pool.twc = state["pool_twc"].to(dev)
    pool.refcount = np.asarray(host["pool_refcount"], np.int64)
    pool.frame_id = np.asarray(host["pool_frame_id"], np.int64)
    pool.write_seq = np.asarray(host["pool_write_seq"], np.int64)
    pool._seq = int(host["pool_seq"])
    mapper.init_gen.set_state(state["init_gen"])
    mapper.draw_gen.set_state(state["draw_gen"])
    mapper.obj_table = _table_from_plain(host["obj_table"])
    mapper.bg_table = _table_from_plain(host["bg_table"])
    mapper.registry = {int(oid): ObjectRecord(**r)
                       for oid, r in host["registry"].items()}
    mapper._slot_objid = np.asarray(host["slot_objid"], np.int32)
    mapper._next_slot = int(host["next_slot"])
    mapper.frames_ingested = int(host["frames_ingested"])
    mapper.models_full_events = int(host["models_full_events"])
    mapper.pool_force_released = int(host["pool_force_released"])
    return int(host["frame_id"])
