"""The port's sharded Mapper (``tpu.mesh_axes``, ``vmap_tpu_torch/
parallel/``) as gloo ranks on the CPU:

  * 2 ranks ``{"obj": 2}`` and 4 ranks ``{"obj": 2, "data": 2}`` against
    the port's one-process run on the same draws and banks: per-frame
    losses and the gathered banks within rtol 2e-3 / atol 1e-4 (JAX's
    ``tests/test_fused_sharded.py``), every rank holding the slot rows
    JAX's mesh gives its device and reading the same losses;
  * the same runs against JAX's Mapper with ``{"obj": 2, "data": 2}`` on
    the conftest's virtual devices, with JAX's draws injected
    (``_torch_parity.KeyedDraws``) and JAX's banks loaded after the first
    ingest: losses within ``tests/test_torch_mapper.py``'s tolerances
    (the last iteration's rtol 2e-3, the mean's 0.1) but where the loss
    conditioning already parts the one-process run from JAX (see that
    test), the banks within rtol 2e-3 plus 1e-3 of scale
    (``tests/test_torch_live.py``). Every
    object shows in every frame of the analytic orbit, so no active
    slot's mask is empty (JAX's CPU step applies the empty-mask rule over
    the whole bank, the port's ranks over their own rows: see the last
    test);
  * the CLI with ``VMAP_COORDINATOR`` on 2 ranks: only the primary writes
    the log, meshes and checkpoints, a resume across ranks continues the
    run (the losses of 11 + 2 frames equal those of a one-process run of
    13 frames), and no rank imports jax;
  * the empty-mask rule acting per shard.

Every rank is a process capped at one torch thread, started and
collected by ``vmap_tpu_torch.parallel.launch``, which kills every rank
on any failure or after 300 s."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from vmap_tpu.config import Config as JConfig
from vmap_tpu.core.mapper import FrameSample as JFrame
from vmap_tpu.core.mapper import Mapper as JMapper
from vmap_tpu_torch.config import Config
from vmap_tpu_torch.core import step as ts
from vmap_tpu_torch.core.mapper import FrameSample, Mapper
from vmap_tpu_torch.data.synthetic import SyntheticScene
from vmap_tpu_torch.interop import FIELDS, bank_from_numpy
from vmap_tpu_torch.parallel import launch

from _torch_parity import KeyedDraws, StepKeys, small_synthetic_config

RANK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "_torch_sharded_rank.py")
FRAMES = 4
KW = dict(
    max_n_models=2, do_bg=True, hidden_feature_size=8,
    hidden_feature_size_bg=16, n_iter_per_frame=2, win_size=2,
    n_samples_per_frame=16, win_size_bg=2, n_samples_per_frame_bg=24,
    keyframe_buffer_size=5, keyframe_step=2, keyframe_step_bg=2, W=80,
    H=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5, frame_pool_size=16, seed=0)
MESHES = {"obj2": {"obj": 2}, "obj2data2": {"obj": 2, "data": 2}}
# the slot rows of each rank: JAX's NamedSharding(P("obj")) on the mesh
# (tests/test_torch_parallel.py holds the port's ranges to it)
SLOTS = {"obj2": [[0, 1], [1, 2]],
         "obj2data2": [[0, 1], [0, 1], [1, 2], [1, 2]]}


def spawn_ranks(n: int, argv_of) -> list:
    """``n`` rank processes of one gloo world, each on one thread and
    without the conftest's JAX settings."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    return launch.spawn(n, argv_of, env={**env, "OMP_NUM_THREADS": "1"})


def results(procs) -> list:
    return launch.collect(procs, timeout=300)


def _frame(scene, i, cls):
    s = scene.frame_sample(i, n_frames=8)
    return cls(s["image"], s["depth"], s["obj"], s["bbox_dict"], s["T"], i)


def _banks(mapper) -> dict:
    return {**{f"obj_{f}": np.array(getattr(mapper.bank_obj, f))
               for f in FIELDS},
            **{f"bg_{f}": np.array(getattr(mapper.bank_bg, f))
               for f in FIELDS}}


class Recorder:
    """draw_source that passes another's draws on and keeps them."""

    def __init__(self, source):
        self.source, self.draws = source, []

    def __call__(self, bank, shapes):
        d = self.source(bank, shapes)
        self.draws.append(d)
        return d

    def save(self, path):
        np.savez(path, **{f"{i}_{k}": v.numpy()
                          for i, d in enumerate(self.draws)
                          for k, v in vars(d).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's Mapper on {"obj": 2, "data": 2}, the port in one process on
    JAX's draws and banks, then the port's 2- and 4-rank runs replaying
    the same draws (all six ranks at once)."""
    tmp = tmp_path_factory.mktemp("sharded")
    scene = SyntheticScene(width=KW["W"], height=KW["H"], fx=KW["fx"],
                           fy=KW["fy"])
    jm = JMapper(JConfig(**KW, mesh_axes=MESHES["obj2data2"]))
    keys = StepKeys(jm)
    rec = Recorder(KeyedDraws(keys.keys))
    pm = Mapper(Config(**KW), device="cpu", draw_source=rec)
    jax_run = {"losses": [], "loss_mean": []}
    one = {"losses": [], "loss_mean": []}
    for i in range(FRAMES):
        jm.ingest_frame(_frame(scene, i, JFrame))
        pm.ingest_frame(_frame(scene, i, FrameSample))
        if i == 0:
            start = _banks(jm)
            np.savez(tmp / "banks.npz", **start)
            pm.bank_obj = bank_from_numpy(
                {f: start[f"obj_{f}"] for f in FIELDS},
                KW["hidden_feature_size"])
            pm.bank_bg = bank_from_numpy(
                {f: start[f"bg_{f}"] for f in FIELDS},
                KW["hidden_feature_size_bg"])
        assert len(pm.registry) == len(jm.registry) == 3   # bg + 2 objects
        with keys.recording():
            met_j = jm.train_frame()
        met_p = pm.train_frame()
        for run, met in ((jax_run, met_j), (one, met_p)):
            run["losses"].append(float(met["loss"]))
            run["loss_mean"].append(float(met["loss_mean"]))
    jax_run["banks"], one["banks"] = _banks(jm), _banks(pm)
    rec.save(tmp / "draws.npz")

    procs = {}
    for name, axes in MESHES.items():
        spec = tmp / f"{name}.json"
        spec.write_text(json.dumps({
            "config": {**KW, "mesh_axes": axes}, "frames": FRAMES,
            "draws": str(tmp / "draws.npz"), "banks": str(tmp / "banks.npz"),
            "out": str(tmp / f"{name}_banks.npz")}))
        procs[name] = spawn_ranks(len(SLOTS[name]),
                                  lambda r, s=spec: [sys.executable, RANK,
                                                     str(s)])
    sharded = {}
    for name, ps in procs.items():
        sharded[name] = {"ranks": results(ps),
                         "banks": dict(np.load(tmp / f"{name}_banks.npz"))}
    return {"jax": jax_run, "one": one, **sharded}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_match_the_one_process_run(runs, mesh):
    one, ranks = runs["one"], runs[mesh]["ranks"]
    assert [r["slots"] for r in ranks] == SLOTS[mesh]
    assert [r["world"] for r in ranks] == [len(SLOTS[mesh])] * len(ranks)
    for r in ranks:
        assert r["foreign"] == [], r["foreign"]
        # every rank reads the same reduced losses
        assert r["losses"] == ranks[0]["losses"]
        assert r["loss_mean"] == ranks[0]["loss_mean"]
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=2e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(r["loss_mean"], one["loss_mean"],
                                   rtol=2e-3, atol=1e-4)
    for k, want in one["banks"].items():
        np.testing.assert_allclose(runs[mesh]["banks"][k], want, rtol=2e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_match_jax_sharded_mapper(runs, mesh):
    """Losses within rtol 2e-3 (the last iteration's) and 0.1 (the
    mean's) of JAX's, but on a frame where the port's one-process run is
    already further from JAX than that: there the loss weight 1 / (sqrt(
    var) + 1e-4) turns the f32 rounding of a near-zero depth variance
    into percents of the loss (ROADMAP §3 "loss conditioning"; frame 2
    here, 11.6% in one process), and the ranks must equal the one-process
    loss instead, so sharding adds nothing to the port's distance from
    JAX. The banks, which AdamW's normalisation keeps together, at their
    tier on every entry."""
    want, got, one = runs["jax"], runs[mesh]["ranks"][0], runs["one"]
    conditioned = 0
    for key, rtol in (("losses", 2e-3), ("loss_mean", 0.1)):
        for f, (g, w, o) in enumerate(zip(got[key], want[key], one[key])):
            if abs(o - w) > rtol * abs(w):
                conditioned += 1
                assert abs(g - o) <= 2e-3 * abs(o), (key, f, g, o, w)
            else:
                assert abs(g - w) <= rtol * abs(w), (key, f, g, w)
    assert conditioned <= 2      # frame 2's loss and loss_mean
    for k, w in want["banks"].items():
        g = runs[mesh]["banks"][k]
        if k.endswith(("_flat", "_m", "_v")):
            np.testing.assert_allclose(g, w, rtol=2e-3,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_cli_on_two_ranks_writes_once_and_resumes(tmp_path):
    """``python -m vmap_tpu_torch.train``'s loop on 2 ranks ``{"obj":
    2}`` with ``--save_ckpt``: 11 frames (the last meshed and
    checkpointed), then ``--resume`` from the primary's checkpoint for 2
    more, each rank with a logdir of its own; the other rank's stays
    unmade. The losses of the 13 frames equal a one-process run's."""
    raw = json.load(open(small_synthetic_config(tmp_path / "cfg.json")))
    raw["trainer"]["n_models"] = 2
    one_cfg = tmp_path / "one.json"
    one_cfg.write_text(json.dumps(raw))
    raw["tpu"]["mesh_axes"] = {"obj": 2}
    cfg = tmp_path / "sharded.json"
    cfg.write_text(json.dumps(raw))
    state = tmp_path / "logs_r0" / "ckpt" / "state"

    def argv(extra):
        return lambda r: [sys.executable, "-m",
                          "vmap_tpu_torch.parallel.launch",
                          str(tmp_path / "logs"), "--config", str(cfg),
                          "--device", "cpu", *extra]

    outs = results(spawn_ranks(2, argv(["--max_frames", "11",
                                        "--save_ckpt"])))
    outs += results(spawn_ranks(2, argv(["--max_frames", "13", "--resume",
                                         str(state)])))
    assert [o["slots"] for o in outs] == [[0, 1], [1, 2]] * 2
    assert [o["frames"] for o in outs] == [11, 11, 13, 13]
    assert all(o["foreign"] == [] for o in outs), outs
    assert not (tmp_path / "logs_r1").exists()
    prim = tmp_path / "logs_r0"
    assert sorted(m for m in os.listdir(prim / "scene_mesh")
                  if m.endswith(".obj")) == sorted(
        f"frame_{f}_obj{i}.obj" for f in (10, 12) for i in (0, 1, 2))
    for i in (0, 1, 2):
        assert os.listdir(prim / "ckpt" / str(i)) == [
            f"obj_{i}_frame_10.npz"]
    rows = [json.loads(line) for line in open(prim / "train_log.jsonl")]
    assert [r["frame"] for r in rows] == list(range(13))

    from vmap_tpu_torch import train
    train.main(["--config", str(one_cfg), "--device", "cpu", "--logdir",
                str(tmp_path / "one"), "--max_frames", "13"])
    want = [json.loads(line)["loss"]
            for line in open(tmp_path / "one" / "train_log.jsonl")]
    np.testing.assert_allclose([r["loss"] for r in rows], want, rtol=2e-3,
                               atol=1e-4)


def test_empty_mask_rule_acts_per_shard():
    """Slot 1's object id shows in no pixel, so its depth and colour
    masks are empty. The one-process frame zeroes those two terms for
    every active slot (``ops/losses.py``, the reference's rule; JAX's CPU
    XLA step does the same over its whole, sharded bank); a rank runs
    ``frame_step`` on its own rows, so the rule acts per shard, as in
    JAX's fused sharded step on the TPU: slot 1's rank matches the
    one-process slot, slot 0's keeps its terms and trains on them. A
    standing deviation of the sharded run from the one-process run, on
    inputs with an empty mask only (ROADMAP §3)."""
    scene = SyntheticScene(width=80, height=60, fx=60.0, fy=60.0)
    pm = Mapper(Config(**{**KW, "do_bg": False}), device="cpu")
    pm.ingest_frame(_frame(scene, 0, FrameSample))
    st = pm.statics
    obj_tab, _ = pm._device_tables()
    ids = torch.tensor([1, 99], dtype=torch.int32)   # 99: in no pixel
    gen = torch.Generator().manual_seed(0)
    draws = ts.torch_draws(gen, ts.draw_shapes(
        2, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, st.px_block),
        torch.device("cpu"))
    bank = pm.bank_obj
    assert bank.active.tolist() == [True, True]
    pool = pm.pool.arrays()
    whole, _, met = ts.frame_step(st, bank, None, *pool, obj_tab, ids, None,
                                  draws, None)
    from vmap_tpu_torch.parallel.sharding import place_bank, place_draws
    shard = []
    for lo in (0, 1):
        b, _, m = ts.frame_step(
            st, place_bank(bank, lo, lo + 1), None, *pool,
            tuple(a[lo:lo + 1] for a in obj_tab), ids[lo:lo + 1], None,
            place_draws(draws, lo, lo + 1), None)
        shard.append((b, float(m["loss_obj"])))
    # slot 1 alone: its own terms were already zero in the whole frame
    # (the two sum in other orders: f32 noise)
    torch.testing.assert_close(shard[1][0].flat, whole.flat[1:2], rtol=1e-5,
                               atol=1e-7)
    # slot 0: the whole frame zeroed its depth and colour terms, the
    # shard trains on them, so the two differ in the update and the loss
    assert not torch.allclose(shard[0][0].flat, whole.flat[0:1], rtol=1e-3,
                              atol=1e-6)
    assert shard[0][1] + shard[1][1] > float(met["loss_obj"]) * 1.01
