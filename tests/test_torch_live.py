"""Live mode in the port (``vmap_tpu_torch/core/live.py``), on the CPU:

  * ``tests/test_live.py``'s checks mirrored: the queue drops the oldest
    and hands out the latest, closes, training runs on every tick of a
    stalled stream, and meshing runs once on idle;
  * against JAX's ``run_live`` on the same frames: both Mappers ingest
    one frame, the JAX banks are copied into the port, one more frame is
    pushed before each loop starts, and each runs a fixed ``max_ticks``
    with JAX's draws for each tick's key injected (``tests/_torch_parity.py
    KeyedDraws``). The banks after the loop agree at rtol 2e-3 plus 1e-3
    of each tensor's scale (phase 3's tier: a pre-activation within
    rounding of 0 falls on either side of the ReLU), the ticks' losses at
    rtol 0.15: the loss weight 1/(sqrt(var) + 1e-4) turns the f32 rounding
    of a near-zero depth variance into up to 13% of a tick's loss here
    (ROADMAP §3, "loss conditioning"), a factor that AdamW normalises
    away;
  * a multi-process ``torch.distributed`` run is refused;
  * ``dataset.live`` configurations are accepted.
"""

import os

import numpy as np
import pytest

from vmap_tpu.config import Config as JConfig
from vmap_tpu.core import live as jlive
from vmap_tpu.core.mapper import FrameSample as JFrame
from vmap_tpu.core.mapper import Mapper as JMapper
from vmap_tpu_torch.config import Config
from vmap_tpu_torch.core import live
from vmap_tpu_torch.core.live import FrameQueue, run_live
from vmap_tpu_torch.core.mapper import FrameSample, Mapper
from vmap_tpu_torch.data.synthetic import SyntheticScene
from vmap_tpu_torch.interop import FIELDS, bank_from_numpy

from _torch_parity import KeyedDraws, StepKeys

KW = dict(
    max_n_models=4, do_bg=True, hidden_feature_size=8,
    hidden_feature_size_bg=8, n_iter_per_frame=2,
    win_size=2, n_samples_per_frame=8, win_size_bg=2,
    n_samples_per_frame_bg=8, keyframe_buffer_size=5, keyframe_step=2,
    keyframe_step_bg=2, W=80, H=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5,
    frame_pool_size=16, seed=0,
    # cheap idle-time mesh exports
    grid_dim=16, live_voxel_size=0.1)


def _fs(scene, fid, cls=FrameSample):
    s = scene.frame_sample(fid, n_frames=8)
    return cls(s["image"], s["depth"], s["obj"], s["bbox_dict"], s["T"],
               fid)


@pytest.fixture(scope="module")
def scene():
    return SyntheticScene(width=80, height=60)


def test_frame_queue_latest_wins(scene):
    q = FrameQueue(maxsize=2)
    for fid in range(5):
        q.push(_fs(scene, fid))
    assert q.poll().frame_id == 4       # drained to the newest
    assert q.poll() is None


def test_frame_queue_drops_the_oldest_when_full(scene):
    q = FrameQueue(maxsize=2)
    for fid in range(3):
        q.push(_fs(scene, fid))
    assert [q._q.get_nowait().frame_id for _ in range(2)] == [1, 2]


def test_frame_queue_close():
    q = FrameQueue()
    assert not q.closed
    q.close()
    assert q.closed


def test_run_live_trains_while_idle(scene):
    """A stalled stream keeps optimising from the keyframe buffers: every
    tick trains, n_iter steps each."""
    m = Mapper(Config(**KW), device="cpu")
    m.process_frame(_fs(scene, 0))
    steps_before = int(m.bank_obj.step.max())
    q = FrameQueue()
    q.push(_fs(scene, 1))   # one new frame, then the stream stalls
    stats = run_live(m, q, keep_alive=1e9, max_ticks=20)
    assert stats.frames_ingested == 1
    assert stats.ticks == 20 and stats.idle_ticks == 19
    assert len(stats.losses) == 20 and np.isfinite(stats.losses).all()
    assert int(m.bank_obj.step.max()) == steps_before + 20 * 2
    assert stats.meshes_exported == 0


def test_run_live_meshes_on_idle(scene, tmp_path):
    m = Mapper(Config(**KW), device="cpu")
    q = FrameQueue()
    for fid in range(3):
        q.push(_fs(scene, fid))
    q.close()
    stats = run_live(m, q, keep_alive=0.0, mesh_dir=str(tmp_path),
                     max_ticks=50)
    assert stats.frames_ingested == 1   # latest-wins drained 3 pushes to 1
    assert stats.meshes_exported == 1
    assert any(f.endswith(".obj") for f in os.listdir(tmp_path))


def test_run_live_losses_match_jax(scene):
    jm = JMapper(JConfig(**KW))
    rec = StepKeys(jm)
    keys = rec.keys
    pm = Mapper(Config(**KW), device="cpu", draw_source=KeyedDraws(keys))
    jm.ingest_frame(_fs(scene, 0, JFrame))
    pm.ingest_frame(_fs(scene, 0))
    pm.bank_obj = bank_from_numpy({f: np.array(getattr(jm.bank_obj, f))
                                   for f in FIELDS}, 8)
    pm.bank_bg = bank_from_numpy({f: np.array(getattr(jm.bank_bg, f))
                                  for f in FIELDS}, 8)
    jq, pq = jlive.FrameQueue(), FrameQueue()
    jq.push(_fs(scene, 1, JFrame))
    pq.push(_fs(scene, 1))
    with rec.recording():
        want = jlive.run_live(jm, jq, keep_alive=1e9, max_ticks=4)
    got = run_live(pm, pq, keep_alive=1e9, max_ticks=4)
    assert set(pm.registry) == set(jm.registry)
    assert (got.ticks, got.frames_ingested, got.idle_ticks) == \
        (want.ticks, want.frames_ingested, want.idle_ticks) == (4, 1, 3)
    assert len(keys) == 4
    for name in ("bank_obj", "bank_bg"):
        tb, jb = getattr(pm, name), getattr(jm, name)
        np.testing.assert_array_equal(tb.step.numpy(), np.asarray(jb.step))
        for f in ("flat", "m", "v"):
            want_f = np.asarray(getattr(jb, f))
            np.testing.assert_allclose(getattr(tb, f).numpy(), want_f,
                                       rtol=2e-3,
                                       atol=1e-3 * np.abs(want_f).max(),
                                       err_msg=f"{name}.{f}")
    np.testing.assert_allclose(got.losses, want.losses, rtol=0.15)


def test_multiprocess_is_refused(monkeypatch):
    assert not live.is_multiprocess()   # no process group here
    monkeypatch.setattr(live, "is_multiprocess", lambda: True)
    m = Mapper(Config(**KW), device="cpu")
    with pytest.raises(RuntimeError, match="single-process"):
        run_live(m, FrameQueue(), max_ticks=1)


def test_live_configurations_are_accepted():
    cfg = Config(**KW)
    cfg.live_mode = True
    assert Mapper(cfg, device="cpu").cfg.live_mode
