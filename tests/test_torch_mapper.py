"""The slice as a whole: the port's Mapper against vmap_tpu's Mapper (CPU,
XLA path) on the committed Replica-layout fixture, frame by frame; and the
port's import / one CPU frame staying free of JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vmap_tpu.config import Config
from vmap_tpu.core.mapper import FrameSample as JFrame
from vmap_tpu.core.mapper import Mapper as JMapper
from vmap_tpu.data.replica import ReplicaDataset
from vmap_tpu_torch.core import mapper as tmapper
from vmap_tpu_torch.interop import FIELDS, bank_from_numpy
from vmap_tpu_torch.ops.quant import Q8_SCALES

from _torch_parity import jax_frame_draw_source, small_synthetic_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "Replica", "fixture_room_vmap.json")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "replica_room", "imap", "00")


def _cfg():
    cfg = Config.from_json(CONFIG)
    cfg.dataset_dir = FIXTURE
    return cfg


def _sample(s, cls):
    return cls(image=s["image"], depth=s["depth"], inst=s["obj"],
               bbox_dict=s["bbox_dict"], t_wc=s["T"], frame_id=s["frame_id"])


def _numpy_bank(bank):
    return {f: np.array(getattr(bank, f)) for f in FIELDS}


def test_mapper_matches_jax_frame_by_frame():
    cfg = _cfg()
    ds = ReplicaDataset(cfg)
    jm = JMapper(cfg)
    keys = []
    next_key = jm._next_key
    jm._next_key = lambda: keys.append(next_key()) or keys[-1]
    frame_key = {}
    pm = tmapper.Mapper(cfg, device="cpu",
                        draw_source=lambda bank, shapes: jax_frame_draw_source(
                            frame_key["k"])(bank, shapes))
    assert pm.slots == jm.slots
    for i in range(len(ds)):
        s = ds[i]
        if s is None:
            continue
        jm.ingest_frame(_sample(s, JFrame))
        pm.ingest_frame(_sample(s, tmapper.FrameSample))
        # registry, slot assignment, keyframe tables and pool accounting
        assert {k: vars(r) for k, r in pm.registry.items()} == \
            {k: vars(r) for k, r in jm.registry.items()}
        for tp, tj in ((pm.obj_table, jm.obj_table),
                       (pm.bg_table, jm.bg_table)):
            for a, b in zip(tp.as_arrays(), tj.as_arrays()):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pm.pool.refcount, jm.pool.refcount)
        np.testing.assert_array_equal(
            pm.pool.packed.numpy().view(np.uint32), np.asarray(jm.pool.packed))
        # the JAX banks (their own random init) into the port, then train
        # both on JAX's draws for this frame
        pm.bank_obj = bank_from_numpy(_numpy_bank(jm.bank_obj),
                                      cfg.hidden_feature_size)
        pm.bank_bg = bank_from_numpy(_numpy_bank(jm.bank_bg),
                                     cfg.hidden_feature_size_bg)
        met_j = jm.train_frame()
        frame_key["k"] = keys[-1]
        met_p = pm.train_frame()
        np.testing.assert_allclose(float(met_p["loss"]), float(met_j["loss"]),
                                   rtol=2e-3, err_msg=f"frame {i}")
        # the mean over iterations includes the first iterations of fresh,
        # saturated fields, where 1/(sqrt(var)+1e-4) turns f32 rounding of
        # a near-zero depth variance into a few percent of loss value (up
        # to 4.4% on this fixture) while the AdamW step, which normalises
        # the gradient scale away, and the last-iteration loss still agree
        np.testing.assert_allclose(float(met_p["loss_mean"]),
                                   float(met_j["loss_mean"]), rtol=0.1)
    assert pm.n_objects == jm.n_objects == 2
    pe, mlp_p, scale = pm.object_params(1)
    assert scale == cfg.obj_scale and pe["dirs"].shape == (21, 3)


@pytest.mark.parametrize("change,match", [
    ({"compute_dtype": "float16"}, "compute_dtype"),
    ({"compute_dtype": "int4"}, "compute_dtype"),
    ({"mesh_axes": {"obj": 2}}, "mesh_axes"),
    ({"training_strategy": "sequential"}, "forloop"),
    ({"n_unidir_funcs": 4}, "n_unidir_funcs"),
    ({"compute_dtype": "int8_dynamic"}, "int8 policies"),
    ({"mesh_axes": {"obj": 4}, "training_strategy": "forloop"},
     "one process"),
])
def test_features_outside_the_slice_raise(change, match):
    """Each raises NotImplementedError, but a mesh larger than the world
    (one process here), which raises the JAX package's ValueError."""
    cfg = _cfg()
    for k, v in change.items():
        setattr(cfg, k, v)
    exc = ValueError if match == "mesh_axes" else NotImplementedError
    with pytest.raises(exc, match=match):
        tmapper.Mapper(cfg, device="cpu")


def test_cuda_requested_without_cuda_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="refusing"):
        tmapper.Mapper(_cfg(), device="cuda")


def test_cuda_is_the_default_and_never_falls_back(monkeypatch, tmp_path):
    """``Mapper(cfg)`` and the CLI without ``--device`` run on CUDA: where
    CUDA is absent both raise, and neither carries on on the CPU."""
    import torch
    from vmap_tpu_torch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="refusing"):
        tmapper.Mapper(_cfg())
    cfg = small_synthetic_config(tmp_path / "cfg.json")
    with pytest.raises(RuntimeError, match="refusing"):
        train.main(["--config", cfg, "--logdir", str(tmp_path / "logs"),
                    "--max_frames", "1"])
    assert train.parse_args([]).device == "cuda"
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("reuse,want", [(4, 4), (3, 1)])
def test_sample_reuse_and_policy_reach_the_step(reuse, want, capsys):
    """The fixture's 4 iterations take reuse 4; reuse 3 does not divide
    them and falls back to 1 with a warning, as the JAX Mapper does. The
    policy reaches the step statics, and the object draws follow n_eff."""
    cfg = _cfg()
    cfg.sample_reuse, cfg.compute_dtype = reuse, "bwd_bf16"
    pm = tmapper.Mapper(cfg, device="cpu")
    st = pm.statics
    assert (st.sample_reuse, st.compute_dtype) == (want, "bwd_bf16")
    assert ("falling back to 1" in capsys.readouterr().out) == (want == 1)
    obj, bg = pm._draws()
    n_frames = st.n_iter * st.win
    assert obj.kf.shape == (pm.slots, n_frames // want)
    assert obj.z.shape[2] == n_frames * st.n_px
    assert bg.kf.shape == (1, st.n_iter * st.win_bg)


def test_kernel_path_refuses_a_policy_without_a_kernel(monkeypatch):
    """On CUDA a matmul policy that K1 is not built for is refused at
    construction, naming the kernel."""
    import torch
    from vmap_tpu_torch.kernels import KERNEL_POLICIES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setitem(KERNEL_POLICIES, "train_frame", ("float32",))
    cfg = _cfg()
    cfg.compute_dtype = "bwd_bf16"
    with pytest.raises(NotImplementedError,
                       match="train_frame kernel under the 'bwd_bf16'"):
        tmapper.Mapper(cfg, device="cuda")


def test_kernel_path_refuses_widths_without_a_kernel(monkeypatch):
    """On CUDA the fixture's h=16 objects have no kernel: the Mapper says
    so before allocating anything on the device."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(NotImplementedError, match="hidden sizes 16/32"):
        tmapper.Mapper(_cfg(), device="cuda")


def test_train_cli_meshes_checkpoints_and_resumes(tmp_path):
    """``--max_frames 11 --save_ckpt``: the last frame (10) takes the
    mesh-and-checkpoint branch; ``--resume`` then trains frames 11 and 12
    and meshes again on its last frame."""
    from vmap_tpu_torch import train
    cfg = small_synthetic_config(tmp_path / "cfg.json")
    logdir = tmp_path / "logs"
    base = ["--config", cfg, "--logdir", str(logdir), "--device", "cpu"]
    train.main(base + ["--max_frames", "11", "--save_ckpt"])
    meshes = sorted(os.listdir(logdir / "scene_mesh"))
    assert [f"frame_10_obj{i}.obj" for i in (0, 1, 2)] == \
        [m for m in meshes if m.endswith(".obj")]
    assert "viewer.html" in meshes
    for i in (0, 1, 2):
        assert os.listdir(logdir / "ckpt" / str(i)) == \
            [f"obj_{i}_frame_10.npz"]
    state = logdir / "ckpt" / "state"
    assert sorted(os.listdir(state)) == [
        "latest.json", "state_frame_10.json", "state_frame_10.pt"]

    mapper = train.main(base + ["--max_frames", "13", "--resume",
                                str(state)])
    rows = [json.loads(line) for line in open(logdir / "train_log.jsonl")]
    assert [r["frame"] for r in rows] == list(range(13))
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert mapper.frames_ingested == 13
    assert os.path.getsize(logdir / "scene_mesh" / "frame_12_obj1.obj") > 0


def _cli_stays_jax_free(tmp_path, tpu: dict, n_frames: int) -> None:
    """``import vmap_tpu_torch``, a CPU run of the port's trainer on the
    fixture for ``n_frames`` frames with the ``tpu`` entries, mesh export
    and a full-state checkpoint, in a subprocess that must import neither
    jax nor any module of the JAX package ``vmap_tpu``."""
    cfg = str(tmp_path / "cfg.json")
    logdir = str(tmp_path / "logs")
    raw = json.load(open(CONFIG))
    raw["dataset"]["path"] = FIXTURE
    raw["tpu"].update(tpu)
    json.dump(raw, open(cfg, "w"))
    code = (
        "import sys, json, os\n"
        "import vmap_tpu_torch\n"
        "import vmap_tpu_torch.core.mapper, vmap_tpu_torch.interop\n"
        "import vmap_tpu_torch.kernels._build\n"
        "from vmap_tpu_torch.core import checkpoint, meshing\n"
        "from vmap_tpu_torch import train\n"
        f"m = train.main(['--config', {cfg!r}, '--logdir', {logdir!r},"
        f" '--max_frames', '{n_frames}', '--device', 'cpu'])\n"
        + "".join(f"assert m.statics.{k} == {v!r}, m.statics\n"
                  for k, v in tpu.items()) +
        f"rows = [json.loads(l) for l in open(os.path.join({logdir!r},"
        " 'train_log.jsonl'))]\n"
        f"assert len(rows) == {n_frames}, rows\n"
        "assert all(r['loss'] == r['loss'] for r in rows), rows\n"
        f"assert m.export_meshes(os.path.join({logdir!r}, 'mesh'), 0)\n"
        f"checkpoint.save_full_checkpoint(m, os.path.join({logdir!r},"
        " 'ckpt'), 0)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vmap_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'flax',\n"
        "                              'vmap_tpu.')))\n"
        "assert not bad, bad\n"
        "print('JAXFREE')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAXFREE" in out.stdout


def test_import_and_cpu_frame_stay_jax_free(tmp_path):
    """One frame under ``sample_reuse`` 4 and ``bwd_bf16``."""
    _cli_stays_jax_free(tmp_path, {"sample_reuse": 4,
                                   "compute_dtype": "bwd_bf16"}, 1)


def test_int8_cli_trains_meshes_checkpoints_jax_free(tmp_path):
    """Three frames under the int8 policy (the plain ops.quant frame on
    the CPU): finite losses, meshes, a full-state checkpoint."""
    _cli_stays_jax_free(tmp_path, {"compute_dtype": "int8"}, 3)


@pytest.mark.parametrize("policy", ["int8", "int8_fwd", "int8_static",
                                    "int8_static_fwd"])
def test_int8_policies_reach_the_step(policy):
    """The Mapper takes each int8 policy and hands it to the step statics;
    the static policies' scales are JAX's defaults (VMAP_Q8_SACT / SHEAD /
    SGRAD unset), a constant of ops.quant."""
    cfg = _cfg()
    cfg.compute_dtype = policy
    st = tmapper.Mapper(cfg, device="cpu").statics
    assert st.compute_dtype == policy
    assert Q8_SCALES == (8.0, 0.125, 0.02)
