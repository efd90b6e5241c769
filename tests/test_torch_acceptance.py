"""``chip_smoke.py --acceptance``, the room protocol's acceptance mode, on
the CPU at the pipeline's quick size (``tests/test_torch_datagen.py``'s):
one generation serves two trainings, each writes its own record, the
control's limits decide the exit code both ways, and the mode imports
neither ``jax`` nor ``vmap_tpu``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a test worker)
import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = ["--device", "cpu", "--frames", "11", "--objects", "6", "--width",
         "96", "--height", "64", "--focal", "56", "--grid_dim", "24",
         "--set", "render.iters_per_frame=2", "--set", "trainer.n_models=8"]
REACHABLE = {"objects_ratio_5cm": 0.0, "objects_accuracy": 100.0,
             "bg_ratio_5cm": 0.0, "scene_ratio_5cm": 0.0}


def run_mode(tmp, runs: list, limits: dict) -> tuple:
    """The mode in a subprocess, the control held to ``limits`` (each
    ACCEPT_LIMITS' direction with its value here), that then reports
    whether ``jax`` or a ``vmap_tpu`` module was imported -> (completed
    process, records directory)."""
    out = str(tmp / "records")
    argv = (["--acceptance", *runs, "--acceptance-work", str(tmp / "work"),
             "--acceptance-out", out] + QUICK)
    held = {k: (op, limits[k]) for k, (op, _)
            in chip_smoke.ACCEPT_LIMITS.items()}
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)   # as _torch_parity caps the workers\n"
        "import chip_smoke\n"
        f"chip_smoke.ACCEPT_LIMITS = {held!r}\n"
        f"rc = chip_smoke.main({argv!r})\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vmap_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'vmap_tpu.')))\n"
        "print('JAXFREE' if not bad else f'IMPORTED {bad}')\n"
        "sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=600)
    return res, out


def last_line(res) -> dict:
    return json.loads(res.stdout.strip().splitlines()[-2])


@pytest.fixture(scope="module")
def accepted(tmp_path_factory):
    """control and control_seed1 on one generation, limits in reach."""
    tmp = tmp_path_factory.mktemp("acceptance")
    res, out = run_mode(tmp, ["control", "control_seed1"], REACHABLE)
    return tmp, res, out


def test_one_generation_serves_two_trainings(accepted):
    tmp, res, out = accepted
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("[1/3] generating") == 1
    assert len(os.listdir(tmp / "work")) == 1
    recs = {t: json.loads(open(os.path.join(out, f"{t}.json")).read())
            for t in ("px1", "px1_seed1")}
    assert sorted(os.listdir(out)) == ["px1.json", "px1_seed1.json"]
    for tag, rec in recs.items():
        assert rec["ok"] and rec["faults"] == [] and rec["tag"] == tag
        assert rec["frames"] == 11 and rec["device"] == "cpu"
        assert "generate" not in rec["stage_s"]
        assert set(rec["stage_s"]) == {"train", "export", "evaluate"}
        assert rec["generation"] == recs["px1"]["generation"]
        assert len(rec["per_object"]) >= 2     # the background and objects
        assert rec["objects_registered"] >= 1 and rec["pool_size"] == 512
        assert 1 <= rec["pool_peak"] <= 11 and rec["explosions"] == 0
        assert rec["limits"] == {k: [op, REACHABLE[k]] for k, (op, _)
                                 in chip_smoke.ACCEPT_LIMITS.items()}
        assert all(np.isfinite(v) for v in rec["metrics"].values())
        # each run's summary is one JSON line of the mode's output
        assert json.dumps(rec, default=float) in res.stdout.splitlines()
    assert recs["px1"]["jax_row"] == "docs/room_study/run4_px1.json"
    # the training seed reaches the trainer: the two runs' losses differ
    logs = [open(tmp / "work" / recs["px1"]["generation"]["key"]
                 / f"run_{t}" / "train_log.jsonl").read() for t in recs]
    assert logs[0] != logs[1]
    assert last_line(res)["ok"] is True


def test_mode_imports_neither_jax_nor_the_jax_package(accepted):
    _, res, _ = accepted
    assert "JAXFREE" in res.stdout, res.stdout[-2000:]


def test_a_limit_out_of_reach_fails_the_mode(tmp_path):
    """The control held to an objects ratio@5cm no run can reach."""
    res, out = run_mode(tmp_path, ["control"],
                        {**REACHABLE, "objects_ratio_5cm": 1.01})
    assert res.returncode == 1, res.stdout[-3000:] + res.stderr[-3000:]
    rec = json.loads(open(os.path.join(out, "px1.json")).read())
    assert not rec["ok"]
    assert [f.split()[0] for f in rec["faults"]] == ["objects_ratio_5cm"]
    assert last_line(res)["ok"] is False
    assert "JAXFREE" in res.stdout


def test_the_jax_rows_meet_the_control_limits():
    """The limits hold both of JAX's px1 seeds, and miss what is past
    them."""
    for row in ("run4_px1.json", "run4_px1_seed1.json"):
        with open(os.path.join(chip_smoke.JAX_ROWS, row)) as f:
            m = chip_smoke.accept_metrics(json.load(f))
        assert chip_smoke.missed_limits(m, chip_smoke.ACCEPT_LIMITS) == []
        worse = {**m, "objects_accuracy": 0.0281, "bg_ratio_5cm": 0.9979}
        assert [x.split()[0] for x in chip_smoke.missed_limits(
            worse, chip_smoke.ACCEPT_LIMITS)] == ["objects_accuracy",
                                                  "bg_ratio_5cm"]
    for _, _, row, _ in chip_smoke.ACCEPT_RUNS.values():
        assert row is None or os.path.exists(
            os.path.join(chip_smoke.JAX_ROWS, row))


def test_the_mode_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        chip_smoke.main(["--acceptance"])
