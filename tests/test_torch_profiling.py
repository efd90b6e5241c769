"""``utils/profiling.py`` of the port: ``tests/test_profiling.py``'s checks
mirrored, ``StageTimer``'s sync, ``device_trace`` writing a Chrome trace on
the CPU, ``trace_summary`` on a hand-made trace, and the trainer's
``--profile`` (the JAX CLI's stage names) and ``--trace DIR``."""

import io
import json
import re
import time
from contextlib import redirect_stdout

import torch

from vmap_tpu_torch.utils.profiling import (StageTimer, device_trace,
                                            performance_measure,
                                            trace_summary)

from _torch_parity import small_synthetic_config


def test_stage_timer_accumulates_and_reports():
    t = StageTimer(enabled=True)
    for _ in range(3):
        with t("stage_a"):
            time.sleep(0.002)
    with t("stage_b"):
        pass
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = t.report()
    assert set(out) == {"stage_a", "stage_b"}
    assert out["stage_a"] >= 2.0  # ms, mean of 3 sleeps
    assert "stage_a" in buf.getvalue()
    assert t.report() == {} and t.totals == {}   # report resets


def test_stage_timer_disabled_is_noop():
    t = StageTimer(enabled=False)
    with t("x"):
        pass
    assert t.report() == {}


def test_stage_timer_syncs_before_each_clock_read():
    calls = []
    t = StageTimer(enabled=True, sync=lambda: calls.append(1))
    with t("a"):
        pass
    with t("b"):
        pass
    assert len(calls) == 4


def test_performance_measure_prints_ms():
    buf = io.StringIO()
    with redirect_stdout(buf):
        with performance_measure("unit"):
            time.sleep(0.001)
    line = buf.getvalue()
    assert "unit execution time:" in line
    assert float(re.search(r"([\d.]+) ms", line).group(1)) >= 1.0


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with device_trace(str(tmp_path / "tr")):
        with torch.profiler.record_function("frame"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "frame" for e in events)
    s = trace_summary(str(path), "frame")
    assert s["kernels"] == {} and s["device_ms"] == 0.0   # no CUDA here
    assert s["window_ms"] > 0 and s["idle_share"] == 1.0


def test_trace_summary_splits_device_time_and_idle_share(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "frame", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "frame", "ts": 150,
           "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "early", "ts": -50,
           "dur": 10}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace_summary(str(path), "frame")
    assert s["kernels"] == {"k1": 0.13, "k2": 0.02}
    assert s["launches"] == {"k1": 2, "k2": 1}
    assert abs(s["device_ms"] - 0.14) < 1e-12       # 10-50 and 200-300
    assert abs(s["window_ms"] - 0.3) < 1e-12        # 0 to the last kernel
    assert abs(s["idle_share"] - (1 - 0.14 / 0.3)) < 1e-12


def _cli(tmp_path, *flags):
    from vmap_tpu_torch import train
    cfg = small_synthetic_config(tmp_path / "cfg.json")
    buf = io.StringIO()
    with redirect_stdout(buf):
        train.main(["--config", cfg, "--logdir", str(tmp_path / "logs"),
                    "--device", "cpu", *flags])
    return buf.getvalue()


def test_train_cli_profile_prints_the_stages(tmp_path):
    """11 frames: frame 10 exports meshes and a checkpoint."""
    out = _cli(tmp_path, "--max_frames", "11", "--save_ckpt", "--profile")
    for stage in ("data", "ingest", "train", "mesh", "ckpt"):
        assert re.search(rf"^{stage}: [\d.]+ ms$", out, re.M), stage
    assert len(re.findall(r"^train: ", out, re.M)) == 11


def test_train_cli_trace_leaves_a_trace(tmp_path):
    out = _cli(tmp_path, "--max_frames", "2", "--trace",
               str(tmp_path / "trace"))
    assert "device trace written to" in out
    assert not re.search(r"^train: ", out, re.M)   # --profile is off
    path = tmp_path / "trace" / "trace.json"
    frames = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") == "frame"]
    assert len(frames) == 2
    assert trace_summary(str(path), "frame")["window_ms"] > 0
