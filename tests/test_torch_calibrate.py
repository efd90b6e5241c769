"""The port's int8 calibration (``vmap_tpu_torch/calibrate_int8_scales.py``)
against ``scripts/calibrate_int8_scales.py``:

  * the probe: the same bank (three slots at h=32, two active) and the
    same iteration slice through the port's ``probe`` and the script's
    ``probe_fn`` (JAX): each of the 12 sites' values within 1e-4 of its
    largest, the largest within rtol 1e-4, inactive slots contributing
    nothing; the port's 99.9th percentile numpy's;
  * the summary's grouping and the suggested values' rounding, as the
    script computes them;
  * the module's CLI end to end on the CPU, on an analytic Replica-layout
    dataset the port generates (6 frames at 80 x 60, probes at frames 2
    and 5): a finite, positive suggestion for each variable, written to
    ``--out``, and the static policies reading it back."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vmap_tpu.core.bank import activate_slot, init_bank
from vmap_tpu.core.step import StepStatics
from vmap_tpu_torch import calibrate_int8_scales as cal
from vmap_tpu_torch.ops import quant as Q

from _torch_parity import port_bank, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_calibrate_int8_scales",
        os.path.join(REPO, "scripts", "calibrate_int8_scales.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slice(rng, cap, n_per, S):
    """One iteration slice: points in the PE's range, depths and z in
    (0.3, 3), states 0 / 1 / 2, mostly valid."""
    z = np.sort(rng.uniform(0.3, 3.0, (cap, n_per, S)), -1)
    return {"pts": rng.uniform(-1.5, 1.5, (cap, n_per, S, 3)),
            "depth": rng.uniform(0.3, 3.0, (cap, n_per)),
            "rgb": rng.uniform(0, 1, (cap, n_per, 3)),
            "state": rng.integers(0, 3, (cap, n_per)).astype(np.int32),
            "valid": rng.uniform(0, 1, (cap, n_per)) < 0.9,
            "z": z}


def test_probe_matches_the_scripts_probe_fn():
    script = _script()
    key = jax.random.PRNGKey(3)
    jbank = init_bank(key, 3, 32, default_scale=2.0)
    for slot in (0, 2):
        jbank = activate_slot(jbank, slot, jax.random.fold_in(key, slot),
                              2.0, 32)
    sl = _slice(np.random.default_rng(0), 3, 40, 10)
    sl = {k: v.astype(np.float32) if v.dtype == np.float64 else v
          for k, v in sl.items()}
    st = StepStatics()
    want = script.probe_fn(jbank.spec, st)(
        jbank.flat, jbank.scale, jbank.active,
        {k: jnp.asarray(v) for k, v in sl.items()})
    got = cal.probe(port_bank(jbank), {k: t(v) for k, v in sl.items()},
                    st.color_scaling, st.opacity_scaling)
    sites = cal.SITES_ACT + tuple("d" + k for k in cal.SITES_HEAD) \
        + cal.SITES_HID
    assert sorted(got) == sorted(want) == sorted(sites)
    for k in sites:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        # slot 1 is inactive: all zero on both sides
        assert not g.reshape(3, -1)[1].any()
        assert not w.reshape(3, -1)[1].any()
        # every value within 1e-4 of the site's largest, the largest within
        # rtol 1e-4
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * w.max(),
                                   err_msg=k)
        np.testing.assert_allclose(g.max(), w.max(), rtol=1e-4, err_msg=k)
        # the percentile is numpy's (on the same values: a value that is 0
        # on one side and 1e-9 on the other moves a 99.9th percentile of a
        # few hundred values between neighbours)
        g = g[g > 0]
        np.testing.assert_allclose(cal.percentile(torch.from_numpy(g), 99.9),
                                   np.percentile(g.astype(np.float64), 99.9),
                                   rtol=1e-12, err_msg=k)


def test_summary_groups_and_rounds_as_the_script():
    stats = {k: [(1.0 + i, 0.5)] for i, k in enumerate(
        cal.SITES_ACT + ("dalpha", "dlogits") + cal.SITES_HID)}
    stats["h3"].append((7.123456, 6.0))
    stats["dlogits"].append((0.2345, 0.1))
    summary, sug = cal.summarise(stats)
    assert summary["S_ACT(quant_relu)"] == {"abs_max": 7.123456,
                                            "p99.9": 6.0}
    assert summary["S_HEAD(grad_head)"]["abs_max"] == 7.0   # dlogits, 1 + 6
    assert summary["S_GRAD(grad_hid)"]["abs_max"] == 12.0   # dc
    assert sug == {"VMAP_Q8_SACT": round(1.1 * 7.123456, 4),
                   "VMAP_Q8_SHEAD": 7.7, "VMAP_Q8_SGRAD": 13.2}


def test_cli_on_a_generated_dataset(tmp_path, monkeypatch, capsys):
    from vmap_tpu_torch.generate_dataset import main as generate
    data = tmp_path / "data"
    generate([str(data), "--frames", "6", "--width", "80", "--height", "60",
              "--fx", "60", "--fy", "60", "--device", "cpu"])
    with open(os.path.join(REPO, "configs", "Replica",
                           "room0_vmap.json")) as f:
        raw = json.load(f)
    raw["dataset"]["path"] = str(data)
    raw["camera"].update(w=80, h=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    raw["model"].update(hidden_feature_size=8, hidden_feature_size_bg=16)
    raw["render"].update(iters_per_frame=3, n_per_optim=24,
                         n_per_optim_bg=48)
    raw["trainer"]["n_models"] = 4
    raw["tpu"].update(frame_pool_size=16, compute_dtype="int8_static",
                      mesh_axes={"obj": 2})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    out = tmp_path / "scales.json"
    res = cal.main(["--config", str(cfg), "--max_frames", "6", "--probes",
                    "2,5", "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "frame 2: probed" in printed and "frame 5: probed" in printed
    sug = json.loads(printed.split("suggested:")[1].splitlines()[0])
    assert json.load(open(out)) == json.loads(json.dumps(res))
    assert sug == res["suggested"]
    assert list(sug) == list(Q.Q8_SCALE_VARS)
    assert all(np.isfinite(v) and v > 0 for v in sug.values()), sug
    for label, v in res["summary"].items():
        assert 0 < v["p99.9"] <= v["abs_max"], label
    for k, v in sug.items():
        monkeypatch.setenv(k, str(v))
    assert Q.static_scales() == tuple(sug.values())
