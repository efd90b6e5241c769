"""Static int8 scales from a training run's maxima (counterpart of
``scripts/calibrate_int8_scales.py``).

    python -m vmap_tpu_torch.calibrate_int8_scales --config <json> \\
        [--max_frames 400] [--probes 10,50,150,399] [--out scales.json] \\
        [--device cuda|cpu]

The ``int8_static`` / ``int8_static_fwd`` policies quantise with fixed
maxima (``ops.quant.static_scales``: ``VMAP_Q8_SACT`` for the post-ReLU
activations, ``VMAP_Q8_SHEAD`` for the two heads' output gradients,
``VMAP_Q8_SGRAD`` for the hidden gradients). This trains the config's
dataset through the port's ``Mapper`` (on the card through K1, under the
config's policy) and, after each ``--probes`` frame, recomputes three
iteration slices of the object bank (iterations 0, n_iter / 2 and the
last) on a fresh sample with the plain f32 MLP, reading the absolute
values at the kernel's 12 quantisation sites by autograd on zero
perturbations added there:

  activations (``SITES_ACT``): h1 h2 h3 h4 c;
  head gradients (``SITES_HEAD``, read as dalpha dlogits): alpha logits;
  hidden gradients (``SITES_HID``): dh1 dh2 dh3 dh4 dc,

over active slots. It prints each group's largest value and 99.9th
percentile, each site's largest value, and the suggested variables, 1.1
times each group's largest value, as JSON; ``--out`` writes the summary
and the suggestion. Feed them back as environment variables::

    VMAP_Q8_SACT=... VMAP_Q8_SHEAD=... VMAP_Q8_SGRAD=... \\
        python -m vmap_tpu_torch.train --config <json with
        tpu.compute_dtype int8_static> ...

The calibration runs in one process (a config's ``tpu.mesh_axes`` is
ignored).
"""

from __future__ import annotations

import argparse
import json

import torch

SITES_ACT = ("h1", "h2", "h3", "h4", "c")
SITES_HEAD = ("alpha", "logits")
SITES_HID = ("dh1", "dh2", "dh3", "dh4", "dc")
GROUPS = (("S_ACT(quant_relu)", SITES_ACT),
          ("S_HEAD(grad_head)", ("dalpha", "dlogits")),
          ("S_GRAD(grad_hid)", SITES_HID))


def probe(bank, sl: dict, color_scaling: float,
          opacity_scaling: float) -> dict:
    """One iteration slice ``sl`` (pts [cap, R, S, 3], depth, rgb, state,
    valid, z) of ``bank`` -> {site: |value| flat}, zero on inactive slots
    (JAX's ``probe_fn``): the forward of ``ops.mlp`` with a zero
    perturbation added at each site, and the loss's gradient by each."""
    from vmap_tpu_torch.ops import losses as L
    from vmap_tpu_torch.ops.embedding import embed
    from vmap_tpu_torch.ops.mlp import _linear

    pe, p = bank.spec.unflatten(bank.flat.detach())
    cap, n_per, S = sl["pts"].shape[:3]
    h = bank.spec.hidden
    eps = {k: torch.zeros((cap, n_per, S, w), device=bank.device,
                          requires_grad=True)
           for k, w in (("h1", h), ("h2", h), ("h3", h), ("h4", h),
                        ("c", h), ("alpha", 1), ("logits", 3))}
    e = embed(pe, sl["pts"], bank.scale)
    x1, x2 = e[..., :87], e[..., 87:]
    h1 = torch.relu(_linear(p, "in", x1) + eps["h1"])
    h2 = torch.relu(_linear(p, "mid1", h1) + eps["h2"])
    h3 = torch.relu(_linear(p, "cat", torch.cat([h2, x1], -1)) + eps["h3"])
    h4 = torch.relu(_linear(p, "mid2", h3) + eps["h4"])
    a_pre = _linear(p, "alpha", h4) + eps["alpha"]
    c = torch.relu(_linear(p, "col", torch.cat([h4, x2], -1)) + eps["c"])
    logit = _linear(p, "col_out", c) + eps["logits"]
    loss, _ = L.step_batch_loss(
        a_pre[..., 0] * 10.0, torch.sigmoid(logit), sl["depth"], sl["rgb"],
        sl["state"], sl["valid"], sl["z"], bank.active, color_scaling,
        opacity_scaling)
    grads = torch.autograd.grad(loss, list(eps.values()))
    out = dict(zip(SITES_ACT, (h1, h2, h3, h4, c)))
    out |= {"d" + k: g for k, g in zip(eps, grads)}
    act = bank.active[:, None, None, None]
    return {k: torch.where(act, v.detach().abs(), 0.0).flatten()
            for k, v in out.items()}


def percentile(a: torch.Tensor, q: float) -> float:
    """numpy's default (linear) percentile of the 1-D ``a``."""
    s = torch.sort(a.double()).values
    pos = (s.numel() - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


def site_stats(out: dict) -> dict:
    """{site: (largest, 99.9th percentile) of its positive values}."""
    stats = {}
    for k, v in out.items():
        a = v[v > 0]
        stats[k] = ((float(a.max()), percentile(a, 99.9)) if a.numel()
                    else (0.0, 0.0))
    return stats


def probe_frame(mapper, frame_idx: int) -> list[dict]:
    """Site stats of three iteration slices of a fresh sample of the
    mapper's object bank (iterations 0, n_iter / 2, n_iter - 1; the
    sample's draws from a generator seeded by the frame, as the JAX script
    folds the frame into its key)."""
    from vmap_tpu_torch.core.step import _sample_bank, draw_shapes, torch_draws

    st = mapper.statics
    gen = torch.Generator(device=mapper.device).manual_seed(7000 + frame_idx)
    draws = torch_draws(gen, draw_shapes(
        mapper.slots, st.n_iter * st.win, st.n_px, st.n_b2s, st.n_bins, 1),
        mapper.device)
    obj_tab, _ = mapper._device_tables()
    obj_ids = torch.from_numpy(mapper._slot_objid).to(mapper.device)
    b = _sample_bank(*mapper.pool.arrays(), *obj_tab, obj_ids,
                     st.n_iter * st.win, st.n_px, st.n_b2s, st, draws)
    b["pts"] = b["origins"][:, :, None] + b["dirs"][:, :, None] \
        * b["z"][..., None]
    n_per = st.win * st.n_px
    stats = []
    for it in (0, st.n_iter // 2, st.n_iter - 1):
        sl = {k: b[k][:, it * n_per:(it + 1) * n_per]
              for k in ("pts", "depth", "rgb", "state", "valid", "z")}
        stats.append(site_stats(probe(mapper.bank_obj, sl, st.color_scaling,
                                      st.opacity_scaling)))
    return stats


def summarise(stats: dict) -> tuple[dict, dict]:
    """{site: [(largest, p99.9), ...]} -> (per group {"abs_max",
    "p99.9"}, the suggested VMAP_Q8_* values: 1.1 x each group's largest,
    rounded as the JAX script rounds them)."""
    summary = {}
    for label, keys in GROUPS:
        summary[label] = {
            "abs_max": max(m for k in keys for m, _ in stats[k]),
            "p99.9": max(p for k in keys for _, p in stats[k])}
    act, head, hid = (summary[label]["abs_max"] for label, _ in GROUPS)
    return summary, {"VMAP_Q8_SACT": round(1.1 * act, 4),
                     "VMAP_Q8_SHEAD": float(f"{1.1 * head:.3g}"),
                     "VMAP_Q8_SGRAD": float(f"{1.1 * hid:.3g}")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--max_frames", type=int, default=400)
    ap.add_argument("--probes", default="10,50,150,399",
                    help="frame indices to measure at")
    ap.add_argument("--out", default=None, help="write JSON summary here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the calibration; returns {"summary", "suggested"}."""
    args = parse_args(argv)
    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.core.mapper import FrameSample, Mapper
    from vmap_tpu_torch.data.loader import PrefetchIterator, make_dataset

    cfg = Config.from_json(args.config)
    cfg.mesh_axes = {}
    dataset = make_dataset(cfg)
    mapper = Mapper(cfg, device=args.device)
    probes = {int(x) for x in args.probes.split(",")}
    stats: dict[str, list] = {}
    it = iter(PrefetchIterator(dataset))
    for fi in range(min(len(dataset), args.max_frames)):
        sample = next(it)
        if sample is None:
            continue
        mapper.ingest_frame(FrameSample(
            image=sample["image"], depth=sample["depth"], inst=sample["obj"],
            bbox_dict=sample["bbox_dict"], t_wc=sample["T"],
            frame_id=sample["frame_id"]))
        m = mapper.train_frame()
        if fi in probes:
            for s in probe_frame(mapper, fi):
                for k, v in s.items():
                    stats.setdefault(k, []).append(v)
            print(f"frame {fi}: probed (loss {float(m.get('loss', 0)):.2f})",
                  flush=True)
    summary, sug = summarise(stats)
    for label, v in summary.items():
        print(f"{label}: abs_max {v['abs_max']:.5g}  p99.9 {v['p99.9']:.5g}")
    for k in sorted(stats):
        print(f"  site {k}: max {max(m for m, _ in stats[k]):.5g}")
    print("suggested:", json.dumps(sug))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "suggested": sug}, f, indent=1)
    return {"summary": summary, "suggested": sug}


if __name__ == "__main__":
    main()
