"""The port's int8 matmul policies (``ops.quant``; ``int8``, ``int8_fwd``,
``int8_static``, ``int8_static_fwd``) against the JAX train-frame kernel
in interpret mode, on the CPU.

Two comparisons, because the two scale granularities differ (see
``vmap_tpu_torch/ops/quant.py``: the port's activation and gradient scales
are per ray tile of one slot, JAX's per tile of its TPU layout):

  * where they coincide (one slot, G = 1, 128 rays that fill exactly one
    JAX chunk, and the port's tile set to the same 128 rays), the plain
    frame is held to JAX by the ratio rule of ``test_torch_policies.py``:
    at n_iter=1 each gradient tensor (read from the first AdamW moment)
    within 1e-2 of its scale, and, where the policy moves a tensor (JAX's
    policy against JAX's f32), the error at least 10x smaller in norm than
    that effect. The two sides still sum in different orders and take sin
    differently, so a value within f32 noise of a quantisation boundary
    can round to neighbouring integers: one quantum of one element (1/127
    of its tensor's scale), which the products that read it then carry;
  * at ``tests/test_int8_kernel.py``'s shapes (G = 4 at h=32, and a
    200-ray bank over two JAX chunks), where the granularities differ,
    by that test's own bars against the port's own f32 frame: per-slot
    losses within rtol 0.08, parameters within 6 lr n_iter, inactive slots
    bit-identical. The distance between the port and JAX under the same
    policy is held to the same bars and printed (``-s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmap_tpu.core.bank import activate_slot, init_bank
from vmap_tpu.kernels.train_step import fused_bank_frame
from vmap_tpu_torch.kernels import train_step as K
from vmap_tpu_torch.ops import quant as Q
from vmap_tpu_torch.ops.mlp import mlp_apply, policy_matmul

from _torch_parity import n, port_bank, t
from test_torch_policies import policy_errors
from test_torch_train_step import conditioned_jax_bank, numpy_batch

LR, WD, CS, OSC = 1e-3, 0.013, 5.0, 10.0
JAX_POLICY = {"float32": "f32", **{p: p for p in Q.INT8_POLICIES}}


# ------------------------------------------------------------ the algebra
def test_dynamic_scale_is_per_tile_and_rounds_half_to_even():
    """s = max|x| / 127 + 1e-30 over each tile of ``pts`` points, q =
    round(x * (1 / s)) with ties to even; a ragged last tile takes its
    own scale."""
    quant = Q.Quantiser("int8", pts=2)
    x = torch.tensor([[[127.0, 0.5], [1.5, -2.5]],
                      [[2.0, -0.5], [1.0, 0.0]],
                      [[0.0, 12.7], [-0.05, 0.0]]]).reshape(1, 3, 4)
    q, s = quant(x, 1.0)
    assert s.shape == (1, 2)
    assert torch.equal(s[0], torch.tensor([127.0, 12.7]) * (1.0 / 127.0)
                       + 1e-30)
    assert torch.equal(q[0, 0], torch.tensor([127.0, 0.0, 2.0, -2.0]))
    assert torch.equal(q[0, 1], torch.tensor([2.0, -0.0, 1.0, 0.0]))
    assert torch.equal(q[0, 2], torch.round(x[0, 2] * (1.0 / s[0, 1])))
    assert q[0, 2].abs().max() == 127.0


def test_static_scale_saturates():
    quant = Q.Quantiser("int8_static_fwd", pts=4)
    x = torch.tensor([[[9.0, -8.0, 4.0, 0.03]]])
    q, s = quant(x, quant.s_act)
    assert torch.equal(q, torch.tensor([[[127.0, -127.0, 64.0, 0.0]]]))
    assert float(s) == pytest.approx(8.0 / 127.0)
    assert (quant.s_head, quant.s_grad) == (0.125, 0.02)


def test_weights_absorb_the_embedding_row_scales():
    """w_in and w_cat's embedding columns are divided by the row scale
    (127 / XS_RANGE for the three xs rows, 127 for the sin rows), w_col's
    by 127, before their one dynamic scale per slot and tensor."""
    g = torch.Generator().manual_seed(0)
    h, n_slots = 8, 2
    w = {"w_in": torch.randn(n_slots, h, 87, generator=g),
         "w_mid1": torch.randn(n_slots, h, h, generator=g),
         "w_cat": torch.randn(n_slots, h, h + 87, generator=g),
         "w_mid2": torch.randn(n_slots, h, h, generator=g),
         "w_alpha": torch.randn(n_slots, 1, h, generator=g),
         "w_col": torch.randn(n_slots, h, h + 42, generator=g),
         "w_col_out": torch.randn(n_slots, 3, h, generator=g)}
    w["w_in"][1, 2, 0] = 500.0        # an xs column sets slot 1's scale
    qw = Q.quant_weights(w, h)
    assert tuple(qw) == Q.QW_NAMES
    q, s = qw["w_in"]
    assert s.shape == (n_slots, 1, 1)
    assert float(s[1]) == pytest.approx(500.0 * Q.XS_RANGE / 127.0 / 127.0)
    assert float(q[1, 2, 0]) == 127.0
    assert float(q.abs().max()) == 127.0
    folded = w["w_col"][..., h:] * (1.0 / 127.0)
    qc, sc = qw["w_col_x"]
    assert torch.equal(sc[:, 0, 0], folded.abs().amax((1, 2)) * (1.0 / 127.0)
                       + 1e-30)
    assert torch.equal(qc, torch.round(folded * (1.0 / sc)))


def test_int8_products_go_through_the_int8_mlp_only():
    x, w = torch.ones(1, 2, 3), torch.ones(1, 4, 3)
    with pytest.raises(ValueError, match="int8_mlp_apply"):
        policy_matmul(x, w, "int8")
    assert torch.equal(policy_matmul(x, w, "int8", fwd_f32=True),
                       x @ w.transpose(1, 2))
    with pytest.raises(ValueError, match="tile_points"):
        mlp_apply({"w_in": torch.ones(1, 4, 87)}, torch.ones(1, 2, 129),
                  policy="int8")


# ------------------------------------------- where the granularities meet
EX_H, EX_NPER, EX_S = 16, 128, 5


def one_iteration_vs_jax(jbank, b: dict, n_per: int, policies,
                         q8_tile_rays: int | None = None,
                         f32: dict | None = None) -> dict:
    """n_iter=1 of one slot's numpy batch ``b`` through the JAX kernel in
    interpret mode and the port's plain frame, under float32 and each of
    ``policies``: {policy: gradients (from the first AdamW moment) and
    losses of both sides}. ``f32``: float32's entry of an earlier call on
    the same bank and batch, taken in place of running float32 again."""
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    pbank = port_bank(jbank)
    m0 = np.asarray(jbank.m)
    out = {} if f32 is None else {"float32": f32}
    for pol in ("float32",) * (f32 is None) + tuple(policies):
        jb, jl = fused_bank_frame(jbank, jbatch, 1, n_per, 1, LR, WD, CS,
                                  OSC, bf16=JAX_POLICY[pol], interpret=True)
        pb, pl = K.fused_frame_reference(
            pbank, {k: t(v) for k, v in b.items()}, 1, n_per, LR, WD, CS,
            OSC, policy=pol, q8_tile_rays=q8_tile_rays)
        out[pol] = {"jax_g": (np.asarray(jb.m) - 0.9 * m0) / 0.1,
                    "port_g": (n(pb.m) - 0.9 * m0) / 0.1,
                    "jax_loss": np.asarray(jl), "port_loss": n(pl)}
    return out


def hold_by_ratio_rule(fr: dict, policy: str, jbank,
                       scale_tol: float = 1e-2) -> None:
    """The port's ``policy`` frame against JAX's (module docstring): each
    gradient tensor within ``scale_tol`` of its scale, within a tenth of the
    policy's effect in norm where the policy moves it, on at least 10
    tensors; the loss likewise."""
    cur, f32 = fr[policy], fr["float32"]
    errs = policy_errors(cur["port_g"], cur["jax_g"], f32["jax_g"],
                         jbank.spec, np.asarray(jbank.active))
    acting = {k: e for k, e in errs.items()
              if e["effect"] > 1e-3 * e["norm"]}
    print(f"\nh={jbank.spec.hidden} {policy}: port vs JAX worst "
          f"{max(e['max_rel'] for e in errs.values()):.3e} of scale, error "
          f"norm at most "
          f"{max(e['err'] / e['effect'] for e in acting.values()):.3e} of "
          f"the policy's effect; loss float32 / {policy}: JAX "
          f"{float(f32['jax_loss'].sum()):.6f} / "
          f"{float(cur['jax_loss'].sum()):.6f}, port "
          f"{float(f32['port_loss'].sum()):.6f} / "
          f"{float(cur['port_loss'].sum()):.6f}")
    for name, e in errs.items():
        assert e["max_rel"] <= scale_tol, (name, e)
        if name in acting:
            assert e["err"] <= 0.1 * e["effect"], (name, e)
    # the policy acts on most tensors
    assert len(acting) >= 10
    np.testing.assert_allclose(cur["port_loss"], cur["jax_loss"], rtol=2e-4,
                               atol=2e-6)
    loss_effect = np.abs(f32["jax_loss"] - cur["jax_loss"]).max()
    loss_err = np.abs(cur["port_loss"] - cur["jax_loss"]).max()
    assert loss_effect > 0 and loss_err <= 0.1 * loss_effect


@pytest.fixture(scope="module")
def exact_frames():
    """One slot (G = 1), 128 rays x 5 samples (one JAX chunk, one port
    tile of 128 rays), n_iter=1: the JAX kernel in interpret mode and the
    port's plain frame under float32 and each int8 policy."""
    jbank = conditioned_jax_bank(1, EX_H, 1)
    b = numpy_batch(np.random.default_rng(3), 1, EX_NPER, EX_S)
    return {"bank": jbank, "batch": b, **one_iteration_vs_jax(
        jbank, b, EX_NPER, Q.INT8_POLICIES, q8_tile_rays=EX_NPER)}


@pytest.mark.parametrize("policy", Q.INT8_POLICIES)
def test_int8_reference_matches_jax_kernel_at_one_tile(exact_frames, policy):
    hold_by_ratio_rule(exact_frames, policy, exact_frames["bank"])


# static maxima other than the defaults (8.0, 0.125, 0.02), each of a
# size the one-tile frame's sites reach, so every one of them acts
ENV_SCALES = {"VMAP_Q8_SACT": "5.0", "VMAP_Q8_SHEAD": "0.3",
              "VMAP_Q8_SGRAD": "0.05"}


def test_int8_static_env_scales_match_jax_kernel_at_one_tile(exact_frames,
                                                             monkeypatch):
    """``int8_static`` with ``VMAP_Q8_SACT`` / ``SHEAD`` / ``SGRAD`` set in
    the environment, which the JAX kernel reads where it is built and the
    port where a frame builds its static scales (``ops.quant
    .static_scales``): the port's plain frame against JAX's kernel by the
    ratio rule, as at the defaults; and the scales act, on both sides, so
    a port that kept the defaults would miss JAX's frame."""
    for k, v in ENV_SCALES.items():
        monkeypatch.setenv(k, v)
    assert Q.static_scales() == tuple(float(v) for v in ENV_SCALES.values())
    fr = one_iteration_vs_jax(exact_frames["bank"], exact_frames["batch"],
                              EX_NPER, ("int8_static",),
                              q8_tile_rays=EX_NPER,
                              f32=exact_frames["float32"])
    hold_by_ratio_rule(fr, "int8_static", exact_frames["bank"])
    default = exact_frames["int8_static"]
    for side in ("port", "jax"):
        moved = np.abs(fr["int8_static"][f"{side}_g"] - default[f"{side}_g"])
        assert moved.max() > 1e-2 * np.abs(default[f"{side}_g"]).max(), side
    # the port at the defaults is as far from JAX's env frame as the
    # scales move it: the fault this test closes
    miss = np.abs(default["port_g"] - fr["int8_static"]["jax_g"]).max()
    assert miss > 10 * np.abs(fr["int8_static"]["port_g"]
                              - fr["int8_static"]["jax_g"]).max()


@pytest.mark.parametrize("dyn", ["int8", "int8_static"])
def test_fwd_half_policy_shares_the_forward_and_sits_nearer_f32(
        exact_frames, dyn):
    """``<policy>_fwd`` runs the same quantised forward as ``<policy>``
    (the same first-iteration loss, on both sides) and an f32 backward, so
    its gradients lie closer to f32's than the fully quantised policy's
    (tests/test_int8_kernel.py's "between f32 and int8")."""
    fr = exact_frames
    half = dyn + "_fwd"
    for side in ("port", "jax"):
        assert np.array_equal(fr[half][f"{side}_loss"],
                              fr[dyn][f"{side}_loss"]), side
        f32 = fr["float32"][f"{side}_g"]
        assert (np.linalg.norm(fr[half][f"{side}_g"] - f32)
                < np.linalg.norm(fr[dyn][f"{side}_g"] - f32)), side


def test_int8_static_matches_jax_kernel_at_h256():
    """The iMAP width: one fresh h=256 field (scale 5.0, its weights as
    activate_slot draws them, as the trainer's first frame has them), 40
    rays x 14 samples, n_iter=1, under int8_static. The static policy
    fixes the activation and gradient scales, and at h=256 G = 1, so JAX's
    weight scales are per slot and tensor as the port's: the two coincide
    at any ray count, and the ratio rule holds. Held here because the
    width-256 instance of the algebra is the one the iMAP trainer runs,
    and its loss under int8_static moves far from float32's."""
    h = 256
    key = jax.random.PRNGKey(0)
    jbank = activate_slot(init_bank(key, 1, hidden=h), 0,
                          jax.random.fold_in(key, 0), 5.0, hidden=h)
    b = numpy_batch(np.random.default_rng(3), 1, 40, 14)
    fr = one_iteration_vs_jax(jbank, b, 40, ("int8_static",))
    hold_by_ratio_rule(fr, "int8_static", jbank)


IMAP_RAYS = 120


def imap_first_frame(tmp_path):
    """``configs/Replica/room0_imap.json`` on the analytic scene (dataset
    format Synthetic at the config's 1200x680 camera), cut to IMAP_RAYS
    rays (24 pixels in each of the 5 window frames) x 14 samples, one
    iteration and a 4-frame pool: the port's Mapper ingests frame 0 and
    its sampler draws the first frame's batch with the trainer's own draws
    (``Mapper._draws``, seeded by the config's ``tpu.seed``). Returns the
    Mapper's fresh h=256 field as a JAX bank, and the batch as numpy."""
    import json
    import os
    from vmap_tpu.core.bank import BankSpec, BankState
    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.core import mapper as TM
    from vmap_tpu_torch.core import step as ST
    from vmap_tpu_torch.data.loader import make_dataset
    from vmap_tpu_torch.interop import bank_to_numpy
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "Replica",
                           "room0_imap.json")) as f:
        raw = json.load(f)
    raw["dataset"].update(format="Synthetic", path="")
    raw["render"].update(iters_per_frame=1, n_per_optim=IMAP_RAYS)
    raw["vis"]["html_viewer"] = False
    raw["tpu"]["frame_pool_size"] = 4
    path = tmp_path / "room0_imap_first_frame.json"
    path.write_text(json.dumps(raw))
    cfg = Config.from_json(str(path))
    s = make_dataset(cfg)[0]
    pm = TM.Mapper(cfg, device="cpu")
    pm.ingest_frame(TM.FrameSample(
        image=s["image"], depth=s["depth"], inst=s["obj"],
        bbox_dict=s["bbox_dict"], t_wc=s["T"], frame_id=s["frame_id"]))
    st = pm.statics
    obj_tab, _ = pm._device_tables()
    draws, _ = pm._draws()
    batch = ST._sample_bank(*pm.pool.arrays(), *obj_tab,
                            torch.from_numpy(pm._slot_objid),
                            st.n_iter * st.win, st.n_px, st.n_b2s, st, draws,
                            px_block=st.px_block)
    jbank = BankState(**{f: jnp.asarray(v) for f, v in
                         bank_to_numpy(pm.bank_obj).items()},
                      spec=BankSpec.create(cfg.hidden_feature_size))
    return jbank, {k: n(v) for k, v in batch.items()}


def test_int8_static_matches_jax_kernel_on_the_imap_first_frame(tmp_path):
    """room0_imap's first frame on the analytic scene, its rays cut to 120
    x 14 samples, n_iter=1, under int8_static: the port's plain frame
    against JAX's kernel in interpret mode by the ratio rule, with each
    gradient tensor within 2e-2 of its scale in place of 1e-2. This
    frame's quantised gradients move by more than 1e-2 of scale under
    noise of f32 size in the input: the test prints, and holds at 1e-2 or
    more, how far the port's own frame moves when z is scaled by 1 +- 1e-6
    (about 8 ulp), one element's quantum flip; the error norm, which tells
    a fault from flips, stays
    within a tenth of the policy's effect. Both sides move the loss
    from float32's alike, so the iMAP trainer's loss under int8_static is
    JAX's algebra with JAX's default static scales
    (``ops.quant.Q8_SCALES``, set on the vMAP objects), not a fault of the
    port."""
    jbank, b = imap_first_frame(tmp_path)
    assert b["z"].shape == (1, IMAP_RAYS, 14) and b["valid"].any()
    fr = one_iteration_vs_jax(jbank, b, IMAP_RAYS, ("int8_static",))
    sign = np.random.default_rng(1).choice([-1.0, 1.0], b["z"].shape)
    nudged = {**b, "z": (b["z"] * (1.0 + sign * 1e-6)).astype(np.float32)}
    m0 = np.asarray(jbank.m)
    pb, _ = K.fused_frame_reference(
        port_bank(jbank), {k: t(v) for k, v in nudged.items()}, 1,
        IMAP_RAYS, LR, WD, CS, OSC, policy="int8_static")
    own = policy_errors((n(pb.m) - 0.9 * m0) / 0.1,
                        fr["int8_static"]["port_g"], fr["float32"]["port_g"],
                        jbank.spec, np.asarray(jbank.active))
    worst = max(e["max_rel"] for e in own.values())
    print(f"\nthe port's own frame with z x (1 +- 1e-6): worst "
          f"{worst:.3e} of scale")
    # the reason for the 2e-2 bar: f32 noise alone moves this frame past
    # the 1e-2 of the other tests
    assert worst >= 1e-2, worst
    hold_by_ratio_rule(fr, "int8_static", jbank, scale_tol=2e-2)


# ------------------------------------------ tests/test_int8_kernel.py's shapes
def _int8_test_bank(cap, h, n_active):
    """tests/test_int8_kernel.py::_bank: weights x0.3, step 3."""
    key = jax.random.PRNGKey(0)
    bank = init_bank(key, cap, hidden=h)
    for s in range(n_active):
        bank = activate_slot(bank, s, jax.random.fold_in(key, s),
                             2.0 + 0.5 * s, hidden=h)
    return bank.replace(flat=bank.flat * 0.3,
                        step=jnp.where(bank.active, 3, 0).astype(jnp.int32))


COARSE = {"obj": (4, 32, 8, 120, 3, 10, 7), "bg": (1, 16, 2, 200, 2, 5, 2)}


@pytest.fixture(scope="module")
def coarse_frames():
    """At each shape: the port's plain frame (its own tile:
    ``kernels.tile_rays``) and the JAX kernel in interpret mode, under
    float32, int8 and int8_fwd, on one bank and batch."""
    out = {}
    for name, (G, h, cap, n_per, n_iter, S, n_act) in COARSE.items():
        jbank = _int8_test_bank(cap, h, n_act)
        b = numpy_batch(np.random.default_rng(7), cap, n_iter * n_per, S)
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        pbank = port_bank(jbank)
        res = out[name] = {"bank": jbank, "n_iter": n_iter}
        for pol in ("float32", "int8", "int8_fwd"):
            pb, pl = K.fused_frame_reference(
                pbank, {k: t(v) for k, v in b.items()}, n_iter, n_per, LR,
                WD, CS, OSC, policy=pol)
            jb, jl = fused_bank_frame(jbank, jbatch, n_iter, n_per, G, LR,
                                      WD, CS, OSC, bf16=JAX_POLICY[pol],
                                      interpret=True)
            res[pol] = {"port": (n(pb.flat), n(pl)),
                        "jax": (np.asarray(jb.flat), np.asarray(jl))}
    return out


@pytest.mark.parametrize("shape", list(COARSE))
@pytest.mark.parametrize("policy", ["int8", "int8_fwd"])
def test_int8_close_to_f32_at_the_jax_test_shapes(coarse_frames, policy,
                                                   shape):
    fr = coarse_frames[shape]
    act = np.asarray(fr["bank"].active)
    flat0 = np.asarray(fr["bank"].flat)
    q_flat, q_l = fr[policy]["port"]
    f_flat, f_l = fr["float32"]["port"]
    bar = 6 * LR * fr["n_iter"]
    assert np.all(np.isfinite(q_l)) and np.all(np.isfinite(q_flat))
    np.testing.assert_allclose(q_l[act], f_l[act], rtol=0.08, atol=1e-3)
    assert float(np.abs(q_flat - f_flat).max()) < bar
    np.testing.assert_array_equal(q_flat[~act], flat0[~act])
    # the port against JAX under the same policy, by the same bars; and
    # each side's distance from its own f32 frame
    j_flat, j_l = fr[policy]["jax"]
    jf_flat, jf_l = fr["float32"]["jax"]

    def dist(flat_a, l_a, flat_b, l_b):
        rel = float((np.abs(l_a - l_b)[act] / np.abs(l_b)[act]).max())
        lrs = float(np.abs(flat_a - flat_b).max()) / LR
        return f"max loss rel {rel:.4e}, max param diff {lrs:.3f} lr"

    print(f"\n{shape}/{policy}: port vs JAX {dist(q_flat, q_l, j_flat, j_l)}"
          f"; port vs port f32 {dist(q_flat, q_l, f_flat, f_l)}; JAX vs JAX "
          f"f32 {dist(j_flat, j_l, jf_flat, jf_l)}")
    np.testing.assert_allclose(q_l[act], j_l[act], rtol=0.08, atol=1e-3)
    assert float(np.abs(q_flat - j_flat).max()) < bar


@pytest.mark.parametrize("policy", ["int8_static", "int8_static_fwd"])
def test_int8_static_runs_and_learns(policy):
    """tests/test_int8_kernel.py::test_int8_static_runs_and_learns on the
    port's plain frame: JAX's default static scales stay finite, keep
    inactive slots bit-identical and reduce the loss over 5 frames."""
    h, cap, n_per, n_iter, S = 32, 8, 96, 3, 6
    bank = port_bank(_int8_test_bank(cap, h, 7))
    flat0 = bank.flat.clone()
    rng = np.random.default_rng(2)
    totals = []
    for _ in range(5):
        b = {k: t(v) for k, v in
             numpy_batch(rng, cap, n_iter * n_per, S).items()}
        bank, lq = K.fused_frame_reference(bank, b, n_iter, n_per, 3e-3, WD,
                                           CS, OSC, policy=policy)
        totals.append(float(lq[bank.active].sum()))
    assert bool(torch.isfinite(bank.flat).all())
    assert totals[-1] < totals[0], totals
    assert torch.equal(bank.flat[~bank.active], flat0[~bank.active])


def test_int8_converges_like_f32():
    """tests/test_int8_kernel.py::test_int8_converges_like_f32 on the
    port: over 6 frames int8 reduces the loss and lands within 15% of the
    f32 end-point loss."""
    h, cap, n_per, n_iter, S = 32, 4, 96, 4, 6
    banks = {p: port_bank(_int8_test_bank(cap, h, cap))
             for p in ("float32", "int8")}
    rng = np.random.default_rng(1)
    first, last = {}, {}
    for frame in range(6):
        b = {k: t(v) for k, v in
             numpy_batch(rng, cap, n_iter * n_per, S).items()}
        for p in banks:
            banks[p], lp = K.fused_frame_reference(
                banks[p], b, n_iter, n_per, 3e-3, WD, CS, OSC, policy=p)
            first.setdefault(p, float(lp.sum()))
            last[p] = float(lp.sum())
    for p in banks:
        assert last[p] < first[p], (p, first, last)
    assert abs(last["int8"] - last["float32"]) < 0.15 * abs(last["float32"])
