"""Helpers shared by the tests that hold the PyTorch port against the JAX
package on the CPU: JAX's own sampler draws handed to the port, the XLA
reference frame of the train-frame kernel, and array conversions."""

from __future__ import annotations

import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vmap_tpu import native as jnative
from vmap_tpu.core.bank import apply_adamw
from vmap_tpu.ops import losses as L
from vmap_tpu.ops.embedding import embed
from vmap_tpu.ops.mlp import mlp_apply
from vmap_tpu_torch import native as tnative
from vmap_tpu_torch.core.step import Draws
from vmap_tpu_torch.interop import FIELDS, bank_from_numpy


def wait_for_jax_native(timeout_s: float = 60.0) -> bool:
    """The JAX package builds its library in place, so a test worker that
    loads it while another worker's g++ is still writing it fails to load
    it, and the module then caches that failure. Where g++ exists, forget
    the failure and try again until the other build has finished."""
    deadline = time.monotonic() + timeout_s
    while not jnative.available():
        if shutil.which("g++") is None or time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        with jnative._lock:
            jnative._tried = False
    return True


def both_native() -> bool:
    """Both packages' marching cubes on their native libraries. Native and
    numpy backends emit the same surface with vertices in another order,
    so a mesh compared vertex by vertex must come from one backend on each
    side."""
    return tnative.available() and wait_for_jax_native()


def small_synthetic_config(path) -> str:
    """``configs/synthetic_vmap.json`` cut for the CPU (hidden 8 / 16, 24
    object rays, 2 iterations, grid_dim 24, 80x60 frames), written to
    ``path``; returns its path as a string."""
    import json
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "synthetic_vmap.json")) as f:
        raw = json.load(f)
    raw["model"].update(hidden_feature_size=8, hidden_feature_size_bg=16)
    raw["render"].update(iters_per_frame=2, n_per_optim=24,
                         n_per_optim_bg=48)
    raw["vis"].update(grid_dim=24, live_voxel_size=0.05)
    raw["camera"].update(w=80, h=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    raw["tpu"]["frame_pool_size"] = 16
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def small_imap_config(path) -> str:
    """``configs/Replica/room0_imap.json`` at its full width (one scene
    field of hidden 256, 5 + 9 = 14 samples per ray) cut for the CPU: the
    analytic scene (dataset format Synthetic) at 80x60, 60 rays and 3
    iterations per frame, grid_dim 24, a 16-frame pool, no HTML viewer;
    written to ``path``, returns its path as a string."""
    import json
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "Replica",
                           "room0_imap.json")) as f:
        raw = json.load(f)
    raw["dataset"].update(format="Synthetic", path="")
    raw["render"].update(iters_per_frame=3, n_per_optim=60)
    raw["vis"].update(grid_dim=24, live_voxel_size=0.05, html_viewer=False)
    raw["camera"].update(w=80, h=60, fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    raw["tpu"]["frame_pool_size"] = 16
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def t(a, dtype=None) -> torch.Tensor:
    """JAX / numpy array -> CPU torch tensor (a copy)."""
    return torch.tensor(np.asarray(a), dtype=dtype)


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def port_bank(jbank):
    """JAX BankState -> port BankState (through numpy)."""
    return bank_from_numpy({f: np.asarray(getattr(jbank, f)) for f in FIELDS},
                           jbank.spec.hidden)


def jax_bank_draws(key, shapes: dict) -> Draws:
    """The uniforms ``vmap_tpu.core.step._sample_bank`` draws from ``key``
    (split per slot, then into keyframe / u / v / z keys), shaped as the
    port's ``step.draw_shapes``."""
    cap, n_frames, n_cols = shapes["u"]
    nu, n_rays = shapes["z"][1:]

    def one(k):
        k_kf, k_u, k_v, k_z = jax.random.split(k, 4)
        return (jax.random.uniform(k_kf, (n_frames,)),
                jax.random.uniform(k_u, (n_frames, n_cols)),
                jax.random.uniform(k_v, (n_frames, n_cols)),
                jax.random.uniform(k_z, (nu, n_rays)))

    kf, u, v, z = jax.vmap(one)(jax.random.split(key, cap))
    return Draws(kf=t(kf), u=t(u), v=t(v), z=t(z))


def jax_frame_draw_source(frame_key):
    """draw_source for the port's frame step / Mapper that reproduces the
    JAX frame step's draws for ``frame_key`` (``split`` -> obj, bg)."""
    k_obj, k_bg = jax.random.split(jnp.asarray(frame_key))
    return lambda bank, shapes: jax_bank_draws(
        k_obj if bank == "obj" else k_bg, shapes)


def ref_frame(bank, batch, n_iter, n_per, lr=1e-3, wd=0.013, cs=5.0,
              osc=10.0):
    """XLA reference of the train-frame kernel (the scan of
    tests/test_train_kernel.py::ref_frame): returns (bank, losses
    [cap, n_iter])."""

    def slice_it(v, it):
        return jax.lax.dynamic_slice_in_dim(v, it * n_per, n_per, axis=1)

    def body(bank, it):
        sl = {k: slice_it(v, it) for k, v in batch.items()}

        def loss_fn(flat):
            pe, mlp_p = bank.spec.unflatten(flat)
            emb = jax.vmap(lambda p, x, s: embed(p, x, s))(
                pe, sl["pts"], bank.scale)
            alpha, color = jax.vmap(mlp_apply)(mlp_p, emb)
            return L.step_batch_loss(
                alpha[..., 0], color, sl["depth"], sl["rgb"], sl["state"],
                sl["valid"], sl["z"], bank.active, cs, osc)

        (_, per), g = jax.value_and_grad(loss_fn, has_aux=True)(bank.flat)
        return apply_adamw(bank, g, lr, wd), per

    bank, pers = jax.lax.scan(body, bank, jnp.arange(n_iter))
    return bank, pers.T
