"""Icosahedral-direction positional encoding (counterpart of
``vmap_tpu/ops/embedding.py``).

Points are divided by a per-object scale, projected onto 21 trainable
directions, multiplied by the bands 2^0..2^max_deg and passed through
``sin(pi * .)``; the output is ``[x/scale (3), sin bands (21*(max_deg+1))]``,
129 dims for max_deg 5, split 87/42 between the density trunk and the
colour head.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vmap_tpu_torch.ops.mlp import policy_matmul

# The 21 icosahedral unit directions, re-declared here so the port never
# imports the JAX module; tests/test_torch_ops.py holds them equal to
# vmap_tpu.ops.embedding.ICO_DIRS.
ICO_DIRS = np.array([
    [0.8506508, 0.0, 0.5257311],
    [0.809017, 0.5, 0.309017],
    [0.5257311, 0.8506508, 0.0],
    [1.0, 0.0, 0.0],
    [0.809017, 0.5, -0.309017],
    [0.8506508, 0.0, -0.5257311],
    [0.309017, 0.809017, -0.5],
    [0.0, 0.5257311, -0.8506508],
    [0.5, 0.309017, -0.809017],
    [0.0, 1.0, 0.0],
    [-0.5257311, 0.8506508, 0.0],
    [-0.309017, 0.809017, -0.5],
    [0.0, 0.5257311, 0.8506508],
    [-0.309017, 0.809017, 0.5],
    [0.309017, 0.809017, 0.5],
    [0.5, 0.309017, 0.809017],
    [0.5, -0.309017, 0.809017],
    [0.0, 0.0, 1.0],
    [-0.5, 0.309017, 0.809017],
    [-0.809017, 0.5, 0.309017],
    [-0.809017, 0.5, -0.309017],
], dtype=np.float32)

N_DIRS = 21


def init_pe_params(device: torch.device | str = "cpu") -> dict:
    """Trainable PE parameters; the projection starts at ICO_DIRS."""
    return {"dirs": torch.tensor(ICO_DIRS, device=device)}   # [21, 3]


def embed(params: dict, x: torch.Tensor, scale: torch.Tensor,
          max_deg: int = 5, policy: str = "float32") -> torch.Tensor:
    """Encode points ``x`` [..., 3] -> [..., 3 + 21*(max_deg+1)].

    ``params["dirs"]`` is [21, 3], or [n, 21, 3] with ``x`` [n, ..., 3] and
    ``scale`` [n] for a bank of n slots. The band factor multiplies the
    projection before ``pi`` does, as the JAX function does. Under a
    matmul ``policy`` other than ``"float32"`` (banks only) the projection's
    forward stays f32; its dirs gradient is the product of bf16-rounded
    operands under the bf16 policies and f32 under the int8 ones, as in
    the train-frame kernel.
    """
    dirs = params["dirs"]
    if dirs.dim() == 2 and policy != "float32":
        raise ValueError("matmul policies take a bank's parameters")
    if dirs.dim() == 3 and policy != "float32":
        n = x.shape[0]
        xs = x / scale.reshape((-1,) + (1,) * (x.dim() - 1))
        proj = policy_matmul(xs.reshape(n, -1, 3), dirs, policy,
                             fwd_f32=True).reshape(*x.shape[:-1], N_DIRS)
    elif dirs.dim() == 3:    # batched over a leading slot axis
        lead = x.shape[1:-1]
        s = scale.reshape((-1,) + (1,) * (len(lead) + 1))
        xs = x / s
        proj = torch.einsum("n...k,njk->n...j", xs, dirs)
    else:
        xs = x / scale
        proj = xs @ dirs.T
    bands = 2.0 ** torch.arange(max_deg + 1, dtype=proj.dtype,
                                device=proj.device)
    pb = proj[..., None, :] * bands[:, None]                 # [..., B, 21]
    sin = torch.sin(pb * math.pi)
    sin = sin.reshape(*proj.shape[:-1], (max_deg + 1) * N_DIRS)
    return torch.cat([xs, sin], dim=-1)
