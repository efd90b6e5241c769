"""Fixed-capacity object bank with flat storage + masked AdamW (counterpart
of ``vmap_tpu/core/bank.py``).

Every per-object parameter (PE projection + 7 MLP layers) packs into one
``[capacity, n_params]`` buffer, with the Adam moments as two more. The
flat order is the JAX package's (``BankSpec.create``): the ``pe`` group
first, then ``mlp``, names sorted within each group, so flat buffers and
checkpoints cross-load between the two packages.

AdamW follows torch.optim.AdamW semantics: decoupled decay ``p *= 1-lr*wd``
before the Adam step, betas (0.9, 0.999), eps 1e-8, a bias-correction step
count per slot. Inactive slots receive exactly zero update.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

import torch

from vmap_tpu_torch.ops import embedding, mlp

B1, B2, EPS = 0.9, 0.999, 1e-8
# the per-slot tensors of a BankState, in the JAX BankState's order
FIELDS = ("flat", "m", "v", "step", "active", "scale")


@dataclass(frozen=True)
class BankSpec:
    """Static layout of one object's parameters inside the flat buffer."""
    hidden: int
    names: tuple   # ((group, name, shape, offset, size), ...)
    n_params: int

    @staticmethod
    @lru_cache(maxsize=8)
    def create(hidden: int) -> "BankSpec":
        shapes = {"pe": {"dirs": (embedding.N_DIRS, 3)}, "mlp": {}}
        for name, (fi, fo) in zip(mlp.LAYERS, mlp.layer_fans(hidden)):
            shapes["mlp"][f"w_{name}"] = (fo, fi)
            shapes["mlp"][f"b_{name}"] = (fo,)
        entries = []
        off = 0
        for group in ("pe", "mlp"):
            for name in sorted(shapes[group]):
                shape = shapes[group][name]
                size = 1
                for s in shape:
                    size *= s
                entries.append((group, name, shape, off, size))
                off += size
        return BankSpec(hidden=hidden, names=tuple(entries), n_params=off)

    def offset(self, name: str) -> int:
        for _, n, _, off, _ in self.names:
            if n == name:
                return off
        raise KeyError(name)

    def flatten(self, pe: dict, mlp_p: dict) -> torch.Tensor:
        """One object's (pe, mlp) dicts -> [n_params]."""
        groups = {"pe": pe, "mlp": mlp_p}
        return torch.cat([groups[g][n].reshape(-1)
                          for g, n, _, _, _ in self.names])

    def unflatten(self, flat: torch.Tensor) -> tuple[dict, dict]:
        """[..., n_params] -> (pe, mlp) dicts of views, leading axes kept."""
        lead = flat.shape[:-1]
        pe, mlp_p = {}, {}
        for g, n, shape, off, size in self.names:
            leaf = flat[..., off:off + size].reshape(*lead, *shape)
            (pe if g == "pe" else mlp_p)[n] = leaf
        return pe, mlp_p


@dataclass
class BankState:
    """Stacked per-object state: six tensors on one device."""
    flat: torch.Tensor     # [capacity, n_params] f32 parameters
    m: torch.Tensor        # [capacity, n_params] Adam first moments
    v: torch.Tensor        # [capacity, n_params] Adam second moments
    step: torch.Tensor     # [capacity] int32 per-slot Adam step count
    active: torch.Tensor   # [capacity] bool
    scale: torch.Tensor    # [capacity] f32 PE coordinate scale
    spec: BankSpec

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def params_for(self, slot: int) -> tuple[dict, dict]:
        return self.spec.unflatten(self.flat[slot])

    def replace(self, **kw) -> "BankState":
        return replace(self, **kw)


def fresh_flat(gen: torch.Generator, spec: BankSpec,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """A freshly initialised [n_params] parameter vector."""
    pe = embedding.init_pe_params()
    mlp_p = mlp.init_mlp_params(gen, spec.hidden)
    return spec.flatten(pe, mlp_p).to(device)


def init_bank(gen: torch.Generator, capacity: int, hidden: int,
              default_scale: float = 2.0,
              device: torch.device | str = "cpu") -> BankState:
    """Every slot freshly initialised from ``gen`` (a CPU generator) and
    inactive."""
    spec = BankSpec.create(hidden)
    flat = torch.stack([fresh_flat(gen, spec) for _ in range(capacity)])
    flat = flat.to(device)
    return BankState(
        flat=flat, m=torch.zeros_like(flat), v=torch.zeros_like(flat),
        step=torch.zeros(capacity, dtype=torch.int32, device=device),
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
        scale=torch.full((capacity,), default_scale, dtype=torch.float32,
                         device=device),
        spec=spec)


def activate_slot(bank: BankState, slot: int, gen: torch.Generator,
                  scale: float) -> BankState:
    """Activate ``slot`` with fresh parameters and zero moments. Updates
    the bank's tensors in place (one slot's rows) and returns the bank."""
    bank.flat[slot] = fresh_flat(gen, bank.spec, bank.device)
    bank.m[slot] = 0.0
    bank.v[slot] = 0.0
    bank.step[slot] = 0
    bank.active[slot] = True
    bank.scale[slot] = scale
    return bank


def set_slot_params(bank: BankState, slot: int, pe: dict,
                    mlp_p: dict) -> BankState:
    """Overwrite one slot's parameters from dicts (checkpoint load), in
    place."""
    dev = bank.device
    bank.flat[slot] = bank.spec.flatten(
        {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         for k, v in pe.items()},
        {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         for k, v in mlp_p.items()})
    return bank


def adam_bias_corrections(step: torch.Tensor, n_iter: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1**t, 1 - b2**t) for t = step + i + 1, i < n_iter: [cap, n_iter]
    f32 (slots whose t would be 0 use t = 1, as ``apply_adamw`` does)."""
    t = (step.to(torch.float32)[:, None]
         + torch.arange(1, n_iter + 1, dtype=torch.float32,
                        device=step.device)[None, :])
    b1 = torch.tensor(B1, dtype=torch.float32, device=step.device)
    b2 = torch.tensor(B2, dtype=torch.float32, device=step.device)
    return 1 - b1 ** t, 1 - b2 ** t


def apply_adamw(bank: BankState, grads_flat: torch.Tensor, lr: float,
                wd: float, b1: float = B1, b2: float = B2,
                eps: float = EPS) -> BankState:
    """Masked AdamW on the flat buffers; returns a new BankState."""
    t = torch.where(bank.active, bank.step + 1, bank.step)
    tb = torch.clamp(t, min=1).to(bank.flat.dtype)[:, None]
    act = bank.active[:, None]
    g = grads_flat
    mn = b1 * bank.m + (1 - b1) * g
    vn = b2 * bank.v + (1 - b2) * g * g
    b1t = torch.tensor(b1, dtype=tb.dtype, device=tb.device)
    b2t = torch.tensor(b2, dtype=tb.dtype, device=tb.device)
    mhat = mn / (1 - b1t ** tb)
    vhat = vn / (1 - b2t ** tb)
    pn = bank.flat * (1 - lr * wd) - lr * mhat / (torch.sqrt(vhat) + eps)
    return bank.replace(
        flat=torch.where(act, pn, bank.flat),
        m=torch.where(act, mn, bank.m),
        v=torch.where(act, vn, bank.v),
        step=t.to(torch.int32),
    )
