"""Bank state and single fields between the JAX package and the port,
through numpy.

The JAX ``BankState`` (``vmap_tpu/core/bank.py``) and the port's hold the
same six fields with the same flat parameter order, so a conversion is a
copy of six arrays. The JAX side passes its fields as numpy arrays
(``np.asarray(bank.flat)`` etc.): this module never imports JAX. A JAX
``OccupancyField``'s ``pe`` / ``mlp`` dicts, scale and widths make the
port's (``field_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from vmap_tpu_torch.core.bank import FIELDS, BankSpec, BankState


def bank_from_numpy(arrays: dict, hidden: int,
                    device: torch.device | str = "cpu") -> BankState:
    """``{"flat", "m", "v", "step", "active", "scale"}`` numpy arrays -> a
    port BankState on ``device``. Raises if the flat width does not match
    the hidden size's BankSpec."""
    spec = BankSpec.create(hidden)
    flat = np.asarray(arrays["flat"], np.float32)
    if flat.ndim != 2 or flat.shape[1] != spec.n_params:
        raise ValueError(f"flat shape {flat.shape} does not match hidden "
                         f"{hidden} ({spec.n_params} params)")

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=device)

    return BankState(
        flat=t("flat", torch.float32), m=t("m", torch.float32),
        v=t("v", torch.float32), step=t("step", torch.int32),
        active=t("active", torch.bool), scale=t("scale", torch.float32),
        spec=spec)


def bank_to_numpy(bank: BankState) -> dict:
    """Port BankState -> numpy arrays with the JAX field dtypes."""
    dtypes = {"flat": np.float32, "m": np.float32, "v": np.float32,
              "step": np.int32, "active": np.bool_, "scale": np.float32}
    return {f: getattr(bank, f).detach().cpu().numpy().astype(dtypes[f])
            for f in FIELDS}


def field_from_numpy(pe: dict, mlp: dict, scale: float, hidden: int,
                     max_deg: int = 5, device: torch.device | str = "cpu"):
    """A JAX ``OccupancyField``'s parameters (``{k: np.asarray(v)}`` of its
    ``pe`` and ``mlp``, ``float(field.scale)``, ``field.hidden``,
    ``field.max_deg``) -> the port's ``OccupancyField`` on ``device``."""
    from vmap_tpu_torch.models import OccupancyField

    def t(d):
        return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                device=device) for k, v in d.items()}

    return OccupancyField(t(pe), t(mlp), scale, hidden=hidden,
                          max_deg=max_deg)
