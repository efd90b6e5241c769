"""One rank of the port's sharded Mapper, for tests/test_torch_sharded.py.

    VMAP_COORDINATOR=127.0.0.1:<port> VMAP_NUM_PROCESSES=<n> \\
        VMAP_PROCESS_ID=<r> python tests/_torch_sharded_rank.py <spec.json>

The spec holds the port ``Config``'s fields (``mesh_axes`` among them),
the number of frames of the analytic scene (``SyntheticScene`` at the
config's camera, an orbit of 8 frames) to train on the CPU, the draws to
replay (an ``.npz`` of the ``Draws`` that a
one-process run was handed, in request order) and the banks to load after
the first frame's ingest (an ``.npz`` of the object and background banks'
fields, ``obj_<field>`` / ``bg_<field>``). Every rank prints one JSON line
(its slot range, each frame's loss and loss_mean, the jax, vmap_tpu and
cv2 modules it holds); rank 0 also writes the gathered banks to
``spec["out"]``. Imports only the port, so its ``sys.modules`` shows
whether the port pulled in JAX.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vmap_tpu_torch.config import Config  # noqa: E402
from vmap_tpu_torch.core.mapper import FrameSample, Mapper  # noqa: E402
from vmap_tpu_torch.core.step import Draws  # noqa: E402
from vmap_tpu_torch.data.synthetic import SyntheticScene  # noqa: E402
from vmap_tpu_torch.interop import FIELDS, bank_from_numpy  # noqa: E402
from vmap_tpu_torch.parallel.distributed import (  # noqa: E402
    init_from_env, shutdown)
from vmap_tpu_torch.parallel.launch import foreign_modules  # noqa: E402


class Replay:
    """draw_source handing out recorded draws in request order."""

    def __init__(self, path: str):
        self.z = np.load(path)
        self.used = 0

    def __call__(self, bank: str, shapes: dict) -> Draws:
        i, self.used = self.used, self.used + 1
        d = Draws(**{k: torch.from_numpy(self.z[f"{i}_{k}"])
                     for k in ("kf", "u", "v", "z")})
        assert {k: tuple(v.shape) for k, v in vars(d).items()} == \
            {k: tuple(v) for k, v in shapes.items()}, (bank, i)
        return d


def main(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    rank, world = init_from_env()
    cfg = Config(**spec["config"])
    mapper = Mapper(cfg, device="cpu",
                    draw_source=Replay(spec["draws"]) if spec.get("draws")
                    else None)
    scene = SyntheticScene(width=cfg.W, height=cfg.H, fx=cfg.fx, fy=cfg.fy)
    losses, means = [], []
    for i in range(spec["frames"]):
        s = scene.frame_sample(i, n_frames=8)
        mapper.ingest_frame(FrameSample(
            image=s["image"], depth=s["depth"], inst=s["obj"],
            bbox_dict=s["bbox_dict"], t_wc=s["T"], frame_id=i))
        if i == 0 and spec.get("banks"):
            z = np.load(spec["banks"])
            mapper.bank_obj = bank_from_numpy(
                {f: z[f"obj_{f}"] for f in FIELDS}, cfg.hidden_feature_size)
            mapper.bank_bg = bank_from_numpy(
                {f: z[f"bg_{f}"] for f in FIELDS},
                cfg.hidden_feature_size_bg)
        met = mapper.train_frame()
        losses.append(float(met["loss"]))
        means.append(float(met["loss_mean"]))
    bank = mapper.bank_obj   # gathered: every rank takes part
    if rank == 0:
        np.savez(spec["out"],
                 **{f"obj_{f}": getattr(bank, f).numpy() for f in FIELDS},
                 **{f"bg_{f}": getattr(mapper.bank_bg, f).numpy()
                    for f in FIELDS})
    print(json.dumps({"rank": rank, "world": world,
                      "slots": [mapper.lo, mapper.hi], "losses": losses,
                      "loss_mean": means, "foreign": foreign_modules()}))
    shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
