"""Re-export meshes from a saved full-state checkpoint at a chosen grid
cap (counterpart of ``scripts/remesh.py``).

    python -m vmap_tpu_torch.remesh --config <run config> \\
        --ckpt <logdir>/ckpt/state --out <mesh_dir> --grid_dim 256 \\
        [--frame N] [--device cuda|cpu]

A run trained with a low ``vis.grid_dim`` is meshed again offline from its
checkpoint (``core.checkpoint.save_full_checkpoint``, the trainer's
``--save_ckpt``) instead of being trained again: the config's grid cap is
replaced by ``--grid_dim``, the state restored into a fresh ``Mapper``
(``load_full_checkpoint``) and every object meshed by
``Mapper.export_meshes``, through the field kernel K2 on the card (the
default) or its plain version with ``--device cpu``. The meshes are named
after ``--frame``, by default the checkpoint's frame. It runs in one
process (a config's ``tpu.mesh_axes`` is ignored).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True,
                   help="a full-state checkpoint: its .pt file or the "
                   "directory holding latest.json")
    p.add_argument("--out", required=True)
    p.add_argument("--grid_dim", type=int, default=256)
    p.add_argument("--frame", type=int, default=None,
                   help="frame id used in the exported filenames "
                   "(default: the checkpoint's frame)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    args = parse_args(argv)
    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.core import checkpoint as ckpt_lib
    from vmap_tpu_torch.core.mapper import Mapper

    cfg = Config.from_json(args.config)
    cfg.grid_dim = args.grid_dim
    cfg.mesh_axes = None
    mapper = Mapper(cfg, device=args.device)
    frame = ckpt_lib.load_full_checkpoint(mapper, args.ckpt)
    fid = args.frame if args.frame is not None else frame
    paths = mapper.export_meshes(args.out, fid)
    print(f"re-meshed {len(paths)} objects at grid cap {args.grid_dim} "
          f"-> {args.out}")
    return paths


if __name__ == "__main__":
    main()
