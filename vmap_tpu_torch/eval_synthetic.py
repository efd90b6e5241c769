"""End-to-end quality check on the analytic scene: train -> mesh -> 3D
metrics against exact ground truth (counterpart of
``scripts/eval_synthetic.py``).

    python -m vmap_tpu_torch.eval_synthetic [--frames 16] [--passes 3]
        [--grid 64] [--width 120] [--height 90] [--iters 10] [--out f.json]
        [--dtype float32|bfloat16|bwd_bf16] [--px_block 1]
        [--px_block_bg 1] [--bg_rays 80] [--bg_hidden 32]
        [--fused auto|0|1] [--device cuda|cpu]

The synthetic scene (``data.synthetic.SyntheticScene``: a sphere and a
box on a floor, seen from an orbit) has closed-form ground-truth meshes,
so Accuracy / Completion / Completion-ratio are exact. ``--frames``
frames of the orbit are trained ``--passes`` times through the port's
``Mapper`` (objects at hidden 32, the background at ``--bg_hidden``),
then every object is meshed at ``--grid`` (``Mapper.mesh_object``) and
scored by ``eval.mesh_eval.eval_object``; the background's completion
counts only the floor the orbit observed (``observed_points_mask``).

The knobs are the JAX script's: ``--dtype`` the matmul policy,
``--px_block`` / ``--px_block_bg`` the pixel blocks, ``--bg_rays`` the
background's rays a frame, ``--bg_hidden`` its width (K1 and K2 are built
for 16 / 32 / 64 / 128 / 256), ``--fused`` ``tpu.fused_train_step``
("auto", or 0 / 1 for false / true: under 0 the card runs the plain
frame, JAX's XLA step). The card is the default device; ``--device cpu``
runs the plain versions (the JAX script's ``--cpu``). Prints one line per
object, then ``kernel launches {...}``, the run's nonzero CUDA kernel
launch counts (``kernels.train_step.LAUNCHES``,
``kernels.ensemble.LAUNCHES``: none on the CPU), and returns (and with
``--out`` writes) {object: metrics}.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--passes", type=int, default=3)
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--width", type=int, default=120)
    p.add_argument("--height", type=int, default=90)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    # quality-study knobs (bf16 / block-sampling / background budget)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "bwd_bf16"])
    p.add_argument("--px_block", type=int, default=1)
    p.add_argument("--px_block_bg", type=int, default=1)
    p.add_argument("--bg_rays", type=int, default=80)
    p.add_argument("--bg_hidden", type=int, default=32)
    p.add_argument("--fused", default="auto", choices=["auto", "0", "1"])
    return p.parse_args(argv)


def scene_config(args, Config):
    """The JAX script's configuration of the run, as a ``Config``."""
    fx = args.width * 0.75
    fused = args.fused if args.fused == "auto" else args.fused == "1"
    return Config(
        max_n_models=4, do_bg=True, hidden_feature_size=32,
        hidden_feature_size_bg=args.bg_hidden, n_iter_per_frame=args.iters,
        win_size=3, n_samples_per_frame=40,
        win_size_bg=3, n_samples_per_frame_bg=args.bg_rays,
        keyframe_buffer_size=10, keyframe_step=4, keyframe_step_bg=4,
        W=args.width, H=args.height, fx=fx, fy=fx,
        cx=(args.width - 1) / 2, cy=(args.height - 1) / 2,
        frame_pool_size=args.frames + 2, live_voxel_size=0.02,
        grid_dim=args.grid, seed=0, compute_dtype=args.dtype,
        px_block=args.px_block, px_block_bg=args.px_block_bg,
        fused_train_step=fused)


def evaluate(mapper, scene, args) -> dict:
    """Every object's mesh at ``args.grid`` scored against the scene's
    exact meshes -> {name: metrics}; the background's completion over the
    observed floor only (the orbit sees a fraction of the 8 x 8 m patch)."""
    import numpy as np
    from vmap_tpu_torch.eval.mesh_eval import (eval_object,
                                               observed_points_mask)
    fx = args.width * 0.75
    names = {0: "background", scene.SPHERE_ID: "sphere",
             scene.BOX_ID: "box"}
    frames = [scene.render(fid, n_frames=args.frames)
              for fid in range(args.frames)]
    poses = np.stack([f[3] for f in frames])
    depths = np.stack([f[1] for f in frames])

    def bg_filter(pts):
        return observed_points_mask(pts, poses, depths, fx, fx,
                                    (args.width - 1) / 2,
                                    (args.height - 1) / 2, tol=0.05)

    results = {}
    for oid, gt_mesh in scene.gt_meshes().items():
        rec = mapper.mesh_object(oid, grid_dim=args.grid)
        if rec is None:
            print(f"{names[oid]}: meshing failed")
            continue
        met = eval_object(rec, gt_mesh, n=8000,
                          gt_filter=bg_filter if oid == 0 else None)
        if met is None:
            print(f"{names[oid]}: empty after GT crop")
            continue
        results[names[oid]] = met
        print(f"{names[oid]:>10}: acc={met['accuracy']:.4f}m "
              f"comp={met['completion']:.4f}m "
              f"r@1cm={met['completion_ratio_1cm']:.3f} "
              f"r@5cm={met['completion_ratio_5cm']:.3f}")
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    from vmap_tpu_torch.config import Config
    from vmap_tpu_torch.core.mapper import FrameSample, Mapper
    from vmap_tpu_torch.data.synthetic import SyntheticScene

    fx = args.width * 0.75
    scene = SyntheticScene(width=args.width, height=args.height, fx=fx,
                           fy=fx)
    m = Mapper(scene_config(args, Config), device=args.device)
    for fid in list(range(args.frames)) * args.passes:
        s = scene.frame_sample(fid, n_frames=args.frames)
        m.process_frame(FrameSample(s["image"], s["depth"], s["obj"],
                                    s["bbox_dict"], s["T"], fid))
    total_steps = int(m.bank_obj.step.max())
    print(f"trained: {m.n_objects} objects, {total_steps} steps each")
    results = evaluate(m, scene, args)
    from vmap_tpu_torch.kernels import ensemble, train_step
    counts = {k: v for k, v in {**train_step.LAUNCHES,
                                **ensemble.LAUNCHES}.items() if v}
    print(f"kernel launches {json.dumps(counts)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
