"""Headless visualisation.

The reference drives a live Open3D window (train.py:41-47, 342-376) and
converts meshes between trimesh and Open3D (vis.py:21-28). Training machines are
headless, so the equivalent here renders mesh snapshots to PNG with a
software rasteriser (matplotlib's 3D collection — no GL required) and, for
quick sanity checks, instance-map colourisations of incoming frames
(reference's cv2.imshow at dataset.py:277-278).
"""

from __future__ import annotations

import numpy as np


def render_mesh_snapshot(meshes, path: str, elev: float = 25.0,
                         azim: float = -60.0, dpi: int = 120) -> str:
    """Render one or more Mesh objects to a shaded PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if not isinstance(meshes, (list, tuple)):
        meshes = [meshes]
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    all_v = []
    for mesh in meshes:
        if mesh is None or len(mesh.faces) == 0:
            continue
        tris = mesh.triangles
        if mesh.vertex_colors is not None:
            c = np.asarray(mesh.vertex_colors[mesh.faces[:, 0]][:, :3],
                           np.float64)
            if c.max() > 1:
                c = c / 255.0
        else:
            c = np.full((len(tris), 3), 0.6)
        # cheap lambert from face normals
        n = mesh.face_normals()
        light = np.array([0.3, -0.5, 0.81])
        lam = np.clip(np.abs(n @ light), 0.3, 1.0)
        coll = Poly3DCollection(tris, facecolors=np.clip(c * lam[:, None], 0, 1),
                                edgecolors="none", zsort="average")
        ax.add_collection3d(coll)
        all_v.append(mesh.vertices)
    if all_v:
        v = np.concatenate(all_v)
        lo, hi = v.min(0), v.max(0)
        centre = (lo + hi) / 2
        r = float((hi - lo).max()) / 2 + 1e-6
        ax.set_xlim(centre[0] - r, centre[0] + r)
        ax.set_ylim(centre[1] - r, centre[1] + r)
        ax.set_zlim(centre[2] - r, centre[2] + r)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def label_to_rgb(inst: np.ndarray, seed: int = 0) -> np.ndarray:
    """Colourise an instance map ((W, H) int) -> (W, H, 3) uint8; id 0 dark,
    -1 (unsure) red-tinted (imgviz.label2rgb counterpart)."""
    inst = np.asarray(inst)
    ids = np.unique(inst)
    rng = np.random.default_rng(seed)
    lut = {0: np.array([30, 30, 30], np.uint8),
           -1: np.array([200, 40, 40], np.uint8)}
    for i in ids:
        if int(i) not in lut:
            lut[int(i)] = rng.integers(50, 255, 3).astype(np.uint8)
    out = np.zeros(inst.shape + (3,), np.uint8)
    for i in ids:
        out[inst == i] = lut[int(i)]
    return out


def save_frame_debug(sample: dict, path: str) -> str:
    """Side-by-side RGB | depth | instance panel for one ingested frame."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].imshow(np.transpose(sample["image"], (1, 0, 2)))
    axes[0].set_title("rgb")
    d = axes[1].imshow(sample["depth"].T, cmap="viridis")
    axes[1].set_title("depth")
    fig.colorbar(d, ax=axes[1], shrink=0.7)
    axes[2].imshow(np.transpose(label_to_rgb(sample["obj"]), (1, 0, 2)))
    axes[2].set_title("instances")
    for ax in axes:
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
