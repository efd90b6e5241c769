"""Replica-scale synthetic room: a procedurally furnished room scene for
the acceptance protocol the reference runs on real Replica sequences
(2000-frame, ~50-object room0, configs/Replica/config_replica_room0_vMAP
.json:18-50 workload shape; eval protocol metric/eval_3D_scene.py:36-82).

Real Replica assets do not exist in this environment; this module builds a
room with the same *shape* of workload — a floor/walls/ceiling shell whose
semantic classes fold to background in the loader (data/replica.py
BACKGROUND_CLASSES), plus dozens of furniture-like instances (box/cylinder
/sphere composites: tables, chairs, shelves, lamps, sofas, crates) — and a
camera walk that observes every object from many viewpoints. Rendered with
the port's PyTorch ray tracer (renderer.py) and written in the exact Replica
vMAP layout (writer.py), it drives the REAL CLI + eval end-to-end at
reference scale.

World convention matches data/synthetic.py: y points DOWN (up = -y),
floor plane at y = 0, ceiling at y = -wall_h.
"""

from __future__ import annotations

import numpy as np

from vmap_tpu_torch.data_generation.settings import SceneObject
from vmap_tpu_torch.geometry.mesh import Mesh
from vmap_tpu_torch.geometry.primitives import box, cylinder, icosphere

# semantic classes: shell parts use Replica BACKGROUND_CLASSES members
# (data/replica.py:28 — floor 40, wall 93, ceiling 31); furniture classes
# are arbitrary non-background ids
FLOOR_CLS, WALL_CLS, CEIL_CLS = 40, 93, 31

# The same geometry written as a ScanNet-layout sequence needs ScanNet's
# semantic vocabulary: the ScanNet loader folds dataset.py:186-187's
# background ids {1, 3, 16, 41, ...} (data/scannet.py:31), in which
# Replica's shell ids 40/93/31 are FOREGROUND — an unmapped room turns
# its walls/floor/ceiling into room-sized "objects" that starve the real
# instances and poison the 3D-box association (diagnosed round 4,
# docs/room_study.md scannet300). Shell remaps onto ScanNet background
# ids (wall->1, floor->3, ceiling->41); chair(3) and shelf(16) move OFF
# the ScanNet background set.
SCANNET_CLS_MAP = {FLOOR_CLS: 3, WALL_CLS: 1, CEIL_CLS: 41, 3: 5, 16: 10}


def _aabb(mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    return mesh.vertices.min(0), mesh.vertices.max(0)


def _rect(center, du, eu: float, dv, ev: float, subdiv: int = 2) -> Mesh:
    """Rectangle patch with EXPLICIT in-plane axes: spans ±eu/2 along unit
    vector ``du`` and ±ev/2 along ``dv``. (plane_patch derives its in-plane
    frame from the normal, which does NOT put extent_u on the axis you
    might expect — the first room build shipped walls rotated 90 degrees
    and a floor with swapped extents, leaving the shell full of holes.)"""
    du = np.asarray(du, float)
    dv = np.asarray(dv, float)
    us = np.linspace(-eu / 2, eu / 2, subdiv + 1)
    vs = np.linspace(-ev / 2, ev / 2, subdiv + 1)
    verts = np.asarray(center, float) + (
        us[:, None, None] * du + vs[None, :, None] * dv).reshape(-1, 3)
    faces = []
    for i in range(subdiv):
        for j in range(subdiv):
            a00 = i * (subdiv + 1) + j
            a01 = a00 + 1
            a10 = a00 + (subdiv + 1)
            faces += [[a00, a10, a11 := a10 + 1], [a00, a11, a01]]
    return Mesh(verts, np.array(faces))


# ---------------------------------------------------------------------- #
# furniture builders: each returns a Mesh FOOTED at y=0 (sitting on the
# floor, extending upward = -y), centred at the origin in x/z
# ---------------------------------------------------------------------- #

def _table(rng) -> Mesh:
    w = rng.uniform(0.7, 1.4)
    d = rng.uniform(0.5, 0.9)
    h = rng.uniform(0.55, 0.8)
    top = box([-w / 2, -h, -d / 2], [w / 2, -h + 0.05, d / 2])
    legs = []
    lx, lz = w / 2 - 0.06, d / 2 - 0.06
    for sx in (-1, 1):
        for sz in (-1, 1):
            legs.append(box([sx * lx - 0.03, -h + 0.05, sz * lz - 0.03],
                            [sx * lx + 0.03, 0.0, sz * lz + 0.03]))
    return Mesh.concatenate([top] + legs)


def _chair(rng) -> Mesh:
    s = rng.uniform(0.38, 0.5)
    seat_h = rng.uniform(0.4, 0.5)
    seat = box([-s / 2, -seat_h, -s / 2], [s / 2, -seat_h + 0.05, s / 2])
    back = box([-s / 2, -seat_h - 0.45, s / 2 - 0.05],
               [s / 2, -seat_h, s / 2])
    legs = []
    for sx in (-1, 1):
        for sz in (-1, 1):
            legs.append(box([sx * (s / 2 - 0.05) - 0.02, -seat_h + 0.05,
                             sz * (s / 2 - 0.05) - 0.02],
                            [sx * (s / 2 - 0.05) + 0.02, 0.0,
                             sz * (s / 2 - 0.05) + 0.02]))
    return Mesh.concatenate([seat, back] + legs)


def _shelf(rng) -> Mesh:
    w = rng.uniform(0.6, 1.1)
    d = rng.uniform(0.25, 0.4)
    h = rng.uniform(1.0, 1.8)
    n_sh = rng.integers(3, 5)
    parts = [box([-w / 2, -h, -d / 2], [-w / 2 + 0.04, 0, d / 2]),
             box([w / 2 - 0.04, -h, -d / 2], [w / 2, 0, d / 2]),
             box([-w / 2, -h, -d / 2], [w / 2, -h + 0.04, d / 2])]
    for k in range(n_sh):
        y = -h * (k + 1) / (n_sh + 1)
        parts.append(box([-w / 2, y - 0.02, -d / 2], [w / 2, y + 0.02, d / 2]))
    return Mesh.concatenate(parts)


def _lamp(rng) -> Mesh:
    h = rng.uniform(1.1, 1.6)
    pole = cylinder(0.03, h - 0.2, center=(0, -(h - 0.2) / 2, 0),
                    segments=12)
    base = cylinder(0.18, 0.04, center=(0, -0.02, 0), segments=16)
    shade = cylinder(0.16, 0.24, center=(0, -(h - 0.08), 0), segments=16,
                     capped=False)
    return Mesh.concatenate([pole, base, shade])


def _sofa(rng) -> Mesh:
    w = rng.uniform(1.2, 1.9)
    d = rng.uniform(0.7, 0.9)
    seat = box([-w / 2, -0.42, -d / 2], [w / 2, 0, d / 2])
    back = box([-w / 2, -0.85, d / 2 - 0.18], [w / 2, 0, d / 2])
    arms = [box([s * w / 2 - (0.09 + 0.09 * s), -0.6, -d / 2],
                [s * w / 2 + (0.09 - 0.09 * s), 0, d / 2])
            for s in (-1, 1)]
    return Mesh.concatenate([seat, back] + arms)


def _crate(rng) -> Mesh:
    w, d, h = rng.uniform(0.3, 0.8, 3)
    return box([-w / 2, -h, -d / 2], [w / 2, 0, d / 2])


def _ball(rng) -> Mesh:
    r = rng.uniform(0.15, 0.35)
    return icosphere(r, (0.0, -r, 0.0), subdivisions=2)


def _drum(rng) -> Mesh:
    r = rng.uniform(0.15, 0.35)
    h = rng.uniform(0.3, 0.9)
    return cylinder(r, h, center=(0, -h / 2, 0), segments=20)


_BUILDERS = [("table", _table, 14), ("chair", _chair, 3),
             ("shelf", _shelf, 16), ("lamp", _lamp, 47),
             ("sofa", _sofa, 76), ("crate", _crate, 7),
             ("ball", _ball, 20), ("drum", _drum, 36)]


# ---------------------------------------------------------------------- #
# loaded-PLY furniture: the reference renders real Replica .glb assets
# (habitat_renderer.py:27-246). No real assets ship in this environment,
# so write_ply_library generates complex organic meshes (displaced
# icospheres, lathed vases, tori — 0.5-5k faces vs the primitives'
# 10-100), exports them as .ply files, and make_room_scene(ply_dir=...)
# loads them back through geometry/mesh.py's PLY parser — exercising the
# mesh-file furniture path at Replica-like triangle counts.
# ---------------------------------------------------------------------- #

def _displaced_rock(rng, subdiv=3) -> Mesh:
    m = icosphere(1.0, (0, 0, 0), subdivisions=subdiv)
    v = m.vertices.copy()
    r = np.linalg.norm(v, axis=1, keepdims=True)
    d = np.ones(len(v))
    for _ in range(4):   # smooth pseudo-noise: a few random plane waves
        k = rng.normal(size=3)
        ph = rng.uniform(0, 2 * np.pi)
        d += rng.uniform(0.05, 0.16) * np.sin(v @ k * 2.2 + ph)
    v = v / r * (r * d[:, None])
    v[:, 1] *= rng.uniform(0.6, 1.1)     # squash
    m = Mesh(v, m.faces)
    mn, mx = _aabb(m)
    s = rng.uniform(0.25, 0.55) / max(mx[0] - mn[0], 1e-6)
    m = m.apply_transform(np.diag([s, s, s, 1.0]))
    mn, mx = _aabb(m)
    return m.apply_translation([0, -mx[1], 0])   # foot at y=0


def _lathed_vase(rng, n_prof=14, segments=28) -> Mesh:
    h = rng.uniform(0.4, 1.0)
    ys = np.linspace(0, -h, n_prof)
    base = rng.uniform(0.08, 0.2)
    prof = base * (1.0 + 0.6 * np.sin(np.linspace(0, np.pi, n_prof))
                   + 0.25 * np.sin(np.linspace(0, 2 * np.pi, n_prof)
                                   + rng.uniform(0, np.pi)))
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    verts = np.stack([prof[:, None] * np.cos(ang)[None, :],
                      np.broadcast_to(ys[:, None], (n_prof, segments)),
                      prof[:, None] * np.sin(ang)[None, :]],
                     -1).reshape(-1, 3)
    faces = []
    for i in range(n_prof - 1):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            faces += [[a, b, a + segments], [b, b + segments, a + segments]]
    # cap the bottom (y=0 ring) with a fan
    c = len(verts)
    verts = np.vstack([verts, [[0.0, 0.0, 0.0]]])
    for j in range(segments):
        faces.append([j, (j + 1) % segments, c])
    return Mesh(np.asarray(verts), np.asarray(faces))


def _torus(rng, seg_u=26, seg_v=14) -> Mesh:
    R = rng.uniform(0.18, 0.35)
    r = rng.uniform(0.05, 0.1)
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([(R + r * np.cos(vv)) * np.cos(uu),
                      -(R + r) - r * np.sin(vv),       # stands on its rim
                      (R + r * np.cos(vv)) * np.sin(uu)], -1).reshape(-1, 3)
    faces = []
    for i in range(seg_u):
        for j in range(seg_v):
            a = i * seg_v + j
            b = ((i + 1) % seg_u) * seg_v + j
            a2 = i * seg_v + (j + 1) % seg_v
            b2 = ((i + 1) % seg_u) * seg_v + (j + 1) % seg_v
            faces += [[a, b, b2], [a, b2, a2]]
    m = Mesh(np.asarray(verts, float), np.asarray(faces))
    mn, mx = _aabb(m)
    return m.apply_translation([0, -mx[1], 0])


def write_ply_library(lib_dir: str, seed: int = 0, n: int = 9) -> list[str]:
    """Generate ``n`` complex furniture meshes and write them as .ply.
    Returns the file paths (deterministic per seed)."""
    import os
    os.makedirs(lib_dir, exist_ok=True)
    rng = np.random.default_rng(seed + 77)
    makers = [_displaced_rock, _lathed_vase, _torus]
    paths = []
    for i in range(n):
        m = makers[i % len(makers)](rng)
        p = os.path.join(lib_dir, f"piece_{i:02d}.ply")
        m.export(p)
        paths.append(p)
    return paths


def _ply_builder(pieces):
    """Builder drawing a random loaded library piece (uniform scale jitter;
    classes: rocks/vases/tori stand in for Replica's plant/vase/sculpture
    classes)."""
    def build(rng):
        m = pieces[rng.integers(len(pieces))]
        s = rng.uniform(0.8, 1.6)
        m = m.apply_transform(np.diag([s, s, s, 1.0]))
        mn, mx = _aabb(m)
        return m.apply_translation([0, -mx[1], 0])
    return build


def _rot_y(mesh: Mesh, ang: float) -> Mesh:
    c, s = np.cos(ang), np.sin(ang)
    T = np.eye(4)
    T[0, 0], T[0, 2], T[2, 0], T[2, 2] = c, s, -s, c
    return mesh.apply_transform(T)


def make_room_scene(n_objects: int = 40, seed: int = 0,
                    size=(9.0, 6.5), wall_h: float = 2.8,
                    ply_dir: str | None = None):
    """Build the furnished room.

    Returns (objects, shell, meta): ``objects`` are the n_objects furniture
    SceneObjects (instance ids 1..n), ``shell`` the floor/walls/ceiling
    SceneObjects (background classes, instance ids n+1..), ``meta`` a dict
    with the room extents. Placement is grid-free rejection sampling on
    footprints with a wall margin, so instances never interpenetrate.

    ``ply_dir``: directory of .ply furniture (see write_ply_library) —
    loaded pieces join the builder pool with weight ~1/3 of draws,
    approximating real Replica geometry complexity with mesh-file assets.
    """
    rng = np.random.default_rng(seed)
    sx, sz = float(size[0]), float(size[1])

    builders = list(_BUILDERS)
    if ply_dir is not None:
        import glob as _glob
        from vmap_tpu_torch.geometry.mesh import load_mesh
        pieces = [load_mesh(p)
                  for p in sorted(_glob.glob(ply_dir + "/*.ply"))]
        if pieces:
            # 4 pool entries of 12 -> ~1/3 of furniture draws are loaded
            builders += [("ply", _ply_builder(pieces), 11)] * 4

    X, Y, Z = (1, 0, 0), (0, 1, 0), (0, 0, 1)
    shell_meshes = [
        (_rect([0, 0, 0], X, sx, Z, sz, subdiv=4), FLOOR_CLS,
         (0.45, 0.42, 0.38)),
        (_rect([0, -wall_h, 0], X, sx, Z, sz, subdiv=2), CEIL_CLS,
         (0.8, 0.8, 0.78)),
        (_rect([-sx / 2, -wall_h / 2, 0], Y, wall_h, Z, sz, subdiv=2),
         WALL_CLS, (0.7, 0.68, 0.6)),
        (_rect([sx / 2, -wall_h / 2, 0], Y, wall_h, Z, sz, subdiv=2),
         WALL_CLS, (0.7, 0.68, 0.6)),
        (_rect([0, -wall_h / 2, -sz / 2], X, sx, Y, wall_h, subdiv=2),
         WALL_CLS, (0.66, 0.68, 0.64)),
        (_rect([0, -wall_h / 2, sz / 2], X, sx, Y, wall_h, subdiv=2),
         WALL_CLS, (0.66, 0.68, 0.64)),
    ]

    margin = 0.3
    placed: list[tuple[float, float, float]] = []   # (x, z, radius)
    objects = []
    attempts = 0
    while len(objects) < n_objects and attempts < n_objects * 500:
        attempts += 1
        name, build, cls = builders[rng.integers(len(builders))]
        mesh = _rot_y(build(rng), rng.uniform(0, 2 * np.pi))
        mn, mx = _aabb(mesh)
        rad = float(max(mx[0] - mn[0], mx[2] - mn[2])) / 2 + 0.10
        if rad >= min(sx, sz) / 2 - margin:
            # piece too wide to place anywhere (a large loaded-PLY draw
            # can exceed the placeable half-extent; uniform(lo, hi) with
            # hi < lo raises) — redraw
            continue
        x = rng.uniform(-sx / 2 + margin + rad, sx / 2 - margin - rad)
        z = rng.uniform(-sz / 2 + margin + rad, sz / 2 - margin - rad)
        # keep the camera walk ellipse (0.28 x room) clear of tall objects
        if (abs(x) < 0.33 * sx and abs(z) < 0.33 * sz
                and (mx[1] - mn[1]) > 0.9):
            continue
        if any((x - px) ** 2 + (z - pz) ** 2 < (rad + pr) ** 2
               for px, pz, pr in placed):
            continue
        placed.append((x, z, rad))
        mesh.apply_translation([x, 0.0, z])
        inst_id = len(objects) + 1
        albedo = tuple(rng.uniform(0.25, 0.9, 3))
        objects.append(SceneObject(mesh, instance_id=inst_id, class_id=cls,
                                   albedo=albedo))

    shell = [SceneObject(m, instance_id=n_objects + 1 + k, class_id=cls,
                         albedo=alb)
             for k, (m, cls, alb) in enumerate(shell_meshes)]
    meta = {"size": (sx, sz), "wall_h": wall_h, "n_objects": len(objects)}
    return objects, shell, meta


def room_trajectory(n_frames: int, size=(7.0, 5.0), seed: int = 0,
                    loops: float = 2.0) -> np.ndarray:
    """[N, 4, 4] camera walk: the eye loops an inner ellipse at standing
    height while the gaze sweeps around the room at an incommensurate rate
    (plus height nodding), so every object is observed from many bearings
    — the coverage property the reference gets from Replica's recorded
    walkthroughs (habitat_renderer.py:150-176 replays traj_w_c.txt)."""
    sx, sz = float(size[0]), float(size[1])
    rng = np.random.default_rng(seed + 1)
    ph_e, ph_t = rng.uniform(0, 2 * np.pi, 2)
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * loops * i / n_frames + ph_e
        # gaze sweeps ~3.17x per eye loop -> dense angular coverage
        b = 2 * np.pi * loops * 3.17 * i / n_frames + ph_t
        eye = np.array([0.28 * sx * np.sin(a),
                        -1.45 + 0.12 * np.sin(5.3 * a),
                        0.28 * sz * np.cos(a)])
        # gaze height sweeps the full room: floor grazing (-0.1) to
        # ceiling (-2.6) — without the high band the background field is
        # unconstrained at the ceiling and hallucinates geometry there
        # (first room run: bg accuracy 0.72 m; see docs/room_study notes)
        target = np.array([0.40 * sx * np.sin(b),
                           -1.35 + 1.25 * np.sin(2.7 * b + 1.1),
                           0.40 * sz * np.cos(b)])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        world_down = np.array([0.0, 1.0, 0.0])
        right = np.cross(world_down, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        T = np.eye(4, dtype=np.float64)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
        poses.append(T)
    return np.stack(poses).astype(np.float64)
