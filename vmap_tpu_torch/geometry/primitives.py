"""Analytic mesh primitives (GT construction for synthetic evaluation and
tests): icosphere, axis box, plane patch."""

from __future__ import annotations

import numpy as np

from vmap_tpu_torch.geometry.mesh import Mesh


def icosphere(radius: float = 1.0, center=(0.0, 0.0, 0.0),
              subdivisions: int = 3) -> Mesh:
    t = (1 + 5 ** 0.5) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(subdivisions):
        mid: dict = {}
        vlist = list(verts)
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                vlist.append((vlist[a] + vlist[b]) / 2)
                mid[key] = len(vlist) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return Mesh(verts + np.asarray(center, float), faces)


def box(box_min, box_max) -> Mesh:
    mn = np.asarray(box_min, float)
    mx = np.asarray(box_max, float)
    verts = np.array([[x, y, z]
                      for x in (mn[0], mx[0])
                      for y in (mn[1], mx[1])
                      for z in (mn[2], mx[2])])
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return Mesh(verts, np.array(faces))


def cylinder(radius: float, height: float, center=(0.0, 0.0, 0.0),
             axis=(0.0, 1.0, 0.0), segments: int = 24,
             capped: bool = True) -> Mesh:
    """Closed cylinder: ``axis`` is the length direction, ``center`` the
    midpoint. Triangulated side quads + (optionally) fan caps."""
    ax = np.asarray(axis, float)
    ax = ax / np.linalg.norm(ax)
    a = np.array([1.0, 0, 0]) if abs(ax[0]) < 0.9 else np.array([0.0, 1, 0])
    u = np.cross(a, ax)
    u /= np.linalg.norm(u)
    v = np.cross(ax, u)
    th = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = radius * (np.cos(th)[:, None] * u + np.sin(th)[:, None] * v)
    c = np.asarray(center, float)
    bot = c - ax * (height / 2) + ring          # [S, 3]
    top = c + ax * (height / 2) + ring
    verts = [bot, top]
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces += [[i, j, segments + j], [i, segments + j, segments + i]]
    if capped:
        base = 2 * segments
        verts.append((c - ax * (height / 2))[None])
        verts.append((c + ax * (height / 2))[None])
        for i in range(segments):
            j = (i + 1) % segments
            faces += [[base, j, i], [base + 1, segments + i, segments + j]]
    return Mesh(np.concatenate(verts), np.array(faces))


def plane_patch(center, normal, extent_u: float, extent_v: float,
                subdiv: int = 8) -> Mesh:
    """Rectangular patch of a plane, triangulated subdiv x subdiv."""
    n = np.asarray(normal, float)
    n = n / np.linalg.norm(n)
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0.0, 1, 0])
    u = np.cross(a, n)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    us = np.linspace(-extent_u / 2, extent_u / 2, subdiv + 1)
    vs = np.linspace(-extent_v / 2, extent_v / 2, subdiv + 1)
    verts = np.asarray(center, float) + (
        us[:, None, None] * u + vs[None, :, None] * v).reshape(-1, 3)
    faces = []
    for i in range(subdiv):
        for j in range(subdiv):
            a00 = i * (subdiv + 1) + j
            a01 = a00 + 1
            a10 = a00 + (subdiv + 1)
            a11 = a10 + 1
            faces += [[a00, a10, a11], [a00, a11, a01]]
    return Mesh(verts, np.array(faces))
