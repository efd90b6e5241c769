"""Triangle-mesh container with the capabilities the reference gets from
trimesh: OBJ/PLY import+export (train.py:357-360, metric/eval_3D_scene.py),
uniform surface sampling (trimesh.sample.sample_surface, eval scripts),
concatenation (scene composition, eval_3D_scene.py:55-60), and slicing to an
oriented box (rec-mesh cropping, eval_3D_obj.py:13-16).
"""

from __future__ import annotations

import struct

import numpy as np


class Mesh:
    def __init__(self, vertices, faces, vertex_colors=None, vertex_normals=None):
        self.vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int64).reshape(-1, 3)
        self.vertex_colors = (None if vertex_colors is None
                              else np.asarray(vertex_colors))
        self.vertex_normals = (None if vertex_normals is None
                               else np.asarray(vertex_normals, np.float64))

    # ---- basic ops ------------------------------------------------------
    def copy(self) -> "Mesh":
        return Mesh(self.vertices.copy(), self.faces.copy(),
                    None if self.vertex_colors is None else self.vertex_colors.copy(),
                    None if self.vertex_normals is None else self.vertex_normals.copy())

    def apply_translation(self, t) -> "Mesh":
        self.vertices = self.vertices + np.asarray(t, np.float64)
        return self

    def apply_scale(self, s) -> "Mesh":
        self.vertices = self.vertices * np.asarray(s, np.float64)
        return self

    def apply_transform(self, T) -> "Mesh":
        T = np.asarray(T, np.float64)
        self.vertices = self.vertices @ T[:3, :3].T + T[:3, 3]
        return self

    @property
    def triangles(self) -> np.ndarray:
        return self.vertices[self.faces]  # [F, 3, 3]

    def face_areas(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)

    @property
    def area(self) -> float:
        return float(self.face_areas().sum())

    def face_normals(self) -> np.ndarray:
        t = self.triangles
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    def compute_vertex_normals(self) -> np.ndarray:
        fn = self.face_normals()
        vn = np.zeros_like(self.vertices)
        for k in range(3):
            np.add.at(vn, self.faces[:, k], fn)
        self.vertex_normals = vn / np.maximum(
            np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        return self.vertex_normals

    # ---- sampling (counterpart of trimesh.sample.sample_surface) --------
    def sample_surface(self, n: int, seed: int | None = None) -> np.ndarray:
        """``n`` points uniform by area over the surface -> [n, 3]."""
        rng = np.random.default_rng(seed)
        areas = self.face_areas()
        total = areas.sum()
        if total <= 0 or len(self.faces) == 0:
            raise ValueError("cannot sample a mesh with zero surface area")
        fidx = rng.choice(len(areas), size=n, p=areas / total)
        t = self.triangles[fidx]
        # uniform barycentric
        r1 = np.sqrt(rng.random(n))
        r2 = rng.random(n)
        a = 1 - r1
        b = r1 * (1 - r2)
        c = r1 * r2
        return (a[:, None] * t[:, 0] + b[:, None] * t[:, 1] + c[:, None] * t[:, 2])

    # ---- composition ----------------------------------------------------
    @staticmethod
    def concatenate(meshes: list["Mesh"]) -> "Mesh":
        meshes = [m for m in meshes if m is not None and len(m.faces)]
        if not meshes:
            return Mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        vs, fs, cs = [], [], []
        off = 0
        any_colors = any(m.vertex_colors is not None for m in meshes)
        for m in meshes:
            vs.append(m.vertices)
            fs.append(m.faces + off)
            if any_colors:
                c = (m.vertex_colors if m.vertex_colors is not None
                     else np.full((len(m.vertices), 3), 127, np.uint8))
                cs.append(np.asarray(c)[:, :3])
            off += len(m.vertices)
        return Mesh(np.concatenate(vs), np.concatenate(fs),
                    np.concatenate(cs) if any_colors else None)

    # ---- slicing (counterpart of trimesh slice_plane, eval_3D_obj.py:16) -
    def slice_halfspace(self, origin, normal) -> "Mesh":
        """Keep the part of the mesh with dot(v - origin, normal) >= 0.
        Triangles crossing the plane are clipped (Sutherland-Hodgman)."""
        o = np.asarray(origin, np.float64)
        nrm = np.asarray(normal, np.float64)
        d = (self.vertices - o) @ nrm
        keep_v = d >= 0
        fk = keep_v[self.faces]
        n_in = fk.sum(axis=1)
        full = self.faces[n_in == 3]
        crossing = np.nonzero((n_in == 1) | (n_in == 2))[0]

        new_vs = [self.vertices]
        new_fs = [full]
        base = len(self.vertices)
        for fi in crossing:
            poly = list(self.faces[fi])
            out_pts = []
            for i in range(3):
                a, b = poly[i], poly[(i + 1) % 3]
                da, db = d[a], d[b]
                pa, pb = self.vertices[a], self.vertices[b]
                if da >= 0:
                    out_pts.append(pa)
                if (da >= 0) != (db >= 0):
                    t = da / (da - db)
                    out_pts.append(pa + t * (pb - pa))
            if len(out_pts) < 3:
                continue
            pts = np.asarray(out_pts)
            idx = np.arange(len(pts)) + base
            new_vs.append(pts)
            for k in range(1, len(pts) - 1):  # fan
                new_fs.append(np.array([[idx[0], idx[k], idx[k + 1]]]))
            base += len(pts)
        verts = np.concatenate(new_vs)
        faces = np.concatenate(new_fs) if new_fs else np.zeros((0, 3), np.int64)
        m = Mesh(verts, faces)
        return m.remove_unreferenced()

    def slice_box(self, obb) -> "Mesh":
        """Crop to an OrientedBox: successive half-space slices against its
        6 faces (inward normals)."""
        m = self
        for o, nrm in obb.face_planes():
            m = m.slice_halfspace(o, nrm)
            if len(m.faces) == 0:
                break
        return m

    def remove_unreferenced(self) -> "Mesh":
        used = np.unique(self.faces)
        remap = np.full(len(self.vertices), -1, np.int64)
        remap[used] = np.arange(len(used))
        return Mesh(self.vertices[used], remap[self.faces],
                    None if self.vertex_colors is None else self.vertex_colors[used])

    # ---- IO -------------------------------------------------------------
    def export(self, path: str) -> None:
        if path.endswith(".obj"):
            self._export_obj(path)
        elif path.endswith(".ply"):
            self._export_ply(path)
        else:
            raise ValueError(f"unsupported mesh format: {path}")

    def _export_obj(self, path: str) -> None:
        """One %-format over every row (the text of a per-row f-string,
        without the Python loop)."""
        cols = self.vertex_colors
        rows = np.asarray(self.vertices, np.float64)[:, :3]
        line = "v %.6f %.6f %.6f\n"
        if cols is not None:
            c = np.asarray(cols, np.float64)
            if c.max() > 1.0:
                c = c / 255.0
            rows = np.concatenate([rows, c[:, :3]], axis=1)
            line = "v %.6f %.6f %.6f %.4f %.4f %.4f\n"
        faces = np.asarray(self.faces, np.int64)[:, :3] + 1
        with open(path, "w") as f:
            f.write("# vmap_tpu mesh\n")
            f.write((line * len(rows)) % tuple(rows.ravel().tolist()))
            f.write(("f %d %d %d\n" * len(faces))
                    % tuple(faces.ravel().tolist()))

    def _export_ply(self, path: str) -> None:
        cols = self.vertex_colors
        with open(path, "wb") as f:
            hdr = ["ply", "format binary_little_endian 1.0",
                   f"element vertex {len(self.vertices)}",
                   "property float x", "property float y", "property float z"]
            if cols is not None:
                hdr += ["property uchar red", "property uchar green",
                        "property uchar blue"]
            hdr += [f"element face {len(self.faces)}",
                    "property list uchar int vertex_indices", "end_header"]
            f.write(("\n".join(hdr) + "\n").encode())
            if cols is not None:
                c = np.asarray(cols)
                if c.dtype != np.uint8:
                    c = np.clip(c * (255.0 if c.max() <= 1.0 else 1.0),
                                0, 255).astype(np.uint8)
                for v, cc in zip(self.vertices.astype(np.float32), c):
                    f.write(struct.pack("<fffBBB", *v, *cc[:3]))
            else:
                f.write(self.vertices.astype("<f4").tobytes())
            for face in self.faces:
                f.write(struct.pack("<Biii", 3, *face))


# ---------------------------------------------------------------------- #
def load_mesh(path: str) -> Mesh:
    if path.endswith(".obj"):
        return _load_obj(path)
    if path.endswith(".ply"):
        return _load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_ply_with_face_props(path: str) -> tuple[Mesh, dict]:
    """PLY load that also returns scalar per-face properties (e.g. the
    ``object_id`` carried by Replica's mesh_semantic.ply) as
    {name: [n_faces] array}. Polygon faces are fan-triangulated and their
    properties replicated per output triangle."""
    return _load_ply(path, want_face_props=True)


def _load_obj(path: str) -> Mesh:
    """Vertices (colours where every vertex has them) and faces, polygons
    fan-triangulated. Where every ``v`` line holds one count of
    single-spaced numbers and every ``f`` line three plain indices (the
    files ``export`` writes), the numbers are parsed in C
    (``np.fromstring``, correctly rounded as ``float``); other files go
    token by token."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    v_lines = [ln for ln in lines if ln.startswith(b"v ")]
    f_lines = [ln for ln in lines if ln.startswith(b"f ")]
    spaces = {ln.count(b" ") for ln in v_lines}
    if (v_lines and f_lines and len(spaces) == 1 and min(spaces) >= 3
            and all(ln.count(b" ") == 3 and b"/" not in ln
                    for ln in f_lines)):
        width = spaces.pop()
        vals = np.fromstring(b" ".join(ln[2:] for ln in v_lines), sep=" ")
        faces = np.fromstring(b" ".join(ln[2:] for ln in f_lines),
                              dtype=np.int64, sep=" ")
        if (vals.size == width * len(v_lines)
                and faces.size == 3 * len(f_lines)):
            vals = vals.reshape(len(v_lines), width)
            colors = vals[:, 3:6].copy() if width >= 6 else None
            return Mesh(vals[:, :3].copy(), faces.reshape(-1, 3) - 1, colors)
    vs, fs, cs = [], [], []
    for line in v_lines:
        parts = line.decode().split()
        vs.append([float(x) for x in parts[1:4]])
        if len(parts) >= 7:
            cs.append([float(x) for x in parts[4:7]])
    for line in f_lines:
        idx = [int(p.split("/")[0]) - 1 for p in line.decode().split()[1:]]
        for k in range(1, len(idx) - 1):  # fan for polygons
            fs.append([idx[0], idx[k], idx[k + 1]])
    colors = np.asarray(cs) if len(cs) == len(vs) and cs else None
    return Mesh(np.asarray(vs), np.asarray(fs, np.int64), colors)


_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _load_ply(path: str, want_face_props: bool = False):
    """Minimal PLY reader: ascii and binary_little_endian, vertex xyz
    (+rgb) and triangular/polygonal faces."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_t, item_t)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], None, True,
                                        _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]]))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]],
                                        False, None, None))

    verts = faces = colors = None
    face_props: dict = {}
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                row = []
                for p in props:
                    if p[2]:  # list
                        n = int(tokens[pos]); pos += 1
                        row.append([float(tokens[pos + i]) for i in range(n)])
                        pos += n
                    else:
                        row.append(float(tokens[pos])); pos += 1
                rows.append(row)
            verts, faces, colors = _ply_collect(name, props, rows, verts,
                                                faces, colors,
                                                face_props=face_props)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if not any(p[2] for p in props):  # fixed-size element: bulk read
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count=count, offset=off)
                off += dt.itemsize * count
                rows = arr
                verts, faces, colors = _ply_collect(name, props, rows, verts,
                                                    faces, colors, structured=True)
            else:
                rows = []
                for _ in range(count):
                    row = []
                    for p in props:
                        if p[2]:
                            cdt = np.dtype("<" + p[3])
                            n = int(np.frombuffer(body, cdt, 1, off)[0])
                            off += cdt.itemsize
                            idt = np.dtype("<" + p[4])
                            row.append(np.frombuffer(body, idt, n, off).tolist())
                            off += idt.itemsize * n
                        else:
                            idt = np.dtype("<" + p[1])
                            row.append(float(np.frombuffer(body, idt, 1, off)[0]))
                            off += idt.itemsize
                    rows.append(row)
                verts, faces, colors = _ply_collect(name, props, rows, verts,
                                                    faces, colors,
                                                    face_props=face_props)
    else:
        raise ValueError(f"unsupported PLY format: {fmt}")
    if verts is None:
        raise ValueError("PLY has no vertex element")
    mesh = Mesh(verts,
                faces if faces is not None else np.zeros((0, 3), np.int64),
                colors)
    if want_face_props:
        return mesh, face_props
    return mesh


def _ply_collect(name, props, rows, verts, faces, colors, structured=False,
                 face_props=None):
    names = [p[0] for p in props]
    if name == "vertex":
        if structured:
            verts = np.stack([rows["x"], rows["y"], rows["z"]], axis=1).astype(np.float64)
            if "red" in names:
                colors = np.stack([rows["red"], rows["green"], rows["blue"]],
                                  axis=1).astype(np.uint8)
        else:
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            verts = np.array([[r[xi], r[yi], r[zi]] for r in rows], np.float64)
            if "red" in names:
                ri = names.index("red")
                colors = np.array([[r[ri], r[ri + 1], r[ri + 2]] for r in rows],
                                  np.uint8)
    elif name == "face":
        li = next(i for i, p in enumerate(props) if p[2])
        scalar_idx = [(i, p[0]) for i, p in enumerate(props) if not p[2]]
        tri = []
        extra = {pname: [] for _, pname in scalar_idx}
        for r in rows:
            idx = [int(x) for x in r[li]]
            n_tris = max(len(idx) - 2, 0)
            for k in range(1, len(idx) - 1):
                tri.append([idx[0], idx[k], idx[k + 1]])
            for i, pname in scalar_idx:
                extra[pname].extend([r[i]] * n_tris)
        faces = np.asarray(tri, np.int64) if tri else np.zeros((0, 3), np.int64)
        if face_props is not None:
            for pname, vals in extra.items():
                face_props[pname] = np.asarray(vals)
    return verts, faces, colors
