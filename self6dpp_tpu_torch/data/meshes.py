"""Mesh primitives, padding to static shapes and BOP PLY reading and
writing (numpy), copied from self6dpp_tpu/data/meshes.py."""

from __future__ import annotations

import numpy as np


def make_cube(size: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    s = size / 2.0
    verts = np.array(
        [[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
         [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]], dtype=np.float32)
    # 12 triangles, outward-facing
    faces = np.array([
        [0, 2, 1], [0, 3, 2],      # z-
        [4, 5, 6], [4, 6, 7],      # z+
        [0, 1, 5], [0, 5, 4],      # y-
        [3, 6, 2], [3, 7, 6],      # y+
        [0, 4, 7], [0, 7, 3],      # x-
        [1, 2, 6], [1, 6, 5],      # x+
    ], dtype=np.int32)
    return verts, faces


def make_icosphere(radius: float = 0.05, subdivisions: int = 2):
    """Icosphere by subdivision: 20 * 4**subdivisions faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        vlist = list(verts)
        new_faces = []

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (vlist[a] + vlist[b]) / 2.0
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts.astype(np.float32), faces.astype(np.int32)


def pad_mesh(verts: np.ndarray, faces: np.ndarray, max_verts: int,
             max_faces: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad to static shapes. Extra faces are (0,0,0) — degenerate, culled by
    the rasterizer's zero-area test."""
    V, F = len(verts), len(faces)
    assert V <= max_verts and F <= max_faces, (V, F, max_verts, max_faces)
    pv = np.zeros((max_verts, 3), dtype=np.float32)
    pv[:V] = verts
    pf = np.zeros((max_faces, 3), dtype=np.int32)
    pf[:F] = faces
    return pv, pf


def load_ply(path: str) -> dict:
    """Minimal BOP PLY loader (ascii + binary_little_endian), returning
    verts (V,3) in the file's unit, faces (F,3) (a polygon's first three
    ids), and optional colors/normals/uv/texture_file. The face list's
    count and index types are read as the header declares them (the JAX
    package's loader takes the list's name for its index type, so it
    cannot read a binary file's faces)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        out_texture = None
        elems: list[tuple[str, int, list[tuple[str, str]]]] = []
        cur_props: list[tuple[str, str]] = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element"):
                _, name, cnt = line.split()
                cur_props = []
                elems.append((name.decode(), int(cnt), cur_props))
            elif line.startswith(b"property"):
                parts = line.split()
                if parts[1] == b"list":
                    # ("list", name, count type, index type)
                    cur_props.append(("list", parts[-1].decode(),
                                      parts[2].decode(), parts[3].decode()))
                else:
                    cur_props.append((parts[1].decode(), parts[2].decode()))
            elif line.startswith(b"comment") and b"TextureFile" in line:
                # BOP textured models (e.g. ycbv) declare their texture png
                # as `comment TextureFile obj_xxxxxx.png`
                out_texture = line.split()[-1].decode()
            elif line.startswith(b"end_header"):
                break

        out: dict = {}
        np_types = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4", "int32": "i4",
                    "uint": "u4", "short": "i2", "ushort": "u2"}

        for name, cnt, props in elems:
            if name == "vertex":
                if fmt == "ascii":
                    data = np.loadtxt([f.readline() for _ in range(cnt)],
                                      dtype=np.float64).reshape(cnt, -1)
                else:
                    dt = np.dtype([(f"p{i}", "<" + np_types[t])
                                   for i, (t, _) in enumerate(props)])
                    data = np.frombuffer(f.read(cnt * dt.itemsize), dtype=dt)
                    data = np.stack([data[f"p{i}"].astype(np.float64)
                                     for i in range(len(props))], axis=1)
                keys = [p[1] for p in props]
                out["verts"] = data[:, [keys.index(k) for k in "xyz"]].astype(np.float32)
                if "nx" in keys:
                    out["normals"] = data[:, [keys.index(k) for k in ("nx", "ny", "nz")]].astype(np.float32)
                if "red" in keys:
                    out["colors"] = (data[:, [keys.index(k) for k in ("red", "green", "blue")]] / 255.0).astype(np.float32)
                if "texture_u" in keys:
                    out["uv"] = data[:, [keys.index("texture_u"), keys.index("texture_v")]].astype(np.float32)
            elif name == "face":
                faces = np.empty((cnt, 3), dtype=np.int32)
                if fmt == "ascii":
                    for i in range(cnt):
                        vals = f.readline().split()
                        faces[i] = [int(v) for v in vals[1 : 4]]
                else:
                    cnt_t = np.dtype("<" + np_types[props[0][2]])
                    idx_t = np.dtype("<" + np_types[props[0][3]])
                    tri = np.dtype([("n", cnt_t), ("i", idx_t, (3,))])
                    start = f.tell()
                    rows = np.frombuffer(f.read(cnt * tri.itemsize), tri)
                    if len(rows) == cnt and (rows["n"] == 3).all():
                        faces[:] = rows["i"]
                    else:       # polygons: one face at a time, first 3 ids
                        f.seek(start)
                        for i in range(cnt):
                            (n,) = np.frombuffer(f.read(cnt_t.itemsize), cnt_t)
                            ids = np.frombuffer(f.read(int(n) * idx_t.itemsize),
                                                idx_t)
                            faces[i] = ids[:3]
                out["faces"] = faces
        if out_texture is not None:
            out["texture_file"] = out_texture
        return out


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: np.ndarray | None = None) -> None:
    """Write an ascii PLY (BOP-compatible, mm units expected by loaders)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            row = f"{v[0]} {v[1]} {v[2]}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
        for fc in faces:
            f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")
