"""Point-cloud and mesh files: PLY (binary little-endian or ascii) and OBJ,
byte for byte the JAX package's formats (numpy, no native code)."""

from __future__ import annotations

import numpy as np


def write_ply(path, points, colors=None, normals=None, binary=True):
    """points (N, 3) float; colors (N, 3) float in [0, 1] or uint8;
    normals (N, 3) float. Properties x y z [nx ny nz] [red green blue]."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(np.asarray(colors, np.float32) * 255.0,
                             0, 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)
    if normals is not None:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)

    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if normals is not None:
                dt += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            if colors is not None:
                dt += [("r", "u1"), ("g", "u1"), ("b", "u1")]
            rec = np.zeros(n, dtype=dt)
            rec["x"], rec["y"], rec["z"] = points.T
            if normals is not None:
                rec["nx"], rec["ny"], rec["nz"] = normals.T
            if colors is not None:
                rec["r"], rec["g"], rec["b"] = colors.T
            f.write(rec.tobytes())
        else:
            for i in range(n):
                row = list(points[i])
                if normals is not None:
                    row += list(normals[i])
                line = " ".join(f"{v:.6f}" for v in row)
                if colors is not None:
                    line += " " + " ".join(str(int(c)) for c in colors[i])
                f.write((line + "\n").encode("ascii"))
    return path


def read_ply(path, return_normals=False):
    """PLY files of :func:`write_ply` -> (points, colors or None) or, with
    ``return_normals``, (points, colors or None, normals or None)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    n = 0
    props = []
    binary = True
    for line in header:
        if line.startswith("format ascii"):
            binary = False
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        if line.startswith("property"):
            _, typ, name = line.split()
            props.append((name, typ))
    type_map = {"float": "<f4", "uchar": "u1"}
    dt = np.dtype([(name, type_map[typ]) for name, typ in props])
    if binary:
        rec = np.frombuffer(data[head_end:head_end + n * dt.itemsize],
                            dtype=dt)
    else:
        rows = data[head_end:].decode("ascii").split()
        arr = np.asarray(rows, dtype=np.float64).reshape(n, len(props))
        rec = np.rec.fromarrays(
            [arr[:, i].astype(type_map[t]) for i, (_, t) in
             enumerate(props)], dtype=dt)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    cols = None
    if "red" in dt.names:
        cols = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
    if return_normals:
        normals = None
        if "nx" in dt.names:
            normals = np.stack([rec["nx"], rec["ny"], rec["nz"]],
                               axis=-1).astype(np.float32)
        return pts, cols, normals
    return pts, cols


_OBJ_BLOCK = 1 << 18     # rows formatted per write


def write_obj(path, vertices, faces, vertex_colors=None):
    """OBJ triangle mesh; per-vertex colors as the xyzrgb extension."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if vertex_colors is not None:
        rows = np.concatenate([vertices, np.asarray(
            vertex_colors, np.float32).reshape(-1, 3)], axis=1)
        v_line = "v %.6f %.6f %.6f %.4f %.4f %.4f\n"
    else:
        rows, v_line = vertices, "v %.6f %.6f %.6f\n"
    with open(path, "w", encoding="ascii") as f:
        # Python floats and ints of the rows, a block at a time: the same
        # text as formatting each numpy scalar, in a fraction of the time
        for lines, table in ((v_line, rows), ("f %d %d %d\n", faces + 1)):
            for i in range(0, len(table), _OBJ_BLOCK):
                f.write("".join(map(lines.__mod__, map(
                    tuple, table[i:i + _OBJ_BLOCK].tolist()))))
    return path


def grid_mesh_faces(height, width, keep=None):
    """Triangles of a depth-grid mesh, 2 (H-1) (W-1) of them: per cell
    (v00, v10, v01) then, after all those, (v11, v01, v10). ``keep``: an
    optional (H, W) bool mask; faces touching a dropped vertex go."""
    idx = np.arange(height * width).reshape(height, width)
    v00 = idx[:-1, :-1].reshape(-1)
    v01 = idx[:-1, 1:].reshape(-1)
    v10 = idx[1:, :-1].reshape(-1)
    v11 = idx[1:, 1:].reshape(-1)
    faces = np.concatenate([np.stack([v00, v10, v01], axis=-1),
                            np.stack([v11, v01, v10], axis=-1)], axis=0)
    if keep is not None:
        k = np.asarray(keep).reshape(-1)
        faces = faces[k[faces].all(axis=1)]
    return faces
