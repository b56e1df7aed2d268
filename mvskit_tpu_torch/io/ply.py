# Copy of mvskit_tpu/io/ply.py; the port imports nothing of mvskit_tpu.
"""PLY point-cloud I/O.

Fresh implementation of the subset of PLY the pipeline needs (the
reference vendors RPly and adapts it in io/io_file.{h,c}: header scan,
vertex read with x/y/z + optional nx/ny/nz + rgb, ascii or binary
write — reference io_file.c:20-341, patch_manager.cpp:542-668).
Supports ascii 1.0 and binary_little_endian 1.0, float/double/uchar/int
scalar properties, plus the reference adapter's mesh extensions
(io_file.c:189-341): `face` elements (variable-length vertex_indices
lists), `range_grid` elements (0-or-1-length per-cell vertex lists with
`obj_info num_cols/num_rows` geometry), and obj_info round-tripping.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_RGB_NAMES = (
    ("red", "green", "blue"),
    ("diffuse_red", "diffuse_green", "diffuse_blue"),
    ("r", "g", "b"),
)


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file. Returns dict with 'xyz' [N,3] float64 and, when
    present, 'normal' [N,3], 'rgb' [N,3] uint8, 'faces' (object array of
    int index lists), 'range_grid' ([rows,cols] int32, -1 = empty cell,
    when obj_info gives the geometry; flat [n] otherwise) and 'obj_info'
    (dict of str->str).

    Tries the native C++ reader (io/native.py) first — the analog of the
    reference's native PLY layer (io/io_file.c) — and falls back to the
    pure-Python parser for anything it declines (including any file with
    face/range_grid elements, which the native fast path skips)."""
    with open(path, "rb") as f:
        head = f.read(4096)
    if (
        b"element face" in head
        or b"element range_grid" in head
        or b"\nobj_info " in head
    ):
        return _read_ply_py(path)
    from . import native

    out = native.read_ply(path)
    if out is not None:
        return out
    return _read_ply_py(path)


def _read_ply_py(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ----
    if not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"PLY missing end_header: {path}")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[data.find(b"\n", end) + 1 :]

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype)|('__list__', ...)])
    obj_info: Dict[str, str] = {}
    for line in header[1:]:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if not elements:
                continue
            if tok[1] == "list":
                elements[-1][2].append(("__list__", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[2], tok[1]))
        elif tok[0] == "obj_info" and len(tok) >= 3:
            obj_info[tok[1]] = " ".join(tok[2:])
        elif tok[0] == "comment":
            continue

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format {fmt}")
    has_vertex = any(e[0] == "vertex" for e in elements)
    if not has_vertex and not any(
        e[0] in ("face", "range_grid") for e in elements
    ):
        raise ValueError(f"PLY has no vertex element: {path}")

    # Walk elements in file order. Scalar-only elements parse
    # vectorized; list elements (face / range_grid, the reference
    # adapter's mesh extensions io_file.c:68-187) parse item by item.
    cols: Dict[str, np.ndarray] = {}
    lists: Dict[str, list] = {}
    toks = body.split() if fmt == "ascii" else None
    tpos = 0  # ascii token cursor
    bpos = 0  # binary byte cursor
    for name, count, props in elements:
        has_list = any(p[0] == "__list__" for p in props)
        if not has_list:
            names = [p[0] for p in props]
            types = [p[1] for p in props]
            if fmt == "ascii":
                ncols = len(names)
                vals = np.array(
                    toks[tpos : tpos + count * ncols], dtype=np.float64
                ).reshape(count, ncols)
                tpos += count * ncols
                got = {n: vals[:, i] for i, n in enumerate(names)}
            else:
                dt = np.dtype(
                    [(n, "<" + _DTYPES[t]) for n, t in zip(names, types)]
                )
                rec = np.frombuffer(body, dtype=dt, count=count, offset=bpos)
                bpos += dt.itemsize * count
                got = {n: rec[n].astype(np.float64) for n in names}
            if name == "vertex":
                cols = got
        else:
            if len(props) != 1:
                raise ValueError(
                    f"mixed list/scalar element {name} unsupported"
                )
            _, cnt_t, val_t, _pname = props[0]
            items = []
            if fmt == "ascii":
                for _ in range(count):
                    k = int(toks[tpos]); tpos += 1
                    items.append(
                        np.array(toks[tpos : tpos + k], dtype=np.int64)
                    )
                    tpos += k
            else:
                cdt = np.dtype("<" + _DTYPES[cnt_t])
                vdt = np.dtype("<" + _DTYPES[val_t])
                for _ in range(count):
                    k = int(np.frombuffer(body, cdt, 1, bpos)[0])
                    bpos += cdt.itemsize
                    items.append(
                        np.frombuffer(body, vdt, k, bpos).astype(np.int64)
                    )
                    bpos += vdt.itemsize * k
            lists[name] = items

    out: Dict[str, np.ndarray] = {}
    if has_vertex:
        out["xyz"] = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    if all(n in cols for n in ("nx", "ny", "nz")):
        out["normal"] = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1)
    for rn in _RGB_NAMES:
        if all(n in cols for n in rn):
            out["rgb"] = np.stack(
                [cols[rn[0]], cols[rn[1]], cols[rn[2]]], axis=1
            ).astype(np.uint8)
            break
    if "face" in lists:
        out["faces"] = np.empty(len(lists["face"]), dtype=object)
        for i, fc in enumerate(lists["face"]):
            out["faces"][i] = fc
    if "range_grid" in lists:
        flat = np.array(
            [int(g[0]) if g.size else -1 for g in lists["range_grid"]],
            dtype=np.int32,
        )
        rows = obj_info.get("num_rows")
        cols_ = obj_info.get("num_cols")
        if rows and cols_ and int(rows) * int(cols_) == flat.size:
            flat = flat.reshape(int(rows), int(cols_))
        out["range_grid"] = flat
    if obj_info:
        out["obj_info"] = obj_info
    return out


def write_ply(
    path: str,
    xyz: np.ndarray,
    normal: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    binary: bool = False,
    rgb_names=("diffuse_red", "diffuse_green", "diffuse_blue"),
    faces=None,
    range_grid: Optional[np.ndarray] = None,
    obj_info: Optional[Dict[str, str]] = None,
) -> None:
    """Write a point cloud. Defaults to the reference's layout:
    x y z [nx ny nz] [diffuse_red diffuse_green diffuse_blue]
    (reference patch_manager.cpp:545-557).

    Mesh extensions (reference io_file.c ply_write_1, :218-341):
      faces      — iterable of vertex-index lists, written as a `face`
                   element with `property list uchar int vertex_indices`;
      range_grid — [rows, cols] (or flat) int array, -1 = empty cell,
                   written as a `range_grid` element of 0/1-length lists
                   with `obj_info num_cols/num_rows` geometry;
      obj_info   — extra `obj_info <key> <value>` header lines.
    """
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    has_mesh = faces is not None or range_grid is not None or obj_info
    if not has_mesh and tuple(rgb_names) == (
        "diffuse_red", "diffuse_green", "diffuse_blue",
    ):
        from . import native

        if native.write_ply(path, xyz, normal=normal, rgb=rgb, binary=binary):
            return
    info = dict(obj_info or {})
    if range_grid is not None:
        range_grid = np.asarray(range_grid)
        if range_grid.ndim == 2:
            # the reference emits num_cols before num_rows (io_file.c:252)
            info.setdefault("num_cols", str(range_grid.shape[1]))
            info.setdefault("num_rows", str(range_grid.shape[0]))
        range_grid = range_grid.reshape(-1).astype(np.int64)
    lines = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
    ]
    lines += [f"obj_info {k} {v}" for k, v in info.items()]
    lines += [
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if normal is not None:
        normal = np.asarray(normal, dtype=np.float32)
        lines += ["property float nx", "property float ny", "property float nz"]
    if rgb is not None:
        rgb = np.asarray(rgb, dtype=np.uint8)
        lines += [f"property uchar {c}" for c in rgb_names]
    if faces is not None:
        faces = [np.asarray(fc, dtype=np.int64).reshape(-1) for fc in faces]
        lines += [
            f"element face {len(faces)}",
            "property list uchar int vertex_indices",
        ]
    if range_grid is not None:
        lines += [
            f"element range_grid {range_grid.size}",
            "property list uchar int vertex_indices",
        ]
    lines.append("end_header")
    header = "\n".join(lines) + "\n"

    def list_blocks_binary(f):
        if faces is not None:
            for fc in faces:
                f.write(np.uint8(len(fc)).tobytes())
                f.write(fc.astype("<i4").tobytes())
        if range_grid is not None:
            for g in range_grid:
                if g >= 0:
                    f.write(np.uint8(1).tobytes())
                    f.write(np.int32(g).tobytes())
                else:
                    f.write(np.uint8(0).tobytes())

    def list_blocks_ascii(f):
        if faces is not None:
            for fc in faces:
                f.write(
                    " ".join([str(len(fc))] + [str(int(v)) for v in fc])
                    + "\n"
                )
        if range_grid is not None:
            for g in range_grid:
                f.write(f"1 {int(g)}\n" if g >= 0 else "0\n")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if binary:
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if normal is not None:
            fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        if rgb is not None:
            fields += [(c, "u1") for c in rgb_names]
        rec = np.zeros(n, dtype=np.dtype(fields))
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        if normal is not None:
            rec["nx"], rec["ny"], rec["nz"] = (
                normal[:, 0], normal[:, 1], normal[:, 2],
            )
        if rgb is not None:
            for i, c in enumerate(rgb_names):
                rec[c] = rgb[:, i]
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(rec.tobytes())
            list_blocks_binary(f)
    else:
        with open(path, "w") as f:
            f.write(header)
            for i in range(n):
                parts = [repr(float(v)) for v in xyz[i]]
                if normal is not None:
                    parts += [repr(float(v)) for v in normal[i]]
                if rgb is not None:
                    parts += [str(int(v)) for v in rgb[i]]
                f.write(" ".join(parts) + "\n")
            list_blocks_ascii(f)


def write_range_grid_ply(path: str, grid: np.ndarray) -> None:
    """Write a range_grid-only PLY (the reference's ply_write_list,
    io_file.c:189-216): one 0/1-length vertex_indices list per cell,
    -1 marking empty cells. Header carries no obj_info, matching the
    reference function."""
    grid = np.asarray(grid).reshape(-1).astype(np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element range_grid {grid.size}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for g in grid:
            f.write(f"1 {int(g)}\n" if g >= 0 else "0\n")
