"""Minimal PLY reader/writer (numpy; no plyfile).

A copy of ``d3net_tpu/utils/ply.py``: the same files read to the same
arrays, and the same points write the same bytes.

Supports ascii and binary_little_endian PLY with vertex properties and
(optionally) triangle faces — the two layouts ScanNet ships
(``*_vh_clean_2.ply`` xyz+rgb(+alpha), ``*_vh_clean_2.labels.ply`` +label).
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns {element_name: structured numpy array}. Faces (list props)
    are returned as an (F, 3) int array under 'face' when triangular."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a ply file"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', ...)])
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append([name, int(count), []])
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", _TYPES[parts[2]],
                                            _TYPES[parts[3]], parts[4]))
                else:
                    elements[-1][2].append((parts[2], _TYPES[parts[1]]))
            elif line == "end_header":
                break

        out = {}
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                assert all(p[0] == "list" for p in props), "mixed list props"
                _, cnt_t, val_t, _pname = props[0]
                if fmt == "ascii":
                    rows = []
                    for _ in range(count):
                        vals = f.readline().split()
                        n = int(vals[0])
                        rows.append([int(v) for v in vals[1 : 1 + n]])
                    out[name] = np.asarray(rows)
                else:
                    # assume constant list length 3 (triangle meshes)
                    cnt_dt = np.dtype(cnt_t)
                    val_dt = np.dtype(val_t)
                    item = cnt_dt.itemsize + 3 * val_dt.itemsize
                    raw = f.read(count * item)
                    arr = np.frombuffer(
                        raw, dtype=[("n", cnt_t), ("v", val_t, (3,))]
                    )
                    assert (arr["n"] == 3).all(), "non-triangle faces"
                    out[name] = arr["v"].copy()
            else:
                dt = np.dtype([(p[0], p[1]) for p in props])
                if fmt == "ascii":
                    data = np.loadtxt(
                        [f.readline() for _ in range(count)], dtype=dt, ndmin=1
                    )
                else:
                    data = np.frombuffer(f.read(count * dt.itemsize), dtype=dt)
                out[name] = data.copy()
        return out


def write_ply_points(path: str, xyz: np.ndarray, rgb=None):
    """ascii point-cloud writer (for visualization dumps)."""
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{xyz[i,0]} {xyz[i,1]} {xyz[i,2]}"
            if rgb is not None:
                row += f" {int(rgb[i,0])} {int(rgb[i,1])} {int(rgb[i,2])}"
            f.write(row + "\n")
