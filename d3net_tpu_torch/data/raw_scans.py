"""Synthetic scans in ScanNet's raw layout, the input of
``d3net_tpu_torch.scripts.prepare_scannet``.

ScanNet ships no data here, so ``write_raw_scan`` writes what one scan
directory of ``scans/`` holds, made from a seed:

    <scan>/<scan>_vh_clean_2.ply                 binary mesh: float x y z,
                                                 uchar red green blue alpha,
                                                 triangle faces
    <scan>/<scan>_vh_clean_2.labels.ply          the same vertices with a
                                                 ushort nyu40 ``label``
    <scan>/<scan>_vh_clean_2.0.010000.segs.json  ``segIndices``, a segment
                                                 id a vertex
    <scan>/<scan>.aggregation.json               ``segGroups``: id, objectId,
                                                 segments, label (a name)
    <scan>/<scan>.txt                            the meta file with its
                                                 ``axisAlignment`` line

The room (floor, four walls, ceiling) and ``objects`` boxes are grids of
vertices, triangulated, each cut into segments of a few hundred vertices;
the raw mesh is the aligned room moved by the inverse of the alignment, as
ScanNet's scans are. ``quirks`` adds what the preprocessing must get
right: a group with no vertices, an object whose first vertex carries a
do-not-care label, labels above 149 and unannotated clutter.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

# ScanNet category names of nyu40 ids, as aggregation.json names them
NYU40_NAMES = {1: "wall", 2: "floor", 3: "cabinet", 4: "bed", 5: "chair",
               6: "sofa", 7: "table", 8: "door", 9: "window",
               10: "bookshelf", 11: "picture", 12: "counter", 14: "desk",
               16: "curtain", 22: "ceiling", 24: "refrigerator",
               28: "shower curtain", 33: "toilet", 34: "sink", 36: "bathtub",
               39: "otherfurniture"}
OBJECT_NYU40 = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36,
                39)
SEGMENT_VERTICES = 400       # about this many vertices a segment


def write_mesh_ply(path: str, xyz: np.ndarray, rgb: np.ndarray,
                   faces: np.ndarray, labels: Optional[np.ndarray] = None):
    """A binary little-endian PLY of ScanNet's ``_vh_clean_2`` layout (with
    ``labels``, its ``.labels.ply``)."""
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
              ("green", "u1"), ("blue", "u1"), ("alpha", "u1")]
    props = ["float x", "float y", "float z", "uchar red", "uchar green",
             "uchar blue", "uchar alpha"]
    if labels is not None:
        fields.append(("label", "<u2"))
        props.append("ushort label")
    vert = np.empty(len(xyz), fields)
    for k, name in enumerate("xyz"):
        vert[name] = xyz[:, k]
    for k, name in enumerate(("red", "green", "blue")):
        vert[name] = rgb[:, k]
    vert["alpha"] = 255
    if labels is not None:
        vert["label"] = labels
    face = np.empty(len(faces), [("n", "u1"), ("v", "<i4", (3,))])
    face["n"] = 3
    face["v"] = faces
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(xyz)}\n"
              + "".join(f"property {p}\n" for p in props)
              + f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vert.tobytes())
        f.write(face.tobytes())


def _grid(origin, u, v, n: int, rng: np.random.Generator):
    """About ``n`` vertices on the parallelogram ``origin + s·u + t·v``,
    triangulated; returns (xyz, faces, rows of vertices)."""
    lu, lv = np.linalg.norm(u), np.linalg.norm(v)
    nu = max(2, int(round(np.sqrt(n * lu / lv))))
    nv = max(2, int(round(n / nu)))
    s, t = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv))
    xyz = (np.asarray(origin) + s.reshape(-1, 1) * u + t.reshape(-1, 1) * v)
    xyz = xyz + rng.normal(0, 0.002, xyz.shape)
    i, j = np.meshgrid(np.arange(nu - 1), np.arange(nv - 1))
    a = (j * nu + i).reshape(-1)
    faces = np.concatenate([np.stack([a, a + 1, a + nu + 1], 1),
                            np.stack([a, a + nu + 1, a + nu], 1)])
    return xyz, faces, nv


def alignment(rng: np.random.Generator) -> np.ndarray:
    """A ScanNet-like ``axisAlignment``: a turn about z and a shift."""
    a = rng.uniform(-np.pi, np.pi)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:3, 3] = rng.uniform(-5, 5, 3) * [1, 1, 0.1]
    return m


def write_raw_scan(scans_dir: str, scan: str, seed: int, *,
                   vertices: int = 150_000, objects: int = 20,
                   align: Optional[np.ndarray] = None, meta: bool = True,
                   aggregation: bool = True, quirks: bool = False
                   ) -> Dict[str, int]:
    """Write scan ``scan`` under ``scans_dir`` (about ``vertices`` mesh
    vertices, ``objects`` boxes in a room, the raw mesh moved by the inverse
    of ``align``, else of a seeded ``alignment``); ``meta=False`` leaves out
    the meta file, ``aggregation=False`` the labels, segments and
    aggregation (a test-split scan). Returns its vertex, face, segment and
    group counts."""
    rng = np.random.default_rng(seed)
    mat = alignment(rng) if align is None else np.asarray(align, np.float64)
    room = rng.uniform([4.0, 4.0, 2.4], [8.0, 7.0, 3.0])
    boxes = []
    for _ in range(objects):
        size = rng.uniform([0.3, 0.3, 0.3], [1.6, 1.2, 1.4])
        lo = rng.uniform(0, room[:2] - size[:2])
        boxes.append((np.array([lo[0], lo[1], 0.0]), size,
                      int(rng.choice(OBJECT_NYU40))))
    # (origin, u, v, nyu40, group) a surface; group None = unannotated
    x, y, z = (np.eye(3)[k] for k in range(3))
    surfaces = [((0, 0, 0), room[0] * x, room[1] * y, 2, "floor"),
                ((0, 0, room[2]), room[0] * x, room[1] * y, 22, "ceiling")]
    for k, (o, u) in enumerate((((0, 0, 0), room[0] * x),
                                ((room[0], 0, 0), room[1] * y),
                                ((room[0], room[1], 0), -room[0] * x),
                                ((0, room[1], 0), -room[1] * y))):
        surfaces.append((o, u, room[2] * z, 1, f"wall{k}"))
    for b, (lo, size, nyu) in enumerate(boxes):
        dx, dy, dz = size[0] * x, size[1] * y, size[2] * z
        top = lo + dz
        for o, u, v in ((top, dx, dy), (lo, dx, dz), (lo, dy, dz),
                        (lo + dy, dx, dz), (lo + dx, dy, dz)):
            surfaces.append((o, u, v, nyu, f"obj{b}"))
    if quirks:                       # unannotated clutter on the floor
        surfaces.append(((0.2, 0.2, 0.01), 0.5 * x, 0.5 * y, 0, None))
    areas = np.array([np.linalg.norm(np.cross(u, v))
                      for _, u, v, _, _ in surfaces])
    counts = np.maximum(8, vertices * areas / areas.sum()).astype(int)

    xyz, faces, labels, seg_ids, rgb = [], [], [], [], []
    group_segs: Dict[str, list] = {}
    group_nyu: Dict[str, int] = {}
    n0, seg0 = 0, 0
    for (o, u, v, nyu, group), n in zip(surfaces, counts):
        p, f, rows = _grid(o, np.asarray(u), np.asarray(v), int(n), rng)
        per_row = len(p) // rows
        rows_per_seg = max(1, SEGMENT_VERTICES // per_row)
        seg = seg0 + np.arange(len(p)) // per_row // rows_per_seg
        xyz.append(p)
        faces.append(f + n0)
        labels.append(np.full(len(p), nyu, np.int64))
        seg_ids.append(seg)
        color = rng.integers(40, 220, 3)
        rgb.append(np.clip(color + rng.integers(-20, 21, (len(p), 3)), 0,
                           255))
        if group is not None:
            group_segs.setdefault(group, []).extend(np.unique(seg).tolist())
            group_nyu[group] = nyu
        n0 += len(p)
        seg0 = int(seg.max()) + 1
    xyz = np.concatenate(xyz)
    faces = np.concatenate(faces).astype(np.int32)
    labels = np.concatenate(labels)
    seg_ids = np.concatenate(seg_ids)
    rgb = np.concatenate(rgb).astype(np.uint8)

    groups = []
    for gi, (group, segs) in enumerate(group_segs.items()):
        segs = [int(s) for s in rng.permutation(segs)]
        groups.append({"id": gi, "objectId": gi, "segments": segs,
                       "label": NYU40_NAMES[group_nyu[group]]})
    if quirks:
        obj = next(g for g in groups if g["label"] not in
                   ("wall", "floor", "ceiling"))
        first = int(np.flatnonzero(seg_ids == obj["segments"][0])[0])
        labels[first] = 1                 # a do-not-care first vertex
        groups.append({"id": len(groups), "objectId": len(groups) + 7,
                       "segments": [seg0 + 1000], "label": "chair"})
        high = rng.choice(len(labels), max(1, len(labels) // 200), False)
        labels[high] = rng.integers(150, 65536, len(high))

    homo = np.concatenate([xyz, np.ones((len(xyz), 1))], 1)
    raw = (homo @ np.linalg.inv(mat).T)[:, :3].astype(np.float32)
    base = os.path.join(scans_dir, scan)
    os.makedirs(base, exist_ok=True)
    write_mesh_ply(os.path.join(base, f"{scan}_vh_clean_2.ply"), raw, rgb,
                   faces)
    if aggregation:
        write_mesh_ply(os.path.join(base, f"{scan}_vh_clean_2.labels.ply"),
                       raw, rgb, faces, labels.astype(np.uint16))
        with open(os.path.join(
                base, f"{scan}_vh_clean_2.0.010000.segs.json"), "w") as f:
            json.dump({"params": {"kThresh": "0.0001", "segMinVerts": "20",
                                  "minPoints": "750", "maxPoints": "30000",
                                  "thinThresh": "0.05", "flatThresh": "0.001",
                                  "minLength": "0.02", "maxLength": "1"},
                       "sceneId": scan,
                       "segIndices": seg_ids.tolist()}, f)
        with open(os.path.join(base, f"{scan}.aggregation.json"), "w") as f:
            json.dump({"sceneId": f"scannet.{scan}", "appId": "Aggregator.v2",
                       "segGroups": groups,
                       "segmentsFile": f"scannet.{scan}_vh_clean_2.0.010000"
                                       ".segs.json"}, f)
    if meta:
        with open(os.path.join(base, f"{scan}.txt"), "w") as f:
            f.write("colorHeight = 968\ncolorWidth = 1296\n")
            f.write("axisAlignment = "
                    + " ".join(f"{v:.6f}" for v in mat.reshape(-1)) + "\n")
            f.write("depthHeight = 480\ndepthWidth = 640\n"
                    "sceneType = Apartment\n")
    return {"vertices": len(xyz), "faces": len(faces),
            "segments": seg0, "groups": len(groups)}
