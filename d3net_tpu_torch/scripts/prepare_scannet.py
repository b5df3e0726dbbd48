"""Offline ScanNet preprocessing, the port's copy of the JAX package's
``scripts/prepare_scannet.py`` (parity: ``data/scannet/prepare_scannet.py``).

Per scan: read the clean_2 mesh (xyz+rgb, vertex normals computed from
faces), the label ply (nyu40 ids remapped to 0..19, unannotated -> -1), the
segs/aggregation jsons (per-point instance ids, wall/floor/ceiling groups
dropped), the axis-align matrix from the meta txt; compute per-instance
AABBs (cx cy cz dx dy dz nyu40label objectId) on raw and aligned meshes;
save one ``<scan>.npz`` consumed by ``d3net_tpu_torch.data.dataset.NpzScenes``
(and by the JAX package's). Host-only numpy: it touches no device.

Usage: python -m d3net_tpu_torch.scripts.prepare_scannet \
           --scans <raw_scans_dir> --out <processed_dir> \
           [--split meta/scannetv2_train.txt] [--workers 8] \
           [--write-inst-gt <gt_dir>]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from d3net_tpu_torch.utils.ply import read_ply

# nyu40 -> 0..19 (prepare_scannet.py remapper)
NYU40_TO_20 = np.full(150, -1, np.int32)
for i, nyu in enumerate([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]):
    NYU40_TO_20[nyu] = i

DONOTCARE_NYU40 = {1, 2, 22}  # wall, floor, ceiling


def compute_normals(xyz: np.ndarray, faces: np.ndarray) -> np.ndarray:
    normals = np.zeros_like(xyz)
    tris = xyz[faces]
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-8
    for k in range(3):
        np.add.at(normals, faces[:, k], n)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True) + 1e-8
    return normals


def read_axis_align_matrix(meta_file: str):
    if not os.path.exists(meta_file):
        return None
    for line in open(meta_file):
        if "axisAlignment" in line:
            vals = [float(x) for x in line.strip().split("=")[1].split()]
            return np.asarray(vals).reshape(4, 4)
    return None


def process_scan(scans_dir: str, scan: str, out_dir: str, align: bool = True):
    base = os.path.join(scans_dir, scan)
    mesh_ply = read_ply(os.path.join(base, f"{scan}_vh_clean_2.ply"))
    v = mesh_ply["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    rgb = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
    rgb = rgb / 127.5 - 1.0
    faces = mesh_ply.get("face")
    normal = compute_normals(xyz, faces) if faces is not None else np.zeros_like(xyz)

    mat = read_axis_align_matrix(os.path.join(base, f"{scan}.txt"))
    if align and mat is not None:
        homo = np.concatenate([xyz, np.ones((len(xyz), 1), np.float32)], 1)
        xyz = (homo @ mat.T)[:, :3].astype(np.float32)
        normal = (normal @ np.linalg.inv(mat[:3, :3]).T).astype(np.float32)

    label_path = os.path.join(base, f"{scan}_vh_clean_2.labels.ply")
    agg_path = os.path.join(base, f"{scan}.aggregation.json")
    seg_path = os.path.join(base, f"{scan}_vh_clean_2.0.010000.segs.json")

    n = len(xyz)
    sem = np.full(n, -1, np.int32)
    inst = np.full(n, -1, np.int32)
    bboxes = np.zeros((0, 8), np.float32)

    if os.path.exists(agg_path):
        lab_ply = read_ply(label_path)
        nyu = np.asarray(lab_ply["vertex"]["label"], np.int64)
        nyu = np.clip(nyu, 0, len(NYU40_TO_20) - 1)
        sem = NYU40_TO_20[nyu]

        seg2verts = {}
        seg_idx = json.load(open(seg_path))["segIndices"]
        for vert, seg in enumerate(seg_idx):
            seg2verts.setdefault(seg, []).append(vert)

        agg = json.load(open(agg_path))
        rows = []
        for group in agg["segGroups"]:
            if group["label"] in ("wall", "floor", "ceiling"):
                continue
            obj_id = group["objectId"]
            verts = [vt for s in group["segments"] for vt in seg2verts.get(s, [])]
            if not verts:
                continue
            verts = np.asarray(verts)
            inst[verts] = obj_id
            nyu_label = int(nyu[verts[0]])
            if nyu_label in DONOTCARE_NYU40:
                continue
            pc = xyz[verts]
            mn, mx = pc.min(0), pc.max(0)
            rows.append([*((mn + mx) / 2), *(mx - mn),
                         float(NYU40_TO_20[nyu_label]), float(obj_id)])
        bboxes = np.asarray(rows, np.float32).reshape(-1, 8)

    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, f"{scan}.npz"),
        xyz=xyz, rgb=rgb, normal=normal,
        sem_labels=sem, instance_ids=inst, instance_bboxes=bboxes,
        scene_id=scan,
    )


def write_instance_gt(npz_path: str, out_dir: str):
    """ScanNet-benchmark GT txt (parity: prepare_scannet_inst_gt.py):
    per point, sem_nyu_id * 1000 + instance_id + 1 (0 = unannotated)."""
    NYU = np.asarray([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                      33, 34, 36, 39])
    d = np.load(npz_path)
    sem = d["sem_labels"]
    inst = d["instance_ids"]
    nyu = np.where(sem >= 0, NYU[np.clip(sem, 0, 19)], 0)
    gt = np.where(inst >= 0, nyu * 1000 + inst + 1, nyu * 1000)
    gt = np.where(sem >= 0, gt, 0)
    os.makedirs(out_dir, exist_ok=True)
    scan = os.path.splitext(os.path.basename(npz_path))[0]
    np.savetxt(os.path.join(out_dir, f"{scan}.txt"), gt, fmt="%d")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scans", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--split", default=None, help="txt with one scan id per line")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--write-inst-gt", default=None,
                   help="also write benchmark GT txts to this dir")
    args = p.parse_args(argv)

    if args.split:
        scans = [l.strip() for l in open(args.split) if l.strip()]
    else:
        scans = sorted(os.listdir(args.scans))

    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(args.workers) as ex:
        futs = [ex.submit(process_scan, args.scans, s, args.out) for s in scans]
        for s, f in zip(scans, futs):
            f.result()
            if args.write_inst_gt:
                write_instance_gt(
                    os.path.join(args.out, f"{s}.npz"), args.write_inst_gt
                )
            print(s)


if __name__ == "__main__":
    main()
