"""Synthetic ScanNet-like scenes for tests and benchmarking.

A copy of ``d3net_tpu/data/synthetic.py`` (the port never imports the JAX
package); the same seed must give the same scene on both sides, so the two
files change together.

The environment ships no ScanNet data; these scenes mimic its statistics
(rooms of a few meters, 2cm surface sampling, axis-aligned instances on a
floor plane) so the full pipeline — voxelization, U-Net, clustering,
ScoreNet, losses, eval — runs end-to-end with meaningful supervision.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Scene:
    """One scene in the canonical preprocessed format (prepare_scannet parity:
    xyz + rgb + normal mesh, sem_labels, instance_ids, instance bboxes)."""

    xyz: np.ndarray            # (N, 3) float32 meters
    rgb: np.ndarray            # (N, 3) float32 in [-1, 1]
    normal: np.ndarray         # (N, 3) float32
    multiview: Optional[np.ndarray]  # (N, 128) float32 or None
    sem_labels: np.ndarray     # (N,) int32, -1 = unannotated
    instance_ids: np.ndarray   # (N,) int32, -1 = none
    instance_bboxes: np.ndarray  # (I, 8): cx cy cz dx dy dz sem_label objid
    scene_id: str = "synthetic"


def _box_surface(rng, center, size, n):
    """Sample n points (+ outward normals) on an axis-aligned box surface."""
    face = rng.integers(0, 6, n)
    u = rng.uniform(-0.5, 0.5, (n, 3))
    axis = face // 2
    side = (face % 2).astype(np.float64) - 0.5
    u[np.arange(n), axis] = side
    normals = np.zeros((n, 3))
    normals[np.arange(n), axis] = np.sign(side)
    return center + u * size, normals


def _class_shape_table(num_classes: int, size_range) -> np.ndarray:
    """Deterministic per-class base box sizes.

    Instance classes must be *inferable from geometry* or class-aware
    detection mAP has an entropy ceiling (a random class label cannot be
    predicted; semantic CE then floors at ~ln(num_classes-2) and per-class
    AP stays ~0 no matter how long the detector trains).  Each class gets a
    distinct fixed (sx, sy, sz) spread over size_range with varied aspect
    ratios — mimicking how real ScanNet categories (chair vs table vs bed)
    are largely separable by extent.
    """
    lo, hi = size_range
    table = np.zeros((num_classes, 3))
    tr = np.random.default_rng(12345)
    for k in range(2, num_classes):
        # stratified scale + random-but-fixed aspect
        frac = (k - 2 + 0.5) / max(1, num_classes - 2)
        scale = lo + frac * (hi - lo)
        aspect = tr.uniform(0.5, 1.6, 3)
        table[k] = scale * aspect / aspect.prod() ** (1 / 3)
    return np.clip(table, lo * 0.6, hi * 1.4)


def make_scene(
    seed: int = 0,
    num_instances: int = 8,
    points_per_instance: int = 3000,
    floor_points: int = 8000,
    room: float = 6.0,
    num_classes: int = 20,
    noise: float = 0.005,
    with_multiview: bool = False,
    density: Optional[float] = None,
    size_range=(0.3, 1.2),
) -> Scene:
    """``density`` (points/m^2 of box surface) overrides points_per_instance;
    ScanNet's ~2cm sampling corresponds to density ~2500-4000."""
    rng = np.random.default_rng(seed)
    shape_table = _class_shape_table(num_classes, size_range)
    pts, sems, insts, nrms = [], [], [], []
    bboxes = []
    for i in range(num_instances):
        cls = int(rng.integers(2, num_classes))  # 0/1 = wall/floor
        # class-conditioned shape (geometry-predictable class) + jitter
        size = shape_table[cls] * rng.uniform(0.85, 1.15, 3)
        center = np.array(
            [rng.uniform(1, room - 1), rng.uniform(1, room - 1), size[2] / 2]
        )
        if density is not None:
            a, b, c = size
            area = 2 * (a * b + b * c + c * a)
            n_pts = max(100, int(area * density))
        else:
            n_pts = points_per_instance
        p, pn = _box_surface(rng, center, size, n_pts)
        p += rng.normal(scale=noise, size=p.shape)
        pts.append(p)
        nrms.append(pn)
        sems.append(np.full(len(p), cls))
        insts.append(np.full(len(p), i))
        bboxes.append([*center, *size, cls, i])
    floor = np.column_stack(
        [
            rng.uniform(0, room, floor_points),
            rng.uniform(0, room, floor_points),
            rng.normal(0, noise, floor_points),
        ]
    )
    pts.append(floor)
    nrms.append(np.tile([0.0, 0.0, 1.0], (floor_points, 1)))
    sems.append(np.ones(floor_points))  # class 1 = floor
    insts.append(np.full(floor_points, -1))

    xyz = np.concatenate(pts).astype(np.float32)
    sem = np.concatenate(sems).astype(np.int32)
    inst = np.concatenate(insts).astype(np.int32)
    n = len(xyz)
    # class-conditioned base color + per-point noise: real ScanNet RGB is
    # informative about category (chairs/tables/beds have characteristic
    # colors), and the 2D ENet supervision (scripts/train_enet.py) needs a
    # color->semantics signal in rendered frames.  Same rng draw count as
    # the old pure-noise colors, so downstream draws (multiview) are
    # stream-compatible.
    ctab = np.random.default_rng(54321).uniform(-0.8, 0.8, (num_classes, 3))
    rgb = (0.55 * ctab[np.clip(sem, 0, num_classes - 1)]
           + 0.45 * rng.uniform(-1, 1, (n, 3))).astype(np.float32)
    # true surface normals + small noise (the round-1 generator emitted
    # random unit vectors — pure noise in the 'use_normal' feature channel)
    normal = np.concatenate(nrms).astype(np.float32)
    normal += rng.normal(scale=0.05, size=normal.shape).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-8
    mv = rng.normal(size=(n, 128)).astype(np.float32) if with_multiview else None
    return Scene(
        xyz=xyz,
        rgb=rgb,
        normal=normal,
        multiview=mv,
        sem_labels=sem,
        instance_ids=inst,
        instance_bboxes=np.asarray(bboxes, np.float32).reshape(-1, 8),
        scene_id=f"synthetic_{seed:04d}",
    )
