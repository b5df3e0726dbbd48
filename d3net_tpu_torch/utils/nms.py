"""Non-maximum suppression (host-side, numpy).

A copy of ``d3net_tpu/utils/nms.py``.

Parity targets in the reference:
- ``lib/det/nms.py:nms_3d_faster_samecls`` — per-class greedy 3D AABB NMS
  used by the detection-eval parser.
- ``lib/utils/eval.py:get_nms_instances`` — greedy NMS over a precomputed
  cross-IoU matrix, used by PointGroup's instance dump path.

These run on host at eval time (tiny inputs, ≤ a few hundred proposals),
so plain numpy is the right tool; nothing here is on the training path.
"""

from __future__ import annotations

import numpy as np


def nms_matrix(cross_ious: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    """Greedy NMS given an (n, n) IoU matrix; returns kept indices."""
    order = np.argsort(scores)[::-1]
    kept = []
    suppressed = np.zeros(len(scores), dtype=bool)
    for i in order:
        if suppressed[i]:
            continue
        kept.append(i)
        suppressed |= cross_ious[i] > threshold
    return np.asarray(kept, dtype=np.int64)


def nms_3d_same_class(
    boxes_minmax: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    threshold: float,
    old_type: bool = False,
) -> np.ndarray:
    """Greedy 3D NMS suppressing only same-class overlaps.

    Args:
        boxes_minmax: (n, 6) [xmin, ymin, zmin, xmax, ymax, zmax]
        scores: (n,)
        classes: (n,) integer class per box
        threshold: IoU threshold
        old_type: if True use overlap/area_of_kept instead of IoU
            (the reference supports both; IoU is the default used by eval).

    Returns kept indices (by descending score).
    """
    n = len(scores)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    bmin = boxes_minmax[:, :3]
    bmax = boxes_minmax[:, 3:6]
    vol = np.clip(bmax - bmin, 0, None).prod(-1)

    order = np.argsort(scores)[::-1]
    kept = []
    alive = np.ones(n, dtype=bool)
    for idx in order:
        if not alive[idx]:
            continue
        kept.append(idx)
        imin = np.maximum(bmin[idx], bmin)
        imax = np.minimum(bmax[idx], bmax)
        inter = np.clip(imax - imin, 0, None).prod(-1)
        if old_type:
            o = inter / (vol[idx] + 1e-8)
        else:
            o = inter / (vol[idx] + vol - inter + 1e-8)
        alive &= ~((o > threshold) & (classes == classes[idx]))
    return np.asarray(kept, dtype=np.int64)
