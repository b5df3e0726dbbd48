"""Axis-aligned 3D box geometry (counterpart of ``d3net_tpu/utils/bbox.py``).

``box_corners`` takes torch tensors (the model) or numpy arrays (the
detection eval); ``corners_to_minmax`` and ``aabb_iou_minmax`` are the
numpy half the eval needs.
"""

from __future__ import annotations

import numpy as np
import torch

# the 8 combinations of ±size/2, z fastest (same order as the JAX package)
_SIGNS = (
    (-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
    (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1),
)


def box_corners(center, size):
    """(…, 3) center and (…, 3) size -> (…, 8, 3) corners."""
    if isinstance(center, torch.Tensor):
        signs = torch.tensor(_SIGNS, dtype=center.dtype, device=center.device)
    else:
        signs = np.asarray(_SIGNS, dtype=center.dtype)
    half = size * 0.5
    return center[..., None, :] + signs * half[..., None, :]


def corners_to_minmax(corners: np.ndarray):
    """(…, 8, 3) corners -> ((…, 3) min, (…, 3) max)."""
    return corners.min(axis=-2), corners.max(axis=-2)


def aabb_iou_minmax(min1, max1, min2, max2, eps=1e-8):
    """IoU of axis-aligned boxes given min/max corners; broadcasts."""
    inter_min = np.maximum(min1, min2)
    inter_max = np.minimum(max1, max2)
    inter = np.clip(inter_max - inter_min, 0, None).prod(axis=-1)
    vol1 = np.clip(max1 - min1, 0, None).prod(axis=-1)
    vol2 = np.clip(max2 - min2, 0, None).prod(axis=-1)
    union = vol1 + vol2 - inter
    return inter / (union + eps)
