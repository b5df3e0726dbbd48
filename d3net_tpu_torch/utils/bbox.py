"""Axis-aligned 3D box geometry (counterpart of ``d3net_tpu/utils/bbox.py``).

``box_corners`` takes torch tensors (the model) or numpy arrays (the
detection eval); ``aabb_iou_corners`` is the torch IoU the speaker's graph
and decoder use; ``corners_to_minmax``, ``aabb_iou_minmax``,
``aabb_giou_minmax`` and ``pairwise_giou_matrix`` are the numpy half the
evals need.
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


def _volume(extent: torch.Tensor) -> torch.Tensor:
    """(…, 3) -> (…,) product, multiplied in axis order as XLA's reduce."""
    return extent[..., 0] * extent[..., 1] * extent[..., 2]


def aabb_iou_corners(c1: torch.Tensor, c2: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """IoU of (…, 8, 3) corner tensors (order-insensitive); broadcasts."""
    min1, max1 = c1.amin(-2), c1.amax(-2)
    min2, max2 = c2.amin(-2), c2.amax(-2)
    inter = _volume((torch.minimum(max1, max2)
                     - torch.maximum(min1, min2)).clamp(min=0))
    vol1 = _volume((max1 - min1).clamp(min=0))
    vol2 = _volume((max2 - min2).clamp(min=0))
    return inter / (vol1 + vol2 - inter + eps)


def aabb_giou_minmax(min1, max1, min2, max2, eps=1e-8):
    """Generalized IoU of axis-aligned boxes (enclosing AABB); broadcasts."""
    inter_min = np.maximum(min1, min2)
    inter_max = np.minimum(max1, max2)
    inter = np.clip(inter_max - inter_min, 0, None).prod(axis=-1)
    vol1 = np.clip(max1 - min1, 0, None).prod(axis=-1)
    vol2 = np.clip(max2 - min2, 0, None).prod(axis=-1)
    union = vol1 + vol2 - inter
    iou = inter / (union + eps)
    hull_min = np.minimum(min1, min2)
    hull_max = np.maximum(max1, max2)
    hull = np.clip(hull_max - hull_min, 0, None).prod(axis=-1)
    return iou - (hull - union) / (hull + eps)


def pairwise_giou_matrix(min1, max1, min2, max2, eps=1e-8):
    """(N,3)/(M,3) min-max boxes -> (N, M) GIoU matrix."""
    return aabb_giou_minmax(min1[:, None, :], max1[:, None, :],
                            min2[None, :, :], max2[None, :, :], eps)
