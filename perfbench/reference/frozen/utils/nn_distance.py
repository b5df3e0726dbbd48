"""Nearest-neighbour assignment between two point sets (counterpart of
``d3net_tpu/utils/nn_distance.py``)."""

from __future__ import annotations

import torch


def nn_distance(pc1, pc2, l1: bool = False, mask2=None, big: float = 1e9):
    """For each point of pc1 (B, N, C) the nearest of pc2 (B, M, C), and
    vice versa. ``l1`` sums |diff|, else squared l2; ``mask2`` (B, M) gives
    invalid pc2 entries distance ``big``. On ties the lower index wins.

    Returns (dist1 (B, N), idx1 (B, N), dist2 (B, M), idx2 (B, M)).
    """
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]
    d = diff.abs() if l1 else diff * diff
    dist = d[..., 0]
    for c in range(1, d.shape[-1]):
        dist = dist + d[..., c]
    if mask2 is not None:
        dist = torch.where(mask2[:, None, :], dist, torch.full_like(dist, big))
    dist1, idx1 = dist.min(dim=2)
    dist2, idx2 = dist.min(dim=1)
    return dist1, idx1.to(torch.int32), dist2, idx2.to(torch.int32)
