"""Axis-aligned 3D box geometry (counterpart of ``d3net_tpu/utils/bbox.py``)."""

from __future__ import annotations

import torch

# the 8 combinations of ±size/2, z fastest (same order as the JAX package)
_SIGNS = (
    (-1, -1, -1), (-1, -1, 1), (-1, 1, -1), (-1, 1, 1),
    (1, -1, -1), (1, -1, 1), (1, 1, -1), (1, 1, 1),
)


def box_corners(center: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(…, 3) center and (…, 3) size -> (…, 8, 3) corners."""
    signs = torch.tensor(_SIGNS, dtype=center.dtype, device=center.device)
    half = size * 0.5
    return center[..., None, :] + signs * half[..., None, :]
