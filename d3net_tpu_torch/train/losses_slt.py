"""Speaker (captioning) losses (counterpart of
``d3net_tpu/train/losses_slt.py``).

Parity targets:
- caption XE + accuracy over good-bbox entries with pad ignore
  (``lib/captioning/loss_helper.py:178-215``),
- 6-bin relative-orientation CE over graph edges
  (``compute_node_orientation_loss`` :244-307).

The listener's grounding and lang-cls losses are ROADMAP.md queue A item
14.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.nn import functional as F


def caption_loss(pred_logits, lang_ids, good_bbox_masks, pad_id: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pred_logits (N, T-1, V); lang_ids (N, T); targets are words 1..T-1.
    (loss, accuracy) over the non-pad words of the good rows; both exactly
    0 when no row is good."""
    targets = lang_ids[:, 1:].long()
    w = ((targets != pad_id) & good_bbox_masks[:, None]).to(pred_logits.dtype)
    nll = -F.log_softmax(pred_logits, -1).gather(-1, targets[..., None])[..., 0]
    denom = w.sum().clamp(min=1.0)
    loss = (nll * w).sum() / denom
    acc = ((pred_logits.argmax(-1) == targets) * w).sum() / denom
    any_good = good_bbox_masks.sum() > 0
    return torch.where(any_good, loss, 0.0), torch.where(any_good, acc, 0.0)


def radian_to_label(radians, num_bins: int = 6) -> torch.Tensor:
    """Bucketize [0, pi) rotation angles into num_bins classes."""
    width = math.pi / num_bins
    return torch.clamp((radians // width).to(torch.int32), 0, num_bins - 1)


def orientation_loss(
    edge_orientations,   # (B, P, L, num_bins)
    local_ids,           # (B, P, L)
    local_mask,          # (B, P, L)
    object_assignment,   # (B, P)
    rotations,           # (B, I, 3, 3)
    rotation_masks,      # (B, I)
    num_bins: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative-rotation-bin CE over graph edges (src=i, tgt=local)."""
    b = rotations.shape[0]
    assign = object_assignment.long()
    rot = torch.take_along_dim(rotations, assign[..., None, None], dim=1)
    rmask = torch.take_along_dim(rotation_masks, assign, dim=1)     # (B, P)
    flat = local_ids.reshape(b, -1).long()
    tgt_rot = torch.take_along_dim(rot, flat[..., None, None], dim=1).reshape(
        local_ids.shape + (3, 3))                                   # (B, P, L, 3, 3)
    rel = rot[:, :, None] @ tgt_rot.transpose(-1, -2)
    tr = rel.diagonal(dim1=-2, dim2=-1).sum(-1)
    ang = torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))    # (B, P, L)
    labels = radian_to_label(ang, num_bins).long()

    tgt_m = torch.take_along_dim(rmask, flat, dim=1).reshape(local_ids.shape)
    w = (rmask[:, :, None] * tgt_m * local_mask).to(edge_orientations.dtype)
    nll = -F.log_softmax(edge_orientations, -1).gather(
        -1, labels[..., None])[..., 0]
    denom = w.sum() + 1e-8
    loss = (nll * w).sum() / denom
    acc = ((edge_orientations.argmax(-1) == labels) * w).sum() / denom
    return loss, acc
