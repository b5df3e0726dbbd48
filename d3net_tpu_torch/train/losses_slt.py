"""Speaker (captioning) and listener (grounding) losses (counterpart of
``d3net_tpu/train/losses_slt.py``).

Parity targets:
- caption XE + accuracy over good-bbox entries with pad ignore
  (``lib/captioning/loss_helper.py:178-215``),
- 6-bin relative-orientation CE over graph edges
  (``compute_node_orientation_loss`` :244-307),
- SoftmaxRankingLoss (or the contrastive loss) grounding with argmax-IoU
  one-hot labels + Acc@kIoU metrics (``lib/grounding/loss_helper.py:
  130-214``, ``loss.py:6-40``),
- language-to-object classification CE (``get_lobjcls_loss`` :231-302).

``argmax`` keeps the first index on ties, as ``jnp.argmax``: a row whose
IoUs are all 0 is labelled with proposal 0.

Under a process group (``parallel.mesh``) every mean is this rank's share
of the global batch's: local sum over the global count.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.utils.bbox import aabb_iou_corners


def caption_loss(pred_logits, lang_ids, good_bbox_masks, pad_id: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pred_logits (N, T-1, V); lang_ids (N, T); targets are words 1..T-1.
    (loss, accuracy) over the non-pad words of the good rows; both exactly
    0 when no row is good."""
    targets = lang_ids[:, 1:].long()
    w = ((targets != pad_id) & good_bbox_masks[:, None]).to(pred_logits.dtype)
    nll = -F.log_softmax(pred_logits, -1).gather(-1, targets[..., None])[..., 0]
    denom = mesh.global_count(w.sum()).clamp(min=1.0)
    loss = (nll * w).sum() / denom
    acc = ((pred_logits.argmax(-1) == targets) * w).sum() / denom
    any_good = mesh.global_count(good_bbox_masks.sum()) > 0
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
    denom = mesh.global_count(w.sum()) + 1e-8
    loss = (nll * w).sum() / denom
    acc = ((edge_orientations.argmax(-1) == labels) * w).sum() / denom
    return loss, acc


def softmax_ranking_loss(preds, targets, reduce: bool = True) -> torch.Tensor:
    """-sum(target * log softmax(pred)) (ref ``SoftmaxRankingLoss``)."""
    probs = torch.softmax(preds + 1e-8, dim=1)
    loss = -(torch.log(probs + 1e-8) * targets).sum(1)
    return mesh.global_mean(loss) if reduce else loss


def contrastive_loss(preds, targets, margin: float = 0.2, gamma: float = 5.0,
                     reduce: bool = True) -> torch.Tensor:
    """Per-row contrastive ranking loss (ref ``ContrastiveLoss``,
    ``lib/grounding/loss.py:27-40``):

    loss_i = max(0, logsumexp_j(gamma*pred_ij*(1-t_ij))
                    - sum_j(gamma*pred_ij*t_ij) + margin)

    Negatives are zeroed (not -inf-masked) inside the logsumexp, as the
    reference multiplies by ``label.logical_not()``."""
    score = preds * gamma
    sim = (score * targets).sum(1)
    neg_sim = torch.logsumexp(score * (1.0 - targets), dim=1)
    loss = torch.clamp(neg_sim - sim + margin, min=0.0)
    return mesh.global_mean(loss) if reduce else loss


def grounding_labels(pred_corners, ref_corner_label
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-hot argmax-IoU labels (ref :148-158): pred_corners (N, P, 8, 3),
    ref_corner_label (N, 8, 3) -> (labels (N, P), IoUs (N, P)), both
    constants of the loss."""
    with torch.no_grad():
        ious = aabb_iou_corners(pred_corners, ref_corner_label[:, None])
        labels = F.one_hot(ious.argmax(-1), ious.shape[-1]).to(ious.dtype)
    return labels, ious


def grounding_loss(
    cluster_ref,        # (N, P) confidences
    pred_corners,       # (N, P, 8, 3)
    ref_corner_label,   # (N, 8, 3)
    annotated=None,     # (N,) optional mask over description rows
    reduce: bool = True,
    loss_type: str = "cross_entropy",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The grounding loss over the annotated rows and its five ``ref_*``
    metrics: the argmax proposal's accuracy against the label, its IoU,
    the label's IoU and the rate of rows whose pick reaches 0.25 / 0.5."""
    labels, ious = grounding_labels(pred_corners, ref_corner_label)
    if loss_type == "contrastive":
        per_row = contrastive_loss(cluster_ref, labels, reduce=False)
    else:
        per_row = softmax_ranking_loss(cluster_ref, labels, reduce=False)
    if annotated is not None:
        w = annotated.to(per_row.dtype)
        loss = (per_row * w).sum() / mesh.global_count(w.sum()).clamp(min=1.0)
    else:
        w = torch.ones_like(per_row)
        loss = mesh.global_mean(per_row)
    pred_idx = cluster_ref.detach().argmax(-1)
    label_idx = labels.argmax(-1)
    chosen_iou = ious.gather(1, pred_idx[:, None])[:, 0]
    best_iou = ious.gather(1, label_idx[:, None])[:, 0]
    denom = mesh.global_count(w.sum()).clamp(min=1.0)
    metrics = {
        "ref_acc_mean": ((pred_idx == label_idx) * w).sum() / denom,
        "ref_iou_mean": (chosen_iou * w).sum() / denom,
        "best_ious_mean": (best_iou * w).sum() / denom,
        "ref_iou_rate_0.25": ((chosen_iou >= 0.25) * w).sum() / denom,
        "ref_iou_rate_0.5": ((chosen_iou >= 0.5) * w).sum() / denom,
    }
    return (loss if reduce else per_row), metrics


def lang_cls_loss(lang_scores, ref_cat_label,
                  annotated: Optional[torch.Tensor] = None,
                  reduce: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Language object-class CE (ref ``get_lobjcls_loss``) and accuracy
    over the annotated rows."""
    target = ref_cat_label.long()
    nll = -F.log_softmax(lang_scores, -1).gather(-1, target[:, None])[:, 0]
    w = (annotated.to(nll.dtype) if annotated is not None
         else torch.ones_like(nll))
    denom = mesh.global_count(w.sum()).clamp(min=1.0)
    loss = (nll * w).sum() / denom
    acc = ((lang_scores.detach().argmax(-1) == target) * w).sum() / denom
    return (loss if reduce else nll), acc
