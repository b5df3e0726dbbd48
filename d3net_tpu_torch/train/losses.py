"""Detector losses (semantic / offset / score), fixed-shape and masked.

Counterpart of ``d3net_tpu/train/losses.py``: semantic cross-entropy with
an ignore label, the offset L1-norm and cosine-direction losses over
instance points, and the proposal score BCE against piecewise-linear
"segmented" IoU targets, where the proposal-vs-GT point-set IoU matrix is
one fixed-shape segment count per batch. Key names are the JAX package's.
The ``pred_bbox`` head's ``bbox_loss`` is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.nn import functional as F

from d3net_tpu_torch.ops import segment as seg


def cross_entropy_ignore(logits, labels, ignore_label: int = -1, mask=None):
    """Mean CE over entries with ``label != ignore_label`` (and ``mask``)."""
    valid = labels != ignore_label
    if mask is not None:
        valid = valid & mask
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    v = valid.to(logits.dtype)
    return (nll * v).sum() / v.sum().clamp(min=1.0)


def offset_losses(pt_offsets, point_xyz, instance_mean_xyz, instance_ids,
                  point_mask, ignore_label: int = -1):
    """L1-norm and cosine-direction offset losses over instance points."""
    gt = instance_mean_xyz - point_xyz
    v = ((instance_ids != ignore_label) & point_mask).to(pt_offsets.dtype)
    denom = v.sum().clamp(min=1e-6)
    norm_loss = ((pt_offsets - gt).abs().sum(-1) * v).sum() / denom
    # rsqrt(sumsq + eps) keeps gradients finite at exactly-zero vectors
    # (padded points), where d||x||/dx is undefined
    gt_n = gt * torch.rsqrt((gt ** 2).sum(-1, keepdim=True) + 1e-12)
    pt_n = pt_offsets * torch.rsqrt(
        (pt_offsets ** 2).sum(-1, keepdim=True) + 1e-12)
    dir_loss = (-(gt_n * pt_n).sum(-1) * v).sum() / denom
    return norm_loss, dir_loss


def get_segmented_scores(scores, fg_thresh: float = 0.75,
                         bg_thresh: float = 0.25):
    """IoU -> BCE target: 1 above fg, 0 below bg, linear between."""
    k = 1.0 / (fg_thresh - bg_thresh)
    b = bg_thresh / (bg_thresh - fg_thresh)
    one, zero = torch.ones_like(scores), torch.zeros_like(scores)
    return torch.where(scores > fg_thresh, one,
                       torch.where(scores < bg_thresh, zero, scores * k + b))


def point_set_iou(member_pt, instance_ids, point_mask, num_clusters: int,
                  num_instances: int, instance_num_point):
    """(B, P, I) point-set IoU between predicted clusters and GT instances.

    member_pt (B, 2, N) cluster slot per point per pass (-1 none);
    instance_ids (B, N) GT instance (-1 none); instance_num_point (B, I).
    Intersections are one segment count over (cluster, instance) keys.
    """
    b = member_pt.shape[0]
    mem = member_pt.reshape(b, -1)
    inst = torch.cat([instance_ids, instance_ids], dim=1)
    pmask2 = torch.cat([point_mask, point_mask], dim=1)
    ok = (mem >= 0) & (inst >= 0) & pmask2
    key = torch.where(ok, mem * num_instances + inst.clamp(min=0),
                      torch.zeros_like(mem))
    inter = seg.segment_count_batched(key, num_clusters * num_instances, ok)
    inter = inter.reshape(b, num_clusters, num_instances)
    npred = seg.segment_count_batched(mem, num_clusters, (mem >= 0) & pmask2)
    union = npred[..., None] + instance_num_point[:, None, :].to(inter.dtype) \
        - inter
    return inter / union.clamp(min=1.0)


def score_loss(scores_logits, member_pt, instance_ids, point_mask,
               cluster_mask, instance_num_point, fg_thresh: float = 0.75,
               bg_thresh: float = 0.25):
    """BCE(score, segmented max-IoU) over occupied cluster slots; returns
    the loss and the (B, P) max IoU per slot."""
    iou = point_set_iou(member_pt, instance_ids, point_mask,
                        scores_logits.shape[-1], instance_num_point.shape[-1],
                        instance_num_point)
    gt_iou = iou.amax(-1)
    target = get_segmented_scores(gt_iou, fg_thresh, bg_thresh)
    # maximum (not clamp) so a logit of exactly 0 splits its gradient as
    # jnp.maximum does
    bce = (torch.maximum(scores_logits, torch.zeros_like(scores_logits))
           - scores_logits * target
           + torch.log1p(torch.exp(-scores_logits.abs())))
    w = cluster_mask.to(bce.dtype)
    return (bce * w).sum() / w.sum().clamp(min=1.0), gt_iou


def detector_loss(out: Dict, batch: Dict, *,
                  loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                  fg_thresh: float = 0.75, bg_thresh: float = 0.25,
                  ignore_label: int = -1, with_score: bool = True) -> Dict:
    """The detector loss dict: ``semantic_loss``, ``offset_norm_loss``,
    ``offset_dir_loss``, with ``with_score`` also ``score_loss`` and
    ``gt_iou_mean``, and the weighted ``total_loss``."""
    if "pred_center" in out:
        raise NotImplementedError("bbox_loss (pred_bbox head) is not ported")
    losses: Dict[str, torch.Tensor] = {}
    losses["semantic_loss"] = cross_entropy_ignore(
        out["semantic_scores"], batch["sem_labels"], ignore_label,
        mask=batch["point_mask"])
    norm_l, dir_l = offset_losses(
        out["pt_offsets"], batch["point_xyz"], batch["instance_mean_xyz"],
        batch["instance_ids"], batch["point_mask"], ignore_label)
    losses["offset_norm_loss"] = norm_l
    losses["offset_dir_loss"] = dir_l
    total = (loss_weight[0] * losses["semantic_loss"]
             + loss_weight[1] * norm_l + loss_weight[2] * dir_l)
    if with_score and "proposal_scores_all" in out:
        s_loss, gt_iou = score_loss(
            out["proposal_scores_all"], out["member_pt"],
            batch["instance_ids"], batch["point_mask"],
            out["cluster_mask_all"], batch["instance_num_point"],
            fg_thresh, bg_thresh)
        cmask = out["cluster_mask_all"].to(gt_iou.dtype)
        losses["score_loss"] = s_loss
        losses["gt_iou_mean"] = (gt_iou * cmask).sum() / cmask.sum().clamp(
            min=1.0)
        total = total + loss_weight[3] * s_loss
    losses["total_loss"] = total
    return losses
