"""Detector losses (semantic / offset / score), fixed-shape and masked.

Counterpart of ``d3net_tpu/train/losses.py``: semantic cross-entropy with
an ignore label, the offset L1-norm and cosine-direction losses over
instance points, and the proposal score BCE against piecewise-linear
"segmented" IoU targets, where the proposal-vs-GT point-set IoU matrix is
one fixed-shape segment count per batch, and the ``pred_bbox`` head's
VoteNet-style ``bbox_loss``. Key names are the JAX package's.

Under a process group (``parallel.mesh``) each rank's loss is its share of
the global batch's: its local masked sum over the global count
(``mesh.global_count``), its per-scene sum over the global scene count
(``mesh.global_mean``); the ranks' shares add up to the global loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from perfbench.reference.frozen.ops import segment as seg
from perfbench.reference.frozen.parallel import mesh


def cross_entropy_ignore(logits, labels, ignore_label: int = -1, mask=None):
    """Mean CE over entries with ``label != ignore_label`` (and ``mask``)."""
    valid = labels != ignore_label
    if mask is not None:
        valid = valid & mask
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    v = valid.to(logits.dtype)
    return (nll * v).sum() / mesh.global_count(v.sum()).clamp(min=1.0)


def offset_losses(pt_offsets, point_xyz, instance_mean_xyz, instance_ids,
                  point_mask, ignore_label: int = -1):
    """L1-norm and cosine-direction offset losses over instance points."""
    gt = instance_mean_xyz - point_xyz
    v = ((instance_ids != ignore_label) & point_mask).to(pt_offsets.dtype)
    denom = mesh.global_count(v.sum()).clamp(min=1e-6)
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
    return (bce * w).sum() / mesh.global_count(w.sum()).clamp(min=1.0), gt_iou


def _huber(x, delta: float = 1.0):
    ax = x.abs()
    q = torch.minimum(ax, torch.full_like(ax, delta))
    return 0.5 * q * q + delta * (ax - q)


def _masked_ce(logits, labels, mask):
    """Per-scene mean CE over the masked entries."""
    nll = -F.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[..., None])[..., 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum(-1) / m.sum(-1).clamp(min=1.0)


def bbox_loss(out: Dict, batch: Dict,
              mean_size_arr: Optional[np.ndarray] = None) -> Dict:
    """VoteNet-style box loss of the ``pred_bbox`` head, fixed-shape: a
    masked (B, P, I) chamfer between predicted centers of the occupied
    slots and GT centers, then per-slot heading (one degenerate bin, label
    0: ScanNet boxes are axis-aligned), size class (= the assigned GT's
    semantic class), size residual (against ``mean_size_arr``, ones when
    not given) and box-class terms.

    ``bbox_loss = center + 0.1 heading_cls + heading_reg + 0.1 size_cls +
    size_reg``; ``bbox_sem_cls_loss`` is reported beside it, not in it.
    """
    pc = out["pred_center"]                          # (B, P, 3)
    pmask = out["cluster_mask_all"] > 0              # (B, P)
    gtc = batch["center_label"]                      # (B, I, 3)
    gts = batch["size_label"]                        # (B, I, 3)
    gcls = batch["sem_cls_label"].long()             # (B, I)
    gmask = batch["gt_box_mask"] > 0                 # (B, I)
    ns = out["size_scores"].shape[-1]
    if mean_size_arr is None:
        mean_size = torch.ones((ns, 3), dtype=pc.dtype, device=pc.device)
    else:
        mean_size = torch.as_tensor(np.asarray(mean_size_arr), dtype=pc.dtype,
                                    device=pc.device)

    big = torch.tensor(1e9, dtype=pc.dtype, device=pc.device)
    d = ((pc[:, :, None, :] - gtc[:, None, :, :]) ** 2).sum(-1)   # (B,P,I)
    d_gt = torch.where(gmask[:, None, :], d, big)
    d1 = d_gt.amin(-1)                               # (B, P) pred -> gt
    assign = d_gt.argmin(-1)                         # (B, P), first on ties
    d2 = torch.where(pmask[:, :, None], d, big).amin(1)   # (B, I) gt -> pred
    pn = pmask.sum(-1).to(pc.dtype).clamp(min=1e-6)
    gn = gmask.sum(-1).to(pc.dtype).clamp(min=1e-6)
    ok1 = pmask & gmask.any(-1)[:, None]
    ok2 = gmask & pmask.any(-1)[:, None]
    zero = torch.zeros((), dtype=pc.dtype, device=pc.device)
    center_per = (torch.where(ok1, d1, zero).sum(-1) / pn
                  + torch.where(ok2, d2, zero).sum(-1) / gn)

    cls_at = gcls.gather(1, assign)                  # (B, P)
    valid_p = ok1   # a slot is supervised only where its scene has a GT

    h_cls_per = _masked_ce(out["heading_scores"], torch.zeros_like(assign),
                           valid_p)
    h_reg_per = torch.where(
        valid_p, _huber(out["heading_residuals_normalized"][..., 0]),
        zero).sum(-1) / pn

    s_cls_per = _masked_ce(out["size_scores"], cls_at, valid_p)
    srn = out["size_residuals_normalized"]           # (B, P, ns, 3)
    pred_res = srn.gather(
        2, cls_at[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0, :]
    mean_at = mean_size[cls_at]                      # (B, P, 3)
    gt_size_at = gts.gather(1, assign[:, :, None].expand(-1, -1, 3))
    res_label = (gt_size_at - mean_at) / mean_at.clamp(min=1e-6)
    s_reg_per = torch.where(
        valid_p, _huber(pred_res - res_label).mean(-1), zero).sum(-1) / pn

    sem_per = _masked_ce(out["sem_cls_scores"], cls_at, valid_p)

    losses = {
        "center_loss": mesh.global_mean(center_per),
        "heading_cls_loss": mesh.global_mean(h_cls_per),
        "heading_reg_loss": mesh.global_mean(h_reg_per),
        "size_cls_loss": mesh.global_mean(s_cls_per),
        "size_reg_loss": mesh.global_mean(s_reg_per),
        "bbox_sem_cls_loss": mesh.global_mean(sem_per),
    }
    losses["bbox_loss"] = (
        losses["center_loss"] + 0.1 * losses["heading_cls_loss"]
        + losses["heading_reg_loss"] + 0.1 * losses["size_cls_loss"]
        + losses["size_reg_loss"])
    return losses


def detector_loss(out: Dict, batch: Dict, *,
                  loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                  fg_thresh: float = 0.75, bg_thresh: float = 0.25,
                  ignore_label: int = -1, with_score: bool = True,
                  mean_size_arr: Optional[np.ndarray] = None) -> Dict:
    """The detector loss dict: ``semantic_loss``, ``offset_norm_loss``,
    ``offset_dir_loss``, with ``with_score`` also ``score_loss`` and
    ``gt_iou_mean``, with the ``pred_bbox`` head's outputs the
    ``bbox_loss`` terms (weight ``loss_weight[4]``, 1 when absent), and the
    weighted ``total_loss``."""
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
        losses["gt_iou_mean"] = (gt_iou * cmask).sum() / mesh.global_count(
            cmask.sum()).clamp(min=1.0)
        total = total + loss_weight[3] * s_loss
    if "pred_center" in out:
        bb = bbox_loss(out, batch, mean_size_arr=mean_size_arr)
        losses.update(bb)
        w_bb = loss_weight[4] if len(loss_weight) > 4 else 1.0
        total = total + w_bb * bb["bbox_loss"]
    losses["total_loss"] = total
    return losses
