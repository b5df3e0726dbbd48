"""Detection mAP evaluation (VoteNet protocol, host-side numpy).

A copy of ``d3net_tpu/eval/detection.py`` over the port's own box and NMS
helpers; it gives the JAX package's numbers exactly.

Parity targets in the reference: ``lib/det/ap_helper.py`` (per-class 3D NMS
+ confidence threshold + hard-class grouping), ``lib/det/eval_det.py``
(greedy TP/FP matching with per-GT det flags, VOC AP with the continuous
precision-envelope integral).

Class convention: predictions carry NYU20 semantic ids (0..19); boxes are
evaluated in 18-class box space via ``cls = sem - 2`` with wall/floor
mapped to class 17, matching ``ap_helper.py:57-58``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from d3net_tpu_torch.utils.bbox import (
    aabb_iou_minmax, box_corners, corners_to_minmax,
)
from d3net_tpu_torch.utils.nms import nms_3d_same_class


def sem_to_box_class(sem: np.ndarray) -> np.ndarray:
    cls = sem.astype(np.int64) - 2
    cls[cls < 0] = 17
    return cls


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Continuous (non-07) VOC AP: area under the precision envelope."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def parse_predictions(
    bbox_corners: np.ndarray,   # (B, K, 8, 3)
    sem_cls: np.ndarray,        # (B, K) NYU20 ids
    obj_prob: np.ndarray,       # (B, K)
    box_mask: np.ndarray,       # (B, K) 1 = valid proposal
    nms_iou: float = 0.25,
    conf_thresh: float = 0.09,
) -> List[List[Tuple[int, np.ndarray, float]]]:
    """Per-scene [(class, corners, score)] after same-class 3D NMS."""
    b, k = obj_prob.shape
    cls = sem_to_box_class(sem_cls)
    out = []
    for i in range(b):
        keep_in = np.where(box_mask[i] > 0)[0]
        entries: List[Tuple[int, np.ndarray, float]] = []
        if len(keep_in):
            mn, mx = corners_to_minmax(bbox_corners[i, keep_in])
            boxes = np.concatenate([mn, mx], axis=1)
            pick = nms_3d_same_class(
                boxes, obj_prob[i, keep_in], cls[i, keep_in], nms_iou
            )
            for j in keep_in[pick]:
                if obj_prob[i, j] > conf_thresh:
                    entries.append((int(cls[i, j]), bbox_corners[i, j], float(obj_prob[i, j])))
        out.append(entries)
    return out


def parse_groundtruths(
    center: np.ndarray,   # (B, I, 3)
    size: np.ndarray,     # (B, I, 3)
    sem_cls: np.ndarray,  # (B, I) NYU20 ids
    mask: np.ndarray,     # (B, I)
) -> List[List[Tuple[int, np.ndarray]]]:
    cls = sem_to_box_class(sem_cls)
    out = []
    for i in range(len(center)):
        entries = []
        for j in np.where(mask[i] > 0)[0]:
            corners = box_corners(center[i, j], size[i, j])
            entries.append((int(cls[i, j]), corners))
        out.append(entries)
    return out


def _corner_iou(c1: np.ndarray, c2: np.ndarray) -> float:
    mn1, mx1 = c1.min(0), c1.max(0)
    mn2, mx2 = c2.min(0), c2.max(0)
    return float(aabb_iou_minmax(mn1, mx1, mn2, mx2))


def eval_det(
    pred_all: Dict[int, List[Tuple[int, np.ndarray, float]]],
    gt_all: Dict[int, List[Tuple[int, np.ndarray]]],
    ovthresh: float = 0.25,
) -> Tuple[Dict[int, float], Dict[int, float]]:
    """({class: AP}, {class: recall}) over all scenes (greedy matching,
    VOC AP; recall = final cumulative recall, ``lib/det/eval_det.py:74-205``
    + the ``rec[key][-1]`` readout in ``ap_helper.py:236-243``)."""
    pred = defaultdict(lambda: defaultdict(list))
    gt = defaultdict(lambda: defaultdict(list))
    for img, entries in pred_all.items():
        for c, box, score in entries:
            pred[c][img].append((box, score))
            _ = gt[c][img]  # ensure key
    for img, entries in gt_all.items():
        for c, box in entries:
            gt[c][img].append(box)

    aps = {}
    recalls = {}
    for c in gt.keys():
        recs = {img: {"bbox": boxes, "det": [False] * len(boxes)} for img, boxes in gt[c].items()}
        npos = sum(len(v) for v in gt[c].values())
        dets = [
            (img, score, box)
            for img, lst in pred.get(c, {}).items()
            for box, score in lst
        ]
        dets.sort(key=lambda t: -t[1])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for d, (img, _score, box) in enumerate(dets):
            r = recs.get(img, {"bbox": [], "det": []})
            ovmax, jmax = -np.inf, -1
            for j, gtbox in enumerate(r["bbox"]):
                iou = _corner_iou(box, gtbox)
                if iou > ovmax:
                    ovmax, jmax = iou, j
            if ovmax > ovthresh and not r["det"][jmax]:
                tp[d] = 1.0
                r["det"][jmax] = True
            else:
                fp[d] = 1.0
        tp, fp = np.cumsum(tp), np.cumsum(fp)
        rec = tp / float(npos + 1e-8)
        prec = tp / np.maximum(tp + fp, 1e-8)
        aps[c] = voc_ap(rec, prec) if len(dets) else 0.0
        recalls[c] = float(rec[-1]) if len(dets) else 0.0
    return aps, recalls


class APCalculator:
    """Accumulate batches and compute mAP/AR (``lib/det/ap_helper.py:195``).

    Over ranks (``parallel.mesh.gather_records``) each scene is tagged with
    ``batch``, the val batch it was added in: ``records()`` hands them over
    and ``load_records`` takes every rank's, numbered in the global scene
    order (the order ties in score keep)."""

    def __init__(self, ovthresh: float = 0.25):
        self.ovthresh = ovthresh
        self.batch = 0
        self.reset()

    def reset(self):
        self.load_records([])

    def records(self) -> List[Tuple[int, tuple]]:
        """``(batch, (predictions, ground truths))`` of every scene."""
        return [(b, (self.pred[i], self.gt[i]))
                for i, b in enumerate(self._batch_of)]

    def load_records(self, records) -> None:
        """The calculator holding exactly ``records`` (``records()``'s
        tuples without the batch), scenes numbered in their order."""
        self.pred: Dict[int, list] = {}
        self.gt: Dict[int, list] = {}
        self._batch_of: List[int] = []
        self._next = 0
        for p, g in records:
            self.step([p], [g])

    def step(self, batch_pred, batch_gt):
        for p, g in zip(batch_pred, batch_gt):
            self.pred[self._next] = p
            self.gt[self._next] = g
            self._batch_of.append(self.batch)
            self._next += 1

    def compute_metrics(self) -> Dict[str, float]:
        aps, recalls = eval_det(self.pred, self.gt, self.ovthresh)
        vals = list(aps.values())
        out = {f"AP_{c}": v for c, v in aps.items()}
        out["mAP"] = float(np.mean(vals)) if vals else 0.0
        out.update({f"Recall_{c}": v for c, v in recalls.items()})
        rec_vals = list(recalls.values())
        out["AR"] = float(np.mean(rec_vals)) if rec_vals else 0.0
        return out
