"""ScanNet benchmark evaluation (counterpart of
``d3net_tpu/eval/segmentation.py``; parity: ``lib/evaluation/``), a numpy
copy that gives JAX's numbers.

- Semantic segmentation: per-class IoU from a confusion matrix over
  annotated points (``semantic_segmentation.py:21-110``).
- Instance segmentation: ScanNet-protocol AP — greedy matching of predicted
  instance masks to GT instances per class at IoU overlaps
  [0.5:0.95:0.05] plus AP@25/AP@50, with precision/recall integration over
  score-ranked predictions (``instance_segmentation.py:54-381``).

The txt benchmark writer is ``eval/scannet_eval.py`` (``eval --task
scannet``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def semantic_confusion(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                       ignore_label: int = -1) -> np.ndarray:
    valid = gt != ignore_label
    idx = gt[valid] * num_classes + pred[valid]
    conf = np.bincount(idx, minlength=num_classes * num_classes)
    return conf.reshape(num_classes, num_classes)


def semantic_iou(conf: np.ndarray) -> Dict[str, float]:
    tp = np.diag(conf).astype(np.float64)
    fp = conf.sum(0) - tp
    fn = conf.sum(1) - tp
    denom = tp + fp + fn
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
    return {
        "mIoU": float(np.nanmean(iou)),
        "per_class_iou": iou.tolist(),
        "accuracy": float(tp.sum() / max(conf.sum(), 1)),
    }


class InstanceEvaluator:
    """Accumulates scenes; predictions are (mask(N,), class, score).

    Over ranks (``parallel.mesh.gather_records``) each scene is tagged with
    ``batch``, the val batch it was added in: ``records()`` hands them over
    with the masks packed 8 points a byte, and ``load_records`` takes every
    rank's, in the global scene order."""

    def __init__(self, overlaps: Sequence[float] = None, min_region_size: int = 100):
        self.overlaps = (
            list(overlaps)
            if overlaps is not None
            else [0.25, 0.5] + [0.5 + 0.05 * i for i in range(1, 10)]
        )
        self.min_region = min_region_size
        self.batch = 0
        self.scenes: List[Tuple] = []
        self._batch_of: List[int] = []

    def add_scene(self, preds: List[Tuple[np.ndarray, int, float]],
                  gt_instance_ids: np.ndarray, gt_sem: np.ndarray):
        self.scenes.append((preds, gt_instance_ids, gt_sem))
        self._batch_of.append(self.batch)

    def records(self) -> List[Tuple[int, tuple]]:
        """``(batch, (packed predictions, points, GT ids, GT classes))`` of
        every scene, each mask as ``np.packbits`` of its points."""
        return [(b, ([(np.packbits(m), c, s) for m, c, s in preds],
                     len(ids), ids, sem))
                for b, (preds, ids, sem) in zip(self._batch_of, self.scenes)]

    def load_records(self, records) -> None:
        """The evaluator holding exactly ``records`` (``records()``'s
        tuples without the batch), in their order, the masks unpacked."""
        self.scenes, self._batch_of = [], []
        for packed, n, ids, sem in records:
            self.add_scene([(np.unpackbits(m, count=n).astype(bool), c, s)
                            for m, c, s in packed], ids, sem)

    def compute(self) -> Dict[str, float]:
        classes = sorted(
            {int(c) for _, _, gs in self.scenes for c in np.unique(gs) if c >= 0}
        )
        ap_per_overlap = {}
        for ov in self.overlaps:
            aps = []
            for cls in classes:
                ap = self._ap_class(cls, ov)
                if ap is not None:
                    aps.append(ap)
            ap_per_overlap[ov] = float(np.mean(aps)) if aps else 0.0
        strict = [ap_per_overlap[o] for o in self.overlaps if o >= 0.5]
        return {
            "AP": float(np.mean(strict)) if strict else 0.0,
            "AP@50": ap_per_overlap.get(0.5, 0.0),
            "AP@25": ap_per_overlap.get(0.25, 0.0),
        }

    def _ap_class(self, cls: int, ov: float):
        """VOC-style AP for one class at one overlap threshold."""
        dets = []  # (score, tp)
        npos = 0
        for preds, gt_ids, gt_sem in self.scenes:
            # GT instances of this class
            gts = []
            for gid in np.unique(gt_ids):
                if gid < 0:
                    continue
                mask = gt_ids == gid
                if mask.sum() < self.min_region:
                    continue
                sem = np.bincount(gt_sem[mask][gt_sem[mask] >= 0]).argmax() \
                    if (gt_sem[mask] >= 0).any() else -1
                if sem == cls:
                    gts.append(mask)
            npos += len(gts)
            matched = [False] * len(gts)
            cls_preds = sorted(
                [p for p in preds if p[1] == cls], key=lambda p: -p[2]
            )
            for mask, _c, score in cls_preds:
                best_iou, best_j = 0.0, -1
                for j, g in enumerate(gts):
                    inter = np.logical_and(mask, g).sum()
                    union = np.logical_or(mask, g).sum()
                    iou = inter / max(union, 1)
                    if iou > best_iou:
                        best_iou, best_j = iou, j
                tp = best_iou > ov and not matched[best_j]
                if tp:
                    matched[best_j] = True
                dets.append((score, tp))
        if npos == 0:
            return None
        if not dets:
            return 0.0
        dets.sort(key=lambda d: -d[0])
        tps = np.cumsum([d[1] for d in dets])
        fps = np.cumsum([not d[1] for d in dets])
        rec = tps / npos
        prec = tps / np.maximum(tps + fps, 1e-9)
        # VOC continuous AP
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 1, 0, -1):
            mpre[i - 1] = max(mpre[i - 1], mpre[i])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
