"""Visual-grounding evaluation (counterpart of
``d3net_tpu/eval/grounding_eval.py``; parity: ``lib/grounding/eval_helper.py``).

Protocol: mask invalid proposals, pick the argmax-confidence proposal, score
its IoU against the referred GT box; report Acc@0.25/0.5 and the mean IoU
overall and broken down by unique/multiple (the ScanRefer
``unique_multiple`` label: whether the referred object's class appears
more than once in the scene, ``eval_helper.py:106-108``) and by "others"
(object category == 17, the otherfurniture bucket, ``eval_helper.py:
110-112``; aggregation as in the reference ``scripts/eval.py:168-426``).
Numpy throughout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from d3net_tpu_torch.utils.bbox import aabb_iou_minmax, corners_to_minmax


class GroundingEvaluator:
    """Accumulates the annotated rows' IoUs and flags. Over ranks
    (``parallel.mesh.gather_records``) each row is tagged with ``batch``,
    the val batch it was added in: ``records()`` hands them over and
    ``load_records`` takes every rank's, merged in the global row order."""

    def __init__(self):
        self.batch = 0
        self.load_records([])

    def records(self) -> List[Tuple[int, tuple]]:
        """``(batch, (iou, multiple, others))`` of every row, in order."""
        return list(zip(self._batch_of,
                        zip(self.ious, self.multiple, self.others)))

    def load_records(self, records) -> None:
        """The evaluator holding exactly ``records`` (``records()``'s
        tuples without the batch), in their order."""
        rows = list(records)
        self.ious: List[float] = [r[0] for r in rows]
        self.multiple: List[bool] = [r[1] for r in rows]
        self.others: List[bool] = [r[2] for r in rows]
        self._batch_of: List[int] = [self.batch] * len(rows)

    def add(
        self,
        cluster_ref: np.ndarray,       # (N, P) confidences
        pred_corners: np.ndarray,      # (N, P, 8, 3)
        pred_mask: np.ndarray,         # (N, P)
        ref_corner_label: np.ndarray,  # (N, 8, 3)
        annotated: np.ndarray,         # (N,)
        unique_multiple: Optional[np.ndarray] = None,  # (N,) 1 = multiple
        object_cat: Optional[np.ndarray] = None,       # (N,) 17 = others
    ) -> None:
        """One batch of description rows; unannotated rows are skipped."""
        conf = np.where(pred_mask > 0, cluster_ref, -1e30)
        pick = conf.argmax(-1)
        chosen = pred_corners[np.arange(len(pick)), pick]
        iou = aabb_iou_minmax(*corners_to_minmax(chosen),
                              *corners_to_minmax(ref_corner_label))
        for i in range(len(pick)):
            if annotated[i] <= 0:
                continue
            self._batch_of.append(self.batch)
            self.ious.append(float(iou[i]))
            self.multiple.append(bool(unique_multiple[i] > 0)
                                 if unique_multiple is not None else False)
            self.others.append(bool(object_cat[i] == 17)
                               if object_cat is not None else False)

    @staticmethod
    def _accs(ious: np.ndarray, tag: str) -> Dict[str, float]:
        if ious.size == 0:
            return {}
        p = f"{tag}_" if tag else ""
        return {
            f"{p}acc@0.25": float((ious >= 0.25).mean()),
            f"{p}acc@0.5": float((ious >= 0.5).mean()),
            f"{p}iou_mean": float(ious.mean()),
        }

    def compute(self, breakdown: bool = True) -> Dict[str, float]:
        if not self.ious:
            return {"acc@0.25": 0.0, "acc@0.5": 0.0, "iou_mean": 0.0}
        ious = np.asarray(self.ious)
        multiple = np.asarray(self.multiple)
        others = np.asarray(self.others)
        out = self._accs(ious, "")
        if breakdown:
            out.update(self._accs(ious[~multiple], "unique"))
            out.update(self._accs(ious[multiple], "multiple"))
            out.update(self._accs(ious[others], "others"))
            out.update(self._accs(ious[~others], "not_others"))
        return out
