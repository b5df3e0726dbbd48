"""Dense-captioning evaluation (counterpart of
``d3net_tpu/eval/caption_eval.py``; parity: ``lib/captioning/eval_helper.py``).

Protocol (C@kIoU):
1. For each scene, the speaker captions every proposal (eval mode).
2. GT boxes are assigned to predicted boxes by hungarian matching on the
   GIoU matrix (``assign_dense_caption`` :102-240; scipy
   linear_sum_assignment on -GIoU).
3. Each GT object's candidate caption is its assigned proposal's caption;
   if the assignment IoU < min_iou the candidate is replaced by "sos eos"
   (:75-100), zeroing its n-gram overlap.
4. Corpus BLEU-4 / CIDEr / ROUGE-L / METEOR (0.0 without nltk) over
   {scene|object} keys.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from d3net_tpu_torch.eval import capeval
from d3net_tpu_torch.utils.bbox import (
    aabb_iou_minmax, corners_to_minmax, pairwise_giou_matrix,
)


def assign_dense_caption(
    pred_corners: np.ndarray,   # (P, 8, 3)
    pred_mask: np.ndarray,      # (P,)
    gt_corners: np.ndarray,     # (I, 8, 3)
    gt_mask: np.ndarray,        # (I,)
) -> List[Tuple[int, int, float]]:
    """Hungarian GIoU assignment: [(gt_idx, pred_idx, iou)] per valid GT."""
    valid_p = np.where(pred_mask > 0)[0]
    valid_g = np.where(gt_mask > 0)[0]
    if len(valid_p) == 0 or len(valid_g) == 0:
        return [(int(g), -1, 0.0) for g in valid_g]
    pmin, pmax = corners_to_minmax(pred_corners[valid_p])
    gmin, gmax = corners_to_minmax(gt_corners[valid_g])
    giou = pairwise_giou_matrix(gmin, gmax, pmin, pmax)  # (G, P)
    rows, cols = linear_sum_assignment(-giou)
    iou = aabb_iou_minmax(gmin[rows], gmax[rows], pmin[cols], pmax[cols])
    assigned = {int(valid_g[r]): (int(valid_p[c]), float(i))
                for r, c, i in zip(rows, cols, iou)}
    return [(int(g), *assigned.get(int(g), (-1, 0.0))) for g in valid_g]


class CaptionEvaluator:
    """Accumulates per-scene candidates and computes corpus metrics.

    Besides the protocol metrics it keeps the raw (pre-replacement)
    candidates and the assignment IoUs, so ``diagnostics()`` can separate
    detector quality (how many candidates the IoU<k rule wiped) from
    caption quality (metrics on the raw candidates).

    Over ranks (``parallel.mesh.gather_records``) each key's record is
    tagged with ``batch``, the val batch it was added in; ``records()``
    hands them over and ``load_records`` takes every rank's, merged in the
    global scene order (CIDEr's document frequencies are the whole
    corpus's, and the dicts' order is the order the metrics sum in).
    """

    def __init__(self, min_iou: float = 0.5):
        self.min_iou = min_iou
        self.batch = 0
        self.load_records([])

    def records(self) -> List[Tuple[int, tuple]]:
        """``(batch, (key, refs, iou, raw candidate, candidate))`` of every
        key, in the order added."""
        return [(b, (k, self.gts[k], self.ious[k], self.raw_cands[k],
                     self.cands[k])) for b, k in self._batch_of]

    def load_records(self, records) -> None:
        """The evaluator holding exactly ``records`` (``records()``'s
        tuples without the batch), in their order."""
        self.gts: Dict[str, List[str]] = {}
        self.cands: Dict[str, List[str]] = {}
        self.raw_cands: Dict[str, List[str]] = {}
        self.ious: Dict[str, float] = {}
        self._batch_of: List[Tuple[int, str]] = []
        for key, refs, iou, raw, cand in records:
            self._batch_of.append((self.batch, key))
            self.gts[key], self.ious[key] = refs, iou
            self.raw_cands[key], self.cands[key] = raw, cand

    def add_scene(
        self,
        scene_id: str,
        captions: List[str],        # per-proposal decoded strings (P,)
        pred_corners: np.ndarray,
        pred_mask: np.ndarray,
        gt_corners: np.ndarray,
        gt_mask: np.ndarray,
        gt_descriptions: Dict[int, List[str]],  # gt idx -> reference strings
    ):
        pairs = assign_dense_caption(pred_corners, pred_mask, gt_corners, gt_mask)
        for g, p, iou in pairs:
            refs = gt_descriptions.get(g)
            if not refs:
                continue
            key = f"{scene_id}|{g}"
            if key not in self.gts:
                self._batch_of.append((self.batch, key))
            self.gts[key] = [f"sos {r} eos" for r in refs]
            self.ious[key] = float(iou)
            self.raw_cands[key] = [captions[p]] if p >= 0 else ["sos eos"]
            if p >= 0 and iou >= self.min_iou:
                self.cands[key] = [captions[p]]
            else:
                self.cands[key] = ["sos eos"]

    @staticmethod
    def _metrics(gts, cands) -> Dict[str, float]:
        corpus_bleu, _ = capeval.bleu(gts, cands, 4)
        cider, _ = capeval.Cider().compute_score(gts, cands)
        rouge, _ = capeval.rouge_l(gts, cands)
        if capeval.meteor_available():
            met, _ = capeval.meteor(gts, cands)
        else:  # nltk (Porter stemmer) absent — report 0 rather than crash
            met = 0.0
        return {"bleu4": corpus_bleu[3], "cider": cider, "rouge": rouge,
                "meteor": met}

    def compute(self) -> Dict[str, float]:
        if not self.cands:
            return {"bleu4": 0.0, "cider": 0.0, "rouge": 0.0, "meteor": 0.0}
        return self._metrics(self.gts, self.cands)

    def diagnostics(self, num_examples: int = 20) -> Dict:
        """Detector-vs-caption failure attribution (not a protocol metric).

        ``*_raw`` metrics score the assigned proposal's caption regardless
        of IoU; ``frac_replaced`` is how many candidates the IoU<min_iou
        rule wiped.
        """
        if not self.cands:
            return {}
        ious = np.array(list(self.ious.values()))
        out: Dict = {
            "frac_replaced": float(np.mean(ious < self.min_iou)),
            "assign_iou_mean": float(ious.mean()),
            "assign_iou_p50": float(np.median(ious)),
            "assign_iou_p90": float(np.percentile(ious, 90)),
            "num_keys": int(len(ious)),
        }
        out.update({f"{k}_raw": v
                    for k, v in self._metrics(self.gts, self.raw_cands).items()})
        keys = sorted(self.gts)[:num_examples]
        out["examples"] = [
            {"key": k, "iou": round(self.ious[k], 3),
             "candidate": self.cands[k][0], "raw_candidate": self.raw_cands[k][0],
             "refs": self.gts[k]}
            for k in keys
        ]
        return out


def decode_captions(ids: np.ndarray, vocab) -> List[str]:
    """(P, T) token ids -> 'sos w1 w2 ... eos' strings (eval candidate form)."""
    return [" ".join(["sos"] + vocab.decode(row, stop_at_eos=True) + ["eos"])
            for row in ids]
