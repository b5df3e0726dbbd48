"""ScanRefer hidden-test captioning submission (the JAX package's
``benchmark/benchmark_captioning.py``; parity: reference
``benchmark/benchmark_captioning.py``).

    python -m d3net_tpu_torch.scripts.benchmark_captioning --folder <run> \
        [--out pred.json] [--cpu]

Restores the run dir's pipeline (``scripts.eval.pipeline_for_eval``: its
best checkpoint, else its last), runs the detector and the speaker's
greedy decode on every val scene, keeps the proposals that survive
same-class NMS at ``test.TEST_NMS_THRESH`` and score above
``test.TEST_SCORE_THRESH``, and gives each the caption of the proposal
whose corners lie nearest. Writes ``{scene_id: [{caption, box, sem_cls,
obj_prob}]}`` (``box`` the 8 corners) to ``--out``, by default
``<run>/benchmark_captioning.json``. Runs on CUDA unless ``--cpu`` is
given; without a GPU and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import resolve_device

DET_KEYS = ("proposal_bbox_batched", "proposal_sem_cls_batched",
            "proposal_scores_batched", "proposal_batch_mask")


def caption_batches(model, val_it, emb: np.ndarray
                    ) -> Iterator[Tuple[list, Dict[str, np.ndarray],
                                        np.ndarray]]:
    """Each val batch's (scenes, the detector's proposals as numpy, the
    greedy caption ids (B, K, T)), ``model`` in eval mode on its own
    device."""
    from d3net_tpu_torch.data.collate import batch_to_torch

    dev = next(model.parameters()).device
    model.eval()
    emb_t = torch.from_numpy(emb).to(dev)
    with torch.no_grad():
        for batch_np, scenes in val_it:
            det = model.run_detector(batch_to_torch(batch_np, dev))
            data = model.run_speaker({**det, "glove_embeddings": emb_t},
                                     mode="eval")
            yield (scenes, {k: det[k].cpu().numpy() for k in DET_KEYS},
                   data["lang_cap"].cpu().numpy())


def scene_entries(det: Dict[str, np.ndarray], i: int, captions: List[str],
                  cfg: cfg_lib.Config) -> List[Dict]:
    """Scene ``i``'s submission entries: each kept proposal's box, class
    and score with the caption of the proposal nearest its corners."""
    from d3net_tpu_torch.eval.detection import parse_predictions

    corners = det["proposal_bbox_batched"]
    preds = parse_predictions(
        *(det[k][i:i + 1] for k in DET_KEYS),
        nms_iou=cfg.test.TEST_NMS_THRESH,
        conf_thresh=cfg.test.TEST_SCORE_THRESH)[0]
    entries = []
    for cls, box, score in preds:
        j = int(np.argmin(np.abs(corners[i] - box).sum(axis=(1, 2))))
        entries.append({"caption": captions[j], "box": box.tolist(),
                        "sem_cls": int(cls), "obj_prob": float(score)})
    return entries


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[Dict]]:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch path)")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    from d3net_tpu_torch.eval.caption_eval import decode_captions
    from d3net_tpu_torch.scripts.eval import pipeline_for_eval

    cfg = cfg_lib.load(os.path.join(args.folder, "config.yaml"))
    model, val_it, vocab, emb, _ = pipeline_for_eval(cfg, args.folder, dev)
    submission = {}
    for scenes, det, ids in caption_batches(model, val_it, emb):
        for i, scene in enumerate(scenes):
            submission[scene.scene_id] = scene_entries(
                det, i, decode_captions(ids[i], vocab), cfg)
    out_path = args.out or os.path.join(args.folder,
                                        "benchmark_captioning.json")
    with open(out_path, "w") as f:
        json.dump(submission, f)
    print(f"wrote {len(submission)} scenes to {out_path}")
    return submission


if __name__ == "__main__":
    main()
