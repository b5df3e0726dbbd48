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

On CUDA it uses every usable card, as the eval CLI does
(``scripts.eval``): one process a card, each restoring the checkpoint and
running its rows of every val batch (a short last batch the ranks cannot
split runs on rank 0 alone); the entries are gathered to rank 0 in the
global scene order, and rank 0 alone writes the file, which is the
one-process file wherever the forward reproduces itself (the CPU; the card
under ``device.parity_precision()`` with deterministic algorithms). Under
``torchrun`` each launched process is one rank; ``--cpu`` is one process.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.parallel import mesh

DET_KEYS = ("proposal_bbox_batched", "proposal_sem_cls_batched",
            "proposal_scores_batched", "proposal_batch_mask")


def caption_batches(model, val_it, emb: np.ndarray,
                    limit: Optional[int] = None
                    ) -> Iterator[Tuple[int, list, Dict[str, np.ndarray],
                                        np.ndarray]]:
    """For each val batch this rank runs rows of (every one without a
    process group; none from the one whose first scene is the ``limit``-th
    on): (the global index of its first row, those rows' scenes, the
    detector's proposals as numpy, the greedy caption ids (rows, K, T)),
    ``model`` in eval mode on its own device."""
    from d3net_tpu_torch.data.collate import batch_to_torch

    dev = next(model.parameters()).device
    model.eval()
    emb_t = torch.from_numpy(emb).to(dev)
    with torch.no_grad():
        for b, (batch_np, scenes) in enumerate(val_it):
            first = b * val_it.batch_size
            if limit is not None and first >= limit:
                break
            with mesh.eval_rows(val_it.splits(b)) as mine:
                if not mine:
                    continue
                lo, hi = mesh.split_rows(len(scenes))
                det = model.run_detector(batch_to_torch(batch_np, dev))
                data = model.run_speaker({**det, "glove_embeddings": emb_t},
                                         mode="eval")
                out = (first + lo, scenes[lo:hi],
                       {k: det[k].cpu().numpy() for k in DET_KEYS},
                       data["lang_cap"].cpu().numpy())
            yield out


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


def benchmark_captioning(cfg: cfg_lib.Config, run_dir: str,
                         device: DeviceLike = None, out: Optional[str] = None,
                         world_size: Optional[int] = None,
                         threads: Optional[int] = None
                         ) -> Dict[str, List[Dict]]:
    """The submission of ``run_dir``'s pipeline, written to ``out`` (by
    default ``<run_dir>/benchmark_captioning.json``) by rank 0, over
    ``mesh.run_world(world_size)`` ranks (``threads``: a CPU rank's torch
    threads); every rank returns it."""
    from d3net_tpu_torch.eval.caption_eval import decode_captions
    from d3net_tpu_torch.scripts.eval import pipeline_for_eval, spawned

    dev = resolve_device(device)
    res = spawned(benchmark_captioning, cfg, run_dir, dev, world_size,
                  threads, out=out)
    if res is not None:
        return res
    model, val_it, vocab, emb, _ = pipeline_for_eval(cfg, run_dir, dev)
    pairs = []
    for first, scenes, det, ids in caption_batches(model, val_it, emb):
        for i, scene in enumerate(scenes):
            pairs.append((first, (scene.scene_id, scene_entries(
                det, i, decode_captions(ids[i], vocab), cfg))))
    merged = mesh.gather_ordered(pairs)
    submission = None
    if merged is not None:
        submission = dict(merged)
        out_path = out or os.path.join(run_dir, "benchmark_captioning.json")
        with open(out_path, "w") as f:
            json.dump(submission, f)
        print(f"wrote {len(submission)} scenes to {out_path}")
    return mesh.broadcast_from_main(submission)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[Dict]]:
    from d3net_tpu_torch.scripts.eval import run_entry

    p = argparse.ArgumentParser()
    p.add_argument("--folder", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch path)")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = cfg_lib.load(os.path.join(args.folder, "config.yaml"))
    return run_entry(benchmark_captioning, cfg, args.folder, dev, args.cpu,
                     out=args.out)


if __name__ == "__main__":
    main()
