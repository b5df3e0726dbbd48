"""ScanRefer hidden-test grounding submission (the JAX package's
``benchmark/benchmark_grounding.py``; parity: reference
``benchmark/benchmark_grounding.py``).

    python -m d3net_tpu_torch.scripts.benchmark_grounding --folder <run> \
        [--out pred.json] [--cpu]

Restores the run dir's pipeline (``scripts.eval.pipeline_for_eval``),
draws each val batch's description rows from one
``np.random.default_rng(0)`` a run (``build_lang_batch``), runs the
detector and the eval-mode listener, and for every annotated description
picks the valid proposal of highest confidence. Writes the list
``[{scene_id, object_id, bbox}]`` (``bbox`` the picked proposal's 8
corners) to ``--out``, by default ``<run>/benchmark_grounding.json``.
``object_id`` is what the JAX script writes: the argmax of the row's
``ref_box_label``, the target's instance slot in the scene. Runs on CUDA
unless ``--cpu`` is given; without a GPU and without ``--cpu`` it raises.
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


def grounding_batches(cfg: cfg_lib.Config, model, val_it, vocab,
                      emb: np.ndarray
                      ) -> Iterator[Tuple[list, Dict[str, np.ndarray],
                                          np.ndarray, np.ndarray,
                                          np.ndarray]]:
    """Each val batch's (scenes, its description rows (B, C, ...), the
    listener's confidences (B, C, K), the proposals' corners (B, K, 8, 3)
    and mask (B, K)), ``model`` in eval mode on its own device; the rows
    come from one ``default_rng(0)`` drawn once a batch."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.data.language import build_lang_batch
    from d3net_tpu_torch.train.pipeline import lang_rows

    dev = next(model.parameters()).device
    model.eval()
    emb_t = torch.from_numpy(emb).to(dev)
    chunk = int(cfg.data.num_des_per_scene)
    rng_np = np.random.default_rng(0)
    with torch.no_grad():
        for batch_np, scenes in val_it:
            det = model.run_detector(batch_to_torch(batch_np, dev))
            lang_np = build_lang_batch(scenes, vocab, chunk,
                                       cfg.data.max_spk_len, rng_np,
                                       val_it.spec.max_instances)
            lang = lang_rows(lang_np, emb, dev)
            data = model.run_listener(
                {**det, **lang}, emb_t[lang["lang_ids"].long()],
                lang["lang_len"], chunk)
            conf = data["cluster_ref"].cpu().numpy().reshape(
                len(scenes), chunk, -1)
            yield (scenes, lang_np, conf,
                   det["proposal_bbox_batched"].cpu().numpy(),
                   det["proposal_batch_mask"].cpu().numpy())


def picks(lang_np: Dict[str, np.ndarray], conf: np.ndarray,
          mask: np.ndarray, i: int) -> List[Tuple[int, int]]:
    """Scene ``i``'s (row, picked proposal) for each annotated row: the
    valid proposal of highest confidence, the first on ties."""
    out = []
    for c in range(conf.shape[1]):
        if lang_np["annotated"][i, c] <= 0:
            continue
        scores = np.where(mask[i] > 0, conf[i, c], -1e30)
        out.append((c, int(scores.argmax())))
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch path)")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    from d3net_tpu_torch.scripts.eval import pipeline_for_eval

    cfg = cfg_lib.load(os.path.join(args.folder, "config.yaml"))
    model, val_it, vocab, emb, _ = pipeline_for_eval(cfg, args.folder, dev)
    submission = []
    for scenes, lang_np, conf, corners, mask in grounding_batches(
            cfg, model, val_it, vocab, emb):
        for i, scene in enumerate(scenes):
            for c, pick in picks(lang_np, conf, mask, i):
                submission.append({
                    "scene_id": scene.scene_id,
                    "object_id": int(lang_np["ref_box_label"][i, c].argmax()),
                    "bbox": corners[i, pick].tolist(),
                })
    out_path = args.out or os.path.join(args.folder,
                                        "benchmark_grounding.json")
    with open(out_path, "w") as f:
        json.dump(submission, f)
    print(f"wrote {len(submission)} entries to {out_path}")
    return submission


if __name__ == "__main__":
    main()
