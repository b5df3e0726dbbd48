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

On CUDA it uses every usable card, as ``benchmark_captioning`` does: each
rank runs its rows of every val batch, the description rows drawn over the
global batch's scenes on every rank (one stream, as one process draws
them) and each rank keeping its own; rank 0 gathers the entries in the
global scene order and alone writes the file.
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


def grounding_batches(cfg: cfg_lib.Config, model, val_it, vocab,
                      emb: np.ndarray, limit: Optional[int] = None
                      ) -> Iterator[Tuple[int, list, Dict[str, np.ndarray],
                                          np.ndarray, np.ndarray,
                                          np.ndarray]]:
    """For each val batch this rank runs rows of (every one without a
    process group; none from the one whose first scene is the ``limit``-th
    on): (the global index of its first row, those rows' scenes, their
    description rows (rows, C, ...), the listener's confidences (rows, C,
    K), the proposals' corners (rows, K, 8, 3) and mask (rows, K)),
    ``model`` in eval mode on its own device; the rows come from one
    ``default_rng(0)`` drawn once a batch over the batch's scenes."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.data.language import build_lang_batch
    from d3net_tpu_torch.train.pipeline import lang_rows

    dev = next(model.parameters()).device
    model.eval()
    emb_t = torch.from_numpy(emb).to(dev)
    chunk = int(cfg.data.num_des_per_scene)
    rng_np = np.random.default_rng(0)
    with torch.no_grad():
        for b, (batch_np, scenes) in enumerate(val_it):
            first = b * val_it.batch_size
            if limit is not None and first >= limit:
                break
            # drawn over the global batch's scenes on every rank
            lang_all = build_lang_batch(scenes, vocab, chunk,
                                        cfg.data.max_spk_len, rng_np,
                                        val_it.spec.max_instances)
            with mesh.eval_rows(val_it.splits(b)) as mine:
                if not mine:
                    continue
                lo, hi = mesh.split_rows(len(scenes))
                lang_np = mesh.shard_host_batch(lang_all)
                det = model.run_detector(batch_to_torch(batch_np, dev))
                lang = lang_rows(lang_np, emb, dev)
                data = model.run_listener(
                    {**det, **lang}, emb_t[lang["lang_ids"].long()],
                    lang["lang_len"], chunk)
                out = (first + lo, scenes[lo:hi], lang_np,
                       data["cluster_ref"].cpu().numpy().reshape(
                           hi - lo, chunk, -1),
                       det["proposal_bbox_batched"].cpu().numpy(),
                       det["proposal_batch_mask"].cpu().numpy())
            yield out


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


def benchmark_grounding(cfg: cfg_lib.Config, run_dir: str,
                        device: DeviceLike = None, out: Optional[str] = None,
                        world_size: Optional[int] = None,
                        threads: Optional[int] = None) -> List[Dict]:
    """The submission of ``run_dir``'s pipeline, written to ``out`` (by
    default ``<run_dir>/benchmark_grounding.json``) by rank 0, over
    ``mesh.run_world(world_size)`` ranks (``threads``: a CPU rank's torch
    threads); every rank returns it."""
    from d3net_tpu_torch.scripts.eval import pipeline_for_eval, spawned

    dev = resolve_device(device)
    res = spawned(benchmark_grounding, cfg, run_dir, dev, world_size,
                  threads, out=out)
    if res is not None:
        return res
    model, val_it, vocab, emb, _ = pipeline_for_eval(cfg, run_dir, dev)
    pairs = []
    for first, scenes, lang_np, conf, corners, mask in grounding_batches(
            cfg, model, val_it, vocab, emb):
        for i, scene in enumerate(scenes):
            for c, pick in picks(lang_np, conf, mask, i):
                pairs.append((first, {
                    "scene_id": scene.scene_id,
                    "object_id": int(lang_np["ref_box_label"][i, c].argmax()),
                    "bbox": corners[i, pick].tolist(),
                }))
    submission = mesh.gather_ordered(pairs)
    if submission is not None:
        out_path = out or os.path.join(run_dir, "benchmark_grounding.json")
        with open(out_path, "w") as f:
            json.dump(submission, f)
        print(f"wrote {len(submission)} entries to {out_path}")
    return mesh.broadcast_from_main(submission)


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    from d3net_tpu_torch.scripts.eval import run_entry

    p = argparse.ArgumentParser()
    p.add_argument("--folder", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch path)")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = cfg_lib.load(os.path.join(args.folder, "config.yaml"))
    return run_entry(benchmark_grounding, cfg, args.folder, dev, args.cpu,
                     out=args.out)


if __name__ == "__main__":
    main()
