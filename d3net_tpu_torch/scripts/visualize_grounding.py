"""Qualitative grounding dumps (the JAX package's
``scripts/visualize_grounding.py``; parity: reference
``scripts/visualize_grounding.py``).

    python -m d3net_tpu_torch.scripts.visualize_grounding --folder <run> \
        [--scenes N] [--cpu]

Restores the run dir's pipeline (``scripts.eval.pipeline_for_eval``),
draws the description rows as ``benchmark_grounding`` does (one
``default_rng(0)`` a run), and for the first ``--scenes`` val scenes
(default 4) writes ``<run>/vis_grounding/<scene_id>/``: ``scene.ply``,
and for each annotated row ``c`` the picked proposal's box edges
(``query<c>_pred.ply``, red) and the target's (``query<c>_gt.ply``,
green), with ``queries.txt`` giving each row's words and pick. Runs on
CUDA unless ``--cpu`` is given; without a GPU and without ``--cpu`` it
raises.

On CUDA it uses every usable card, as ``benchmark_grounding`` does: each
rank runs its rows of the val batches that hold those scenes and writes
its own scenes' files.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device


def visualize_grounding(cfg: cfg_lib.Config, run_dir: str,
                        device: DeviceLike = None, scenes: int = 4,
                        world_size: Optional[int] = None,
                        threads: Optional[int] = None) -> str:
    """The dumps of the first ``scenes`` val scenes under
    ``<run_dir>/vis_grounding``, over ``mesh.run_world(world_size)`` ranks
    (``threads``: a CPU rank's torch threads); returns that dir."""
    from d3net_tpu_torch.scripts.benchmark_grounding import (
        grounding_batches, picks,
    )
    from d3net_tpu_torch.scripts.eval import pipeline_for_eval, spawned
    from d3net_tpu_torch.scripts.visualize_captioning import (
        box_edges_ply, report_written, write_scene_ply,
    )

    dev = resolve_device(device)
    res = spawned(visualize_grounding, cfg, run_dir, dev, world_size,
                  threads, scenes=scenes)
    if res is not None:
        return res
    model, val_it, vocab, emb, _ = pipeline_for_eval(cfg, run_dir, dev)
    out_dir = os.path.join(run_dir, "vis_grounding")
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for first, rows, lang_np, conf, corners, masks in grounding_batches(
            cfg, model, val_it, vocab, emb, scenes):
        for i, scene in enumerate(rows[:max(0, scenes - first)]):
            sdir = os.path.join(out_dir, scene.scene_id)
            write_scene_ply(sdir, scene)
            with open(os.path.join(sdir, "queries.txt"), "w") as f:
                for c, pick in picks(lang_np, conf, masks, i):
                    text = " ".join(vocab.decode(lang_np["lang_ids"][i, c]))
                    box_edges_ply(os.path.join(sdir, f"query{c}_pred.ply"),
                                  [corners[i, pick]], [(255, 0, 0)])
                    box_edges_ply(
                        os.path.join(sdir, f"query{c}_gt.ply"),
                        [lang_np["ref_box_corner_label"][i, c]],
                        [(0, 255, 0)])
                    f.write(f"query {c}: {text} -> proposal {pick}\n")
            done += 1
    report_written(done, out_dir)
    return out_dir


def main(argv: Optional[Sequence[str]] = None) -> str:
    from d3net_tpu_torch.scripts.eval import run_entry

    parser = argparse.ArgumentParser()
    parser.add_argument("--folder", required=True)
    parser.add_argument("--scenes", type=int, default=4)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain PyTorch path)")
    args = parser.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = cfg_lib.load(os.path.join(args.folder, "config.yaml"))
    return run_entry(visualize_grounding, cfg, args.folder, dev, args.cpu,
                     scenes=args.scenes)


if __name__ == "__main__":
    main()
