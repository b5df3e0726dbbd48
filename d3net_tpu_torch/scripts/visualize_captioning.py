"""Qualitative dense-captioning dumps (the JAX package's
``scripts/visualize_captioning.py``; parity: reference
``scripts/visualize_captioning.py``).

    python -m d3net_tpu_torch.scripts.visualize_captioning --folder <run> \
        [--scenes N] [--cpu]

Restores the run dir's pipeline (``scripts.eval.pipeline_for_eval``) and,
for the first ``--scenes`` val scenes (default 4), writes
``<run>/vis_captioning/<scene_id>/``: ``scene.ply`` (the points and
colours), ``pred_boxes.ply`` (the valid proposals' box edges, sampled as
red points) and ``captions.txt`` (one line per valid proposal with its
greedy caption). Runs on CUDA unless ``--cpu`` is given; without a GPU and
without ``--cpu`` it raises.

On CUDA it uses every usable card, as ``benchmark_captioning`` does: each
rank runs its rows of the val batches that hold those scenes and writes
its own scenes' files.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.utils.ply import write_ply_points

# the 12 edges between the 8 corners of ``utils.bbox.box_corners``
BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def box_edges_ply(path, corners_list, colors=None):
    """Write box wireframes as a PLY point cloud sampled along edges (20
    points an edge, red unless ``colors`` gives each box its own)."""
    pts, cols = [], []
    for bi, corners in enumerate(corners_list):
        color = colors[bi] if colors is not None else (255, 0, 0)
        for a, b in BOX_EDGES:
            for t in np.linspace(0, 1, 20):
                pts.append(corners[a] * (1 - t) + corners[b] * t)
                cols.append(color)
    if pts:
        write_ply_points(path, np.asarray(pts), np.asarray(cols))


def write_scene_ply(scene_dir: str, scene) -> None:
    """``<scene_dir>/scene.ply``: the scene's points with their colours
    mapped from [-1, 1] to [0, 255]."""
    os.makedirs(scene_dir, exist_ok=True)
    rgb255 = ((scene.rgb + 1) * 127.5).clip(0, 255)
    write_ply_points(os.path.join(scene_dir, "scene.ply"), scene.xyz, rgb255)


def report_written(done: int, out_dir: str) -> None:
    """Rank 0 prints how many scenes every rank wrote under ``out_dir``."""
    counts = mesh.gather_to_main(done)
    if counts is not None:
        print(f"wrote {sum(counts)} scenes to {out_dir}")


def visualize_captioning(cfg: cfg_lib.Config, run_dir: str,
                         device: DeviceLike = None, scenes: int = 4,
                         world_size: Optional[int] = None,
                         threads: Optional[int] = None) -> str:
    """The dumps of the first ``scenes`` val scenes under
    ``<run_dir>/vis_captioning``, over ``mesh.run_world(world_size)``
    ranks (``threads``: a CPU rank's torch threads); returns that dir."""
    from d3net_tpu_torch.eval.caption_eval import decode_captions
    from d3net_tpu_torch.scripts.benchmark_captioning import caption_batches
    from d3net_tpu_torch.scripts.eval import pipeline_for_eval, spawned

    dev = resolve_device(device)
    res = spawned(visualize_captioning, cfg, run_dir, dev, world_size,
                  threads, scenes=scenes)
    if res is not None:
        return res
    model, val_it, vocab, emb, _ = pipeline_for_eval(cfg, run_dir, dev)
    out_dir = os.path.join(run_dir, "vis_captioning")
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for first, rows, det, ids in caption_batches(model, val_it, emb, scenes):
        corners = det["proposal_bbox_batched"]
        masks = det["proposal_batch_mask"]
        for i, scene in enumerate(rows[:max(0, scenes - first)]):
            sdir = os.path.join(out_dir, scene.scene_id)
            write_scene_ply(sdir, scene)
            keep = np.where(masks[i] > 0)[0]
            box_edges_ply(os.path.join(sdir, "pred_boxes.ply"),
                          corners[i, keep])
            caps = decode_captions(ids[i], vocab)
            with open(os.path.join(sdir, "captions.txt"), "w") as f:
                for j in keep:
                    f.write(f"proposal {j}: {caps[j]}\n")
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
    return run_entry(visualize_captioning, cfg, args.folder, dev, args.cpu,
                     scenes=args.scenes)


if __name__ == "__main__":
    main()
