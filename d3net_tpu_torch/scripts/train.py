"""Train entry point of the port (the JAX package's ``scripts/train.py``).

    python -m d3net_tpu_torch.scripts.train --config conf/pointgroup.yaml \
        [--folder NAME] [--max_steps N] [--cpu]

The task YAML is merged over ``path.yaml`` beside it, when there is one;
the run goes to ``general.output_root/<folder or general.experiment>``
and resumes from its last checkpoint. The detector (task mode (1, 0, 0))
trains through ``run_detector_training``, or with ``tpu.steps_per_dispatch``
(e.g. conf/flagship_converge.yaml) through ``run_detector_training_scan``;
the detector with the speaker
((1, 1, 0), e.g. conf/pointgroup_captioning.yaml), with the listener
((1, 0, 1), e.g. conf/pointgroup_grounding.yaml) or with both by joint
self-critical RL ((1, 1, 1), conf/pointgroup_joint.yaml), whose
``model.pretrained_<sub>`` pickles ``prepare_weights`` writes, through
``run_pipeline_training``. Runs on CUDA unless ``--cpu`` is given; without
a GPU and without ``--cpu`` it raises.

On CUDA the run uses every usable card: the largest count of the visible
cards that divides ``data.batch_size`` (a warning names the cards left
idle), one spawned process a card, joined over NCCL, each training on its
rows of the global batch (``parallel.mesh``); with one usable card it runs
in this process with no process group. Under ``torchrun`` (``WORLD_SIZE``
set) each launched process is one rank:

    torchrun --nproc_per_node=4 -m d3net_tpu_torch.scripts.train \
        --config conf/pointgroup.yaml

(across hosts: ``--nnodes``, ``--node_rank`` and ``--master_addr``, as
torchrun documents). ``--cpu`` is one process.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.train.pipeline import task_mode


def load_task_config(path: str) -> cfg_lib.Config:
    """The task YAML deep-merged over ``path.yaml`` in its directory."""
    base = os.path.join(os.path.dirname(path), "path.yaml")
    paths = [p for p in [base] if os.path.exists(p)] + [path]
    return cfg_lib.load(*paths)


def loop_of(cfg: cfg_lib.Config) -> str:
    """The run loop that trains ``cfg``: ``detector``, ``scan`` (the
    detector in dispatches, ``tpu.steps_per_dispatch``) or ``pipeline``."""
    if task_mode(cfg) != (1, 0, 0):
        return "pipeline"
    return "scan" if cfg.tpu.get("steps_per_dispatch") else "detector"


def run_training(cfg: cfg_lib.Config, run_dir: str,
                 max_steps: Optional[int] = None, device: DeviceLike = None):
    """The config's run loop in this process (this rank's, under a process
    group); returns its train state."""
    loop = loop_of(cfg)
    if loop == "scan":
        from d3net_tpu_torch.train.loop import (
            run_detector_training_scan as run,
        )
    elif loop == "detector":
        from d3net_tpu_torch.train.loop import run_detector_training as run
    else:
        from d3net_tpu_torch.train.pipeline import run_pipeline_training as run
    return run(cfg, run_dir, max_steps=max_steps, device=device)


def train(cfg: cfg_lib.Config, run_dir: str, max_steps: Optional[int] = None,
          device: DeviceLike = None, world_size: Optional[int] = None,
          threads: Optional[int] = None) -> None:
    """Train ``cfg`` into ``run_dir`` over ``world_size`` ranks, each a
    process on its own card (NCCL) or, on the CPU, a gloo process with
    ``threads`` torch threads. ``world_size`` defaults to every usable card
    on CUDA (``mesh.make_mesh``: the largest count of visible cards that
    divides ``data.batch_size``, warning about the idle ones) and to 1 on
    the CPU. One rank runs in this process with no process group."""
    dev = resolve_device(device)
    world_size = mesh.run_world(int(cfg.data.batch_size), dev, world_size)
    if world_size == 1:
        run_training(cfg, run_dir, max_steps, dev)
        return
    mesh.spawn_ranks(_train_rank, world_size, cfg, run_dir, max_steps,
                     dev.type, dev=dev, threads=threads)


def _train_rank(cfg: cfg_lib.Config, run_dir: str,
                max_steps: Optional[int], device_type: str) -> None:
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    run_training(cfg, run_dir, max_steps, dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True,
                        help="task yaml (merged over path.yaml beside it)")
    parser.add_argument("--folder", default=None, help="resume/run dir name")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain PyTorch path)")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = load_task_config(args.config)
    run_dir = os.path.join(cfg.general.output_root,
                           args.folder or cfg.general.experiment)
    if args.cpu:
        run_training(cfg, run_dir, args.max_steps, device)
        return
    launched = mesh.init_multihost()
    if launched["process_count"] > 1:
        # an external launcher (torchrun) made the group: this process is
        # one of its ranks, on its LOCAL_RANK card
        mesh.make_mesh(int(cfg.data.batch_size))
        try:
            run_training(cfg, run_dir, args.max_steps, torch.device(
                "cuda", torch.cuda.current_device()))
        finally:
            mesh.teardown()
        return
    train(cfg, run_dir, args.max_steps, device)


if __name__ == "__main__":
    main()
