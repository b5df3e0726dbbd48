"""Train entry point of the port (the JAX package's ``scripts/train.py``).

    python -m d3net_tpu_torch.scripts.train --config conf/pointgroup.yaml \
        [--folder NAME] [--max_steps N] [--cpu]

The task YAML is merged over ``path.yaml`` beside it, when there is one;
the run goes to ``general.output_root/<folder or general.experiment>``
and resumes from its last checkpoint. Runs on CUDA unless ``--cpu`` is
given; without a GPU and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import resolve_device


def load_task_config(path: str) -> cfg_lib.Config:
    """The task YAML deep-merged over ``path.yaml`` in its directory."""
    base = os.path.join(os.path.dirname(path), "path.yaml")
    paths = [p for p in [base] if os.path.exists(p)] + [path]
    return cfg_lib.load(*paths)


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
    task_mode = (
        int(not cfg.model.no_detection),
        int(not cfg.model.no_captioning),
        int(not cfg.model.no_grounding),
    )
    if task_mode != (1, 0, 0):
        raise NotImplementedError(
            f"task mode {task_mode}: only the detector (1, 0, 0) is ported; "
            "the speaker, listener and joint pipeline are ROADMAP.md queue A "
            "items 13-15")
    if cfg.tpu.get("steps_per_dispatch"):
        raise NotImplementedError(
            "tpu.steps_per_dispatch: the scan trainer "
            "(run_detector_training_scan) is not ported (ROADMAP.md, Next)")

    from d3net_tpu_torch.train.loop import run_detector_training

    run_detector_training(cfg, run_dir, max_steps=args.max_steps,
                          device=device)


if __name__ == "__main__":
    main()
