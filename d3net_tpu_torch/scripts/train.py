"""Train entry point of the port (the JAX package's ``scripts/train.py``).

    python -m d3net_tpu_torch.scripts.train --config conf/pointgroup.yaml \
        [--folder NAME] [--max_steps N] [--cpu]

The task YAML is merged over ``path.yaml`` beside it, when there is one;
the run goes to ``general.output_root/<folder or general.experiment>``
and resumes from its last checkpoint. The detector (task mode (1, 0, 0))
trains through ``run_detector_training``; the detector with the speaker
((1, 1, 0), e.g. conf/pointgroup_captioning.yaml), with the listener
((1, 0, 1), e.g. conf/pointgroup_grounding.yaml) or with both by joint
self-critical RL ((1, 1, 1), conf/pointgroup_joint.yaml), whose
``model.pretrained_<sub>`` pickles ``prepare_weights`` writes, through
``run_pipeline_training``. Runs on CUDA unless ``--cpu`` is given; without
a GPU and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import resolve_device
from d3net_tpu_torch.train.pipeline import task_mode


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
    if task_mode(cfg) == (1, 0, 0):
        if cfg.tpu.get("steps_per_dispatch"):
            raise NotImplementedError(
                "tpu.steps_per_dispatch: the scan trainer "
                "(run_detector_training_scan) is not ported (ROADMAP.md, "
                "queue A item 19)")
        from d3net_tpu_torch.train.loop import run_detector_training as run
    else:
        from d3net_tpu_torch.train.pipeline import run_pipeline_training as run
    run(cfg, run_dir, max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
