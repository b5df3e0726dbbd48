"""Weight surgery for the stage-wise curriculum (the JAX package's
``scripts/prepare_weights.py``; parity: reference ``scripts/prepare_weights.py``).

    python -m d3net_tpu_torch.scripts.prepare_weights --folder <run dir> \
        --name <tag> [--out pretrained] [--which best|last]

Reads a run dir of the port (its ``config.yaml`` and the pinned best
checkpoint, else the latest) and writes each submodule as
``<out>/<tag>_<sub>.pkl``: ``{"params", "batch_stats"}`` Flax trees of
numpy arrays, the pickle the JAX script writes. So the
``model.pretrained_<sub>`` of either package reads the file of either. A
detector-only run's whole model is the detector. Runs on the host.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Sequence

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.params import flatten, state_dict_to_flax


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--folder", required=True, help="run dir with ckpt/")
    p.add_argument("--name", required=True, help="output tag")
    p.add_argument("--out", default="pretrained")
    p.add_argument("--which", choices=["best", "last"], default="best",
                   help="pinned-best checkpoint (default) or the latest")
    args = p.parse_args(argv)

    from d3net_tpu_torch.train.loop import Checkpointer, detector_from_cfg
    from d3net_tpu_torch.train.pipeline import (
        SUBMODULES, build_vocab, pipeline_from_cfg,
    )

    cfg = cfg_lib.load(os.path.join(args.folder, "config.yaml"))
    # the curriculum hands off the best checkpoint; without one, the latest
    ck = Checkpointer(args.folder, "total_loss")
    mgr = ck.best_mgr if (args.which == "best"
                          and ck.best_mgr.latest_step() is not None) else ck.mgr
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {args.folder}")
    weights = mgr.restore(step)["model"]
    if any(k.startswith("detector.") for k in weights):
        model = pipeline_from_cfg(cfg, build_vocab(cfg)[0])
        model.load_state_dict(weights)
        subs = {s: getattr(model, s) for s in SUBMODULES if hasattr(model, s)}
    else:
        # detector-only runs (mode 0) train a bare PointGroup: the whole
        # model is the detector submodule
        model = detector_from_cfg(cfg)
        model.load_state_dict(weights)
        subs = {"detector": model}

    os.makedirs(args.out, exist_ok=True)
    for sub, module in subs.items():
        payload = state_dict_to_flax(module)
        path = os.path.join(args.out, f"{args.name}_{sub}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        n = sum(a.size for a in flatten(payload["params"]).values())
        print(f"wrote {path} ({n / 1e6:.2f}M params, step {step})")


if __name__ == "__main__":
    main()
