"""Carry a run of the JAX package onto the port: its orbax checkpoints as
the port's ``state.pt``.

Where the JAX run lives (JAX and orbax installed):

    python scripts/export_jax_run.py --folder <jax run dir> --out run.npz

then where the port runs (numpy and torch alone):

    python -m d3net_tpu_torch.scripts.import_jax_run --archive run.npz \
        --out <port run dir> [--cpu]

It reads the run archive (``d3net_tpu_torch.jax_run``), builds the model of
its ``config.yaml`` with the port's builders (the detector's, or the
pipeline's with the submodules its loop freezes, which must be those the
archive's multi_transform labels freeze), and for its last and best
checkpoints loads the weights (``params.flax_to_state_dict``: a leaf left
unused or an entry left unset raises), the optimizer state
(``params.optax_state_to_torch``) and the StepLR at the optax schedule's
count (``trainer.seek_schedule``). It writes the port's run dir:
``config.yaml``, ``ckpt/<last>/state.pt``, ``ckpt_best/<best>/state.pt``
with ``best.json``, the run's ``metrics.jsonl`` and its ``run_meta.json``
with ``imported_from`` ({folder, step, archive sha256}) added, which the
port's loops keep.

The port's entry points then take the run dir as it is: ``python -m
d3net_tpu_torch.scripts.train --config <out>/config.yaml --folder <out>``
resumes at the next step (restarting its epoch at 0, as the JAX loop's
resume does), and ``scripts.eval``, the submission and visualize tools and
``prepare_weights`` restore it. The config's ``model.pretrained_<sub>``
pickles are taken out of the port's ``config.yaml``: their paths are the
JAX machine's, and the checkpoints hold what they seeded (``imported_from``
names them). A ``tpu.conv_impl`` of a TPU tiling (``colres``, ``column``,
``block``) stays as recorded and runs as the gather layout: the weights
interchange. An out dir that already holds a checkpoint is refused. Runs
on CUDA unless ``--cpu`` is given; without a GPU and without ``--cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence

from torch import nn

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.jax_run import read_archive
from d3net_tpu_torch.scripts.train import loop_of


def model_of(cfg: cfg_lib.Config, loop: str) -> nn.Module:
    """The model the run loop ``loop`` trains, its submodules frozen as the
    loop freezes them."""
    from d3net_tpu_torch.train.loop import detector_from_cfg
    from d3net_tpu_torch.train.pipeline import (
        build_vocab, freeze_flags, freeze_submodules, pipeline_from_cfg,
        pipeline_mode,
    )

    if loop != "pipeline":
        return detector_from_cfg(cfg)
    model = pipeline_from_cfg(cfg, build_vocab(cfg)[0])
    freeze_submodules(model, freeze_flags(cfg, pipeline_mode(cfg)))
    return model


def _check_archive(meta: Dict[str, Any], loop: str, model: nn.Module,
                   kw: Dict[str, Any]) -> None:
    """The archive's loop, schedule and frozen labels must be what the
    port's loop of its config gives."""
    if meta["loop"] != loop:
        raise ValueError(f"the archive's loop is {meta['loop']}, its config "
                         f"trains in the {loop} loop")
    sched = meta["schedule"]
    steps = max(1, kw["step_epoch"] * kw["steps_per_epoch"])
    if (sched["optim"], int(sched["transition_steps"])) != (kw["optim"],
                                                            steps):
        raise ValueError(f"the archive's schedule {sched} is not the port's "
                         f"({kw['optim']}, {steps} steps a decay)")
    if loop == "pipeline":
        port = {name: "train" if any(p.requires_grad
                                     for p in sub.parameters()) else "freeze"
                for name, sub in model.named_children()
                if any(True for _ in sub.parameters())}
        if meta["labels"] != port:
            raise ValueError(f"the archive's multi_transform labels "
                             f"{meta['labels']} are not the port's {port}")


def import_run(archive: str, out_dir: str,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Write the port's run dir ``out_dir`` from the run archive
    ``archive`` (see the module's docstring); returns what it wrote: the
    loop, the step of each checkpoint, the archive's sha256."""
    from d3net_tpu_torch.params import flax_to_state_dict, optax_state_to_torch
    from d3net_tpu_torch.train.loop import (
        Checkpointer, optimizer_kw, run_meta_extra, write_run_meta,
    )
    from d3net_tpu_torch.train.pipeline import SUBMODULES
    from d3net_tpu_torch.train.trainer import create_train_state, seek_schedule

    dev = resolve_device(device)
    arc = read_archive(archive)
    meta = arc.meta
    cfg = cfg_lib.Config(cfg_lib.parse_yaml(meta["config_yaml"]) or {})
    pretrained = {}
    for sub in SUBMODULES:
        key = f"pretrained_{sub}"
        if cfg.model.get(key):
            pretrained[key] = cfg.model[key]
            cfg.model[key] = None
    loop = loop_of(cfg)
    model = model_of(cfg, loop).to(dev)
    kw = optimizer_kw(cfg, loop == "scan")
    _check_archive(meta, loop, model, kw)

    ckpt = Checkpointer(out_dir, "none")
    if ckpt.mgr.latest_step() is not None or \
            ckpt.best_mgr.latest_step() is not None:
        raise FileExistsError(f"{out_dir} already holds a checkpoint")
    cfg_lib.save(cfg, os.path.join(out_dir, "config.yaml"))
    for kind, st in arc.steps.items():
        model.load_state_dict(flax_to_state_dict(
            {"params": st.params, "batch_stats": st.batch_stats}, model))
        state = create_train_state(model, **kw)
        count = optax_state_to_torch(st.opt_state, model, state.optimizer)
        seek_schedule(state, st.step if count is None else count)
        state.step = st.step
        mgr = ckpt.mgr if kind == "last" else ckpt.best_mgr
        mgr.save(st.step, Checkpointer._payload(state))
    if "best" in arc.steps and meta["best_json"] is not None:
        with open(os.path.join(out_dir, "ckpt_best", "best.json"), "w") as f:
            json.dump(meta["best_json"], f)
    with open(os.path.join(out_dir, "metrics.jsonl"), "w") as f:
        f.write(meta["metrics_jsonl"])
    last = arc.steps.get("last")
    imported = {"folder": meta["folder"],
                "step": None if last is None else last.step,
                "archive_sha256": arc.sha256, "pretrained": pretrained}
    write_run_meta(out_dir, cfg, {"jax_run_meta": meta["run_meta"],
                                  **run_meta_extra(dev, cfg),
                                  "imported_from": imported})
    return {"out": out_dir, "loop": loop,
            "steps": {k: s.step for k, s in arc.steps.items()},
            "archive_sha256": arc.sha256}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--archive", required=True,
                   help="the run archive (its .npz or .json)")
    p.add_argument("--out", required=True, help="the port's run dir")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch path)")
    args = p.parse_args(argv)
    res = import_run(args.archive, args.out,
                     resolve_device("cpu" if args.cpu else None))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
