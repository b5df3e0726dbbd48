"""Eval entry point of the port (the JAX package's ``scripts/eval.py``).

    python -m d3net_tpu_torch.scripts.eval --folder <run_dir> \
        --task detection|captioning|grounding|scannet [--set KEY=VALUE ...] \
        [--cpu]

Reloads the run dir's ``config.yaml``, restores its best checkpoint (else
its last; with none it warns and evaluates random weights) and runs the
task's protocol over the val scenes:

- ``detection``: mAP and AR at IoU 0.25 and 0.5 -> ``eval_detection.json``;
- ``captioning``: the detector -> speaker pipeline captions every proposal
  greedily, scored as CIDEr, BLEU-4, ROUGE-L and METEOR at
  ``eval.min_iou_threshold`` (METEOR is 0.0 where nltk is absent) ->
  ``eval_captioning.json``;
- ``grounding``: the detector -> listener pipeline grounds every
  description row of the val scenes, scored as Acc@0.25/0.5
  (``ref_iou_rate_*``) and the mean IoU, with the unique/multiple and
  others breakdown, averaged over ``eval.repeat`` runs ->
  ``eval_grounding.json``.

- ``scannet``: the detector's ScanNet-benchmark txt tree under
  ``split_pred/val`` and its mIoU, accuracy, AP, AP@50 and AP@25 ->
  ``eval_scannet.json`` (``eval/scannet_eval.py``).

The captioning and grounding tasks' checkpoint must hold the whole
pipeline: a detector-only one fails to load; a joint RL run's holds both
submodules, so either task reads its run dir. ``scannet`` reads a
pipeline's or a detector run's checkpoint.

Each file is stamped with the checkpoint it used. Runs on CUDA unless
``--cpu`` is given; without a GPU and without ``--cpu`` it raises.

On CUDA the eval uses every usable card, as the train entry does: the
largest count of the visible cards that divides ``data.batch_size`` (a
warning names the cards left idle), one spawned process a card, joined
over NCCL; with one usable card it runs in this process with no process
group. Each rank restores the checkpoint and runs its rows of every val
batch (a short last batch the ranks cannot split runs on rank 0 alone);
the evaluators' records are gathered to rank 0 in the global scene order,
rank 0 computes the metrics and alone writes files (``--task scannet``:
each rank writes its own scenes' txt files). The result equals the
one-card eval's wherever the forward reproduces itself: on the CPU, and on
the card under ``device.parity_precision()`` with deterministic
algorithms (at the default settings a bf16 detector's forward differs
from run to run already). Under ``torchrun`` each launched process is one
rank:

    torchrun --nproc_per_node=4 -m d3net_tpu_torch.scripts.eval \
        --folder <run_dir> --task detection

``--cpu`` is one process.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.parallel import mesh


def restore_for_eval(model: nn.Module, cfg: cfg_lib.Config,
                     run_dir: str, detector_alone: bool = False
                     ) -> Tuple[object, Dict]:
    """``model``'s train state with the run dir's best weights (else its
    last) loaded strictly: (state, checkpoint stamp). With no checkpoint
    it warns and keeps the model's weights. With ``detector_alone``, a
    checkpoint that holds a detector alone (the detector run loops') loads
    into the pipeline's ``detector``, and the state is the detector's."""
    from d3net_tpu_torch.train.loop import Checkpointer
    from d3net_tpu_torch.train.trainer import create_train_state

    ckpt = Checkpointer(run_dir, "total_loss", "min")
    if detector_alone and _holds_detector_alone(ckpt):
        model = model.detector
    state = create_train_state(model, lr=cfg.train.optim.lr)
    if ckpt.restore_weights(state) is None:
        if mesh.is_main():
            print("WARNING: no checkpoint found, evaluating random weights")
        return state, {"kind": "none", "step": -1}
    info = dict(ckpt.restored_from or {})
    if mesh.is_main():
        print(f"evaluating {info.get('kind')} checkpoint "
              f"(step {info.get('step')})")
    return state, info


def _holds_detector_alone(ckpt) -> bool:
    """Whether the checkpoint ``restore_weights`` would read (best, else
    last) is a detector's alone: no ``detector.`` prefix on its keys."""
    for mgr in (ckpt.best_mgr, ckpt.mgr):
        step = mgr.latest_step()
        if step is not None:
            return not any(k.startswith("detector.")
                           for k in mgr.restore(step)["model"])
    return False


def _write(run_dir: str, task: str, results: Dict, ckpt_info: Dict) -> None:
    """``eval_<task>.json`` (rank 0 alone writes under a process group)."""
    if not mesh.is_main():
        return
    print(json.dumps(results, indent=2))
    # the checkpoint that produced this eval is stamped into the file only,
    # keeping the returned metric dict clean
    with open(os.path.join(run_dir, f"eval_{task}.json"), "w") as f:
        json.dump({**results, "checkpoint": ckpt_info}, f)


def spawned(fn: Callable[..., Any], cfg: cfg_lib.Config, run_dir: str,
            dev, world_size: Optional[int], threads: Optional[int],
            **kw) -> Optional[Any]:
    """``fn(cfg, run_dir, device, **kw)`` (a module-level function: an eval
    task or a tool) over ``mesh.run_world`` ranks where that is more than
    one (each a process on its own card, or a gloo process of ``threads``
    threads on the CPU): rank 0's result; None where ``fn`` is to run in
    this process."""
    n = mesh.run_world(int(cfg.data.batch_size), dev, world_size)
    if n == 1:
        return None
    return mesh.spawn_ranks(_rank_entry, n, fn, cfg, run_dir, dev.type, kw,
                            dev=dev, threads=threads)[0]


def _rank_entry(fn: Callable[..., Any], cfg: cfg_lib.Config, run_dir: str,
                device_type: str, kw: Dict[str, Any]) -> Any:
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    return fn(cfg, run_dir, dev, **kw)


def run_entry(fn: Callable[..., Any], cfg: cfg_lib.Config, run_dir: str,
              device: torch.device, cpu: bool, **kw) -> Any:
    """A command line's ``fn(cfg, run_dir, device, **kw)``: in this process
    with ``--cpu``; under ``torchrun`` (``WORLD_SIZE`` set) this process is
    one rank of the launcher's group, on its ``LOCAL_RANK`` card; else over
    every usable card (``fn``'s own spawn)."""
    if cpu:
        return fn(cfg, run_dir, device, **kw)
    launched = mesh.init_multihost()
    if launched["process_count"] > 1:
        mesh.make_mesh(int(cfg.data.batch_size))
        try:
            return fn(cfg, run_dir, torch.device(
                "cuda", torch.cuda.current_device()), **kw)
        finally:
            mesh.teardown()
    return fn(cfg, run_dir, device, **kw)


def tasks() -> Dict[str, Callable[..., Dict]]:
    """The eval CLI's task functions by name."""
    from d3net_tpu_torch.eval.scannet_eval import eval_scannet

    return {"detection": eval_detection, "captioning": eval_captioning,
            "grounding": eval_grounding, "scannet": eval_scannet}


def eval_detection(cfg: cfg_lib.Config, run_dir: str,
                   device: DeviceLike = None,
                   world_size: Optional[int] = None,
                   threads: Optional[int] = None) -> Dict:
    """mAP and AR at IoU 0.25 and 0.5 over the val scenes ->
    ``eval_detection.json``; over ``mesh.run_world(world_size)`` ranks
    (``threads``: a CPU rank's torch threads)."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.eval.detection import (
        APCalculator, parse_groundtruths, parse_predictions,
    )
    from d3net_tpu_torch.train.loop import (
        detector_from_cfg, init_detector, make_val_loader, spec_from_cfg,
    )
    from d3net_tpu_torch.train.trainer import detector_eval_step

    dev = resolve_device(device)
    res = spawned(eval_detection, cfg, run_dir, dev, world_size, threads)
    if res is not None:
        return res
    spec = spec_from_cfg(cfg)
    model = init_detector(detector_from_cfg(cfg), 0).to(dev)
    val_it = make_val_loader(cfg, spec)
    state, ckpt_info = restore_for_eval(model, cfg, run_dir)

    calcs = {t: APCalculator(t) for t in (0.25, 0.5)}
    for b, batch_np in enumerate(val_it):
        with mesh.eval_rows(val_it.splits(b)) as mine:
            if not mine:
                continue
            # the losses' normalisers are global: every rank runs every
            # split batch
            out, _ = detector_eval_step(state, batch_to_torch(batch_np, dev))
        preds = parse_predictions(
            *(out[k].cpu().numpy() for k in (
                "proposal_bbox_batched", "proposal_sem_cls_batched",
                "proposal_scores_batched", "proposal_batch_mask")),
            nms_iou=0.25,
            conf_thresh=cfg.test.TEST_SCORE_THRESH,
        )
        gts = parse_groundtruths(
            batch_np["center_label"],
            batch_np["size_label"],
            batch_np["sem_cls_label"],
            batch_np["gt_box_mask"],
        )
        for c in calcs.values():
            c.batch = b
            c.step(preds, gts)
    results = {}
    if not mesh.gather_records(*calcs.values()):
        return mesh.broadcast_from_main(results)
    for t, c in calcs.items():
        m = c.compute_metrics()
        results[f"mAP@{t}"] = m["mAP"]
        results[f"AR@{t}"] = m["AR"]
        results[f"per_class@{t}"] = {
            k: v for k, v in m.items() if k.startswith(("AP_", "Recall_"))
        }
    _write(run_dir, "detection", results, ckpt_info)
    return mesh.broadcast_from_main(results)


def pipeline_for_eval(cfg: cfg_lib.Config, run_dir: str, dev,
                       detector_alone: bool = False):
    """The config's ``PipelineNet`` on ``dev`` with the run dir's weights
    (``restore_for_eval``'s ``detector_alone``), its val loader,
    vocabulary, embeddings and checkpoint stamp."""
    from d3net_tpu_torch.params import flax_to_state_dict, init_flax_variables
    from d3net_tpu_torch.train.loop import make_val_loader, spec_from_cfg
    from d3net_tpu_torch.train.pipeline import build_vocab, pipeline_from_cfg

    vocab, emb = build_vocab(cfg)
    model = pipeline_from_cfg(cfg, vocab)
    model.load_state_dict(flax_to_state_dict(init_flax_variables(model, 0),
                                             model))
    model.to(dev)
    val_it = make_val_loader(cfg, spec_from_cfg(cfg), return_scenes=True)
    _, ckpt_info = restore_for_eval(model, cfg, run_dir, detector_alone)
    return model, val_it, vocab, emb, ckpt_info


def eval_captioning(cfg: cfg_lib.Config, run_dir: str,
                    device: DeviceLike = None,
                    world_size: Optional[int] = None,
                    threads: Optional[int] = None) -> Dict[str, float]:
    """The JAX package's ``eval_captioning_cli``: mode-1 validation of the
    run dir's pipeline, over ``mesh.run_world(world_size)`` ranks."""
    from d3net_tpu_torch.train.pipeline import run_pipeline_validation

    dev = resolve_device(device)
    res = spawned(eval_captioning, cfg, run_dir, dev, world_size, threads)
    if res is not None:
        return res
    model, val_it, vocab, emb, ckpt_info = pipeline_for_eval(
        cfg, run_dir, dev)
    metrics = run_pipeline_validation(cfg, model, val_it, vocab, emb, mode=1)
    _write(run_dir, "captioning", metrics, ckpt_info)
    return metrics


def eval_grounding(cfg: cfg_lib.Config, run_dir: str,
                   device: DeviceLike = None,
                   world_size: Optional[int] = None,
                   threads: Optional[int] = None) -> Dict[str, float]:
    """The JAX package's ``eval_grounding_cli``: mode-2 validation of the
    run dir's pipeline, each metric the mean of ``eval.repeat`` runs, over
    ``mesh.run_world(world_size)`` ranks."""
    from d3net_tpu_torch.train.pipeline import run_pipeline_validation

    dev = resolve_device(device)
    res = spawned(eval_grounding, cfg, run_dir, dev, world_size, threads)
    if res is not None:
        return res
    model, val_it, vocab, emb, ckpt_info = pipeline_for_eval(
        cfg, run_dir, dev)
    runs: Dict[str, list] = {}
    for _ in range(int(cfg.eval.get("repeat", 1))):
        m = run_pipeline_validation(cfg, model, val_it, vocab, emb, mode=2)
        for k, v in m.items():
            runs.setdefault(k, []).append(v)
    metrics = {k: float(np.mean(v)) for k, v in runs.items()}
    _write(run_dir, "grounding", metrics, ckpt_info)
    return metrics


def apply_overrides(cfg: cfg_lib.Config, sets: Sequence[str]) -> None:
    """``KEY=VALUE`` overrides of dotted config keys (int, float, bool or
    string values)."""
    for kv in sets:
        key, _, val = kv.partition("=")
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node[p]
        old = node.get(parts[-1])
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        if isinstance(val, str) and val.lower() in ("true", "false"):
            val = val.lower() == "true"
        node[parts[-1]] = val
        print(f"config override: {key} = {val!r} (was {old!r})")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--folder", required=True)
    parser.add_argument(
        "--task", required=True,
        choices=["detection", "captioning", "grounding", "scannet"])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain PyTorch path)")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override a dotted config key for this eval only, e.g. "
             "--set test.TEST_SCORE_THRESH=0.2")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = cfg_lib.load(os.path.join(args.folder, "config.yaml"))
    apply_overrides(cfg, args.set)
    run_entry(tasks()[args.task], cfg, args.folder, device, args.cpu)


if __name__ == "__main__":
    main()
