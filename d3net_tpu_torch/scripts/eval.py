"""Eval entry point of the port (the JAX package's ``scripts/eval.py``).

    python -m d3net_tpu_torch.scripts.eval --folder <run_dir> \
        --task detection|captioning|grounding [--set KEY=VALUE ...] [--cpu]

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

The pipeline tasks' checkpoint must hold the whole pipeline: a
detector-only one fails to load; a joint RL run's holds both submodules,
so either task reads its run dir. ``scannet`` is not ported and raises.

Each file is stamped with the checkpoint it used. Runs on CUDA unless
``--cpu`` is given; without a GPU and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device


def restore_for_eval(model: nn.Module, cfg: cfg_lib.Config,
                     run_dir: str) -> Tuple[object, Dict]:
    """``model``'s train state with the run dir's best weights (else its
    last) loaded strictly: (state, checkpoint stamp). With no checkpoint
    it warns and keeps the model's weights."""
    from d3net_tpu_torch.train.loop import Checkpointer
    from d3net_tpu_torch.train.trainer import create_train_state

    state = create_train_state(model, lr=cfg.train.optim.lr)
    ckpt = Checkpointer(run_dir, "total_loss", "min")
    if ckpt.restore_weights(state) is None:
        print("WARNING: no checkpoint found, evaluating random weights")
        return state, {"kind": "none", "step": -1}
    info = dict(ckpt.restored_from or {})
    print(f"evaluating {info.get('kind')} checkpoint (step {info.get('step')})")
    return state, info


def _write(run_dir: str, task: str, results: Dict, ckpt_info: Dict) -> None:
    print(json.dumps(results, indent=2))
    # the checkpoint that produced this eval is stamped into the file only,
    # keeping the returned metric dict clean
    with open(os.path.join(run_dir, f"eval_{task}.json"), "w") as f:
        json.dump({**results, "checkpoint": ckpt_info}, f)


def eval_detection(cfg: cfg_lib.Config, run_dir: str,
                   device: DeviceLike = None) -> Dict:
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.eval.detection import (
        APCalculator, parse_groundtruths, parse_predictions,
    )
    from d3net_tpu_torch.train.loop import (
        detector_from_cfg, init_detector, make_val_loader, spec_from_cfg,
    )
    from d3net_tpu_torch.train.trainer import detector_eval_step

    dev = resolve_device(device)
    spec = spec_from_cfg(cfg)
    model = init_detector(detector_from_cfg(cfg), 0).to(dev)
    val_it = make_val_loader(cfg, spec)
    state, ckpt_info = restore_for_eval(model, cfg, run_dir)

    calcs = {t: APCalculator(t) for t in (0.25, 0.5)}
    for batch_np in val_it:
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
            c.step(preds, gts)
    results = {}
    for t, c in calcs.items():
        m = c.compute_metrics()
        results[f"mAP@{t}"] = m["mAP"]
        results[f"AR@{t}"] = m["AR"]
        results[f"per_class@{t}"] = {
            k: v for k, v in m.items() if k.startswith(("AP_", "Recall_"))
        }
    _write(run_dir, "detection", results, ckpt_info)
    return results


def _pipeline_for_eval(cfg: cfg_lib.Config, run_dir: str, dev):
    """The config's ``PipelineNet`` on ``dev`` with the run dir's weights,
    its val loader, vocabulary, embeddings and checkpoint stamp."""
    from d3net_tpu_torch.params import flax_to_state_dict, init_flax_variables
    from d3net_tpu_torch.train.loop import make_val_loader, spec_from_cfg
    from d3net_tpu_torch.train.pipeline import build_vocab, pipeline_from_cfg

    vocab, emb = build_vocab(cfg)
    model = pipeline_from_cfg(cfg, vocab)
    model.load_state_dict(flax_to_state_dict(init_flax_variables(model, 0),
                                             model))
    model.to(dev)
    val_it = make_val_loader(cfg, spec_from_cfg(cfg), return_scenes=True)
    _, ckpt_info = restore_for_eval(model, cfg, run_dir)
    return model, val_it, vocab, emb, ckpt_info


def eval_captioning(cfg: cfg_lib.Config, run_dir: str,
                    device: DeviceLike = None) -> Dict[str, float]:
    """The JAX package's ``eval_captioning_cli``: mode-1 validation of the
    run dir's pipeline."""
    from d3net_tpu_torch.train.pipeline import run_pipeline_validation

    model, val_it, vocab, emb, ckpt_info = _pipeline_for_eval(
        cfg, run_dir, resolve_device(device))
    metrics = run_pipeline_validation(cfg, model, val_it, vocab, emb, mode=1)
    _write(run_dir, "captioning", metrics, ckpt_info)
    return metrics


def eval_grounding(cfg: cfg_lib.Config, run_dir: str,
                   device: DeviceLike = None) -> Dict[str, float]:
    """The JAX package's ``eval_grounding_cli``: mode-2 validation of the
    run dir's pipeline, each metric the mean of ``eval.repeat`` runs."""
    from d3net_tpu_torch.train.pipeline import run_pipeline_validation

    model, val_it, vocab, emb, ckpt_info = _pipeline_for_eval(
        cfg, run_dir, resolve_device(device))
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
    if args.task == "scannet":
        raise NotImplementedError(
            "--task scannet is not ported (ROADMAP.md, queue A item 16)")
    run = {"detection": eval_detection, "captioning": eval_captioning,
           "grounding": eval_grounding}[args.task]
    run(cfg, args.folder, device)


if __name__ == "__main__":
    main()
