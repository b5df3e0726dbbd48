"""Eval entry point of the port (the JAX package's ``scripts/eval.py``).

    python -m d3net_tpu_torch.scripts.eval --folder <run_dir> \
        --task detection [--set KEY=VALUE ...] [--cpu]

Reloads the run dir's ``config.yaml``, restores its best checkpoint (else
its last), runs the detection protocol (mAP and AR at IoU 0.25 and 0.5
over the val scenes) and writes ``eval_detection.json`` stamped with the
checkpoint it used. Runs on CUDA unless ``--cpu`` is given; without a GPU
and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.device import DeviceLike, resolve_device


def eval_detection(cfg: cfg_lib.Config, run_dir: str,
                   device: DeviceLike = None) -> Dict:
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.eval.detection import (
        APCalculator, parse_groundtruths, parse_predictions,
    )
    from d3net_tpu_torch.train.loop import (
        Checkpointer, detector_from_cfg, init_detector, make_dataloaders,
        spec_from_cfg,
    )
    from d3net_tpu_torch.train.trainer import (
        create_train_state, detector_eval_step,
    )

    dev = resolve_device(device)
    spec = spec_from_cfg(cfg)
    model = init_detector(detector_from_cfg(cfg), 0).to(dev)
    _, val_it = make_dataloaders(cfg, spec)
    state = create_train_state(model, lr=cfg.train.optim.lr)
    ckpt = Checkpointer(run_dir, "total_loss", "min")
    if ckpt.restore_weights(state) is None:
        print("WARNING: no checkpoint found, evaluating random weights")
        ckpt_info = {"kind": "none", "step": -1}
    else:
        ckpt_info = dict(ckpt.restored_from or {})
        print(f"evaluating {ckpt_info.get('kind')} checkpoint "
              f"(step {ckpt_info.get('step')})")

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
    print(json.dumps(results, indent=2))
    # the checkpoint that produced this eval is stamped into the file only,
    # keeping the returned metric dict clean
    with open(os.path.join(run_dir, "eval_detection.json"), "w") as f:
        json.dump({**results, "checkpoint": ckpt_info}, f)
    return results


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
    if args.task != "detection":
        item = {"captioning": "13 and 16", "grounding": "14 and 16",
                "scannet": "16"}[args.task]
        raise NotImplementedError(
            f"--task {args.task} is not ported (ROADMAP.md, queue A item "
            f"{item})")
    eval_detection(cfg, args.folder, device)


if __name__ == "__main__":
    main()
