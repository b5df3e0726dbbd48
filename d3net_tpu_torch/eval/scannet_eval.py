"""ScanNet-benchmark predictions and metrics (``eval --task scannet``;
counterpart of ``d3net_tpu/eval/cli.py`` ``eval_scannet_cli``, parity:
``PointGroup.test``, ``model/pointgroup.py:543-625``).

For every val scene the detector's predictions are written in the
official txt tree under ``<run>/split_pred/val``: ``semantic/<scene>.txt``
(a NYU40 class id a point), ``instance/<scene>.txt`` (one line a kept
instance: its mask file, NYU40 class id and score) and
``instance/predicted_masks/<scene>_<rank>.txt`` (a 0/1 a point). Instances
are the proposals of both clustering passes whose score (sigmoid) and
point count pass ``test.TEST_SCORE_THRESH`` / ``TEST_NPOINT_THRESH``,
after greedy mask-IoU NMS at ``test.TEST_NMS_THRESH``; an instance's
class is its points' majority semantic prediction. The same predictions
give mIoU and accuracy (``semantic_iou``) and AP, AP@50 and AP@25
(``InstanceEvaluator``) on the synthetic val split ->
``eval_scannet.json``, stamped with the checkpoint. The model comes from
``scripts.eval.pipeline_for_eval``, which also takes a detector-only
checkpoint (the detector run loops') into the pipeline's detector.

Over ranks (``parallel.mesh.run_world``) each rank runs its rows of every
val batch and writes its own scenes' txt files, which are the files world
1 writes, byte for byte; the confusion matrix is summed over the ranks and
``InstanceEvaluator``'s scenes, their masks packed, are gathered to rank 0
in the global scene order, where the AP is computed.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.parallel import mesh

NYU20_CLASS_IDX = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                   34, 36, 39]


def _write_ints(path: str, values: np.ndarray) -> None:
    """One integer a line: the bytes ``np.savetxt(path, values,
    fmt="%d")`` writes for a 1-D array, without its per-row formatting
    loop (a mask file has a line per point)."""
    with open(path, "w") as f:
        if len(values):
            f.write("\n".join(map(str, values.tolist())) + "\n")


def eval_scannet(cfg, run_dir: str, device: DeviceLike = None,
                 world_size: Optional[int] = None,
                 threads: Optional[int] = None) -> Dict:
    """The txt tree and its metrics -> ``eval_scannet.json``, over
    ``parallel.mesh.run_world(world_size)`` ranks (``threads``: a CPU
    rank's torch threads)."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.eval.segmentation import (
        InstanceEvaluator, semantic_confusion, semantic_iou,
    )
    from d3net_tpu_torch.scripts.eval import (
        _write, pipeline_for_eval, spawned,
    )
    from d3net_tpu_torch.utils.nms import nms_matrix

    dev = resolve_device(device)
    res = spawned(eval_scannet, cfg, run_dir, dev, world_size, threads)
    if res is not None:
        return res
    model, val_it, _, _, ckpt_info = pipeline_for_eval(
        cfg, run_dir, dev, detector_alone=True)
    model.eval()

    pred_root = os.path.join(run_dir, "split_pred", "val")
    sem_dir = os.path.join(pred_root, "semantic")
    inst_dir = os.path.join(pred_root, "instance")
    mask_dir = os.path.join(inst_dir, "predicted_masks")
    for d in (sem_dir, inst_dir, mask_dir):
        os.makedirs(d, exist_ok=True)

    conf = np.zeros((20, 20), np.int64)
    inst_eval = InstanceEvaluator()
    for b, (batch_np, scenes) in enumerate(val_it):
        with mesh.eval_rows(val_it.splits(b)) as mine:
            if not mine:
                continue
            lo, hi = mesh.split_rows(len(scenes))
            scenes = scenes[lo:hi]
            with torch.no_grad():
                out = model.run_detector(batch_to_torch(batch_np, dev))
        out = {k: out[k].float().cpu().numpy() if out[k].is_floating_point()
               else out[k].cpu().numpy()
               for k in ("semantic_scores", "member_pt",
                         "proposal_scores_all", "cluster_mask_all",
                         "cluster_npoint")}
        sem_pred = out["semantic_scores"].argmax(-1)
        member = out["member_pt"]                           # (B, 2, N)
        scores = 1 / (1 + np.exp(-out["proposal_scores_all"]))
        cmask = out["cluster_mask_all"].astype(bool)
        npoint = out["cluster_npoint"]
        pmask = np.asarray(batch_np["point_mask"])
        for i, scene in enumerate(scenes):
            n = int(pmask[i].sum())
            sp = sem_pred[i, :n]
            _write_ints(os.path.join(sem_dir, f"{scene.scene_id}.txt"),
                        np.asarray(NYU20_CLASS_IDX)[sp])
            conf += semantic_confusion(sp, batch_np["sem_labels"][i, :n], 20)

            # proposal point masks + thresholds + matrix NMS (ref :577-601)
            keep = np.where(
                cmask[i] & (scores[i] > cfg.test.TEST_SCORE_THRESH)
                & (npoint[i] > cfg.test.TEST_NPOINT_THRESH))[0]
            masks = np.stack(
                [((member[i, 0, :n] == s) | (member[i, 1, :n] == s))
                 for s in keep]) if len(keep) else np.zeros((0, n), bool)
            preds = []
            if len(keep):
                mf = masks.astype(np.float32)
                inter = mf @ mf.T
                sz = mf.sum(1)
                ious = inter / np.maximum(sz[:, None] + sz[None] - inter, 1e-6)
                pick = nms_matrix(ious, scores[i, keep],
                                  cfg.test.TEST_NMS_THRESH)
                with open(os.path.join(inst_dir, f"{scene.scene_id}.txt"),
                          "w") as f:
                    for rank, pi in enumerate(pick):
                        slot = keep[pi]
                        mask = masks[pi]
                        cls = int(np.bincount(sp[mask], minlength=20).argmax())
                        mpath = (f"predicted_masks/{scene.scene_id}_"
                                 f"{rank:03d}.txt")
                        f.write(f"{mpath} {NYU20_CLASS_IDX[cls]} "
                                f"{scores[i, slot]:.4f}\n")
                        _write_ints(os.path.join(inst_dir, mpath),
                                    mask.astype(np.int32))
                        preds.append((mask, cls, float(scores[i, slot])))
            inst_eval.batch = b
            inst_eval.add_scene(preds, batch_np["instance_ids"][i, :n],
                                batch_np["sem_labels"][i, :n])

    conf = mesh.host_all_gather(conf[None]).sum(0)
    if not mesh.gather_records(inst_eval):
        return mesh.broadcast_from_main({})
    metrics = {**semantic_iou(conf), **inst_eval.compute()}
    metrics.pop("per_class_iou", None)
    _write(run_dir, "scannet", metrics, ckpt_info)
    return mesh.broadcast_from_main(metrics)
