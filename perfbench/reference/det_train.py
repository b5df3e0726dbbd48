"""The plain reference of the detector's first train steps.

It follows the scan trainer's first steps from the benchmark's weights
and scenes with a frozen copy of the port's plain code (``frozen/``: the
numpy voxel tables, the plain row gather, the float32 model, loss and
AdamW), in float32 with TF32 off. It works out the augmented batches, the
voxel tables and the optimizer state again; the step draws (cluster
jitter, proposal shuffle) come from the same seeded generator the
program's step takes.

The clusters are the one stage it takes from the program: which voxels
group together is a discrete decision on the semantic argmax and the
shifted coordinates, which bfloat16 rounding flips at random weights, so
a float32 reference that clusters on its own scores other clusters and
its ScoreNet loss and gradients part from the program's for that reason
alone. The reference therefore follows the program's clusters, and
:func:`cluster_mismatch` checks that stage by itself: the frozen
clustering, run on the program's own clustering inputs, has to give the
program's clusters exactly.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Mapping, Optional

import torch

from perfbench.reference import compare, precision
from perfbench.reference.frozen.data.collate import BatchSpec, batch_to_torch
from perfbench.reference.frozen.data.dataset import BatchIterator
from perfbench.reference.frozen.models.pointgroup import PointGroup
from perfbench.reference.frozen.train.trainer import (
    create_train_state, detector_train_step,
)


def spec(cfg: Mapping[str, Any]) -> BatchSpec:
    d, m, t = cfg["data"], cfg["model"], cfg["tpu"]
    return BatchSpec(
        max_points=d["max_num_point"], voxel_caps=list(t["voxel_caps"]),
        max_instances=d["max_num_instance"], scale=d["scale"],
        full_scale=float(d["full_scale"][1]), use_color=m["use_color"],
        use_normal=m["use_normal"], use_multiview=m["use_multiview"],
        num_levels=len(m["blocks"]), conv_impl="gather")


def model_kwargs(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """PointGroup's arguments, in float32 whatever the config computes in."""
    m, c, t, tr, te = (cfg["model"], cfg["cluster"], cfg["tpu"],
                       cfg["train"], cfg["test"])
    return dict(
        m=m["m"], classes=cfg["data"]["classes"], blocks=tuple(m["blocks"]),
        cluster_blocks=tuple(m["cluster_blocks"]),
        block_reps=m["block_reps"], block_residual=m["block_residual"],
        use_coords=m["use_coords"], max_num_proposal=m["max_num_proposal"],
        cluster_radius=c["cluster_radius"],
        cluster_cell_size=t["cluster_cell_size"],
        cluster_ring=t["cluster_ring"],
        cluster_npoint_thre=c["cluster_npoint_thre"],
        cluster_prop_iters=t["cluster_prop_iters"],
        clusters_per_pass=t["clusters_per_pass"],
        score_fullscale=tr["score_fullscale"], score_scale=tr["score_scale"],
        test_score_thresh=te["TEST_SCORE_THRESH"],
        test_npoint_thresh=te["TEST_NPOINT_THRESH"], compute_dtype=None)


def optimizer_kwargs(cfg: Mapping[str, Any], steps_per_epoch: int
                     ) -> Dict[str, Any]:
    o = cfg["train"]["optim"]
    return dict(lr=o["lr"], optim=o["classname"],
                weight_decay=o["weight_decay"],
                step_epoch=cfg["train"]["step_epoch"],
                multiplier=cfg["train"]["multiplier"],
                steps_per_epoch=steps_per_epoch)


def _rows(tree, n: int):
    """The first ``n`` scenes of a device batch."""
    if isinstance(tree, dict):
        return {k: _rows(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, n) for v in tree]
    return tree[:n]


def follow(cfg: Mapping[str, Any], scenes: List[Any], batch_size: int,
           shuffle_seed: int, step_seed: int,
           start: Mapping[str, torch.Tensor], steps_per_epoch: int,
           device: torch.device, steps: int = 3,
           product_dtype: Optional[torch.dtype] = None,
           fault: Optional[str] = None,
           clusters: Optional[List[Dict[str, list]]] = None,
           compute_dtype: Optional[str] = None,
           loss_weight: Optional[tuple] = None) -> Dict[str, Any]:
    """The first ``steps`` steps: their total losses, the first gradient's
    leaf norms and each leaf's change after the last step.

    ``product_dtype`` rounds the products' operands (the control);
    ``fault="half_batch"`` runs each step on the first half of its batch,
    the mean taken over the rest (a planted fault). ``clusters`` (one
    record a step: the program's clustering inputs and outputs) replaces
    the clustering's decisions with the program's. ``compute_dtype``
    (``"bfloat16"``) runs the frozen model in the program's activation
    type under PyTorch's default flags: a witness of what that type alone
    does to the numbers, not a reference. ``loss_weight`` replaces the
    configuration's (a witness too). The result's ``offsets`` holds the
    first step's smallest predicted offset norms over the instance points
    (the offset direction loss's gradient goes as their inverse)."""
    cfg = copy.deepcopy(cfg)
    sp = spec(cfg)
    tr = cfg["data"]["transform"]
    it = BatchIterator(scenes, sp, batch_size, shuffle=True,
                       augment=bool(tr["jitter"] or tr["flip"] or tr["rot"]),
                       elastic=bool(cfg["data"].get("elastic", False)),
                       seed=shuffle_seed, prefetch=0, workers=1)
    per_epoch = len(it)
    in_ch = sp.feat_dim() + 3 * bool(cfg["model"]["use_coords"])
    model = PointGroup(in_ch, **dict(model_kwargs(cfg),
                                     compute_dtype=compute_dtype)).to(device)
    model.load_state_dict(start)
    if clusters is not None:
        taken = iter(clusters)
        half = fault == "half_batch"

        def program_clusters(*_):
            out = [o.to(device) for o in next(taken)["outputs"]]
            return [o[:batch_size // 2] for o in out] if half else out

        model._cluster_batch = program_clusters
    state = create_train_state(model,
                               **optimizer_kwargs(cfg, steps_per_epoch))
    lw = tuple(loss_weight or cfg["train"]["loss_weight"][:4])
    offsets: Dict[str, float] = {}
    losses, grads, first = [], None, {}
    plain = (precision.plain_f32() if compute_dtype is None
             else contextlib.nullcontext())
    with plain, precision.products(product_dtype):
        for s in range(steps):
            # the stack holds augmented epoch after epoch
            it.epoch = s // per_epoch
            batch = batch_to_torch(it._build_one(it._order(), s % per_epoch),
                                   device)
            if compute_dtype in ("bfloat16", "bf16"):
                # as the program's stack holds them
                batch["point_feats"] = batch["point_feats"].to(
                    torch.bfloat16)
            if fault == "half_batch":
                batch = _rows(batch, batch_size // 2)
            elif fault is not None:
                raise ValueError(f"unknown fault {fault}")
            gen = torch.Generator(device=device).manual_seed(
                (int(step_seed) << 32) + s)
            if s == 0:
                inner = model.forward

                def first_call(*a, **k):
                    out = inner(*a, **k)
                    first.update({n: out[n].detach().float().clone()
                                  for n in ("semantic_scores", "pt_offsets")})
                    inst = (batch["point_mask"].bool()
                            & (batch["instance_ids"] >= 0))
                    n = first["pt_offsets"].norm(dim=-1)[inst].double()
                    offsets.update(min=float(n.min()),
                                   under_1e_3=int((n < 1e-3).sum()),
                                   under_1e_2=int((n < 1e-2).sum()),
                                   median=float(n.median()),
                                   points=int(n.numel()))
                    return out

                model.forward = first_call
            _, m = detector_train_step(state, batch, gen, loss_weight=lw)
            if s == 0:
                del model.forward
            losses.append(m["total_loss"])
            if s == 0:
                grads = {k: v.clone() for k, v in
                         compare.first_grads(model, state.optimizer).items()}
    out = {"losses": [float(v) for v in torch.stack(losses).tolist()],
           "grads": grads, "changes": compare.changes(model, start),
           "forward": first, "offsets": offsets}
    del state, model
    return out


def cluster_mismatch(cfg: Mapping[str, Any],
                     clusters: Optional[List[Dict[str, list]]],
                     device: torch.device) -> float:
    """Share of the recorded clustering outputs (members and slot masks of
    every step) that the frozen clustering, run on the program's own
    clustering inputs, gives otherwise; 0 where they agree exactly."""
    if not clusters:
        return float("inf")
    sp = spec(cfg)
    in_ch = sp.feat_dim() + 3 * bool(cfg["model"]["use_coords"])
    model = PointGroup(in_ch, **model_kwargs(cfg))
    bad = total = 0
    with precision.plain_f32():
        for rec in clusters:
            ins = [a.to(device) for a in rec["inputs"]]
            got = PointGroup._cluster_batch(model, *ins)
            for g, w in zip(got[:2], rec["outputs"][:2]):
                bad += int((g.cpu() != w).sum())
                total += w.numel()
    return bad / max(total, 1)
