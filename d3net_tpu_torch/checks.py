"""The speaker, the listener, the joint RL step, ENet and the submission
tools on cuda against the same on cpu, and the data-parallel steps' rank
workers and their comparisons (the end of the file), shared by
``chip_smoke.py``
(phases ``caption_parity``, ``spk_train_parity``, ``grounding_parity``,
``lis_train_parity``, ``joint_parity``, ``enet_parity``, ``tools_parity``)
and the card tests
``tests/test_torch_cuda.py::test_speaker_cuda_matches_cpu``,
``test_speaker_train_step_cuda_matches_cpu``,
``test_listener_cuda_matches_cpu``,
``test_listener_train_step_cuda_matches_cpu``,
``test_joint_step_cuda_matches_cpu``, ``test_enet_cuda_matches_cpu`` and
``test_tools_cuda_matches_cpu``.

The greedy decode is a chain of argmaxes: where f32 sums reorder on the
card, a near-tie can flip a token and the rest of its row with it. So the
ids must be equal, and each device's logits are compared teacher-forced on
the cpu's ids (``teacher_forced_logits``), which keeps one flip from
hiding or causing every later difference. For a row whose ids differ the
report gives the cpu's top-2 margin at the first difference.

A train step's gradients go through every ReLU, and an input within float
noise of 0 can fall on either side when sums run in another order: the
cuda step takes each ReLU's side from the cpu step (``relu_sides``).

The joint step's rollout is a beam search: where a row's ids differ
between the devices, ``joint_step_cuda_vs_cpu`` reports the cpu's top-2
margin at the first difference and runs both steps on the cpu's rollout.

The listener's backward into the detector is ill-conditioned in f32:
moving every weight by one ulp moves a few gradient elements by more than
the gradient tolerance. So ``listener_step_cuda_vs_cpu`` also runs the cpu
step on weights moved by one ulp (``ulp_moved``), and a gradient element
outside the tolerance passes only where the cuda-cpu difference is within
``ulp_factor`` times that element's own one-ulp movement, for under 1% of
any tensor (``grad_mismatches``). The biases that only shift a train-mode
BatchNorm's input (``BN_FED_BIASES``) have a zero gradient: there both
devices' noise must stay under 1e-5 of the largest gradient.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from d3net_tpu_torch import device
from d3net_tpu_torch.params import flatten, load_pipeline, state_dict_to_flax

SPEAKER_INTS = ("adjacent_mat", "local_ids", "local_mask")
SPEAKER_FLOATS = ("bbox_feature", "edge_feature", "edge_orientations")
LISTENER_FLOATS = ("cluster_ref", "lang_scores", "lang_emb", "lang_hiddens")
# the listener's biases that add a constant to a train-mode BatchNorm's
# input, which the batch mean takes out
BN_FED_BIASES = tuple(f"listener.match.{n}.bias" for n in (
    "feat_fc1", "match_fc1", "match_fc2", "cross_attn_1.LayerNorm_0"))


def teacher_forced_logits(caption, embeddings, target_feat, obj_feats,
                          valid_masks, ids: torch.Tensor) -> torch.Tensor:
    """``greedy_decode``'s rollout with step t reading ``ids[:, t-1]`` (sos
    at t = 0) in place of its own previous pick -> logits (N, T, V)."""
    n = target_feat.shape[0]
    feat_proj = caption.map_feat(obj_feats)
    h = target_feat.new_zeros(n, caption.hidden_size)
    hiddens = (h, h)
    words = torch.cat([ids.new_full((n, 1), caption.sos_id), ids[:, :-1]],
                      1).long()
    out = []
    for t in range(ids.shape[1]):
        logits, hiddens, _ = caption.step(hiddens, embeddings[words[:, t]],
                                          target_feat, obj_feats, valid_masks,
                                          feat_proj)
        out.append(logits)
    return torch.stack(out, 1)


def speaker_cuda_vs_cpu(variables, cfg, vocab, data: Dict[str, np.ndarray],
                        rtol: float = 1e-4, atol: float = 1e-5
                        ) -> Dict[str, Any]:
    """The pipeline's speaker of ``variables`` in eval mode on ``data``
    (proposals and ``glove_embeddings``, numpy) on cpu and on cuda, inside
    ``device.parity_precision()``. The cuda decode runs once more under
    CUDA's sync debug mode "error", so a host sync in its loop raises.
    ``ok`` is true when the graph's integers and the ids are equal and
    every float output is within ``rtol``/``atol``."""
    outs, logits = {}, {}
    with device.parity_precision(), torch.no_grad():
        for dev in ("cpu", "cuda"):
            spk = load_pipeline(variables, cfg, vocab, device=dev).speaker
            out = spk({k: torch.from_numpy(v).to(dev) for k, v in data.items()},
                      mode="eval")
            inputs = spk.caption.eval_inputs(out)
            emb = out["glove_embeddings"]
            if dev == "cpu":
                cpu_ids = out["lang_cap"].flatten(0, 1)
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    spk.caption.greedy_decode(emb, *inputs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            logits[dev] = teacher_forced_logits(spk.caption, emb, *inputs,
                                                cpu_ids.to(dev)).cpu()
            outs[dev] = {k: v.cpu() for k, v in out.items()}
    cpu, gpu = outs["cpu"], outs["cuda"]
    ints = {k: bool(torch.equal(cpu[k], gpu[k])) for k in SPEAKER_INTS}
    pairs = {k: (gpu[k], cpu[k]) for k in SPEAKER_FLOATS}
    pairs["teacher_forced_logits"] = (logits["cuda"], logits["cpu"])
    errs = {k: float((g - c).abs().max()) for k, (g, c) in pairs.items()}
    bad = [k for k, (g, c) in pairs.items()
           if not torch.allclose(g, c, rtol=rtol, atol=atol)]
    ids_c, ids_g = cpu["lang_cap"].flatten(0, 1), gpu["lang_cap"].flatten(0, 1)
    rows = (ids_c != ids_g).any(1).nonzero()[:, 0].tolist()
    margins = []
    for r in rows[:10]:
        t = int((ids_c[r] != ids_g[r]).nonzero()[0, 0])
        top2 = logits["cpu"][r, t].topk(2).values
        margins.append({"row": r, "step": t,
                        "cpu_top2_margin": float(top2[0] - top2[1])})
    return {"ok": all(ints.values()) and not bad and not rows,
            "rows": int(ids_c.shape[0]), "steps": int(ids_c.shape[1]),
            "integers_equal": ints, "max_abs_err": errs,
            "outside_tolerance": bad, "ids_equal": not rows,
            "rows_differing": len(rows), "first_difference": margins,
            "distinct_words": int(torch.unique(ids_c).numel()),
            "rtol": rtol, "atol": atol}


@contextlib.contextmanager
def relu_sides(ref: List[torch.Tensor], record: bool):
    """Stands in for ``F.relu`` for one train step. ``record``: keeps each
    call's input (the reference step, on the cpu). Otherwise each call
    takes the side of the kink the reference's input took (``x * (ref >
    0)``), and the yielded dict counts the inputs whose own side differs
    and the largest of those inputs, relative to the call's largest input.

    An input within float noise of 0 can land on either side of the kink
    when sums run in another order, and that one element's gradient then
    reaches every layer before it (seen on the card: one ScoreNet element
    at 1e-8 on the cpu, -1e-7 on cuda). Following the reference's side
    keeps the gradients comparable; the caller bounds the crossings."""
    real = F.relu
    calls = iter(ref)
    seen = {"crossings": 0, "largest": 0.0}

    def relu(x, inplace=False):
        if record:
            ref.append(x.detach().clone())
            return real(x, inplace)
        want = next(calls).to(x.device)
        side = want > 0
        cross = side != (x.detach() > 0)
        if bool(cross.any()):
            size = max(float(want.abs().max()), 1e-30)
            near = torch.maximum(want[cross].abs(), x.detach()[cross].abs())
            seen["crossings"] += int(cross.sum())
            seen["largest"] = max(seen["largest"], float(near.max()) / size)
        return x * side

    F.relu = relu
    try:
        yield seen
    finally:
        F.relu = real
    if not record and next(calls, None) is not None:
        raise AssertionError("the step made fewer ReLU calls than the "
                             "reference")


def randomize(tree, rng: np.random.Generator):
    """Nonzero biases and BN statistics and unequal PReLU slopes in a Flax
    tree of numpy leaves (in place; Flax starts biases and means at 0,
    scales and variances at 1, slopes at 0.25)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            randomize(v, rng)
        elif k in ("bias", "mean"):
            tree[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "alpha":
            tree[k] = rng.uniform(0.1, 0.4, v.shape).astype(np.float32)
    return tree


def rot_z(theta: np.ndarray) -> np.ndarray:
    """Rotations about z by ``theta`` -> (..., 3, 3) f32."""
    c, s = np.cos(theta), np.sin(theta)
    out = np.zeros(theta.shape + (3, 3), np.float32)
    out[..., 0, 0], out[..., 0, 1] = c, -s
    out[..., 1, 0], out[..., 1, 1] = s, c
    out[..., 2, 2] = 1.0
    return out


def speaker_step_case(cfg, vocab, seed: int = 0) -> Dict[str, Any]:
    """One mode-1 train step's inputs at ``cfg``'s widths (numpy): the
    first batch of its train loader with seeded object rotations about z
    (so the orientation loss runs), its description rows, random weights
    with nonzero biases and BN statistics, and the jitter, proposal
    permutation and Gumbel draws."""
    from d3net_tpu_torch.data.language import build_lang_batch
    from d3net_tpu_torch.params import init_flax_variables
    from d3net_tpu_torch.train.loop import make_dataloaders, spec_from_cfg
    from d3net_tpu_torch.train.pipeline import pipeline_from_cfg

    spec = spec_from_cfg(cfg)
    train_it, _ = make_dataloaders(cfg, spec, return_scenes=True)
    batch_np, scenes = next(iter(train_it))
    rng = np.random.default_rng(seed)
    b, i = batch_np["center_label"].shape[:2]
    batch_np["scene_object_rotations"] = rot_z(rng.uniform(-np.pi, np.pi,
                                                           (b, i)))
    batch_np["scene_object_rotation_masks"] = (rng.random((b, i)) < 0.8
                                               ).astype(np.float32)
    chunk = int(cfg.data.num_des_per_scene)
    lang_np = build_lang_batch(scenes, vocab, chunk, cfg.data.max_spk_len,
                               np.random.default_rng(seed),
                               spec.max_instances, apply_word_erase=True)
    variables = randomize(init_flax_variables(pipeline_from_cfg(cfg, vocab),
                                              seed), rng)
    k = cfg.model.max_num_proposal
    return {"batch": batch_np, "scenes": scenes, "lang": lang_np,
            "variables": variables, "chunk": chunk,
            "jitter": rng.random((b, 2 * cfg.tpu.clusters_per_pass, 3)
                                 ).astype(np.float32),
            "perm": rng.permutation(k).astype(np.int64),
            "gumbel": rng.gumbel(size=(b * chunk, k)).astype(np.float32)}


def speaker_step_cuda_vs_cpu(cfg, vocab, emb, case: Dict[str, Any],
                             freeze_detector: bool, loss_rtol: float = 1e-4,
                             grad_rtol: float = 1e-3, grad_atol: float = 1e-6,
                             bn_rtol: float = 1e-4, bn_atol: float = 1e-5,
                             kink_noise: float = 1e-5) -> Dict[str, Any]:
    """One ``speaker_train_step`` of ``case`` (``speaker_step_case``) on cpu
    and on cuda inside ``device.parity_precision()``, the same injected
    draws, the cuda step on the cpu step's ReLU sides: losses, every
    gradient and the new BN statistics within their tolerances, and the
    target ids and good-box masks of the same draws equal. ``ok`` when all
    hold and no ReLU input that changed side lies beyond ``kink_noise``
    (relative) of the kink. Also the cuda step's ``gather_rows``
    launches (a frozen detector runs no backward gathers)."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.train.pipeline import (
        freeze_submodules, lang_rows, speaker_losses, speaker_train_step,
    )
    from d3net_tpu_torch.train.trainer import create_train_state

    lw = tuple(cfg.train.loss_weight[:4])
    o = cfg.train.optim
    res, relu_ref = {}, []
    with device.parity_precision():
        for dev in ("cpu", "cuda"):
            model = load_pipeline(case["variables"], cfg, vocab, device=dev)
            freeze_submodules(model, {"detector": freeze_detector})
            state = create_train_state(model, lr=o.lr, optim=o.classname,
                                       weight_decay=o.weight_decay)
            batch = batch_to_torch(case["batch"], dev)
            lang = lang_rows(case["lang"], emb, dev)
            kw = dict(chunk_size=case["chunk"], loss_weight=lw,
                      jitter_u=torch.from_numpy(case["jitter"]).to(dev),
                      proposal_perm=torch.from_numpy(case["perm"]).to(dev)[None],
                      gumbel=torch.from_numpy(case["gumbel"]).to(dev))
            before = gather.gather_rows.launches
            with relu_sides(relu_ref, dev == "cpu") as kinks:
                _, metrics = speaker_train_step(state, batch, lang, **kw)
            launches = gather.gather_rows.launches - before
            fresh = load_pipeline(case["variables"], cfg, vocab, device=dev)
            with torch.no_grad():
                _, _, data = speaker_losses(fresh, batch, lang, **kw)
            res[dev] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": flatten(state_dict_to_flax(model, {
                    n: p.grad for n, p in model.named_parameters()
                    if p.grad is not None})["params"]),
                "stats": flatten(state_dict_to_flax(model)["batch_stats"]),
                "ints": {k: data[k].cpu() for k in ("target_ids",
                                                    "good_bbox_masks")},
                "kinks": kinks, "launches": launches}
    cpu, gpu = res["cpu"], res["cuda"]
    bad = [k for k, want in cpu["metrics"].items()
           if not np.isclose(gpu["metrics"][k], want, rtol=loss_rtol, atol=0)]
    if set(gpu["grads"]) != set(cpu["grads"]):
        bad.append("grad:keys")
    for name, group, rtol, atol in (("grad", "grads", grad_rtol, grad_atol),
                                    ("bn", "stats", bn_rtol, bn_atol)):
        for k, want in cpu[group].items():
            if not np.allclose(gpu[group].get(k, np.nan), want, rtol=rtol,
                               atol=atol):
                bad.append(f"{name}:{k}")
    ints = {k: bool(torch.equal(gpu["ints"][k], v))
            for k, v in cpu["ints"].items()}
    kinks = gpu["kinks"]
    if kinks["largest"] > kink_noise:
        bad.append("relu_kink_crossing")
    return {"ok": not bad and all(ints.values()),
            "freeze_detector": freeze_detector,
            "losses_cpu": cpu["metrics"], "losses_cuda": gpu["metrics"],
            "gradients": len(cpu["grads"]),
            "grad_max_abs_err": max(float(np.abs(gpu["grads"][k] - v).max())
                                    for k, v in cpu["grads"].items()
                                    if k in gpu["grads"]),
            "bn_max_abs_err": max(float(np.abs(gpu["stats"][k] - v).max())
                                  for k, v in cpu["stats"].items()),
            "integers_equal": ints,
            "good_rows": int(cpu["ints"]["good_bbox_masks"].sum()),
            "relu_kink_crossings": kinks, "outside_tolerance": bad,
            "gather_launches_cuda": gpu["launches"],
            "gather_launches_cpu": cpu["launches"]}


def listener_step_case(cfg, vocab, emb, seed: int = 0) -> Dict[str, Any]:
    """One mode-2 train step's inputs at ``cfg``'s widths (numpy): the
    first batch of its train loader, its description rows, random weights
    with nonzero biases, BN statistics and PReLU slopes, the jitter and
    proposal permutation, a copy-paste draw that applies, and the
    listener's dropout keep masks, drawn once on the cpu from a seeded
    generator (``ListenerDraws.drawn``)."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.data.language import build_lang_batch
    from d3net_tpu_torch.models.listener import ListenerDraws
    from d3net_tpu_torch.params import init_flax_variables
    from d3net_tpu_torch.train.loop import make_dataloaders, spec_from_cfg
    from d3net_tpu_torch.train.pipeline import (
        lang_rows, listener_losses, pipeline_from_cfg,
    )

    spec = spec_from_cfg(cfg)
    train_it, _ = make_dataloaders(cfg, spec, return_scenes=True)
    batch_np, scenes = next(iter(train_it))
    rng = np.random.default_rng(seed)
    b = batch_np["center_label"].shape[0]
    chunk = int(cfg.data.num_des_per_scene)
    lang_np = build_lang_batch(scenes, vocab, chunk, cfg.data.max_spk_len,
                               np.random.default_rng(seed),
                               spec.max_instances, apply_word_erase=True)
    variables = randomize(init_flax_variables(pipeline_from_cfg(cfg, vocab),
                                              seed), rng)
    k = cfg.model.max_num_proposal
    case = {"batch": batch_np, "scenes": scenes, "lang": lang_np,
            "variables": variables, "chunk": chunk,
            "jitter": rng.random((b, 2 * cfg.tpu.clusters_per_pass, 3)
                                 ).astype(np.float32),
            "perm": rng.permutation(k).astype(np.int64),
            "copy_paste": (np.asarray(True),
                           rng.gumbel(size=(b, k, k)).astype(np.float32))}
    draws = ListenerDraws(torch.Generator().manual_seed(seed),
                          copy_paste=tuple(torch.from_numpy(a)
                                           for a in case["copy_paste"]))
    model = load_pipeline(variables, cfg, vocab, device="cpu")
    with torch.no_grad():
        listener_losses(model, batch_to_torch(batch_np, "cpu"),
                        lang_rows(lang_np, emb, "cpu"), chunk_size=chunk,
                        jitter_u=torch.from_numpy(case["jitter"]),
                        proposal_perm=torch.from_numpy(case["perm"])[None],
                        draws=draws)
    case["masks"] = {p: m.numpy() for p, m in draws.drawn.items()}
    return case


def listener_step_kwargs(case: Dict[str, Any], dev) -> Dict[str, Any]:
    """The draws of ``case`` (``listener_step_case``) as the keyword
    arguments of ``listener_train_step``/``listener_losses`` on ``dev``."""
    from d3net_tpu_torch.models.listener import ListenerDraws

    return {"jitter_u": torch.from_numpy(case["jitter"]).to(dev),
            "proposal_perm": torch.from_numpy(case["perm"]).to(dev)[None],
            "draws": ListenerDraws(
                masks={p: torch.from_numpy(m).to(dev)
                       for p, m in case["masks"].items()},
                copy_paste=tuple(torch.from_numpy(a).to(dev)
                                 for a in case["copy_paste"]))}


def listener_cuda_vs_cpu(variables, cfg, vocab, data: Dict[str, np.ndarray],
                         seed: int = 0, rtol: float = 1e-4,
                         atol: float = 1e-5) -> Dict[str, Any]:
    """The pipeline's listener of ``variables`` on ``data`` (proposals,
    ``word_embs`` and ``lang_len``, numpy) on cpu and on cuda inside
    ``device.parity_precision()``: in eval mode, then in train mode with
    the same draws (the keep masks drawn on the cpu from a seeded
    generator, a copy-paste draw that applies). ``ok`` when every float
    output of both modes and the BN statistics after the train forward
    are within ``rtol``/``atol``."""
    from d3net_tpu_torch.models.listener import ListenerDraws
    from d3net_tpu_torch.models.match import gumbel_draw

    chunk = data["word_embs"].shape[0] // data["proposal_batch_mask"].shape[0]
    b, p = data["proposal_batch_mask"].shape
    gen = torch.Generator().manual_seed(seed)
    copy_paste = (torch.tensor(True), gumbel_draw((b, p, p), gen, "cpu"))
    outs, stats, masks = {}, {}, None
    with device.parity_precision(), torch.no_grad():
        for dev in ("cpu", "cuda"):
            lis = load_pipeline(variables, cfg, vocab, device=dev).listener
            t = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
            props = {k: t[k] for k in ("proposal_feats_batched",
                                       "proposal_batch_mask",
                                       "proposal_center_batched")}
            for train in (False, True):
                if not train:
                    draws = None
                elif masks is None:
                    draws = ListenerDraws(gen, copy_paste=copy_paste)
                else:
                    draws = ListenerDraws(
                        masks={k: m.to(dev) for k, m in masks.items()},
                        copy_paste=tuple(a.to(dev) for a in copy_paste))
                out = lis(props, t["word_embs"], t["lang_len"],
                                       chunk, train=train, draws=draws)
                if train and masks is None:
                    masks = draws.drawn
                outs[(dev, train)] = {k: out[k].cpu()
                                      for k in LISTENER_FLOATS}
            stats[dev] = {k: v.cpu() for k, v in lis.state_dict().items()
                          if k.endswith((".mean", ".var"))}
    errs, bad = {}, []
    for train in (False, True):
        mode = "train" if train else "eval"
        for k in LISTENER_FLOATS:
            g, c = outs[("cuda", train)][k], outs[("cpu", train)][k]
            errs[f"{mode}:{k}"] = float((g - c).abs().max())
            if not torch.allclose(g, c, rtol=rtol, atol=atol):
                bad.append(f"{mode}:{k}")
    for k, c in stats["cpu"].items():
        if not torch.allclose(stats["cuda"][k], c, rtol=rtol, atol=atol):
            bad.append(f"bn:{k}")
    return {"ok": not bad, "rows": int(data["word_embs"].shape[0]),
            "proposals": p, "dropout_masks": sorted(masks),
            "max_abs_err": errs, "bn_statistics": len(stats["cpu"]),
            "outside_tolerance": bad, "rtol": rtol, "atol": atol}


def grad_mismatches(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                    noise: Optional[Dict[str, np.ndarray]] = None,
                    rtol: float = 1e-3, atol: float = 1e-6,
                    ulp_factor: float = 4.0, zero_grads=(),
                    per_tensor: bool = True, zero_by_noise: bool = False
                    ) -> Tuple[List[str], int]:
    """The keys of the flat gradients ``want`` that ``got`` does not match,
    and how many elements passed only as f32 noise. An element passes
    within ``rtol``/``atol``, or, given ``noise`` (by key, one side's
    gradient less the same on weights moved by one ulp, ``ulp_moved``),
    within ``ulp_factor`` times it, for under 1% of the tensor (with
    ``per_tensor`` False, of all the gradients' elements: "noise_share"
    when not). The keys of ``zero_grads`` have a zero gradient: both sides
    must stay under 1e-5 of the largest gradient (or, with
    ``zero_by_noise``, under ``ulp_factor`` times the tensor's largest
    one-ulp movement: such a gradient is a sum that cancels, all of it
    noise)."""
    bad = [] if set(got) == set(want) else ["keys"]
    top = max(float(np.abs(w).max()) for w in want.values())
    noise_elements = 0
    for k, w in want.items():
        g = got.get(k, np.full_like(w, np.nan))
        if k in zero_grads:
            size = max(float(np.abs(g).max()), float(np.abs(w).max()))
            if not (size <= 1e-5 * top or (
                    zero_by_noise and size <= ulp_factor * noise[k].max())):
                bad.append(k)
            continue
        diff = np.abs(g - w)
        outside = ~(diff <= atol + rtol * np.abs(w))
        passed = (outside & (diff <= ulp_factor * noise[k]) if noise
                  else np.zeros_like(outside))
        noise_elements += int(passed.sum())
        if (outside & ~passed).any() or (per_tensor
                                         and passed.mean() >= 0.01):
            bad.append(k)
    if not per_tensor and noise_elements >= 0.01 * sum(
            w.size for w in want.values()):
        bad.append("noise_share")
    return bad, noise_elements


def grad_detail(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                noise: Dict[str, np.ndarray], keys, rtol: float = 1e-3,
                atol: float = 1e-6) -> Dict[str, Dict[str, float]]:
    """For each of ``keys`` (flat gradient names): its size, the elements
    outside ``rtol``/``atol``, the largest difference, and the largest
    difference over that element's ``noise``."""
    out = {}
    for k in keys:
        if k not in got or k not in want:
            continue
        diff = np.abs(got[k] - want[k])
        outside = ~(diff <= atol + rtol * np.abs(want[k]))
        out[k] = {"size": int(diff.size), "outside": int(outside.sum()),
                  "max_diff": float(diff.max()),
                  "max_diff_over_noise": float(
                      (diff[outside] / np.maximum(noise[k][outside], 1e-30)
                       ).max()) if outside.any() else 0.0}
    return out


def ulp_moved(tree, rng: np.random.Generator):
    """A Flax tree of numpy leaves with every leaf moved by one ulp
    (relative 2^-24, random signs)."""
    return {k: ulp_moved(v, rng) if isinstance(v, dict) else (
        v * (1 + rng.choice([-1.0, 1.0], v.shape) * 2.0 ** -24)).astype(
            np.float32) for k, v in tree.items()}


def listener_step_cuda_vs_cpu(cfg, vocab, emb, case: Dict[str, Any],
                              freeze_detector: bool, loss_rtol: float = 1e-4,
                              grad_rtol: float = 1e-3, grad_atol: float = 1e-6,
                              bn_rtol: float = 1e-4, bn_atol: float = 1e-5,
                              kink_noise: float = 1e-5,
                              ulp_factor: float = 4.0) -> Dict[str, Any]:
    """One ``listener_train_step`` of ``case`` (``listener_step_case``) on
    cpu and on cuda inside ``device.parity_precision()``, the same injected
    draws, the cuda step on the cpu step's ReLU sides: the ten metrics,
    every gradient (with the f32 noise rules of this module's docstring)
    and the new BN statistics within their tolerances. ``ok`` when all
    hold and no ReLU input that changed side lies beyond ``kink_noise``
    (relative) of the kink. Also the cuda step's ``gather_rows`` launches
    (a frozen detector runs no backward gathers)."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.train.pipeline import (
        freeze_submodules, lang_rows, listener_train_step,
    )
    from d3net_tpu_torch.train.trainer import create_train_state

    lw = tuple(cfg.train.loss_weight[:4])
    o = cfg.train.optim
    moved = dict(case["variables"])
    moved["params"] = ulp_moved(moved["params"], np.random.default_rng(0))
    res, relu_ref = {}, []
    with device.parity_precision():
        for run, dev, variables in (("cpu", "cpu", case["variables"]),
                                    ("cuda", "cuda", case["variables"]),
                                    ("cpu_ulp", "cpu", moved)):
            model = load_pipeline(variables, cfg, vocab, device=dev)
            freeze_submodules(model, {"detector": freeze_detector})
            state = create_train_state(model, lr=o.lr, optim=o.classname,
                                       weight_decay=o.weight_decay)
            before = gather.gather_rows.launches
            with relu_sides([] if run == "cpu_ulp" else relu_ref,
                            run != "cuda") as kinks:
                _, metrics = listener_train_step(
                    state, batch_to_torch(case["batch"], dev),
                    lang_rows(case["lang"], emb, dev), chunk_size=case["chunk"],
                    loss_weight=lw, **listener_step_kwargs(case, dev))
            res[run] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": flatten(state_dict_to_flax(model, {
                    n: p.grad for n, p in model.named_parameters()
                    if p.grad is not None})["params"]),
                "stats": flatten(state_dict_to_flax(model)["batch_stats"]),
                "kinks": kinks,
                "launches": gather.gather_rows.launches - before}
    cpu, gpu, ulp = res["cpu"], res["cuda"], res["cpu_ulp"]
    bad = [k for k, want in cpu["metrics"].items()
           if not np.isclose(gpu["metrics"][k], want, rtol=loss_rtol, atol=0)]
    grads_bad, noise_elements = grad_mismatches(
        gpu["grads"], cpu["grads"],
        {k: np.abs(v - ulp["grads"][k]) for k, v in cpu["grads"].items()},
        grad_rtol, grad_atol, ulp_factor, BN_FED_BIASES)
    bad += [f"grad:{k}" for k in grads_bad]
    for k, want in cpu["stats"].items():
        if not np.allclose(gpu["stats"].get(k, np.nan), want, rtol=bn_rtol,
                           atol=bn_atol):
            bad.append(f"bn:{k}")
    kinks = gpu["kinks"]
    if kinks["largest"] > kink_noise:
        bad.append("relu_kink_crossing")
    return {"ok": not bad, "freeze_detector": freeze_detector,
            "losses_cpu": cpu["metrics"], "losses_cuda": gpu["metrics"],
            "gradients": len(cpu["grads"]),
            "grad_max_abs_err": max(float(np.abs(gpu["grads"][k] - v).max())
                                    for k, v in cpu["grads"].items()
                                    if k in gpu["grads"]),
            "grad_ulp_noise_elements": noise_elements,
            "bn_max_abs_err": max(float(np.abs(gpu["stats"][k] - v).max())
                                  for k, v in cpu["stats"].items()),
            "relu_kink_crossings": kinks, "outside_tolerance": bad,
            "gather_launches_cuda": gpu["launches"],
            "gather_launches_cpu": cpu["launches"]}


# ---------------------------------------------------------------------------
# the joint RL step (mode 3)
# ---------------------------------------------------------------------------

def joint_parity_config(cfg):
    """A joint config (e.g. conf/debug/tiny_joint.yaml's) set up in place
    for a parity step: the published beam (3 in 3 groups, lambda 0.5, top
    3), 4 caption references, the XE anchor at 0.2, and
    ``data.min_iou_threshold`` 0 so that a random detector's targets that
    meet their box are good rows and the RL loss reaches the speaker."""
    t = cfg.train
    t.beam_size, t.beam_group_size, t.sample_topn = 3, 3, 3
    t.diversity_lambda, t.num_caption_refs, t.rl_xe_weight = 0.5, 4, 0.2
    cfg.data.min_iou_threshold = 0.0
    return cfg


def joint_step_kw(cfg) -> Dict[str, Any]:
    """The config's keyword arguments of ``joint_rl_train_step`` but the
    draws (the run loop's)."""
    t = cfg.train
    return dict(chunk_size=int(cfg.data.num_des_per_scene),
                loss_weight=tuple(t.loss_weight[:4]),
                beam_size=int(t.beam_size), sample_topn=int(t.sample_topn),
                ref_reward_weight=t.ref_reward_weight,
                lang_reward_weight=t.lang_reward_weight,
                listener_reward_weight=t.listener_reward_weight,
                caption_reward_weight=t.caption_reward_weight,
                loss_type=str(cfg.model.get("loss_type", "cross_entropy")),
                xe_weight=float(t.get("rl_xe_weight", 0.0) or 0.0))


def joint_step_case(cfg, vocab, emb, seed: int = 0) -> Dict[str, Any]:
    """One mode-3 train step's inputs at ``cfg``'s widths (numpy): the
    first two batches of its train loader (the speaker and the listener
    stream), their description rows with ``train.num_caption_refs``
    references, random weights with nonzero biases, BN statistics and
    PReLU slopes, the jitter, proposal permutation and target Gumbel draws,
    a copy-paste draw that applies, and the two train-mode listeners'
    dropout keep masks (``spk_masks`` at the sampled captions' N·topn rows,
    ``lis_masks`` at N rows, a mask of the same path and shape shared),
    drawn once on the cpu from a seeded generator."""
    from d3net_tpu_torch.data.language import build_lang_batch
    from d3net_tpu_torch.models.listener import ListenerDraws
    from d3net_tpu_torch.params import init_flax_variables
    from d3net_tpu_torch.train.loop import make_dataloaders, spec_from_cfg
    from d3net_tpu_torch.train.pipeline import pipeline_from_cfg

    spec = spec_from_cfg(cfg)
    train_it, _ = make_dataloaders(cfg, spec, return_scenes=True)
    items = iter(train_it)
    chunk = int(cfg.data.num_des_per_scene)
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(2):
        batch_np, scenes = next(items)
        lang_np = build_lang_batch(
            scenes, vocab, chunk, cfg.data.max_spk_len,
            np.random.default_rng(seed + len(streams)), spec.max_instances,
            apply_word_erase=True, num_refs=int(cfg.train.num_caption_refs))
        streams.append((batch_np, scenes, lang_np))
    variables = randomize(init_flax_variables(pipeline_from_cfg(cfg, vocab),
                                              seed), rng)
    b = streams[0][0]["center_label"].shape[0]
    k = cfg.model.max_num_proposal
    topn = int(cfg.train.sample_topn)
    case = {"spk": streams[0], "lis": streams[1], "variables": variables,
            "chunk": chunk,
            "jitter": rng.random((b, 2 * cfg.tpu.clusters_per_pass, 3)
                                 ).astype(np.float32),
            "perm": rng.permutation(k).astype(np.int64),
            "gumbel": rng.gumbel(size=(b * chunk, k)).astype(np.float32),
            "copy_paste": (np.asarray(True),
                           rng.gumbel(size=(b, k, k)).astype(np.float32))}
    # the keep masks depend only on the listeners' input shapes
    lis = load_pipeline(variables, cfg, vocab, device="cpu").listener
    gen = torch.Generator().manual_seed(seed)
    props = {"proposal_feats_batched": torch.zeros(
                 b, k, lis.match.feat_fc1.in_features),
             "proposal_batch_mask": torch.ones(b, k),
             "proposal_center_batched": torch.zeros(b, k, 3)}
    t_mod = cfg.data.max_spk_len + 2
    t_lang = streams[1][2]["lang_ids"].shape[-1]
    drawn = {}
    for name, rows, t in (("spk_masks", chunk * topn, t_mod),
                          ("lis_masks", chunk, t_lang)):
        draws = ListenerDraws(gen, copy_paste=tuple(
            torch.from_numpy(a) for a in case["copy_paste"]), shared=drawn)
        with torch.no_grad():
            lis(props, torch.zeros(b * rows, t, emb.shape[1]),
                torch.full((b * rows,), t), rows, train=True, draws=draws)
        case[name] = {p: m.numpy() for p, m in draws.drawn.items()}
        drawn = draws.drawn
    return case


def joint_step_kwargs(case: Dict[str, Any], dev) -> Dict[str, Any]:
    """The draws of ``case`` (``joint_step_case``) as the keyword arguments
    of ``joint_rl_train_step``/``joint_rl_losses`` on ``dev``."""
    from d3net_tpu_torch.models.listener import ListenerDraws

    copy_paste = tuple(torch.from_numpy(a).to(dev)
                       for a in case["copy_paste"])
    return {"jitter_u": torch.from_numpy(case["jitter"]).to(dev),
            "proposal_perm": torch.from_numpy(case["perm"]).to(dev)[None],
            "gumbel": torch.from_numpy(case["gumbel"]).to(dev),
            **{f"{s}_draws": ListenerDraws(
                masks={p: torch.from_numpy(m).to(dev)
                       for p, m in case[f"{s}_masks"].items()},
                copy_paste=copy_paste) for s in ("spk", "lis")}}


def joint_step_inputs(case: Dict[str, Any], emb, dev):
    """The two streams of ``case`` as (spk batch, spk rows, lis batch, lis
    rows) tensors on ``dev``."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.train.pipeline import lang_rows

    return [x for s in ("spk", "lis") for x in (
        batch_to_torch(case[s][0], dev), lang_rows(case[s][2], emb, dev))]


def rollout_logits(model, data: Dict, rollout: Dict[str, torch.Tensor],
                   chunk: int) -> torch.Tensor:
    """The speaker's logits (N, topn, T, V) teacher-forced on the rollout's
    samples and targets (``data``: the detector's outputs and rows): the
    top-2 margins behind a difference in the samples."""
    from d3net_tpu_torch.models.speaker import expand_to_rows

    spk = model.speaker
    rows = expand_to_rows(spk.graph(data) if spk.num_graph_steps > 0
                          else data, chunk)
    dev = rows["lang_ids"].device
    rows.update(target_ids_in=rollout["target_ids"].to(dev),
                target_ious_in=rollout["target_ious"].to(dev))
    inputs = spk.caption.train_inputs(rows, None)[3:]
    sampled = rollout["sampled_cap"].to(dev)
    logits = spk.caption.rollout_logits(sampled, rows["glove_embeddings"],
                                        *inputs)
    return logits.reshape(sampled.shape + (-1,)).cpu()


def joint_step_cuda_vs_cpu(cfg, vocab, emb, case: Dict[str, Any],
                           freeze_detector: bool, loss_rtol: float = 1e-4,
                           grad_rtol: float = 1e-3, grad_atol: float = 1e-6,
                           bn_rtol: float = 1e-4, bn_atol: float = 1e-5,
                           kink_noise: float = 1e-5,
                           ulp_factor: float = 4.0) -> Dict[str, Any]:
    """One ``joint_rl_train_step`` of ``case`` (``joint_step_case``) on cpu
    and on cuda inside ``device.parity_precision()``, the same injected
    draws. The cpu's rollout (ids, targets) is compared with the cuda
    step's own, run first with no step and the rollout alone once under
    CUDA's sync debug mode "error"; the steps then all run on the cpu's
    rollout, the cuda step on the cpu step's ReLU sides: the metrics,
    every gradient and the new BN statistics within their tolerances.
    ``ok`` when the rollouts are equal and all the rest holds. Also each
    device's ``gather_rows`` launches in its step.

    The gradients follow this module's rules, set for this step: an
    element's one-ulp movement is the larger of the two devices', the
    elements passing within ``ulp_factor`` times it are bounded to 1% of
    the step's gradient elements (not of each tensor), and a BN-fed bias
    may also pass within ``ulp_factor`` times its tensor's largest one-ulp
    movement. On the cpu at conf/debug/tiny_joint.yaml's widths a one-ulp
    move of every weight alone puts 1.0-1.4% of four detector kernels'
    elements and 1 of 8 of three BN parameters' outside ``grad_rtol``/
    ``grad_atol``, and the "zero" gradient of
    ``listener.match.feat_fc1.bias``, a cancelling sum of terms near
    16-32, reads ±2e-5 (1.5e-5 of the largest gradient) on either device
    and moves as much with the weights."""
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.train.pipeline import (
        expand_rows, freeze_submodules, joint_rl_train_step,
        make_caption_reward_fn, sample_caption_ids,
    )
    from d3net_tpu_torch.train.trainer import create_train_state

    kw = joint_step_kw(cfg)
    reward_fn = make_caption_reward_fn(vocab)
    o = cfg.train.optim
    moved = dict(case["variables"])
    moved["params"] = ulp_moved(moved["params"], np.random.default_rng(0))
    rollouts = {}
    with device.parity_precision(), torch.no_grad():
        for dev in ("cpu", "cuda"):
            model = load_pipeline(case["variables"], cfg, vocab, device=dev)
            spk_b, spk_l, _, _ = joint_step_inputs(case, emb, dev)
            draws = joint_step_kwargs(case, dev)
            out = model.run_detector(spk_b, train=True,
                                     jitter_u=draws["jitter_u"],
                                     proposal_perm=draws["proposal_perm"])
            data = {**out, **spk_l, **expand_rows(out, spk_b, case["chunk"])}

            def rollout():
                return sample_caption_ids(
                    model, data, chunk_size=case["chunk"],
                    beam_size=kw["beam_size"], sample_topn=kw["sample_topn"],
                    gumbel=draws["gumbel"])
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    rollout()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            rollouts[dev] = {k: v.cpu() for k, v in rollout().items()}
            if dev == "cpu":
                logits = rollout_logits(model, data, rollouts["cpu"],
                                        case["chunk"])
    res, relu_ref = {}, []
    with device.parity_precision():
        for run, dev, variables in (("cpu", "cpu", case["variables"]),
                                    ("cuda", "cuda", case["variables"]),
                                    ("cpu_ulp", "cpu", moved),
                                    ("cuda_ulp", "cuda", moved)):
            model = load_pipeline(variables, cfg, vocab, device=dev)
            freeze_submodules(model, {"detector": freeze_detector})
            state = create_train_state(model, lr=o.lr, optim=o.classname,
                                       weight_decay=o.weight_decay)
            before = gather.gather_rows.launches
            with relu_sides([] if run.endswith("_ulp") else relu_ref,
                            run != "cuda") as kinks:
                _, metrics, rec = joint_rl_train_step(
                    state, *joint_step_inputs(case, emb, dev), reward_fn,
                    rollout={k: v.to(dev) for k, v in rollouts["cpu"].items()},
                    **joint_step_kwargs(case, dev), **kw)
            res[run] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": flatten(state_dict_to_flax(model, {
                    n: p.grad for n, p in model.named_parameters()
                    if p.grad is not None})["params"]),
                "stats": flatten(state_dict_to_flax(model)["batch_stats"]),
                "scores": [rec[k].cpu() for k in ("sampled_scores",
                                                  "baseline_scores")],
                "kinks": kinks,
                "launches": gather.gather_rows.launches - before}
    cpu, gpu = res["cpu"], res["cuda"]
    ids_equal = {k: bool(torch.equal(rollouts["cuda"][k], v))
                 for k, v in rollouts["cpu"].items()
                 if k in ("sampled_cap", "baseline_cap", "target_ids")}
    margins = []
    s_c, s_g = rollouts["cpu"]["sampled_cap"], rollouts["cuda"]["sampled_cap"]
    rows = (s_c != s_g).flatten(1).any(1).nonzero()[:, 0].tolist()
    for r in rows[:10]:
        j, t = (s_c[r] != s_g[r]).nonzero()[0].tolist()
        top2 = logits[r, j, t].topk(2).values
        margins.append({"row": r, "sample": j, "step": t,
                        "cpu_top2_margin": float(top2[0] - top2[1])})
    bad = [k for k, want in cpu["metrics"].items()
           if not np.isclose(gpu["metrics"][k], want, rtol=loss_rtol, atol=0)]
    # each element's f32 noise: the larger of the two devices' movements
    # when every weight moves by one ulp
    noise = {k: np.maximum(np.abs(v - res["cpu_ulp"]["grads"][k]),
                           np.abs(gpu["grads"][k] - res["cuda_ulp"]["grads"][k]))
             for k, v in cpu["grads"].items() if k in gpu["grads"]}
    grads_bad, noise_elements = grad_mismatches(
        gpu["grads"], cpu["grads"], noise, grad_rtol, grad_atol, ulp_factor,
        BN_FED_BIASES, per_tensor=False, zero_by_noise=True)
    bad += [f"grad:{k}" for k in grads_bad]
    for k, want in cpu["stats"].items():
        if not np.allclose(gpu["stats"].get(k, np.nan), want, rtol=bn_rtol,
                           atol=bn_atol):
            bad.append(f"bn:{k}")
    if not all(torch.equal(g, c) for g, c in zip(gpu["scores"],
                                                  cpu["scores"])):
        bad.append("caption_scores")
    kinks = gpu["kinks"]
    if kinks["largest"] > kink_noise:
        bad.append("relu_kink_crossing")
    return {"ok": not bad and all(ids_equal.values()),
            "freeze_detector": freeze_detector,
            "rollout_ids_equal": ids_equal, "rows_differing": len(rows),
            "first_difference": margins,
            "sampled_shape": list(s_c.shape),
            "good_rows": int((rollouts["cpu"]["target_ious"]
                              > cfg.data.min_iou_threshold).sum()),
            "losses_cpu": cpu["metrics"], "losses_cuda": gpu["metrics"],
            "gradients": len(cpu["grads"]),
            "grad_max_abs_err": max(float(np.abs(gpu["grads"][k] - v).max())
                                    for k, v in cpu["grads"].items()
                                    if k in gpu["grads"]),
            "grad_ulp_noise_elements": noise_elements,
            "grad_detail": grad_detail(gpu["grads"], cpu["grads"], noise,
                                       grads_bad, grad_rtol, grad_atol),
            "bn_max_abs_err": max(float(np.abs(gpu["stats"][k] - v).max())
                                  for k, v in cpu["stats"].items()),
            "relu_kink_crossings": kinks, "outside_tolerance": bad,
            "gather_launches_cuda": gpu["launches"],
            "gather_launches_cpu": cpu["launches"]}


# ---------------------------------------------------------------------------
# ENet (the multiview encoder) and its train step
# ---------------------------------------------------------------------------

# the initial block's conv bias only shifts a train-mode BatchNorm's input
ENET_BN_FED = ("ENetEncoder_0.InitialBlock_0.Conv_0.bias",)


def enet_cuda_vs_cpu(shape=(2, 64, 80, 3), classes: int = 20, seed: int = 0,
                     rtol: float = 1e-4, atol: float = 1e-5,
                     grad_rtol: float = 1e-3, grad_atol: float = 1e-6
                     ) -> Dict[str, Any]:
    """The ENet encoder's eval forward (light and full layouts, random BN
    statistics, biases and slopes; f32) and one ``train_enet`` step (the
    same dropout masks, Adam) on cpu and on cuda inside
    ``device.parity_precision()``: forward outputs, the step's loss,
    accuracy and new BN statistics within ``rtol``/``atol``, every
    gradient within ``grad_rtol``/``grad_atol`` (``ENET_BN_FED`` has a zero
    gradient: both devices under 1e-5 of the largest). ``ok`` when all
    hold.

    The step runs in float64 on both devices (its f32 loss and accuracy
    are compared too): in f32 the backward is ill-conditioned where a
    PReLU input sits within rounding of its kink on these small maps (on
    the cpu, the f32 step's first conv kernel gradient lands 3.6e-3 off
    the f64 step's, 0.4% of its largest element, and a one-ulp move of
    the weights moves it by 9.5e-4). The images are uniform noise, with
    no ties in the max-pools."""
    from d3net_tpu_torch.models.enet import ENetEncoder
    from d3net_tpu_torch.models.listener import ListenerDraws
    from d3net_tpu_torch.params import (
        enet_flax_to_state_dict, init_enet_flax_variables,
    )
    from d3net_tpu_torch.scripts.train_enet import (
        enet_train_step, make_model, make_optimizer,
    )

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    labels = rng.integers(-1, classes, (shape[0], shape[1] // 8,
                                        shape[2] // 8)).astype(np.int32)
    bad, report = [], {}
    with device.parity_precision():
        for full in (False, True):
            model = ENetEncoder(full)
            v = randomize(init_enet_flax_variables(model, seed), rng)
            out = {}
            for dev in ("cpu", "cuda"):
                model.load_state_dict(enet_flax_to_state_dict(v, model))
                model.to(dev).eval()
                with torch.no_grad():
                    out[dev] = model(torch.from_numpy(x).to(dev)).cpu().numpy()
            err = float(np.abs(out["cuda"] - out["cpu"]).max())
            report[f"forward_{'full' if full else 'light'}_max_abs_err"] = err
            if not np.allclose(out["cuda"], out["cpu"], rtol=rtol, atol=atol):
                bad.append(f"forward_{'full' if full else 'light'}")

        masks = None
        res = {}
        for run, dev, dtype in (("cpu", "cpu", torch.float64),
                                ("cuda", "cuda", torch.float64),
                                ("cpu_f32", "cpu", torch.float32),
                                ("cuda_f32", "cuda", torch.float32)):
            model = make_model(classes, seed, "cpu").to(dev, dtype)
            draws = ListenerDraws(torch.Generator().manual_seed(seed),
                                  masks)
            loss, acc = enet_train_step(
                model, make_optimizer(model, 1e-3),
                torch.from_numpy(x).to(dev, dtype),
                torch.from_numpy(labels).to(dev), draws)
            if masks is None:
                masks = {k: m.cpu() for k, m in draws.drawn.items()}
            res[run] = {
                "loss": float(loss), "acc": float(acc),
                "grads": {k: v.astype(np.float64) for k, v in flatten(
                    state_dict_to_flax(model, {
                        n: p.grad for n, p in model.named_parameters()})[
                            "params"]).items()},
                "stats": flatten(state_dict_to_flax(model)["batch_stats"])}
    cpu, gpu = res["cpu"], res["cuda"]
    for a, b in (("cuda", "cpu"), ("cuda_f32", "cpu_f32")):
        for k in ("loss", "acc"):
            if not np.isclose(res[a][k], res[b][k], rtol=rtol, atol=0):
                bad.append(f"{a}:{k}")
    grads_bad, _ = grad_mismatches(gpu["grads"], cpu["grads"], None,
                                   grad_rtol, grad_atol,
                                   zero_grads=ENET_BN_FED)
    bad += [f"grad:{k}" for k in grads_bad]
    for k, want in cpu["stats"].items():
        if not np.allclose(gpu["stats"][k], want, rtol=rtol, atol=atol):
            bad.append(f"bn:{k}")
    return {"ok": not bad, "shape": list(shape), **report,
            "step_dtype": "float64",
            **{f"loss_{r}": res[r]["loss"] for r in res},
            **{f"acc_{r}": res[r]["acc"] for r in res},
            "gradients": len(cpu["grads"]),
            "grad_max_abs_err": max(float(np.abs(gpu["grads"][k] - v).max())
                                    for k, v in cpu["grads"].items()),
            "grad_max_abs_err_f32": max(
                float(np.abs(res["cuda_f32"]["grads"][k] - v).max())
                for k, v in res["cpu_f32"]["grads"].items()),
            "bn_max_abs_err": max(float(np.abs(gpu["stats"][k] - v).max())
                                  for k, v in cpu["stats"].items()),
            "outside_tolerance": bad}


def _entries_differ(got: List[Dict], want: List[Dict], equal: Tuple[str, ...],
                    close: Tuple[str, ...], rtol: float, atol: float
                    ) -> Tuple[List[str], float]:
    """Submission entries compared key by key: (what differs, the largest
    abs error of the ``close`` keys)."""
    bad, err = [], 0.0
    if len(got) != len(want):
        return [f"{len(got)} entries against {len(want)}"], float("inf")
    for n, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            bad.append(f"{n}: keys {sorted(g)}")
            continue
        bad += [f"{n}:{k}" for k in equal if g[k] != w[k]]
        for k in close:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            err = max(err, float(np.abs(a - b).max()))
            if a.shape != b.shape or not np.allclose(a, b, rtol=rtol,
                                                     atol=atol):
                bad.append(f"{n}:{k}")
    return bad, err


def tools_cuda_vs_cpu(config: str, root: str, seed: int = 2,
                      rtol: float = 1e-4, atol: float = 1e-5
                      ) -> Dict[str, Any]:
    """The ScanRefer submission writers and the ENet weight port's
    selftest, cuda against cpu inside ``device.parity_precision()``: a run
    dir under ``root`` holds ``config`` (a pipeline with the speaker and
    the listener) and one checkpoint of seeded weights (nonzero biases and
    BN statistics); ``benchmark_captioning`` and ``benchmark_grounding``
    run on it on each device, and ``port_enet_weights.selftest`` on each.
    Captions, ``sem_cls``, scene and object ids equal, boxes and
    ``obj_prob`` within ``rtol``/``atol``, the selftest forward likewise;
    ``gather_rows`` launched on cuda only. ``ok`` when all hold."""
    from d3net_tpu_torch import config as cfg_lib
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.params import init_flax_variables
    from d3net_tpu_torch.scripts import (
        benchmark_captioning, benchmark_grounding, port_enet_weights,
    )
    from d3net_tpu_torch.train.loop import Checkpointer
    from d3net_tpu_torch.train.pipeline import build_vocab, pipeline_from_cfg
    from d3net_tpu_torch.train.trainer import create_train_state

    cfg = cfg_lib.load(config)
    cfg.general.output_root = root
    run = os.path.join(root, "tools_parity")
    os.makedirs(run)
    cfg_lib.save(cfg, os.path.join(run, "config.yaml"))
    vocab, _ = build_vocab(cfg)
    variables = randomize(init_flax_variables(pipeline_from_cfg(cfg, vocab),
                                              seed),
                          np.random.default_rng(seed))
    model = load_pipeline(variables, cfg, vocab, device="cpu")
    Checkpointer(run, "cider", "max").save(1, create_train_state(model),
                                           {"cider": 0.0})
    del model
    out: Dict[str, Dict[str, Any]] = {}
    launches: Dict[str, int] = {}
    with device.parity_precision():
        for dev in ("cpu", "cuda"):
            flag = ["--cpu"] if dev == "cpu" else []
            before = gather.gather_rows.launches
            out[dev] = {
                "captioning": benchmark_captioning.main(
                    ["--folder", run, "--out",
                     os.path.join(run, f"captioning_{dev}.json")] + flag),
                "grounding": benchmark_grounding.main(
                    ["--folder", run, "--out",
                     os.path.join(run, f"grounding_{dev}.json")] + flag),
                "enet": port_enet_weights.selftest(dev)}
            launches[dev] = gather.gather_rows.launches - before
    cpu, gpu = out["cpu"], out["cuda"]
    bad = []
    if list(gpu["captioning"]) != list(cpu["captioning"]):
        bad.append("captioning scenes")
    cap_err, n_cap = 0.0, 0
    for scene, want in cpu["captioning"].items():
        b, e = _entries_differ(gpu["captioning"].get(scene, []), want,
                               ("caption", "sem_cls"), ("box", "obj_prob"),
                               rtol, atol)
        bad += [f"captioning {scene} {x}" for x in b]
        cap_err, n_cap = max(cap_err, e), n_cap + len(want)
    b, grd_err = _entries_differ(gpu["grounding"], cpu["grounding"],
                                 ("scene_id", "object_id"), ("bbox",),
                                 rtol, atol)
    bad += [f"grounding {x}" for x in b]
    enet_err = float(np.abs(gpu["enet"] - cpu["enet"]).max())
    if not np.allclose(gpu["enet"], cpu["enet"], rtol=rtol, atol=atol):
        bad.append("enet selftest forward")
    if launches["cpu"] != 0 or launches["cuda"] == 0:
        bad.append(f"gather_rows launches {launches}")
    return {"ok": not bad, "scenes": len(cpu["captioning"]),
            "caption_entries": n_cap,
            "grounding_entries": len(cpu["grounding"]),
            "captioning_max_abs_err": cap_err,
            "grounding_max_abs_err": grd_err,
            "enet_selftest_max_abs_err": enet_err,
            "gather_launches_cpu": launches["cpu"],
            "gather_launches_cuda": launches["cuda"],
            "outside_tolerance": bad}


# ---------------------------------------------------------------------------
# gathers held exact as they run (chip_smoke.py's train phases), and the
# data-parallel steps: rank workers of ``parallel.mesh.spawn``, shared by
# tests/test_torch_dist_*.py, tests/test_torch_cuda.py and chip_smoke.py's
# phase ``dist``. Each runs one rank's share of a step on its rows of a
# global case; called with no process group it is world size 1 on the
# whole batch. They live here because a spawned rank imports its target's
# module (a worker in a test module would bring JAX into every rank).
# ---------------------------------------------------------------------------

class GatherRecorder:
    """Stands in for the ``gather`` module inside the ops that call it; the
    real wrapper (and its launch count) still runs every call. It keeps
    each call's tensors for the kernel replay, or with ``check`` holds each
    call's output against the plain version on the same tensors as the
    call happens (in the backward too) and keeps only a count, the largest
    error, the rows gathered by dtype and width, and the bytes the calls
    need (``probe.gather_bytes``: distinct source rows reached, output,
    index). With ``limit`` only the first ``limit`` calls are checked (one
    call's worth of work, when the later calls are timed or profiled); the
    later ones run the wrapper alone."""

    def __init__(self, real, check=False, where="the train step",
                 limit: Optional[int] = None):
        self.real = real
        self.check = check
        self.where = where
        self.limit = limit
        self.calls = []
        self.checked = 0
        self.max_abs_err = 0.0
        self.rows_by_dtype_width = {}
        self.bytes_needed = 0

    def gather_rows(self, src, idx):
        from d3net_tpu_torch.probe import gather_bytes

        out = self.real.gather_rows(src, idx)
        if self.limit is not None and self.checked >= self.limit:
            return out
        if not self.check:
            self.calls.append((src, idx))
            return out
        with torch.no_grad():
            want = self.real.gather_rows_plain(src.detach(), idx)
            if out.numel():
                self.max_abs_err = max(self.max_abs_err, float(
                    (out.float() - want.float()).abs().max()))
        if not torch.equal(out, want):
            raise AssertionError(
                f"gather {self.checked} of {self.where} ({src.dtype}, width "
                f"{src.shape[1]}, {idx.numel()} rows): kernel disagrees with "
                f"the plain version")
        self.checked += 1
        key = f"{src.dtype}".replace("torch.", "") + f"x{src.shape[1]}"
        self.rows_by_dtype_width[key] = (
            self.rows_by_dtype_width.get(key, 0) + idx.numel())
        self.bytes_needed += gather_bytes(src, idx, 4 * idx.numel())
        return out


@contextlib.contextmanager
def checked_gathers(where: str, limit: Optional[int] = None):
    """Every ``gather_rows`` call of the block (the first ``limit``, if
    given) held bit-exact against the plain version as it runs (a
    ``GatherRecorder`` with ``check``); yields the recorder."""
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.ops import segment, sparse_conv

    rec = GatherRecorder(gather, check=True, where=where, limit=limit)
    sparse_conv.gather, segment.gather = rec, rec
    try:
        yield rec
    finally:
        sparse_conv.gather, segment.gather = gather, gather


def watch_process(log_path: str) -> None:
    """Watch this process as a script runs it: every ``gather_rows`` call
    held against the plain version as it runs (a checking
    ``GatherRecorder``: a call that differs raises), every step of a
    ``StepLoop`` timed with the loop waiting for the card around each
    part (its ``on_step`` record, with the step's metrics), and every
    dispatch of the scan trainer (its ``on_dispatch`` record). At exit it
    appends one JSON line to ``log_path``: ``argv``, ``t0`` (the call's
    ``time.time()``), ``seconds`` since the call, ``launches`` (the
    wrapper's count), ``checked``, ``max_abs_err``, ``steps`` and
    ``dispatches``. A ``sitecustomize``
    module that calls it watches every Python process a script starts."""
    import atexit
    import sys

    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.ops import segment, sparse_conv
    from d3net_tpu_torch.train import loop

    t0 = time.time()
    rec = GatherRecorder(gather, check=True, where=" ".join(sys.argv))
    sparse_conv.gather, segment.gather = rec, rec
    steps: List[Dict[str, Any]] = []
    metrics: List[Dict[str, torch.Tensor]] = []
    dispatches: List[Dict[str, Any]] = []

    init, run_epoch = loop.StepLoop.__init__, loop.StepLoop.run_epoch
    scan = loop.run_detector_training_scan

    def watched_init(self, *args, **kw):
        init(self, *args, **kw)
        if self.on_step is None:
            self.on_step, self.sync_steps = steps.append, True

    def watched_epoch(self, epoch, train_it, to_device, train_step,
                      log_extra=None):
        def step(batch, i):
            m = train_step(batch, i)
            metrics.append({k: v.detach() for k, v in m.items()})
            return m
        return run_epoch(self, epoch, train_it, to_device, step, log_extra)

    def watched_scan(*args, **kw):
        kw.setdefault("on_dispatch", dispatches.append)
        return scan(*args, **kw)

    loop.StepLoop.__init__ = watched_init
    loop.StepLoop.run_epoch = watched_epoch
    loop.run_detector_training_scan = watched_scan

    def write():
        for step, m in zip(steps, metrics):
            step.update({k: float(v) for k, v in m.items()})
        line = {"argv": sys.argv, "t0": t0, "seconds": time.time() - t0,
                "launches": gather.gather_rows.launches,
                "checked": rec.checked, "max_abs_err": rec.max_abs_err,
                "steps": steps, "dispatches": dispatches}
        with open(log_path, "a") as f:
            f.write(json.dumps(line) + "\n")

    atexit.register(write)


# tests/test_parallel.py's model, batch layout and scenes
DP_CFG = dict(m=4, blocks=(1, 2), cluster_blocks=(1, 2), clusters_per_pass=8,
              max_num_proposal=8, cluster_npoint_thre=30,
              test_npoint_thresh=30, test_score_thresh=0.0, cluster_ring=1,
              cluster_cell_size=0.03, cluster_prop_iters=4)
DP_SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
                floor_points=500, room=3.0)
DP_SPEC = dict(max_points=1024, voxel_caps=[1024, 512], max_instances=8,
               use_multiview=False)


def detector_case(cfg: Dict[str, Any], batch_np: Dict[str, Any],
                  seed: int = 0) -> Dict[str, Any]:
    """One detector train step's inputs (numpy) on a global batch: the
    ``PointGroup`` keyword arguments ``cfg``, Flax-initialised weights from
    ``seed`` with nonzero biases and BN statistics, the global batch's
    cluster jitter and one proposal permutation shared by its scenes."""
    from d3net_tpu_torch.models.pointgroup import PointGroup
    from d3net_tpu_torch.params import init_flax_variables

    rng = np.random.default_rng(seed)
    in_ch = batch_np["point_feats"].shape[-1] + 3 * bool(
        cfg.get("use_coords", True))
    b = batch_np["point_mask"].shape[0]
    return {"cfg": dict(cfg), "batch": batch_np,
            "variables": randomize(init_flax_variables(
                PointGroup(in_ch, **cfg), seed), rng),
            "jitter": rng.random((b, 2 * cfg["clusters_per_pass"], 3)
                                 ).astype(np.float32),
            "perm": rng.permutation(cfg["max_num_proposal"]
                                    ).astype(np.int64)}


def detector_dp_case(b: int, seed: int = 0) -> Dict[str, Any]:
    """``detector_case`` at tests/test_parallel.py's model on its batch of
    ``b`` synthetic scenes (seeds 0..b-1)."""
    from d3net_tpu_torch.data.collate import BatchSpec, build_batch
    from d3net_tpu_torch.data.synthetic import make_scene

    scenes = [make_scene(seed=i, **DP_SCENE) for i in range(b)]
    return detector_case(DP_CFG, build_batch(scenes, BatchSpec(**DP_SPEC)),
                         seed)


def _rank_device(dev) -> torch.device:
    if dev is not None:
        return torch.device(dev)
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


def _parity(dev: torch.device):
    """TF32 off on the card (``device.parity_precision``): worlds compared
    there differ by summation order alone."""
    return (device.parity_precision() if dev.type == "cuda"
            else contextlib.nullcontext())


def _state_arrays(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _grad_arrays(model) -> Dict[str, np.ndarray]:
    return {n: p.grad.detach().cpu().numpy()
            for n, p in model.named_parameters() if p.grad is not None}


def detector_step_rank(case: Dict[str, Any], do_clustering: bool = True,
                       optim: str = "SGD", dev=None,
                       check_gathers: bool = False) -> Dict[str, Any]:
    """This rank's ``detector_train_step`` of ``case`` (``detector_case``)
    on its rows, with the case's global draws, at lr 1e-3 (the JAX dp
    test's optimizer): the global metrics, the summed gradients, the
    parameters and BN statistics after the step, and the cluster ids and
    proposal slots of a train forward of the case's weights on its rows
    with the same draws. With ``check_gathers`` every gather is held exact
    against its plain version (the launches and checks are returned). On
    the card TF32 is off."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.parallel import mesh
    from d3net_tpu_torch.params import load_detector
    from d3net_tpu_torch.train.trainer import (
        create_train_state, detector_train_step,
    )

    dev = _rank_device(dev)
    model = load_detector(case["variables"], case["cfg"], device=dev)
    state = create_train_state(model, lr=1e-3, optim=optim,
                               steps_per_epoch=10)
    batch = batch_to_torch(mesh.shard_host_batch(case["batch"]), dev)
    kw = dict(jitter_u=torch.from_numpy(case["jitter"]).to(dev),
              proposal_perm=torch.from_numpy(case["perm"]).to(dev)[None])
    before = gather.gather_rows.launches
    with _parity(dev), (checked_gathers("the dp train step") if check_gathers
                        else contextlib.nullcontext()) as rec:
        _, metrics = detector_train_step(state, batch,
                                         do_clustering=do_clustering, **kw)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _grad_arrays(model), "state": _state_arrays(model),
           "launches": gather.gather_rows.launches - before}
    if rec is not None:
        out.update(checked=rec.checked, max_abs_err=rec.max_abs_err)
    if do_clustering:
        fresh = load_detector(case["variables"], case["cfg"], device=dev)
        with _parity(dev), torch.no_grad():
            fwd = fresh(batch, train=True, **kw)
        out["ints"] = {k: fwd[k].cpu().numpy()
                       for k in ("member_pt", "cluster_mask_all",
                                 "proposal_slot")}
    return out


def rank_calls(calls: List[Tuple[Any, tuple, Dict[str, Any]]]) -> List[Any]:
    """``[fn(*args, **kw) for fn, args, kw in calls]``: several workers in
    one spawn of ranks (each spawn costs every rank a fresh interpreter)."""
    return [fn(*args, **kw) for fn, args, kw in calls]


def bn_case(shapes: Dict[str, Tuple[int, ...]], seed: int = 0,
            empty_half: bool = False) -> Dict[str, Any]:
    """Inputs of the three train-mode BatchNorms (numpy, global batch):
    ``rows`` a (B, M, C) ``MaskedBatchNorm`` input with a (B, M) mask,
    ``grid`` the ScoreNet's NCDHW (P, C, G, G, G) with occupancy (P, G, G,
    G), ``listener`` the match module's ``BatchNorm`` rows (N, C); each
    with an upstream gradient ``dy`` of the output's shape, and random
    scales and biases. With ``empty_half`` the second half of the batch
    rows of ``rows`` and ``grid`` is masked out entirely (the second rank's
    at world size 2)."""
    rng = np.random.default_rng(seed)
    case = {}
    for name in ("rows", "grid", "listener"):
        shape = shapes[name]
        x = rng.normal(1.0, 2.0, shape).astype(np.float32)
        c = shape[1] if name == "grid" else shape[-1]
        entry = {"x": x, "dy": rng.normal(size=shape).astype(np.float32),
                 "scale": rng.normal(1.0, 0.2, c).astype(np.float32),
                 "bias": rng.normal(0.0, 0.2, c).astype(np.float32)}
        if name != "listener":
            mshape = shape[:1] + shape[2:] if name == "grid" else shape[:2]
            mask = rng.random(mshape) < 0.6
            if empty_half:
                mask[shape[0] // 2:] = False
            entry["mask"] = mask
        case[name] = entry
    return case


def bn_rank(case: Dict[str, Any], dtype: str = "float32",
            dev=None) -> Dict[str, Dict[str, np.ndarray]]:
    """This rank's train-mode forward and backward of the three BatchNorms
    of ``case`` (``bn_case``) on its rows, on ``dev`` (the CPU by default):
    the output and ``dx`` of its rows (as f32), the global
    ``dscale``/``dbias`` (summed over the ranks) and the new running
    statistics. ``MaskedBatchNorm``'s inputs are cast to ``dtype`` (the
    backbone and ScoreNet run in bf16 under ``compute_dtype``); the
    listener's stay f32, as the listener runs."""
    from d3net_tpu_torch.models.blocks import MaskedBatchNorm
    from d3net_tpu_torch.models.match import BatchNorm
    from d3net_tpu_torch.models.scorenet import _bn
    from d3net_tpu_torch.parallel import mesh

    dev = torch.device("cpu") if dev is None else torch.device(dev)
    out = {}
    for name, entry in case.items():
        e = {k: torch.from_numpy(np.asarray(v)) for k, v in entry.items()}
        e = {k: (v if k in ("scale", "bias")
                 else mesh.shard_host_batch(v)).to(dev)
             for k, v in e.items()}
        c = e["scale"].shape[0]
        bn = (BatchNorm(c) if name == "listener"
              else MaskedBatchNorm(c)).to(dev)
        with torch.no_grad():
            bn.scale.copy_(e["scale"])
            bn.bias.copy_(e["bias"])
        dt = torch.float32 if name == "listener" else getattr(torch, dtype)
        x = e["x"].to(dt).requires_grad_(True)
        dy = e["dy"].to(dt)
        with _parity(dev):
            if name == "listener":
                y = bn(x, True)
            elif name == "grid":
                y = _bn(bn, x, e["mask"], True)
            else:
                y = bn(x, e["mask"], True)
            (y * dy).float().sum().backward()
        mesh.all_reduce_grads([bn.scale, bn.bias])
        out[name] = {"y": y.detach().float().cpu().numpy(),
                     "dx": x.grad.float().cpu().numpy(),
                     "dscale": bn.scale.grad.cpu().numpy(),
                     "dbias": bn.bias.grad.cpu().numpy(),
                     "mean": bn.mean.cpu().numpy().copy(),
                     "var": bn.var.cpu().numpy().copy()}
    return out


def pipeline_step_rank(mode: int, cfg, case: Dict[str, Any], seed: int = 0,
                       dev=None, check_gathers: bool = False
                       ) -> Dict[str, Any]:
    """This rank's pipeline train step of ``case`` on its rows: mode 1
    ``speaker_train_step`` on ``speaker_step_case``'s global draws, mode 2
    ``listener_train_step`` and mode 3 ``joint_rl_train_step``
    (``joint_step_case``'s two streams, ``joint_step_kw(cfg)``) on draws
    from a generator seeded ``seed`` (each draw made at the global batch's
    rows). Returns the global metrics, the summed gradients, the state
    after the step, the gather launches (checked exact with
    ``check_gathers``) and, in mode 3, this rank's rollout ids and host
    scores. On the card TF32 is off."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.parallel import mesh
    from d3net_tpu_torch.train import pipeline as pl
    from d3net_tpu_torch.train.trainer import create_train_state

    dev = _rank_device(dev)
    vocab, emb = pl.build_vocab(cfg)
    model = load_pipeline(case["variables"], cfg, vocab, device=dev)
    o = cfg.train.optim
    state = create_train_state(model, lr=o.lr, optim=o.classname,
                               weight_decay=o.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lw = tuple(cfg.train.loss_weight[:4])

    def inputs(batch_np, lang_np):
        return (batch_to_torch(mesh.shard_host_batch(batch_np), dev),
                pl.lang_rows(mesh.shard_host_batch(lang_np), emb, dev))

    before = gather.gather_rows.launches
    rollout = None
    with _parity(dev), (checked_gathers(f"the mode-{mode} dp step")
                        if check_gathers else contextlib.nullcontext()) as rec:
        if mode == 1:
            _, metrics = pl.speaker_train_step(
                state, *inputs(case["batch"], case["lang"]),
                chunk_size=case["chunk"], loss_weight=lw,
                jitter_u=torch.from_numpy(case["jitter"]).to(dev),
                proposal_perm=torch.from_numpy(case["perm"]).to(dev)[None],
                gumbel=torch.from_numpy(case["gumbel"]).to(dev))
        elif mode == 2:
            _, metrics = pl.listener_train_step(
                state, *inputs(case["batch"], case["lang"]), gen,
                chunk_size=case["chunk"], loss_weight=lw)
        else:
            streams = [x for s in ("spk", "lis")
                       for x in inputs(case[s][0], case[s][2])]
            _, metrics, rollout = pl.joint_rl_train_step(
                state, *streams, pl.make_caption_reward_fn(vocab), gen,
                **joint_step_kw(cfg))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _grad_arrays(model), "state": _state_arrays(model),
           "launches": gather.gather_rows.launches - before}
    if rec is not None:
        out.update(checked=rec.checked, max_abs_err=rec.max_abs_err)
    if rollout is not None:
        out["rollout"] = {k: rollout[k].cpu().numpy() for k in (
            "sampled_cap", "baseline_cap", "sampled_scores",
            "baseline_scores")}
    return out


def _tree_equal(a, b) -> bool:
    """Nested dicts/lists of tensors and plain values equal, bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a.cpu(), b.cpu())
    return a == b


def train_rank(cfg, run_dir: str, steps: Sequence[int]) -> Dict[str, Any]:
    """The config's run loop on this rank on the CPU
    (``scripts.train.run_training``) to each of ``steps`` in turn (a later
    one resumes from the run dir). Returns the final state's arrays and,
    for a detector run, whether a fresh state restored from the run dir
    equals it bit for bit (model, optimizer, scheduler, step)."""
    from d3net_tpu_torch.scripts.train import run_training
    from d3net_tpu_torch.train.loop import (
        Checkpointer, detector_from_cfg, init_detector,
    )
    from d3net_tpu_torch.train.pipeline import task_mode
    from d3net_tpu_torch.train.trainer import create_train_state

    for n in steps:
        state = run_training(cfg, run_dir, n, "cpu")
    out = {"state": _state_arrays(state.model), "step": state.step}
    if task_mode(cfg) == (1, 0, 0):
        fresh = create_train_state(init_detector(detector_from_cfg(cfg), 1),
                                   optim=cfg.train.optim.classname)
        Checkpointer(run_dir, "none").restore_last(fresh)
        out["restored_equal"] = (
            fresh.step == state.step
            and _tree_equal(fresh.model.state_dict(),
                            state.model.state_dict())
            and _tree_equal(fresh.optimizer.state_dict(),
                            state.optimizer.state_dict())
            and _tree_equal(fresh.scheduler.state_dict(),
                            state.scheduler.state_dict()))
    return out


EVAL_RTOL = 1e-5     # a float of an eval's output, world N against world 1


def eval_outputs(task: str, run_dir: str) -> Dict[str, Any]:
    """What an eval of ``task`` left in ``run_dir``: ``eval_<task>.json``
    as text and, for ``scannet``, every file of ``split_pred`` as bytes by
    its path under it."""
    with open(os.path.join(run_dir, f"eval_{task}.json")) as f:
        out: Dict[str, Any] = {"json": f.read()}
    if task == "scannet":
        root = os.path.join(run_dir, "split_pred")
        out["tree"] = {}
        for d, _, files in os.walk(root):
            for name in files:
                path = os.path.join(d, name)
                with open(path, "rb") as f:
                    out["tree"][os.path.relpath(path, root)] = f.read()
    return out


def seeded_run_dir(config: str, run_dir: str, seed: int = 0,
                   min_iou: Optional[float] = None) -> Dict[str, Any]:
    """A run dir of the task YAML ``config`` (``scripts.train.
    load_task_config``) holding one checkpoint, step 3, of seeded weights
    with nonzero biases and BN statistics (``randomize``), no training:
    the detector's for a detector config (task mode (1, 0, 0)), else the
    pipeline's; with ``eval.min_iou_threshold`` at ``min_iou`` when given.
    Returns the weights as a Flax tree of numpy leaves."""
    from d3net_tpu_torch import config as cfg_lib
    from d3net_tpu_torch.params import (
        flax_to_state_dict, init_flax_variables,
    )
    from d3net_tpu_torch.scripts.train import load_task_config
    from d3net_tpu_torch.train.loop import Checkpointer, detector_from_cfg
    from d3net_tpu_torch.train.pipeline import (
        build_vocab, pipeline_from_cfg, task_mode,
    )
    from d3net_tpu_torch.train.trainer import create_train_state

    cfg = load_task_config(config)
    if min_iou is not None:
        cfg.eval.min_iou_threshold = min_iou
    os.makedirs(run_dir)
    cfg_lib.save(cfg, os.path.join(run_dir, "config.yaml"))
    model = (detector_from_cfg(cfg) if task_mode(cfg) == (1, 0, 0)
             else pipeline_from_cfg(cfg, build_vocab(cfg)[0]))
    variables = randomize(init_flax_variables(model, seed),
                          np.random.default_rng(seed))
    model.load_state_dict(flax_to_state_dict(variables, model))
    Checkpointer(run_dir, "total_loss").save(
        3, create_train_state(model), {"total_loss": 1.0})
    return variables


@contextlib.contextmanager
def val_scene_count(n: Optional[int]):
    """The loaders' ``D3NET_VAL_SCENES`` at ``n`` while open (as it was
    for None)."""
    saved = os.environ.get("D3NET_VAL_SCENES")
    if n is not None:
        os.environ["D3NET_VAL_SCENES"] = str(n)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("D3NET_VAL_SCENES", None)
        else:
            os.environ["D3NET_VAL_SCENES"] = saved


@contextlib.contextmanager
def exact_settings(dev: torch.device):
    """On the card, ``device.parity_precision()`` and ``deterministic()``
    while open (the settings under which the bf16 detector's eval forward
    reproduces itself, ``detector_repro``); nothing on the CPU."""
    with contextlib.ExitStack() as stack:
        if dev.type == "cuda":
            stack.enter_context(device.parity_precision())
            stack.enter_context(deterministic())
        yield


def eval_rank(task: str, run_dir: str, val_scenes: Optional[int] = None,
              dev=None, check_gathers: bool = False,
              exact: bool = False) -> Dict[str, Any]:
    """This rank's ``task`` eval of ``run_dir`` as the eval CLI runs it
    (its ``config.yaml``, ``scripts.eval.tasks()``), on this rank's device
    (with no process group, in this process on ``dev`` alone, however many
    cards it sees), with ``D3NET_VAL_SCENES`` at
    ``val_scenes`` while it runs; a ``scannet`` eval first clears the run
    dir's ``split_pred`` (rank 0, the others waiting). With ``exact`` on
    the card it runs inside ``device.parity_precision()`` and
    ``deterministic()``: at the default settings the bf16 detector's eval
    forward does not reproduce itself run to run (atomic adds, bf16
    reductions), under them it does (``detector_repro``). Returns the
    metrics; on rank 0 ``eval_outputs``; the val batches this rank ran
    rows of, its ``gather_rows`` launches (the card's count) and, with
    ``check_gathers``, the gathers held exact against the plain version as
    they ran and their largest error; the seconds."""
    import shutil

    from d3net_tpu_torch import config as cfg_lib
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.parallel import mesh
    from d3net_tpu_torch.scripts.eval import tasks
    from d3net_tpu_torch.train.loop import num_val_scenes

    dev = _rank_device(dev)
    with val_scene_count(val_scenes):
        cfg = cfg_lib.load(os.path.join(run_dir, "config.yaml"))
        if task == "scannet":
            if mesh.is_main():
                shutil.rmtree(os.path.join(run_dir, "split_pred"),
                              ignore_errors=True)
            mesh.barrier()
        n, b = num_val_scenes(cfg), int(cfg.data.batch_size)
        batches = sum(
            mesh.split_rows(min(b, n - lo), mesh.rank(), mesh.world())[1] > 0
            for lo in range(0, n, b))
        gather.gather_rows.launches = 0
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if exact:
                stack.enter_context(exact_settings(dev))
            rec = (stack.enter_context(checked_gathers(f"the {task} eval"))
                   if check_gathers else None)
            metrics = tasks()[task](cfg, run_dir, dev, world_size=1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        out = {"task": task, "metrics": metrics, "val_batches": batches,
               "seconds": time.perf_counter() - t0,
               "launches": gather.gather_rows.launches}
        if rec is not None:
            out.update(checked=rec.checked, max_abs_err=rec.max_abs_err)
        if mesh.is_main():
            out.update(eval_outputs(task, run_dir))
        return out


def values_differ(got, want, where: str, rtol: float) -> List[str]:
    """Where ``got`` differs from ``want`` (nested dicts and lists): ints,
    bools and strings exact, floats within ``rtol``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [f"{where}: keys {sorted(got)} against {sorted(want)}"]
        return [d for k in want
                for d in values_differ(got[k], want[k], f"{where}.{k}",
                                        rtol)]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [f"{where}: {got!r} against {want!r}"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in values_differ(g, w, f"{where}[{i}]", rtol)]
    if isinstance(want, float) and isinstance(got, (int, float)):
        same = (math.isnan(want) and math.isnan(got)) or math.isclose(
            got, want, rel_tol=rtol, abs_tol=0.0)
    else:
        same = type(got) is type(want) and got == want
    return [] if same else [f"{where}: {got!r} against {want!r}"]


def eval_mismatches(got: List[Dict[str, Any]], want: Dict[str, Any],
                    rtol: float = EVAL_RTOL) -> List[str]:
    """Where a world-N eval (``eval_rank``'s results, in rank order)
    differs from world 1's (``want``: ``metrics`` and ``eval_outputs``):
    the metrics and the json file's values (ints and strings exact, floats
    within ``rtol``), every rank's metrics equal to rank 0's, the
    ``split_pred`` trees byte-equal, and every gather a rank checked
    exact."""
    bad = values_differ(got[0]["metrics"], want["metrics"], "metrics", rtol)
    bad += values_differ(json.loads(got[0]["json"]),
                          json.loads(want["json"]), "json", rtol)
    for r, g in enumerate(got[1:], 1):
        if g["metrics"] != got[0]["metrics"]:
            bad.append(f"rank {r}'s metrics differ from rank 0's")
    if "tree" in want:
        t0, t1 = got[0].get("tree", {}), want["tree"]
        if sorted(t0) != sorted(t1):
            bad.append(f"split_pred files {sorted(set(t0) ^ set(t1))}")
        bad += [f"split_pred/{k} differs" for k in t1
                if k in t0 and t0[k] != t1[k]]
    for r, g in enumerate(got):
        if "checked" in g and g["checked"] != g["launches"]:
            bad.append(f"rank {r}: {g['checked']} of {g['launches']} "
                       "gathers checked")
    return bad


def eval_calls(evals: Sequence[Tuple], dev=None,
               check_gathers: bool = False) -> List[Tuple]:
    """``rank_calls``' calls of each eval ``(task, run_dir, val_scenes[,
    exact])``: ``eval_rank`` on ``dev`` (None: the rank's device)."""
    return [(eval_rank, (task, run_dir, n, dev, check_gathers, *exact), {})
            for task, run_dir, n, *exact in evals]


def eval_reports(evals: Sequence[Tuple], ranks: List[List[Dict[str, Any]]],
                 one: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Each eval of ``evals`` on the ranks (``ranks[r][i]``: rank ``r``'s
    ``eval_rank`` result of eval ``i``) against world size 1 (``one[i]``):
    its ``eval_mismatches``, both worlds' metrics and seconds and each
    rank's launches a val batch; ``ok`` when none differs."""
    world = len(ranks)
    report, bad = [], []
    for i, (task, _, n, *exact) in enumerate(evals):
        got = [r[i] for r in ranks]
        miss = eval_mismatches(got, one[i])
        bad += [f"{task} (val scenes {n}): {m}" for m in miss]
        report.append({
            "task": task, "val_scenes": n, "exact": bool(exact and exact[0]),
            "mismatches": miss,
            "metrics_world1": one[i]["metrics"],
            f"metrics_world{world}": got[0]["metrics"],
            "seconds_world1": one[i].get("seconds"),
            f"seconds_world{world}": [g["seconds"] for g in got],
            "val_batches_per_rank": [g["val_batches"] for g in got],
            "launches_per_rank": [g["launches"] for g in got],
            "checked_per_rank": [g.get("checked") for g in got],
            "max_abs_err": max((g.get("max_abs_err") or 0.0) for g in got)})
    return {"ok": not bad, "world": world, "mismatches": bad,
            "evals": report}


def evals_world_vs_one(evals: Sequence[Tuple], world: int = 2,
                       one: Optional[List[Optional[Dict[str, Any]]]] = None,
                       dev=None, check_gathers: bool = False,
                       threads: Optional[int] = None, backend: str = "gloo",
                       devices: Optional[Sequence[str]] = None
                       ) -> Dict[str, Any]:
    """Each eval ``(task, run_dir, val_scenes[, exact])`` (``eval_rank``'s
    arguments) over ``world`` ranks in one spawn for all of them (gloo, on
    ``dev`` each: cuda:0 for two ranks on one card, where NCCL takes one
    rank a card; or ``backend`` over ``devices``, one a rank) against world
    size 1: ``one[i]`` (an ``eval_rank`` result) where given, else eval
    ``i`` run here on ``dev`` first (``eval_reports``)."""
    from d3net_tpu_torch.parallel import mesh

    one = [o if o is not None else rank_calls([c])[0] for o, c in zip(
        one or [None] * len(evals), eval_calls(evals, dev, check_gathers))]
    if devices is None and dev is not None:
        devices = [dev] * world
    # a rank evaluates on its own device (``devices[r]``)
    ranks = mesh.spawn(rank_calls, world, eval_calls(evals, None,
                                                     check_gathers),
                       backend=backend, devices=devices, threads=threads)
    return eval_reports(evals, ranks, one)


# the file or directory each model-running tool writes in its run dir
TOOL_OUTPUTS = {"benchmark_captioning": "benchmark_captioning.json",
                "benchmark_grounding": "benchmark_grounding.json",
                "visualize_captioning": "vis_captioning",
                "visualize_grounding": "vis_grounding"}


def tool_outputs(tool: str, run_dir: str) -> Dict[str, bytes]:
    """What ``tool`` left in ``run_dir``: each file (its JSON, or every
    file of its dump directory) as bytes by its path under ``run_dir``."""
    path = os.path.join(run_dir, TOOL_OUTPUTS[tool])
    if os.path.isfile(path):
        paths = [path]
    else:
        paths = [os.path.join(d, f) for d, _, files in os.walk(path)
                 for f in files]
    out = {}
    for p in sorted(paths):
        with open(p, "rb") as f:
            out[os.path.relpath(p, run_dir)] = f.read()
    return out


def tool_rank(tool: str, run_dir: str, val_scenes: Optional[int] = None,
              dev=None, check_gathers: bool = False, exact: bool = False,
              kw: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """This rank's run of the model-running ``tool`` (a name of
    ``TOOL_OUTPUTS``: ``scripts.<tool>.<tool>(cfg, run_dir, device, **kw)``,
    as its command line runs it) on ``run_dir``, as ``eval_rank`` runs an
    eval: on this rank's device (with no process group, in this process on
    ``dev`` alone), ``D3NET_VAL_SCENES`` at ``val_scenes`` while it runs,
    under the ``exact`` settings on the card when asked, every gather held
    exact with ``check_gathers``. Rank 0 first clears the tool's outputs
    (the others waiting), and after the run, once every rank has written
    its files, reads them all (``tool_outputs``). Returns rank 0's
    ``files``, this rank's val batches, ``gather_rows`` launches (and with
    ``check_gathers`` those checked and their largest error) and
    seconds."""
    import importlib
    import shutil

    from d3net_tpu_torch import config as cfg_lib
    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.parallel import mesh
    from d3net_tpu_torch.train.loop import num_val_scenes

    dev = _rank_device(dev)
    fn = getattr(importlib.import_module(f"d3net_tpu_torch.scripts.{tool}"),
                 tool)
    with val_scene_count(val_scenes):
        cfg = cfg_lib.load(os.path.join(run_dir, "config.yaml"))
        out = os.path.join(run_dir, TOOL_OUTPUTS[tool])
        if mesh.is_main():
            if os.path.isdir(out):
                shutil.rmtree(out)
            elif os.path.exists(out):
                os.remove(out)
        mesh.barrier()
        n, b = num_val_scenes(cfg), int(cfg.data.batch_size)
        limit = (kw or {}).get("scenes", n)
        batches = sum(
            mesh.split_rows(min(b, n - lo), mesh.rank(), mesh.world())[1] > 0
            for lo in range(0, min(n, limit), b))
        gather.gather_rows.launches = 0
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if exact:
                stack.enter_context(exact_settings(dev))
            rec = (stack.enter_context(checked_gathers(f"the {tool} run"))
                   if check_gathers else None)
            fn(cfg, run_dir, dev, world_size=1, **(kw or {}))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        res = {"tool": tool, "val_batches": batches,
               "seconds": time.perf_counter() - t0,
               "launches": gather.gather_rows.launches}
        if rec is not None:
            res.update(checked=rec.checked, max_abs_err=rec.max_abs_err)
        mesh.barrier()
        if mesh.is_main():
            res["files"] = tool_outputs(tool, run_dir)
        return res


def _ply_vertices(data: bytes) -> np.ndarray:
    """The vertex fields of a PLY file's bytes, as one float64 array."""
    import tempfile

    from d3net_tpu_torch.utils.ply import read_ply

    with tempfile.NamedTemporaryFile(suffix=".ply") as f:
        f.write(data)
        f.flush()
        v = read_ply(f.name)["vertex"]
    return np.stack([v[k].astype(np.float64) for k in v.dtype.names], -1)


def file_mismatches(got: Dict[str, bytes], want: Dict[str, bytes],
                    rtol: Optional[float] = None) -> Tuple[List[str], int]:
    """Where the files ``got`` differ from ``want`` (bytes by path): the
    same paths, each byte-equal; with ``rtol``, a ``.json`` or ``.ply``
    file whose bytes differ may hold the same values instead (its JSON
    values: ints and strings exact, floats within ``rtol``; its vertices
    within ``rtol`` / atol 1e-6). Returns the mismatches and how many
    files were byte-equal."""
    bad = []
    if sorted(got) != sorted(want):
        bad.append(f"files {sorted(set(got) ^ set(want))}")
    same = 0
    for k in want:
        if k not in got:
            continue
        if got[k] == want[k]:
            same += 1
        elif rtol is not None and k.endswith(".json"):
            bad += values_differ(json.loads(got[k]), json.loads(want[k]), k,
                                 rtol)[:5]
        elif rtol is not None and k.endswith(".ply"):
            g, w = _ply_vertices(got[k]), _ply_vertices(want[k])
            if g.shape != w.shape or not np.allclose(g, w, rtol=rtol,
                                                     atol=1e-6):
                bad.append(f"{k}: vertices differ")
        else:
            bad.append(f"{k} differs")
    return bad, same


def tool_calls(tools: Sequence[Tuple], dev=None,
               check_gathers: bool = False) -> List[Tuple]:
    """``rank_calls``' calls of each tool run ``(tool, run_dir, val_scenes,
    exact[, kw])``: ``tool_rank`` on ``dev`` (None: the rank's device)."""
    return [(tool_rank, (tool, run_dir, n, dev, check_gathers, exact,
                         *rest), {})
            for tool, run_dir, n, exact, *rest in tools]


def tool_reports(tools: Sequence[Tuple], ranks: List[List[Dict[str, Any]]],
                 one: List[Dict[str, Any]],
                 rtol: Optional[float] = None) -> Dict[str, Any]:
    """Each tool run of ``tools`` on the ranks (``ranks[r][i]``: rank
    ``r``'s ``tool_rank`` result of run ``i``) against world size 1
    (``one[i]``): the files byte-equal (the same paths, each the same
    bytes: the JSON's scene order included), or with ``rtol`` equal in
    value where their bytes differ (``file_mismatches``); every gather a
    rank checked exact; both worlds' seconds, each rank's launches a val
    batch, the files byte-equal; ``ok`` when none differs."""
    world = len(ranks)
    report, bad = [], []
    for i, (tool, _, n, exact, *_) in enumerate(tools):
        got = [r[i] for r in ranks]
        want = one[i]["files"]
        miss, same = file_mismatches(got[0]["files"], want, rtol)
        for r, g in enumerate(got):
            if "checked" in g and g["checked"] != g["launches"]:
                miss.append(f"rank {r}: {g['checked']} of {g['launches']} "
                            "gathers checked")
        bad += [f"{tool} (val scenes {n}): {m}" for m in miss]
        report.append({
            "tool": tool, "val_scenes": n, "exact": bool(exact),
            "mismatches": miss, "files": len(want), "byte_equal": same,
            "bytes": sum(len(v) for v in want.values()),
            "seconds_world1": one[i]["seconds"],
            f"seconds_world{world}": [g["seconds"] for g in got],
            "val_batches_per_rank": [g["val_batches"] for g in got],
            "launches_per_rank": [g["launches"] for g in got],
            "checked_per_rank": [g.get("checked") for g in got],
            "max_abs_err": max((g.get("max_abs_err") or 0.0) for g in got)})
    return {"ok": not bad, "world": world, "mismatches": bad,
            "tools": report}


def tools_world_vs_one(tools: Sequence[Tuple], world: int = 2,
                       one: Optional[List[Optional[Dict[str, Any]]]] = None,
                       dev=None, check_gathers: bool = False,
                       threads: Optional[int] = None, backend: str = "gloo",
                       devices: Optional[Sequence[str]] = None,
                       rtol: Optional[float] = None) -> Dict[str, Any]:
    """Each tool run ``(tool, run_dir, val_scenes, exact[, kw])``
    (``tool_rank``'s arguments) over ``world`` ranks in one spawn for all
    of them, against world size 1 (``one[i]`` where given, else run here
    on ``dev`` first), as ``evals_world_vs_one`` holds the evals
    (``tool_reports`` at ``rtol``)."""
    from d3net_tpu_torch.parallel import mesh

    one = [o if o is not None else rank_calls([c])[0] for o, c in zip(
        one or [None] * len(tools), tool_calls(tools, dev, check_gathers))]
    if devices is None and dev is not None:
        devices = [dev] * world
    ranks = mesh.spawn(rank_calls, world, tool_calls(tools, None,
                                                     check_gathers),
                       backend=backend, devices=devices, threads=threads)
    return tool_reports(tools, ranks, one, rtol)


REPRO_FLOATS = ("semantic_scores", "pt_offsets", "proposal_scores_all")
REPRO_INTS = ("member_pt", "cluster_mask_all", "proposal_batch_mask")


def detector_repro(model, scenes: Sequence[Any], spec,
                   dev) -> Dict[str, Dict[str, Any]]:
    """Whether the detector's eval forward on ``dev`` reproduces itself,
    at the default settings and under ``device.parity_precision()`` with
    ``deterministic()``: ``scenes`` (an even count) as one batch twice
    (``run_to_run``), and each half as a batch of its own against its rows
    of the whole (``halves``: what two ranks run). Per case the largest
    difference of each of ``REPRO_FLOATS`` and the count of differing
    entries of each of ``REPRO_INTS`` (cluster ids, proposal masks)."""
    from d3net_tpu_torch.data.collate import batch_to_torch, build_batch

    h = len(scenes) // 2
    batches = [build_batch(list(part), spec)
               for part in (scenes, scenes[:h], scenes[h:])]

    def forward(b):
        with torch.no_grad():
            out = model(batch_to_torch(b, dev), train=False)
        return {k: out[k].float().cpu().numpy()
                for k in REPRO_FLOATS + REPRO_INTS}

    def differ(a, b):
        return {**{k: float(np.abs(a[k] - b[k]).max()) for k in REPRO_FLOATS},
                **{f"{k}_differ": int((a[k] != b[k]).sum())
                   for k in REPRO_INTS}}

    out = {}
    for name, exact in (("default", False), ("exact", True)):
        with contextlib.ExitStack() as stack:
            if exact:
                stack.enter_context(device.parity_precision())
                stack.enter_context(deterministic())
            whole, again, first, second = [forward(b)
                                           for b in batches[:1] + batches]
        out[name] = {
            "run_to_run": differ(whole, again),
            "halves": differ({k: np.concatenate([first[k], second[k]])
                              for k in whole}, whole)}
    return out


def checkpoint_rank(run_dir: str) -> Dict[str, Any]:
    """``Checkpointer.save`` of step 5 (monitor ``total_loss`` at 0.5) on
    this rank: whether this rank's checkpointer took it as its best (rank
    0 alone decides), and whether the checkpoint was on disk when save
    returned."""
    from d3net_tpu_torch.train.loop import Checkpointer
    from d3net_tpu_torch.train.trainer import create_train_state

    ckpt = Checkpointer(run_dir, "total_loss")
    ckpt.save(5, create_train_state(torch.nn.Linear(2, 2)),
              {"total_loss": 0.5})
    return {"wrote": ckpt.best_step == 5,
            "on_disk": os.path.exists(os.path.join(
                run_dir, "ckpt_best", "5", "state.pt"))}


def cap_counters_rank() -> Dict[str, float]:
    """The run loop's cap counters (``loop._cap_counters``) on this rank
    after it counted ``rank + 1`` truncated points: the global batch's sum
    under a process group."""
    from d3net_tpu_torch.data.collate import CAP_STATS
    from d3net_tpu_torch.parallel import mesh
    from d3net_tpu_torch.train.loop import _cap_counters

    CAP_STATS.reset()
    CAP_STATS.add(cap_points_truncated=mesh.rank() + 1, batches=1)
    return _cap_counters()


def mesh_rank(batch_size: int) -> Dict[str, Any]:
    """``parallel.mesh`` on this rank: a linear layer and its AdamW state
    made from a rank-seeded draw, then ``replicate``; and ``make_mesh``
    under the group at ``batch_size`` (its error message when the batch
    does not split over the ranks)."""
    from d3net_tpu_torch.parallel import mesh

    torch.manual_seed(1 + mesh.rank())
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters())
    model(torch.randn(4, 3)).sum().backward()
    opt.step()
    mesh.replicate(model, opt)
    try:
        mesh.make_mesh(batch_size)
        error = None
    except ValueError as e:
        error = str(e)
    return {"rank": mesh.rank(), "world": mesh.world(),
            "model": _state_arrays(model),
            "adam": [{k: v.numpy().copy() for k, v in opt.state[p].items()}
                     for p in model.parameters()],
            "error": error}


def trace_rank() -> Dict[str, Any]:
    """The tracer on this rank under a CPU profiler session: a reduction
    of the step (``all_reduce_sum``, ``sum_metrics``), a host gather and
    rank 0's object broadcast -> each span's name and counters, and the
    window's sums."""
    from torch.profiler import ProfilerActivity, profile

    from d3net_tpu_torch import trace
    from d3net_tpu_torch.parallel import mesh

    x = torch.full((4,), float(mesh.rank() + 1))
    with profile(activities=[ProfilerActivity.CPU]):
        total = mesh.all_reduce_sum(x)
        mesh.sum_metrics({"a": x.sum()})
        mesh.host_all_gather(np.ones((2, 3), np.int32))
        mesh.broadcast_from_main({"rank": mesh.rank()})
    w = trace.last_window()
    return {"spans": [(s.name, dict(s.counts)) for s in w.spans],
            "counts": w.counts, "total": total.tolist()}


def flagship_step_syncs(dev, scenes: int = 4, warm: int = 2
                        ) -> Dict[str, Any]:
    """The host syncs of one scan-trainer step in conf/flagship_converge.
    yaml's layout on ``dev`` (its stack of ``scenes`` seeded scenes with
    their synthetic multiview features in place of the feature store,
    bf16), after ``warm`` steps: the step traced under a CPU profiler
    session -> ``host_syncs`` inside its ``train.step`` span and the
    ``file:line`` of each (``trace.last_window``)."""
    from torch.profiler import ProfilerActivity, profile

    from d3net_tpu_torch import trace
    from d3net_tpu_torch.scripts.train import load_task_config
    from d3net_tpu_torch.train import loop
    from d3net_tpu_torch.train.trainer import (
        create_train_state, detector_train_step,
    )

    cfg = load_task_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "conf", "flagship_converge.yaml"))
    cfg.data.multiview_hdf5 = None
    cfg.data.synthetic.num_scenes = scenes
    cfg.data.synthetic.num_val_scenes = 1
    cfg.data.batch_size = scenes
    cfg.tpu.augment_variants = 1
    train_it, _ = loop.make_dataloaders(cfg, loop.spec_from_cfg(cfg))
    stack, nb = loop.build_scan_stack(cfg, train_it, dev)
    state = create_train_state(
        loop.init_detector(loop.detector_from_cfg(cfg),
                           cfg.general.manual_seed).to(dev),
        **loop.optimizer_kw(cfg, scan=True))
    lw = tuple(cfg.train.loss_weight[:4])

    def step():
        detector_train_step(state, loop.stack_batch(stack, state.step % nb),
                            loop.step_generator(1, state.step, dev),
                            loss_weight=lw, sum_metrics=False)

    for _ in range(warm):
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    w = trace.last_window()
    return {"host_syncs": w.under("train.step", "host_syncs"),
            "sites": w.sync_sites}


def launcher_rank(r: int, world_size: int, port: int) -> None:
    """One process of a launcher-made group (``torchrun``'s environment,
    rendezvous at localhost:``port``): ``mesh.init_multihost`` joins it,
    then an all-reduce of the ranks' ids must give their sum."""
    from d3net_tpu_torch.parallel import mesh

    os.environ.update(WORLD_SIZE=str(world_size), RANK=str(r),
                      LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    info = mesh.init_multihost()
    try:
        total = mesh.all_reduce_sum(torch.tensor([float(r)]))
        want = {"process_index": r, "process_count": world_size}
        if {k: info[k] for k in want} != want or float(total) != sum(
                range(world_size)):
            raise AssertionError(f"rank {r}: {info}, all-reduce {total}")
    finally:
        mesh.teardown()


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (warning where an op has none)
    and cuDNN's deterministic convolutions inside the block; the previous
    settings come back on exit."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
        torch.backends.cudnn.benchmark = saved[3]


def _scaled_diffs(got: Dict[str, torch.Tensor],
                  want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per key: the largest difference over the largest magnitude of
    ``want`` (0 where bit-equal)."""
    out = {}
    for k, w in want.items():
        a, b = got[k].detach().double(), w.detach().double()
        d = float((a - b).abs().max()) if a.numel() else 0.0
        out[k] = d / max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
    return out


def world1_group_step(variables, cfg: Dict[str, Any], batch: Dict,
                      seed: int = 0, then=None, dev="cuda",
                      backend: str = "nccl") -> Dict[str, Any]:
    """The detector train step through the distributed path on a one-rank
    group (NCCL on the card) against the step with no group, from the same
    weights, on the same batch (tensors on ``dev``) and the same
    generator's draws. An all-reduce over one rank is a copy, and every
    other op of the distributed path computes the same values, so the
    metrics, gradients, parameters and BN statistics are bit-equal where
    the step itself is bit-reproducible. The three steps run under
    PyTorch's deterministic algorithms (the card's atomic adds in
    ``index_add_`` and the scatters otherwise sum in another order each
    run), and the step with no group runs twice: a tensor where those two
    differ (an op with no deterministic version) may differ in the
    distributed step by at most 4x their scaled difference
    (``_scaled_diffs``), every other tensor must be bit-equal. Returns the
    comparison and the distributed step's metrics and gathers (each held
    exact against its plain version); ``then(state)``, called with the
    group still set up and the deterministic algorithms off, adds its dict
    under ``"then"``."""
    import tempfile

    from d3net_tpu_torch.kernels import gather
    from d3net_tpu_torch.parallel import mesh
    from d3net_tpu_torch.params import load_detector
    from d3net_tpu_torch.train.trainer import (
        create_train_state, detector_train_step,
    )

    def step(check: bool):
        state = create_train_state(load_detector(variables, cfg,
                                                 device=dev))
        gen = torch.Generator(device=dev).manual_seed(seed)
        before = gather.gather_rows.launches
        with (checked_gathers("the world-1 group's step") if check
              else contextlib.nullcontext()) as rec:
            _, metrics = detector_train_step(state, batch, gen)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        parts = {"metrics": dict(metrics),
                 "state": {k: v.clone() for k, v in
                           state.model.state_dict().items()},
                 "grads": {n: p.grad.clone() for n, p in
                           state.model.named_parameters()}}
        return state, parts, rec, gather.gather_rows.launches - before

    with deterministic():
        ref = step(False)[1]
        again = step(False)[1]
    with tempfile.TemporaryDirectory(prefix="d3net_group_") as tmp:
        mesh.setup(0, 1, f"file://{os.path.join(tmp, 'rendezvous')}",
                   backend)
        try:
            with deterministic():
                state, got, rec, launches = step(True)
            extra = then(state) if then is not None else None
        finally:
            mesh.teardown()
    report, ok = {}, True
    for part in ("metrics", "state", "grads"):
        noise = _scaled_diffs(again[part], ref[part])
        diff = _scaled_diffs(got[part], ref[part])
        beyond = sorted(k for k, d in diff.items() if d > 4.0 * noise[k])
        report[part] = {"ref_vs_ref": max(noise.values()),
                        "dist_vs_ref": max(diff.values()),
                        "differ": sorted(k for k, d in diff.items() if d),
                        "beyond": beyond}
        ok = ok and not beyond
    return {"ok": ok, "bit_equal": not any(r["differ"]
                                           for r in report.values()),
            "step_reproducible": not any(r["ref_vs_ref"]
                                         for r in report.values()),
            "compare": report,
            "metrics": {k: float(v) for k, v in got["metrics"].items()},
            "launches": launches, "checked": rec.checked,
            "max_abs_err": rec.max_abs_err, "then": extra}


def world_grad_mismatches(got: Dict[str, np.ndarray],
                          want: Dict[str, np.ndarray],
                          got_moved: Dict[str, np.ndarray],
                          want_moved: Dict[str, np.ndarray]
                          ) -> Tuple[List[str], int]:
    """World N's gradients ``got`` against world 1's ``want`` for a step
    whose backward into the detector is ill-conditioned in f32 (the
    listener's, the joint step's): ``grad_mismatches`` at rtol 1e-3 / atol
    1e-6, where an element outside passes within 4x the largest one-ulp
    movement of its tensor in either world (``*_moved``: the same step on
    weights moved by one ulp, ``ulp_moved``), for under 1% of the step's
    elements; the listener's BN-fed biases, zero gradients, within the
    same. The listener's Flax BatchNorm takes E[x²] - E[x]², whose
    cancellation turns the ranks' split sums into more than a weight's ulp
    at a few elements."""
    noise = {k: np.full_like(w, max(float(np.abs(want_moved[k] - w).max()),
                                    float(np.abs(got_moved[k] - got[k])
                                          .max())))
             for k, w in want.items()}
    return grad_mismatches(got, want, noise, zero_grads=BN_FED_BIASES,
                           per_tensor=False, zero_by_noise=True)


# tests/test_parallel.py's parameter bounds, by clustering
DIST_PARAM_TOL = {False: dict(rtol=1e-5, atol=2e-6),
                  True: dict(rtol=2e-3, atol=5e-5)}


# ``bn_case`` in bf16 at counts above 256, where bf16 rounds integers: the
# seed's ranks' counts round apart from the global count at 2 and 4 ranks
BF16_BN_SHAPES = {"rows": (4, 512, 8), "grid": (8, 6, 8, 8, 8),
                  "listener": (32, 8)}
BF16_BN_SEED = 8


def bf16_bn_mismatches(ranks: List[Dict[str, Dict[str, np.ndarray]]],
                       one: Dict[str, Dict[str, np.ndarray]]) -> List[str]:
    """``MaskedBatchNorm`` in bf16 (``bn_rank``) on the ranks against one
    process: the running statistics and the parameters' gradients (f32)
    within rtol 1e-5 / atol 1e-6 and bit-identical across the ranks, the
    rows' output and dx (bf16) within one bf16 ulp."""
    bad = []
    for name in ("rows", "grid"):
        want = one[name]
        for k in ("mean", "var", "dscale", "dbias"):
            if not np.allclose(ranks[0][name][k], want[k], rtol=1e-5,
                               atol=1e-6):
                bad.append(f"bf16 bn {name} {k}")
            if any(not np.array_equal(r[name][k], ranks[0][name][k])
                   for r in ranks[1:]):
                bad.append(f"bf16 bn {name} {k} differs across ranks")
        for k in ("y", "dx"):
            if not np.allclose(np.concatenate([r[name][k] for r in ranks]),
                               want[k], rtol=2.0 ** -8, atol=1e-6):
                bad.append(f"bf16 bn {name} {k}")
    return bad


def dist_ranks_on_one_card(det_case: Dict[str, Any], joint_cfg,
                           joint_case: Dict[str, Any], world: int = 2,
                           also: Sequence[Tuple[Any, tuple, Dict]] = ()
                           ) -> Dict[str, Any]:
    """``world`` ranks on cuda:0 over gloo (NCCL takes one rank a card)
    against world size 1 on the card, TF32 off, every gather of every rank
    held exact against its plain version: the detector step of
    ``det_case`` (``detector_case``) without and with clustering, the
    mode-3 joint step of ``joint_case`` (``joint_step_case``), and
    ``MaskedBatchNorm`` in bf16 (``bf16_bn_mismatches``). The calls
    ``also`` run after them in the same ranks only (one start of the
    ranks); every rank's results of them come back under ``also``, in
    rank order. Held to
    tests/test_parallel.py's bounds (clustering off: losses rtol 1e-5 /
    atol 1e-6, parameters rtol 1e-5 / atol 2e-6; on: ``score_loss``,
    ``gt_iou_mean``, ``total_loss`` and ``grad_norm`` atol 5e-3,
    parameters rtol 2e-3 / atol 5e-5, the cluster ids recorded) and the
    joint step's (rollout ids and host scores equal, metrics rtol 1e-4 /
    atol 1e-6, gradients ``world_grad_mismatches``: the joint step's
    backward into the detector is ill-conditioned in f32, so both worlds
    also run it on weights moved by one ulp); parameters bit-identical
    across the ranks. ``ok`` when all hold."""
    from d3net_tpu_torch.parallel import mesh

    dev = "cuda:0"
    moved = dict(joint_case, variables=ulp_moved(
        joint_case["variables"], np.random.default_rng(3)))
    calls = [(detector_step_rank, (det_case, c, "SGD", dev, True), {})
             for c in (False, True)]
    calls += [(pipeline_step_rank, (3, joint_cfg, case, 0, dev, True), {})
              for case in (joint_case, moved)]
    calls.append((bn_rank, (bn_case(BF16_BN_SHAPES, BF16_BN_SEED),
                            "bfloat16", dev), {}))
    one = rank_calls(calls)
    ranks = mesh.spawn(rank_calls, world, calls + list(also),
                       backend="gloo", devices=[dev] * world)
    bad = bf16_bn_mismatches([r[4] for r in ranks], one[4])
    report = {}
    for i, name in enumerate(("det_no_clustering", "det_clustering",
                              "joint", "joint_ulp_moved")):
        want = one[i]
        got = [r[i] for r in ranks]
        for r, g in enumerate(got):
            if g["checked"] != g["launches"] or g["launches"] == 0:
                bad.append(f"{name} rank {r}: {g['checked']} of "
                           f"{g['launches']} gathers checked")
            if any(not np.array_equal(g["state"][k], v)
                   for k, v in got[0]["state"].items()):
                bad.append(f"{name} rank {r}: parameters differ from rank 0")
        g0 = got[0]
        rec = {"launches_per_rank": [g["launches"] for g in got],
               "launches_world1": want["launches"],
               "metrics_world1": want["metrics"],
               f"metrics_world{world}": g0["metrics"]}
        if name.startswith("det"):
            clus = name == "det_clustering"
            for k, v in want["metrics"].items():
                chaotic = clus and k in ("score_loss", "gt_iou_mean",
                                         "total_loss", "grad_norm")
                ok = (abs(g0["metrics"][k] - v) <= 5e-3 if chaotic else
                      np.isclose(g0["metrics"][k], v, rtol=1e-5, atol=1e-6))
                if not ok:
                    bad.append(f"{name} metric {k}")
            for k, v in want["state"].items():
                if not np.allclose(g0["state"][k], v, **DIST_PARAM_TOL[clus]):
                    bad.append(f"{name} state {k}")
            if clus:
                rec["cluster_ids_equal"] = {k: bool(np.array_equal(
                    np.concatenate([g["ints"][k] for g in got]), v))
                    for k, v in want["ints"].items()}
        elif name == "joint":
            for k, v in want["metrics"].items():
                if not np.isclose(g0["metrics"][k], v, rtol=1e-4, atol=1e-6):
                    bad.append(f"joint metric {k}")
            for k, v in want["rollout"].items():
                if not np.array_equal(np.concatenate(
                        [g["rollout"][k] for g in got]), v):
                    bad.append(f"joint rollout {k}")
            g_bad, noise_passed = world_grad_mismatches(
                g0["grads"], want["grads"], ranks[0][3]["grads"],
                one[3]["grads"])
            bad += [f"joint grad {k}" for k in g_bad]
            rec["grad_elements_passed_as_noise"] = noise_passed
        report[name] = rec
    return {"ok": not bad, "world": world, "outside_tolerance": bad,
            "gathers_max_abs_err": max(r[i]["max_abs_err"] for r in ranks
                                       for i in range(4)),
            **report, "also": [r[len(calls):] for r in ranks]}


def failing_rank() -> None:
    """Rank 1 raises while rank 0 waits in an all-reduce for it: the
    spawn must bring rank 0 down and raise rank 1's error, not hang."""
    from d3net_tpu_torch.parallel import mesh

    if mesh.rank() == 1:
        raise ValueError("rank 1 failed before its all-reduce")
    mesh.all_reduce_sum(torch.ones(4))
