"""The speaker, the listener and the joint RL step on cuda against the
same on cpu, shared by ``chip_smoke.py`` (phases ``caption_parity``,
``spk_train_parity``, ``grounding_parity``, ``lis_train_parity``,
``joint_parity``) and the card tests
``tests/test_torch_cuda.py::test_speaker_cuda_matches_cpu``,
``test_speaker_train_step_cuda_matches_cpu``,
``test_listener_cuda_matches_cpu``,
``test_listener_train_step_cuda_matches_cpu`` and
``test_joint_step_cuda_matches_cpu``.

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
from typing import Any, Dict, List, Optional, Tuple

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
