"""The plain reference of the dense-captioning eval.

A frozen copy of the port's plain code (``frozen/``) builds the
``PipelineNet`` of the configuration from the benchmark's weights, its
vocabulary and embeddings, and the val batches from the same scenes, in
float32 with TF32 off. For each sampled val batch it runs the detector
and the relational graph on its own, and compares each stage's outputs
with the program's:

- ``forward``: the per-point semantic scores and offsets that the
  clustering starts from;
- ``objectness``: the ScoreNet logits that the proposal selection ranks,
  over the program's clusters;
- ``features``: the decoder's inputs, the graph's proposal features;
- ``caption_gap``: by how much each served caption token's logit lies
  below the best, with the program's decoder inputs teacher-forced
  through the reference's decoder (up to the caption's first eos, over
  the proposals the batch keeps).

Three discrete stages are followed, not recomputed: the clusters, the
proposal selection (which slots pass the objectness and size thresholds,
and the top ``max_num_proposal`` of those by objectness: a score near the
threshold, or near-equal scores, go the other way under the program's
TF32 ScoreNet, and a slot let through or not changes the graph's
neighbours and every caption that reads them), and the decoder's
inputs. Near-equal logits swap the greedy tokens as near-equal
scores do, so a decoder fed the reference's own features (which part
from the program's by TF32's rounding) reads the program's tokens as far
below its best as a bfloat16 decoder's. Each followed stage is checked by
itself: the frozen clustering and the frozen stable top-k, run on the
program's own inputs to them, have to give the program's outputs
exactly, and the decoder's inputs are ``features``. The decoder's valid
masks come from the followed proposals' boxes, so the reference's own
serve.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Any, Dict, List, Mapping, Optional

import torch

import perfbench.reference.frozen.models.pointgroup as frozen_pg
from perfbench.reference import precision
from perfbench.reference.compare import global_diff
from perfbench.reference.det_train import model_kwargs, spec
from perfbench.reference.frozen.data.collate import batch_to_torch
from perfbench.reference.frozen.data.dataset import BatchIterator
from perfbench.reference.frozen.data.language import base_corpus
from perfbench.reference.frozen.data.vocab import (
    Vocabulary, embedding_matrix,
)
from perfbench.reference.frozen.models.pipeline import PipelineNet
from perfbench.reference.frozen.ops.cluster import topk_stable

# the detector outputs compared (the program's records hold these)
DETECTOR_KEYS = ("semantic_scores", "pt_offsets", "proposal_scores_all",
                 "cluster_mask_all")


def build(cfg: Mapping[str, Any], device) -> tuple:
    """(PipelineNet, vocabulary, embeddings) of the configuration."""
    vocab = Vocabulary.build(base_corpus())
    emb = embedding_matrix(vocab, cfg.get("glove_path"))
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    det = dict(model_kwargs(cfg),
               requires_gt_mask=bool(d.get("requires_gt_mask", False)))
    sp = spec(cfg)
    net = PipelineNet(
        sp.feat_dim() + 3 * bool(m["use_coords"]), det,
        num_vocabs=len(vocab), sos_id=vocab.sos_id, eos_id=vocab.eos_id,
        pad_id=vocab.pad_id, num_graph_steps=m["num_graph_steps"],
        num_locals=m["num_locals"], max_spk_len=d["max_spk_len"],
        min_iou_threshold=d["min_iou_threshold"],
        use_relation=m["use_relation"], use_orientation=m["use_orientation"],
        use_lang_classifier=m["use_lang_classifier"],
        use_bidir=m["use_bidir"], match_type=m["match_type"],
        num_text_classes=m["num_bbox_class"],
        no_captioning=bool(m["no_captioning"]),
        no_grounding=bool(m["no_grounding"]),
        beam_group_size=int(t.get("beam_group_size", 1) or 1),
        diversity_lambda=float(t.get("diversity_lambda", 0.5)))
    return net.to(device), vocab, torch.from_numpy(emb).to(device)


def teacher_forced_logits(caption, embeddings, target_feat, obj_feats,
                          valid_masks, ids: torch.Tensor) -> torch.Tensor:
    """The greedy decode's rollout with step t reading ``ids[:, t-1]``
    (sos at t = 0) in place of its own pick -> logits (N, T, V)."""
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


@contextlib.contextmanager
def _follow(net, rec: Mapping[str, list], device):
    """The frozen detector taking the program's clusters and selection
    (which slots pass the test thresholds, and the top ones of those) for
    one batch."""
    clusters = iter(rec["clusters"])
    ranks = iter(rec["ranks"])
    valids = iter([program_valid(r[0]).to(device) for r in rec["ranks"]])
    inner = frozen_pg.topk_stable

    def program_clusters(*_):
        return [o.to(device) for o in next(clusters)["outputs"]]

    def program_selection(rank, k):
        idx = next(ranks)[1].to(device)
        return rank.gather(-1, idx.long()), idx

    net.detector._cluster_batch = program_clusters
    net.detector._proposal_valid = lambda *_: next(valids)
    frozen_pg.topk_stable = program_selection
    try:
        yield
    finally:
        frozen_pg.topk_stable = inner
        del net.detector._cluster_batch, net.detector._proposal_valid


def program_valid(rank: torch.Tensor) -> torch.Tensor:
    """The slots the program let through its test thresholds: its ranking
    holds their objectness (a sigmoid, >= 0) and -1 elsewhere."""
    return rank > -0.5


def median_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The median element's ``|got - want|`` over the median ``|want|``:
    the typical rounding, where :func:`global_diff` is led by the few
    largest differences (0 where there is nothing to compare)."""
    if not want.numel():
        return 0.0
    return float((got.float() - want.float()).abs().median()
                 / want.float().abs().median().clamp(min=1e-30))


def _stages(net, emb, batch, rec, device, scorenet=None):
    """The frozen detector (taking the program's clusters and selection)
    and graph on one batch -> (detector outputs, decoder inputs); the
    ScoreNet's (scores, pooled) go into ``scorenet`` where given."""
    sn = net.detector.score_net
    if scorenet is not None:
        inner = sn.forward

        def kept(*a, **k):
            scorenet.append(inner(*a, **k))
            return scorenet[-1]
        sn.forward = kept
    try:
        with _follow(net, rec, device):
            det = net.run_detector(batch)
    finally:
        if scorenet is not None:
            del sn.forward
    data = net.speaker.graph({**det, "glove_embeddings": emb})
    return det, net.speaker.caption.eval_inputs(data)


def score_head_gap(net, scores: torch.Tensor, pooled: torch.Tensor,
                   keep: torch.Tensor) -> float:
    """The ScoreNet's last layer rerun on the served pooled features of
    the kept clusters: the relative difference of the served logits."""
    want = net.detector.score_net.Dense_0(pooled.float())[:, 0]
    return global_diff({"s": scores.float()[keep]}, {"s": want[keep]})


def _served(ids: torch.Tensor, eos: int) -> torch.Tensor:
    """(N, T) mask of the tokens up to and including each row's first
    eos."""
    is_eos = (ids == eos).int()
    return (torch.cumsum(is_eos, 1) - is_eos) == 0


def detector_gaps(got: Mapping[str, torch.Tensor],
                  want: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """``forward``: the larger relative difference (``|got - want| /
    |want|``) of the per-point semantic scores and offsets; ``objectness``:
    that of the proposals' ScoreNet logits over the clusters the program
    kept (``cluster_mask_all``), and ``objectness.median`` its typical
    gap (:func:`median_gap`)."""
    keep = got["cluster_mask_all"].bool()
    gs = got["proposal_scores_all"].float()[keep]
    ws = want["proposal_scores_all"].float()[keep]
    return {
        "forward": max(global_diff({k: got[k].float()},
                                   {k: want[k].float()})
                       for k in ("semantic_scores", "pt_offsets")),
        "objectness": global_diff({"s": gs}, {"s": ws}),
        "objectness.median": median_gap(gs, ws),
    }


def judge_sample(cfg: Mapping[str, Any], scenes: List[Any],
                 start: Mapping[str, torch.Tensor],
                 sample: List[Mapping[str, Any]], device,
                 control: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared over the sampled val batches (each the
    program's records of one batch, with its index ``batch``), each the
    largest over the batches: ``caption_gap`` (the widest gap, in logits,
    of a served token below the reference decoder's best on the served
    decoder inputs), ``logits`` (the largest gap between a served token's
    logit and the reference's logit of that token), ``features`` (the
    larger relative difference of the decoder's target and object
    features; ``features.median`` the typical gap of the target features
    of the proposals kept), ``forward``,
    ``objectness`` and ``objectness.median`` (:func:`detector_gaps`),
    ``score_head`` (:func:`score_head_gap`),
    ``clusters`` and ``selection`` (shares of the program's decisions the
    frozen stage, rerun on the program's inputs, gives otherwise; the
    selection is the test thresholds' pass and the top slots).
    ``control="bfloat16"`` puts the reference computed with bfloat16
    products in the program's place: its detector outputs and decoder
    inputs, and at each position of the same captions the token its
    decoder puts first on those inputs, are judged."""
    cfg = copy.deepcopy(cfg)
    net, vocab, emb = build(cfg, device)
    net.load_state_dict(start)
    net.eval()
    caption = net.speaker.caption
    it = BatchIterator(scenes, spec(cfg), cfg["data"]["batch_size"],
                       shuffle=False, augment=False, seed=0, drop_last=False,
                       return_scenes=True, prefetch=0, workers=1)
    order = it._order()
    gap = dlog = fwd = obj = feat = obj_m = feat_m = head = 0.0
    bad_c = tot_c = bad_s = tot_s = 0
    with torch.no_grad(), precision.plain_f32():
        for rec in sample:
            bnp = it._build_one(order, rec["batch"])[0]
            clus, rank, ids = rec["clusters"], rec["ranks"], rec["ids"]
            batch = batch_to_torch(bnp, device)
            one = {"clusters": [clus], "ranks": [rank]}
            b, p, t = ids.shape
            flat = ids.reshape(b * p, t).to(device)
            det, (tf, of, vm) = _stages(net, emb, batch, one, device)
            served_det = {k: rec["detector"][k].to(device)
                          for k in DETECTOR_KEYS}
            served_in = [rec["decoder"][k].to(device) for k in
                         ("target_feat", "obj_feats")]
            served = flat
            served_logit = rec["logits"].reshape(b * p, t).to(device)
            served_sn = rec["scorenet"]
            if control == "bfloat16":
                low_sn: list = []
                with torch.autocast(device.type, dtype=torch.bfloat16):
                    served_det, (ltf, lof, _) = _stages(net, emb, batch,
                                                        one, device, low_sn)
                    low = teacher_forced_logits(caption, emb, ltf, lof, vm,
                                                flat).float()
                served_sn = {"scores": low_sn[0][0], "pooled": low_sn[0][1]}
                served_in = [ltf.float(), lof.float()]
                served = low.argmax(-1)
                served_logit = low.amax(-1)
            elif control is not None:
                raise ValueError(f"unknown control {control}")
            # the valid masks come from the followed proposals' boxes
            ref = teacher_forced_logits(caption, emb, *served_in, vm, flat)
            keep = (_served(flat, vocab.eos_id)
                    & det["proposal_batch_mask"].reshape(b * p, 1).bool())
            picked = ref.gather(-1, served.long()[..., None])[..., 0]
            g = (ref.amax(-1) - picked)[keep]
            gap = max(gap, float(g.max()) if g.numel() else 0.0)
            d = (served_logit - picked).abs()[keep]
            dlog = max(dlog, float(d.max()) if d.numel() else 0.0)
            gaps = detector_gaps(served_det, det)
            fwd = _worst(fwd, gaps["forward"])
            obj = _worst(obj, gaps["objectness"])
            obj_m = _worst(obj_m, gaps["objectness.median"])
            head = _worst(head, score_head_gap(
                net, served_sn["scores"].to(device),
                served_sn["pooled"].to(device),
                served_det["cluster_mask_all"].reshape(-1).bool()))
            feat = _worst(feat, max(
                global_diff({"x": served_in[0]}, {"x": tf}),
                global_diff({"x": served_in[1]}, {"x": of})))
            rows = det["proposal_batch_mask"].reshape(b * p).bool()
            feat_m = _worst(feat_m, median_gap(served_in[0][rows], tf[rows]))
            # the followed stages, each checked by itself
            got = frozen_pg.PointGroup._cluster_batch(
                net.detector, *[a.to(device) for a in clus["inputs"]])
            for gg, w in zip(got[:2], clus["outputs"][:2]):
                bad_c += int((gg.cpu() != w).sum())
                tot_c += w.numel()
            sel = topk_stable(rank[0].to(device),
                              rank[1].shape[-1])[1].cpu()
            bad_s += int((sel != rank[1]).sum())
            tot_s += sel.numel()
            want_v = frozen_pg.PointGroup._proposal_valid(
                net.detector, rec["detector"]["cluster_mask_all"].bool(),
                torch.sigmoid(rec["detector"]["proposal_scores_all"].float()),
                det["cluster_npoint"].cpu())
            bad_s += int((want_v != program_valid(rank[0])).sum())
            tot_s += want_v.numel()
    return {"caption_gap": gap, "logits": dlog, "features": feat,
            "features.median": feat_m, "forward": fwd, "objectness": obj,
            "objectness.median": obj_m, "score_head": head,
            "clusters": bad_c / max(tot_c, 1),
            "selection": bad_s / max(tot_s, 1)}


def _worst(a: float, b: float) -> float:
    """The larger reading; one that is not finite wins."""
    return b if not math.isfinite(b) or b > a else a
