"""The pipeline's training and validation for modes 1 (detector ->
speaker), 2 (detector -> listener) and 3 (joint speaker-listener
self-critical RL) (counterpart of ``d3net_tpu/train/pipeline_loop.py``;
parity: ``PipelineNet.training_step`` modes 1-3, ``model/pipeline.py:
152-309``).

- ``task_mode``: the config's (detection, captioning, grounding) flags.
- ``speaker_train_step``: the detector in train mode (BN statistics
  updated) and ``detector_loss``, the speaker teacher-forced over the
  batch's description rows, caption XE over the good annotated rows (plus
  0.1 x the orientation loss when the batch has object rotations), one
  backward and one optimizer step. Its cluster jitter, proposal shuffle
  and target-sampling Gumbel draw come from one ``torch.Generator`` or are
  passed in as tensors.
- ``listener_train_step``: the detector as above, then the listener on
  the rows' GloVe embeddings with dropout and copy-paste (its draws from
  the same generator, or a ``ListenerDraws``); the loss is
  ``detector_loss`` + the grounding loss + the lang-cls loss.
- Freezing: a frozen submodule (``model.freeze_detector``) gets no update
  and no weight decay, and no gradient is computed for it; its BN
  statistics still move, as the detector runs in train mode. A
  ``freeze_<sub>`` that names no submodule of the model is a no-op.
- ``apply_pretrained``: the JAX package's ``pretrained/<tag>_<sub>.pkl``
  (``{"params", "batch_stats"}`` Flax trees of numpy leaves, written by
  either package's ``prepare_weights``) into the named submodules.
- ``joint_rl_train_step`` (mode 3): two batch streams. The speaker
  stream's detector output feeds the rollout (``sample_caption_ids``:
  diverse beam samples and a greedy baseline, detached, no grad), the
  host CIDEr reward of both (``caption_scores`` over
  ``make_caption_reward_fn``: the step's one host sync), then the
  speaker teacher-forced on the rollout under grad (mode ``rl_tf``), the
  moderator, the listener on the sampled captions (trained) and on the
  baseline (no grad), the self-critical loss ``-reward x sum logp`` over
  the good rows, an optional XE anchor; the listener stream's detector and
  listener with the grounding and lang-cls losses; one backward. The
  JAX package's phase A runs the speaker stream's detector a second time
  with the same draws and throws its BN statistics away: its rollout is
  this one, and the detector runs once a stream here.
- ``run_pipeline_training``: the JAX loop's run dir, lang stream, step
  seeds, validation cadence and checkpoints (mode 3: the listener stream
  takes the previous batch, the first step after a start or a resume the
  current one), with the detector loop's timing hook and profile window.
- ``run_pipeline_validation``: mode 1 captions every val scene's
  proposals greedily, scored by ``CaptionEvaluator`` against several
  grammar descriptions of each GT object (CIDEr, BLEU-4, ROUGE-L and
  METEOR at ``eval.min_iou_threshold``); mode 2 grounds every description
  row, scored by ``GroundingEvaluator`` (Acc@0.25/0.5 as
  ``ref_iou_rate_*``, with the unique/multiple and others breakdown);
  mode 3 does both on the same detector output and adds ``combined`` =
  ``cider`` + ``ref_iou_rate_0.5``.
"""

from __future__ import annotations

import itertools
import json
import os
import pickle
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from d3net_tpu_torch import trace
from d3net_tpu_torch.config import Config
from d3net_tpu_torch.data.collate import batch_to_torch
from d3net_tpu_torch.data.language import (
    base_corpus, build_lang_batch, describe_instance,
)
from d3net_tpu_torch.data.vocab import Vocabulary, embedding_matrix
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.eval import capeval
from d3net_tpu_torch.eval.caption_eval import CaptionEvaluator, decode_captions
from d3net_tpu_torch.eval.grounding_eval import GroundingEvaluator
from d3net_tpu_torch.models.listener import ListenerDraws
from d3net_tpu_torch.models.match import gumbel_draw
from d3net_tpu_torch.models.pipeline import PipelineNet
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.params import (
    flax_to_state_dict, init_flax_variables, state_dict_to_flax,
)
from d3net_tpu_torch.train.loop import (
    Checkpointer, StepLoop, detector_cfg_dict, in_channels_from_cfg,
    make_dataloaders, run_meta_extra, setup_run,
    optimizer_kw, spec_from_cfg, step_generator, write_run_meta,
)
from d3net_tpu_torch.train.losses import detector_loss
from d3net_tpu_torch.train.losses_slt import (
    caption_loss, grounding_loss, lang_cls_loss, orientation_loss,
)
from d3net_tpu_torch.train.migrate import migrate_legacy_block_names
from d3net_tpu_torch.train.trainer import TrainState, create_train_state
from d3net_tpu_torch.utils.bbox import box_corners

SUBMODULES = ("detector", "speaker", "listener")


def pipeline_from_cfg(cfg: Config, vocab: Vocabulary) -> PipelineNet:
    """The config's ``PipelineNet``; its detector also reads
    ``data.requires_gt_mask``, which the detector's own loop leaves out."""
    det_cfg = dict(detector_cfg_dict(cfg), requires_gt_mask=bool(
        cfg.data.get("requires_gt_mask", False)))
    return PipelineNet(
        in_channels_from_cfg(cfg),
        det_cfg,
        num_vocabs=len(vocab),
        sos_id=vocab.sos_id,
        eos_id=vocab.eos_id,
        pad_id=vocab.pad_id,
        num_graph_steps=cfg.model.num_graph_steps,
        num_locals=cfg.model.num_locals,
        max_spk_len=cfg.data.max_spk_len,
        min_iou_threshold=cfg.data.min_iou_threshold,
        use_relation=cfg.model.use_relation,
        use_orientation=cfg.model.use_orientation,
        use_lang_classifier=cfg.model.use_lang_classifier,
        use_bidir=cfg.model.use_bidir,
        match_type=cfg.model.match_type,
        num_text_classes=cfg.model.num_bbox_class,
        no_captioning=bool(cfg.model.no_captioning),
        no_grounding=bool(cfg.model.no_grounding),
        beam_group_size=int(cfg.train.get("beam_group_size", 1) or 1),
        diversity_lambda=float(cfg.train.get("diversity_lambda", 0.5)),
    )


def task_mode(cfg: Config) -> Tuple[int, int, int]:
    """The config's (detection, captioning, grounding) flags. (1, 0, 0)
    trains the detector alone, (1, 1, 0) the speaker (pipeline mode 1),
    (1, 0, 1) the listener (mode 2), (1, 1, 1) both by joint
    self-critical RL (mode 3)."""
    return (int(not cfg.model.no_detection), int(not cfg.model.no_captioning),
            int(not cfg.model.no_grounding))


def pipeline_mode(cfg: Config) -> int:
    """The pipeline loop's mode of the config: 1 (the speaker), 2 (the
    listener) or 3 (both, joint self-critical RL)."""
    _, cap, grd = task_mode(cfg)
    return 3 if cap and grd else 1 if cap else 2


def freeze_flags(cfg: Config, mode: int) -> Dict[str, bool]:
    """The submodules the pipeline loop of ``mode`` freezes (``make_frozen_
    optimizer``'s ``freeze`` labels): ``model.freeze_detector``;
    ``freeze_speaker`` and ``freeze_listener`` where the mode does not
    train that submodule alone."""
    return {"detector": bool(cfg.model.freeze_detector),
            "speaker": bool(cfg.model.get("freeze_speaker", False))
            and mode != 1,
            "listener": bool(cfg.model.get("freeze_listener", False))
            and mode != 2}


def build_vocab(cfg: Config) -> Tuple[Vocabulary, np.ndarray]:
    vocab = Vocabulary.build(base_corpus())
    return vocab, embedding_matrix(vocab, cfg.get("glove_path"))


# ---------------------------------------------------------------------------
# the mode-1 train step
# ---------------------------------------------------------------------------

def lang_rows(lang_np: Mapping[str, np.ndarray], emb: np.ndarray,
              device) -> Dict[str, torch.Tensor]:
    """(B, C, ...) host lang batch -> (B·C, ...) tensors on ``device``,
    with the embedding matrix as ``glove_embeddings``."""
    out = {k: torch.from_numpy(np.ascontiguousarray(
        v.reshape((-1,) + v.shape[2:]))).to(device)
        for k, v in lang_np.items()}
    out["glove_embeddings"] = torch.from_numpy(emb).to(device)
    return out


def expand_rows(det_out: Mapping, batch: Mapping, chunk_size: int) -> Dict:
    """Scene-level labels and proposals -> description rows: the GT boxes
    for the speaker's target selection, the proposals' boxes and classes
    for the grounding loss."""
    def rep(x):
        return x.repeat_interleave(chunk_size, dim=0)
    return {
        "center_label_chunk": rep(batch["center_label"]),
        "gt_bbox_chunk": rep(box_corners(batch["center_label"],
                                         batch["size_label"])),
        "proposal_bbox_rows": rep(det_out["proposal_bbox_batched"]),
        "proposal_sem_cls_batched_rows": rep(
            det_out["proposal_sem_cls_batched"]),
    }


def speaker_losses(model: PipelineNet, batch: Dict, lang: Dict, *,
                   chunk_size: int,
                   loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                   generator: Optional[torch.Generator] = None,
                   jitter_u: Optional[torch.Tensor] = None,
                   proposal_perm: Optional[torch.Tensor] = None,
                   gumbel: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """The mode-1 loss of ``model`` on ``batch`` and its description rows
    ``lang`` (ref :152-191) -> (total, the JAX step's seven metrics, the
    speaker's outputs). The draws not given come from ``generator``:
    jitter, proposal shuffle, then the (N, P) Gumbel draw."""
    out = model.run_detector(batch, train=True, generator=generator,
                             jitter_u=jitter_u, proposal_perm=proposal_perm)
    det = detector_loss(out, batch, loss_weight=loss_weight)["total_loss"]
    data = {**out, **lang, **expand_rows(out, batch, chunk_size)}
    b, p = out["proposal_batch_mask"].shape
    if gumbel is None:
        gumbel = mesh.draw_rows(lambda n: gumbel_draw(
            (n, p), generator, det.device), b * chunk_size)
    gumbel = mesh.local_rows(gumbel, b * chunk_size)
    data = model.run_speaker(data, mode="tf", chunk_size=chunk_size,
                             gumbel=gumbel)
    annotated = lang["annotated"]
    cap_l, cap_acc = caption_loss(data["lang_cap"], lang["lang_ids"],
                                  data["good_bbox_masks"] & (annotated > 0),
                                  pad_id=model.pad_id)
    if model.use_orientation and "scene_object_rotations" in batch:
        # the graph's edges are per scene: one row of each scene's chunk
        ori_l, ori_acc = orientation_loss(
            data["edge_orientations"], data["local_ids"][::chunk_size],
            data["local_mask"][::chunk_size], out["object_assignment"],
            batch["scene_object_rotations"],
            batch["scene_object_rotation_masks"])
    else:
        ori_l = ori_acc = det.new_zeros(())
    total = det + cap_l + 0.1 * ori_l
    metrics = {
        "detect_loss": det, "captioning_loss": cap_l,
        "orientation_loss": ori_l, "cap_acc": cap_acc, "ori_acc": ori_acc,
        "pred_ious": (data["target_ious"] * annotated).sum()
        / mesh.global_count(annotated.sum()).clamp(min=1.0),
        "loss": total,
    }
    return total, metrics, data


def speaker_train_step(state: TrainState, batch: Dict, lang: Dict,
                       generator: Optional[torch.Generator] = None, *,
                       chunk_size: int,
                       loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                       jitter_u: Optional[torch.Tensor] = None,
                       proposal_perm: Optional[torch.Tensor] = None,
                       gumbel: Optional[torch.Tensor] = None,
                       ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One mode-1 optimization step of ``state.model`` (a ``PipelineNet``):
    ``speaker_losses``, its backward through the parameters that require a
    gradient (a frozen detector's do not) and an update of those. Returns
    the state (updated in place) and the metrics, detached."""
    with trace.span("train.step", id=state.step):
        with trace.span("train.forward"):
            total, metrics, _ = speaker_losses(
                state.model, batch, lang, chunk_size=chunk_size,
                loss_weight=loss_weight, generator=generator,
                jitter_u=jitter_u, proposal_perm=proposal_perm, gumbel=gumbel)
        return apply_gradients(state, total), step_metrics(metrics)


def step_metrics(metrics: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """A step's metrics, detached; under a process group the global values
    (each rank's shares summed)."""
    return mesh.sum_metrics({k: v.detach() for k, v in metrics.items()})


def apply_gradients(state: TrainState, total: torch.Tensor) -> TrainState:
    """The backward of ``total`` through the parameters that require a
    gradient, then one optimizer and scheduler step; returns ``state``
    (updated in place). Under a process group ``total`` is this rank's
    share of the global loss and the gradients are summed over the ranks
    before the step. The ``train.backward`` and ``train.optim`` spans."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    with trace.span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
    with trace.span("train.optim"):
        # a parameter the loss does not reach (the orientation head without
        # rotation labels) has a zero gradient in JAX, and optax still
        # decays and moments it
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.all_reduce_grads(params)
        state.optimizer.step()
        state.scheduler.step()
    state.step += 1
    return state


# ---------------------------------------------------------------------------
# the mode-2 train step
# ---------------------------------------------------------------------------

def listener_losses(model: PipelineNet, batch: Dict, lang: Dict, *,
                    chunk_size: int,
                    loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                    loss_type: str = "cross_entropy",
                    generator: Optional[torch.Generator] = None,
                    jitter_u: Optional[torch.Tensor] = None,
                    proposal_perm: Optional[torch.Tensor] = None,
                    draws: Optional[ListenerDraws] = None,
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """The mode-2 loss of ``model`` on ``batch`` and its description rows
    ``lang`` (ref :193-226) -> (total, the JAX step's ten metrics, the
    listener's outputs). The draws not given come from ``generator``:
    jitter, proposal shuffle, then the listener's dropout masks and
    copy-paste draws."""
    out = model.run_detector(batch, train=True, generator=generator,
                             jitter_u=jitter_u, proposal_perm=proposal_perm)
    det = detector_loss(out, batch, loss_weight=loss_weight)["total_loss"]
    word_embs = lang["glove_embeddings"][lang["lang_ids"].long()]
    data = model.run_listener(
        {**out, **lang}, word_embs, lang["lang_len"], chunk_size, train=True,
        draws=draws if draws is not None else ListenerDraws(generator))
    rows = expand_rows(out, batch, chunk_size)
    annotated = lang["annotated"]
    ref_l, ref_m = grounding_loss(
        data["cluster_ref"], rows["proposal_bbox_rows"],
        lang["ref_box_corner_label"], annotated, loss_type=loss_type)
    lang_l, lang_acc = lang_cls_loss(data["lang_scores"],
                                     lang["ref_cat_label"], annotated)
    total = det + ref_l + lang_l
    metrics = {"detect_loss": det, "grounding_loss": ref_l,
               "lobjcls_loss": lang_l, "lang_acc": lang_acc, "loss": total,
               **ref_m}
    return total, metrics, data


def listener_train_step(state: TrainState, batch: Dict, lang: Dict,
                        generator: Optional[torch.Generator] = None, *,
                        chunk_size: int,
                        loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                        loss_type: str = "cross_entropy",
                        jitter_u: Optional[torch.Tensor] = None,
                        proposal_perm: Optional[torch.Tensor] = None,
                        draws: Optional[ListenerDraws] = None,
                        ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One mode-2 optimization step of ``state.model`` (a ``PipelineNet``
    with a listener): ``listener_losses``, then ``apply_gradients``.
    Returns the state (updated in place) and the metrics, detached."""
    with trace.span("train.step", id=state.step):
        with trace.span("train.forward"):
            total, metrics, _ = listener_losses(
                state.model, batch, lang, chunk_size=chunk_size,
                loss_weight=loss_weight, loss_type=loss_type,
                generator=generator, jitter_u=jitter_u,
                proposal_perm=proposal_perm, draws=draws)
        return apply_gradients(state, total), step_metrics(metrics)


# ---------------------------------------------------------------------------
# the mode-3 train step: joint speaker-listener self-critical RL
# ---------------------------------------------------------------------------

ROLLOUT_KEYS = ("sampled_cap", "baseline_cap", "target_ids", "target_ious")


def make_caption_reward_fn(vocab: Vocabulary):
    """The host reward (ref ``compute_caption_reward`` :15-96; the JAX
    function with ``bleu_weight`` 0, as its loop calls it):
    ``fn(cand_ids (N, T), gt_ids (N, T) or (N, R, T), annotated (N,))``
    -> (N,) f32, the CIDEr of each annotated row's decoded candidate
    against its references (every annotation of the target object when
    ``gt_ids`` has R of them; an all-zero row is padding), each reference
    deduplicated and every sentence ending in "eos". A row without
    annotation or references scores 0. One ``Cider().compute_score`` a
    call, so the corpus document frequencies are the call's."""

    def host_fn(cand_ids: np.ndarray, gt_ids: np.ndarray,
                annotated: np.ndarray) -> np.ndarray:
        cand_ids, gt_ids = np.asarray(cand_ids), np.asarray(gt_ids)
        n = cand_ids.shape[0]
        gts, cands, keys = {}, {}, []
        for i in range(n):
            if annotated[i] <= 0:
                continue
            refs = []
            for row in (gt_ids[i] if gt_ids.ndim == 3 else gt_ids[i][None]):
                if not row.any():
                    continue
                sent = " ".join(vocab.decode(row, stop_at_eos=True) + ["eos"])
                if sent not in refs:
                    refs.append(sent)
            if not refs:
                continue
            gts[str(i)] = refs
            cands[str(i)] = [" ".join(vocab.decode(cand_ids[i],
                                                   stop_at_eos=True)
                                      + ["eos"])]
            keys.append(i)
        scores = np.zeros(n, np.float32)
        if keys:
            _, cider = capeval.Cider().compute_score(gts, cands)
            scores[np.asarray(keys)] = np.asarray(cider, np.float32)
        return scores

    return host_fn


def sample_caption_ids(model: PipelineNet, data: Dict, *, chunk_size: int,
                       beam_size: int, sample_topn: int,
                       gumbel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The RL rollout (the JAX package's phase A) on the speaker stream's
    detector outputs and description rows ``data``, without grad: the
    targets on the (N, P) draw ``gumbel``, the speaker in mode ``rl``.
    -> ``sampled_cap`` (N, topn, T), ``baseline_cap`` (N, T + 1),
    ``target_ids``, ``target_ious`` and the beam's ``sampled_logps``. No
    host sync. The ``rl.rollout`` span."""
    with torch.no_grad(), trace.span("rl.rollout"):
        out = model.run_speaker(data, mode="rl", chunk_size=chunk_size,
                                gumbel=gumbel, beam_size=beam_size,
                                sample_topn=sample_topn)
    return {k: out[k] for k in ROLLOUT_KEYS + ("sampled_logps",)}


def caption_scores(reward_fn, rollout: Mapping[str, torch.Tensor],
                   lang: Mapping[str, torch.Tensor], sample_topn: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host reward of the rollout's sampled captions and of its
    baseline (repeated ``sample_topn`` times) against the rows'
    references (``gt_refs`` where the lang batch has them, else
    ``lang_ids``), each row repeated ``sample_topn`` times: two
    ``reward_fn`` calls, each its own corpus. The ids, references and
    annotation come to the host in one copy, the step's one host sync.
    Under a process group the corpus is the global batch's, as JAX's: every
    rank's host rows are gathered (the gloo group), both calls score all of
    them on every rank, and each rank keeps its rows (CIDEr's document
    frequencies over one rank's references would differ).
    -> two (N·topn,) f32 tensors on the rollout's device. The
    ``rl.reward`` span (its host sync counted)."""
    with trace.span("rl.reward"):
        sampled, baseline = rollout["sampled_cap"], rollout["baseline_cap"]
        n = sampled.shape[0]
        gt = lang.get("gt_refs", lang["lang_ids"])
        parts = [sampled.reshape(n, -1), baseline, gt.reshape(n, -1),
                 (lang["annotated"] > 0)[:, None]]
        host = mesh.host_all_gather(
            torch.cat([x.to(torch.int32) for x in parts], 1).cpu().numpy())
        ids_s, ids_b, gt_np, ann = np.split(host, np.cumsum(
            [x.shape[1] for x in parts[:-1]]), axis=1)

        def rep(x):
            return np.repeat(x, sample_topn, axis=0)

        n_all = host.shape[0]
        gt_np = rep(gt_np.reshape((n_all,) + tuple(gt.shape[1:])))
        ann = rep(ann[:, 0])
        mine = slice(mesh.rank() * n * sample_topn,
                     (mesh.rank() + 1) * n * sample_topn)
        return tuple(
            torch.from_numpy(reward_fn(ids, gt_np, ann)[mine]).to(
                sampled.device)
            for ids in (ids_s.reshape(n_all * sample_topn, -1), rep(ids_b)))


def speaker_stream_losses(model: PipelineNet, batch: Dict, lang: Dict,
                          reward_fn, *, chunk_size: int, beam_size: int,
                          sample_topn: int,
                          loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                          ref_reward_weight: float = 1.0,
                          lang_reward_weight: float = 1.0,
                          listener_reward_weight: float = 0.1,
                          caption_reward_weight: float = 1.0,
                          loss_type: str = "cross_entropy",
                          xe_weight: float = 0.0,
                          jitter_u: torch.Tensor, proposal_perm: torch.Tensor,
                          gumbel: Optional[torch.Tensor],
                          draws: ListenerDraws,
                          rollout: Optional[Mapping[str, torch.Tensor]] = None,
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                     Dict]:
    """The speaker stream of the mode-3 loss (ref :228-300) on ``batch``
    and its rows ``lang`` -> (its part of the total, the JAX step's
    speaker-stream metrics, the rollout with its ``sampled_scores`` and
    ``baseline_scores``): the detector; the rollout (``sample_caption_ids``
    on the detector's output, unless ``rollout`` is given) and its host
    reward; the speaker teacher-forced on it; the moderator; the listener
    on the sampled captions (train mode, ``draws``) and on the baseline
    (eval mode on the statistics just written, no grad); the rewards
    (CIDEr delta + ``listener_reward_weight`` x the listener's loss
    deltas, no grad) and the self-critical loss over the good rows; the
    sampled listener's losses, means over every row; with ``xe_weight``
    the XE anchor, teacher-forcing the descriptions on the rollout's
    targets."""
    out = model.run_detector(batch, train=True, jitter_u=jitter_u,
                             proposal_perm=proposal_perm)
    det = detector_loss(out, batch, loss_weight=loss_weight)["total_loss"]
    data = {**out, **lang, **expand_rows(out, batch, chunk_size)}
    if rollout is None:
        rollout = sample_caption_ids(model, data, chunk_size=chunk_size,
                                     beam_size=beam_size,
                                     sample_topn=sample_topn, gumbel=gumbel)
    sampled_scores, baseline_scores = caption_scores(reward_fn, rollout, lang,
                                                     sample_topn)
    spk_in = {**data, **{f"{k}_in": rollout[k] for k in ROLLOUT_KEYS}}
    data = model.run_speaker(spk_in, mode="rl_tf", chunk_size=chunk_size,
                             sample_topn=sample_topn)
    data["proposal_bbox_batched"] = data["proposal_bbox_rows"]
    data = model.moderator(data, sample_topn)

    props = {k: out[k] for k in ("proposal_feats_batched",
                                 "proposal_batch_mask",
                                 "proposal_center_batched")}
    rows = chunk_size * sample_topn
    prop_rows = data["proposal_bbox_rows"].repeat_interleave(sample_topn, 0)
    ref_label, cat_label = (data["mod_ref_box_corner_label"],
                            data["mod_ref_cat_label"])
    s_out = model.run_listener(props, data["mod_sampled_embs"],
                               data["mod_sampled_lens"], rows, train=True,
                               draws=draws)
    ref_sampled, _ = grounding_loss(s_out["cluster_ref"], prop_rows,
                                    ref_label, reduce=False,
                                    loss_type=loss_type)
    lang_sampled, _ = lang_cls_loss(s_out["lang_scores"], cat_label,
                                    reduce=False)
    with torch.no_grad():                  # the reward's baseline only
        b_out = model.run_listener(props, data["mod_baseline_embs"],
                                   data["mod_baseline_lens"], rows)
        ref_baseline, _ = grounding_loss(b_out["cluster_ref"], prop_rows,
                                         ref_label, reduce=False,
                                         loss_type=loss_type)
        lang_baseline, _ = lang_cls_loss(b_out["lang_scores"], cat_label,
                                         reduce=False)

    caption_reward = sampled_scores - baseline_scores
    listener_reward = (
        ref_reward_weight * -(ref_sampled.detach() - ref_baseline)
        + lang_reward_weight * -(lang_sampled.detach() - lang_baseline))
    rewards = (caption_reward_weight * caption_reward
               + listener_reward_weight * listener_reward)
    n_rows = lang["lang_ids"].shape[0]
    logps = data["sampled_logps"].reshape(n_rows * sample_topn, -1).sum(-1)
    good = data["good_bbox_masks"].float().repeat_interleave(sample_topn, 0)
    n_good = mesh.global_count(good.sum()) + 1e-8
    cap_loss_rl = -(rewards * logps * good).sum() / n_good
    ann_mask = lang["annotated"].repeat_interleave(sample_topn, 0) * good
    spk_ref_loss = mesh.global_mean(ref_sampled)
    metrics = {
        "cap_rwd": (caption_reward * good).sum() / n_good,
        "loc_rwd": (listener_reward * good).sum() / n_good,
        "ttl_rwd": (rewards * good).sum() / n_good,
        "cap_acc": (sampled_scores * ann_mask).sum()
        / (mesh.global_count(ann_mask.sum()) + 1e-8),
        "spk_detect_loss": det, "captioning_loss": cap_loss_rl,
        "spk_ref_loss": spk_ref_loss}
    total = det + cap_loss_rl
    if xe_weight > 0.0:
        tf_out = model.run_speaker(spk_in, mode="tf", chunk_size=chunk_size)
        xe, _ = caption_loss(tf_out["lang_cap"], lang["lang_ids"],
                             tf_out["good_bbox_masks"]
                             & (lang["annotated"] > 0),
                             pad_id=model.pad_id)
        metrics["cap_xe_loss"] = xe_weight * xe
        total = total + metrics["cap_xe_loss"]
    total = total + spk_ref_loss + mesh.global_mean(lang_sampled)
    return total, metrics, {**rollout, "sampled_scores": sampled_scores,
                            "baseline_scores": baseline_scores}


def joint_rl_losses(model: PipelineNet, spk_batch: Dict, spk_lang: Dict,
                    lis_batch: Dict, lis_lang: Dict, reward_fn, *,
                    chunk_size: int, beam_size: int = 3, sample_topn: int = 3,
                    loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                    loss_type: str = "cross_entropy",
                    generator: Optional[torch.Generator] = None,
                    jitter_u: Optional[torch.Tensor] = None,
                    proposal_perm: Optional[torch.Tensor] = None,
                    gumbel: Optional[torch.Tensor] = None,
                    spk_draws: Optional[ListenerDraws] = None,
                    lis_draws: Optional[ListenerDraws] = None,
                    rollout: Optional[Mapping[str, torch.Tensor]] = None,
                    **weights) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                        Dict]:
    """The mode-3 loss (ref :228-309; the JAX package's
    ``joint_rl_train_step`` with ``rollout=`` and ``caption_scores=``) of
    ``model`` on the speaker stream (``spk_batch``, its rows ``spk_lang``:
    ``speaker_stream_losses``, whose reward and XE weights are
    ``weights``) and the listener stream (``lis_batch``, ``lis_lang``:
    ``listener_losses``) -> (total, the JAX step's metrics, the rollout
    with its scores).

    Where the JAX step hands two calls the same key, they get the same
    draw: both detectors the same jitter and proposal permutation, both
    train-mode listeners the same copy-paste draw and, at a dropout whose
    shape is the same in both (``ListenerDraws.shared``), the same keep
    mask. The draws not given come from ``generator``: jitter,
    permutation, the (N, P) Gumbel, then the listeners' draws in call
    order. Call order is the BN statistics' order: the speaker stream's
    detector, the listener on the sampled captions, the baseline listener,
    then the listener stream's detector and listener."""
    det = model.detector
    dev = spk_lang["lang_ids"].device
    b = spk_batch["point_mask"].shape[0]
    p = det.max_num_proposal
    if jitter_u is None:
        jitter_u = mesh.draw_rows(lambda n: torch.rand(
            (n, 2 * det.clusters_per_pass, 3), generator=generator,
            device=dev), b)
    if proposal_perm is None:
        proposal_perm = mesh.draw_rows(lambda n: torch.stack([
            torch.randperm(p, generator=generator, device=dev)
            for _ in range(n)]), b)
    if gumbel is None and rollout is None:
        gumbel = mesh.draw_rows(lambda n: gumbel_draw(
            (n, p), generator, dev), b * chunk_size)
    if gumbel is not None:
        gumbel = mesh.local_rows(gumbel, b * chunk_size)
    if rollout is not None:
        rollout = {k: mesh.local_rows(v, b * chunk_size)
                   for k, v in rollout.items()}
    if spk_draws is None:
        spk_draws = ListenerDraws(generator)
    kw = dict(chunk_size=chunk_size, loss_weight=loss_weight,
              loss_type=loss_type, jitter_u=jitter_u,
              proposal_perm=proposal_perm)
    total, metrics, rollout = speaker_stream_losses(
        model, spk_batch, spk_lang, reward_fn, beam_size=beam_size,
        sample_topn=sample_topn, gumbel=gumbel, draws=spk_draws,
        rollout=rollout, **kw, **weights)
    if lis_draws is None:
        lis_draws = ListenerDraws(generator,
                                  copy_paste=spk_draws.copy_paste_draw,
                                  shared=spk_draws.drawn)
    lis_total, lis, _ = listener_losses(model, lis_batch, lis_lang,
                                        draws=lis_draws, **kw)
    total = total + lis_total
    metrics.update(loss=total, lis_detect_loss=lis["detect_loss"],
                   lis_ref_loss=lis["grounding_loss"],
                   lang_acc=lis["lang_acc"],
                   **{f"lis_{k}": v for k, v in lis.items()
                      if k.startswith(("ref_", "best_"))})
    return total, metrics, rollout


def joint_rl_train_step(state: TrainState, spk_batch: Dict, spk_lang: Dict,
                        lis_batch: Dict, lis_lang: Dict, reward_fn,
                        generator: Optional[torch.Generator] = None, **kw
                        ) -> Tuple[TrainState, Dict[str, torch.Tensor], Dict]:
    """One mode-3 optimization step of ``state.model`` (a ``PipelineNet``
    with both submodules): ``joint_rl_losses`` (``kw`` are its keyword
    arguments), then ``apply_gradients``. Returns the state (updated in
    place), the metrics, detached, and the rollout with its scores."""
    with trace.span("train.step", id=state.step):
        with trace.span("train.forward"):
            total, metrics, rollout = joint_rl_losses(
                state.model, spk_batch, spk_lang, lis_batch, lis_lang,
                reward_fn, generator=generator, **kw)
        return (apply_gradients(state, total), step_metrics(metrics),
                rollout)


# ---------------------------------------------------------------------------
# freezing and pretrained weights
# ---------------------------------------------------------------------------

def freeze_submodules(model: PipelineNet, freeze: Mapping[str, bool]) -> None:
    """No gradient for the parameters of each submodule that ``freeze``
    names true (``make_frozen_optimizer``'s frozen labels): the train state
    made after this neither updates nor decays them."""
    for name, frozen in freeze.items():
        sub = getattr(model, name, None)
        if sub is not None:
            sub.requires_grad_(not frozen)


def apply_pretrained(model: PipelineNet, cfg: Config) -> None:
    """Load the submodule weights that ``model.pretrained_<sub>`` names: a
    pickle of ``{"params", "batch_stats"}`` Flax trees (ref per-rank
    loading, ``scripts/train.py:288-310``). Legacy U-Net block names are
    migrated; a payload without BN statistics keeps the model's. A missing
    file raises, as does a submodule the model lacks."""
    for sub in SUBMODULES:
        path = cfg.model.get(f"pretrained_{sub}")
        if not path:
            continue
        module = getattr(model, sub, None)
        if module is None:
            raise ValueError(f"pretrained_{sub}: {sub} is not in the model")
        with open(path, "rb") as f:
            payload = pickle.load(f)
        variables = state_dict_to_flax(module)
        variables["params"] = migrate_legacy_block_names(payload["params"])
        if payload.get("batch_stats"):
            variables["batch_stats"] = migrate_legacy_block_names(
                payload["batch_stats"])
        module.load_state_dict(flax_to_state_dict(variables, module))
        print(f"loaded pretrained {sub} from {path}")


# ---------------------------------------------------------------------------
# the run loop
# ---------------------------------------------------------------------------

def run_pipeline_training(cfg: Config, run_dir: str,
                          max_steps: Optional[int] = None,
                          device: DeviceLike = None,
                          on_step: Optional[Callable[[Dict], None]] = None,
                          ) -> TrainState:
    """Train the pipeline of ``cfg`` (mode 1: detector -> speaker, mode 2:
    detector -> listener, or mode 3: both by joint self-critical RL, by
    ``task_mode``) into ``run_dir``, resuming from its last checkpoint;
    returns the train state.

    The JAX loop's order: weights (seeded random, then the pretrained
    submodules), the lang stream from ``default_rng(manual_seed)`` (its
    first draw is the init batch's, which JAX spends on ``model.init``),
    per-step generators from ``(manual_seed + 7, step)``, validation every
    ``check_val_every_n_epoch`` epochs, at the last and at ``max_steps``,
    and a checkpoint after each by the monitor (``val_score/cider`` ->
    ``cider``; ``val_score/ref_iou_rate_0.5`` -> ``ref_iou_rate_0.5``;
    ``val_score/combined`` -> ``combined``). ``freeze_detector`` freezes
    the detector; ``freeze_speaker`` and ``freeze_listener`` freeze the
    submodule the mode does not train (both apply in mode 3), a no-op
    where the model lacks it. In mode 3 the listener stream takes the
    previous step's batch and rows (the current ones at the first step of
    the call) and the reward is ``train.caption_reward_weight``'s CIDEr
    over ``train.num_caption_refs`` references. Runs on CUDA unless
    ``device`` says otherwise; ``on_step`` is ``StepLoop``'s, with the
    card waited on around each part of a step. Under a process group
    (``parallel.mesh``) each rank trains on its rows of every global batch
    (the description rows drawn over the global batch's scenes), every
    rank loads the pretrained weights and validates its rows of every val
    batch, and rank 0 alone writes the run dir.
    """
    mode = pipeline_mode(cfg)
    dev = resolve_device(device)
    setup_run(cfg, run_dir)
    ckpt = Checkpointer(run_dir, cfg.general.monitor.split("/")[-1],
                        cfg.general.monitor_mode)

    vocab, emb = build_vocab(cfg)
    model = pipeline_from_cfg(cfg, vocab)
    model.load_state_dict(flax_to_state_dict(
        init_flax_variables(model, cfg.general.manual_seed), model))
    apply_pretrained(model, cfg)
    model.to(dev)
    spec = spec_from_cfg(cfg)
    train_it, val_it = make_dataloaders(cfg, spec, return_scenes=True)
    chunk = int(cfg.data.num_des_per_scene)
    rng_np = np.random.default_rng(cfg.general.manual_seed)

    def make_lang(scenes):
        return build_lang_batch(
            scenes, vocab, chunk, cfg.data.max_spk_len, rng_np,
            spec.max_instances,
            apply_word_erase=bool(cfg.train.get("apply_word_erase", False)),
            num_refs=int(cfg.train.get("num_caption_refs", 1) or 1))

    make_lang([train_it.scenes[i] for i in range(cfg.data.batch_size)])
    freeze_submodules(model, freeze_flags(cfg, mode))
    state = create_train_state(model, **optimizer_kw(cfg))
    if ckpt.restore_last(state) is not None and mesh.is_main():
        print(f"resumed from step {state.step}")
    mesh.replicate(state.model, state.optimizer)
    write_run_meta(run_dir, cfg, run_meta_extra(dev, cfg))
    loop = StepLoop(cfg, run_dir, dev, train_it.augment, state.step,
                    max_steps, on_step, True)

    def to_device(item):
        # the rows are drawn over the global batch's scenes; a rank keeps
        # its own
        batch_np, scenes = item
        lang_np = mesh.shard_host_batch(make_lang(scenes))
        return [batch_np, lang_np], (batch_to_torch(batch_np, dev),
                                     lang_rows(lang_np, emb, dev))

    kw = dict(chunk_size=chunk, loss_weight=tuple(cfg.train.loss_weight[:4]))
    if mode != 1:
        kw["loss_type"] = str(cfg.model.get("loss_type", "cross_entropy"))
    seed = cfg.general.manual_seed + 7
    check_every = int(cfg.train.get("check_val_every_n_epoch", 1) or 1)
    if mode == 3:
        t = cfg.train
        reward_fn = make_caption_reward_fn(vocab)
        kw.update(beam_size=int(t.beam_size), sample_topn=int(t.sample_topn),
                  ref_reward_weight=t.ref_reward_weight,
                  lang_reward_weight=t.lang_reward_weight,
                  listener_reward_weight=t.listener_reward_weight,
                  caption_reward_weight=t.caption_reward_weight,
                  xe_weight=float(t.get("rl_xe_weight", 0.0) or 0.0))
        prev = []            # the listener stream: the previous pair

        def train_step(pair, step):
            lis_pair = prev[0] if prev else pair
            prev[:] = [pair]
            return joint_rl_train_step(
                state, *pair, *lis_pair, reward_fn,
                step_generator(seed, step, dev), **kw)[1]
    else:
        def train_step(pair, step):
            return (speaker_train_step if mode == 1 else listener_train_step)(
                state, *pair, step_generator(seed, step, dev), **kw)[1]

    for epoch in range(cfg.train.epochs):
        t_epoch = time.time()
        loop.run_epoch(epoch, train_it, to_device, train_step)
        if ((epoch + 1) % check_every != 0 and epoch + 1 < cfg.train.epochs
                and not loop.done):
            continue

        val_metrics = run_pipeline_validation(
            cfg, model, val_it, vocab, emb, mode,
            diag_path=os.path.join(run_dir, "caption_diag.json"))
        loop.logger.log(loop.step, val_metrics, "val")
        if mesh.is_main():
            print(f"epoch {epoch} VAL " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(val_metrics.items())))
        ckpt.save(loop.step, state, val_metrics)
        if mesh.is_main():
            print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s")
        if loop.done:
            break
    loop.finish()
    return state


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def caption_references(scene, num_refs: int) -> Dict[int, list]:
    """Up to ``num_refs`` distinct grammar descriptions of each instance of
    ``scene`` (seeds 0..num_refs-1): the reference evaluates against every
    human annotation of an object (``lib/captioning/eval_helper.py:
    258-307``), not one."""
    out = {}
    for j in range(len(scene.instance_bboxes)):
        refs = []
        for seed in range(num_refs):
            s = " ".join(describe_instance(scene, j,
                                           np.random.default_rng(seed)))
            if s not in refs:
                refs.append(s)
        out[j] = refs
    return out


def run_pipeline_validation(cfg: Config, model: PipelineNet, val_it,
                            vocab: Vocabulary, emb: np.ndarray, mode: int = 1,
                            diag_path: Optional[str] = None,
                            ) -> Dict[str, float]:
    """The val split scored by mode (ref ``validation_epoch_end``
    :645-735) with ``model`` in eval mode on its own device; ``val_it``
    yields (batch, scenes). Mode 1: caption CIDEr@kIoU, with the
    evaluator's ``cap_frac_replaced``, ``cap_assign_iou_mean`` and
    ``cider_raw`` (its whole ``diagnostics()`` go to ``diag_path`` when
    given). Mode 2: grounding over every description row of
    ``build_lang_batch`` (from ``default_rng(0)``), the evaluator's
    ``acc@k`` named ``ref_iou_rate_k``, ``iou_mean`` and the breakdown
    keys. Mode 3: both on the same detector output (the rows drawn for
    every batch before either task) and ``combined`` = ``cider`` +
    ``ref_iou_rate_0.5``.

    Under a process group ``val_it`` is the rank's (``make_val_loader``):
    each rank runs its rows of every val batch, the description rows drawn
    over the global batch's scenes on every rank (one stream) and the rank
    keeping its own; a short last batch the ranks cannot split runs on
    rank 0 alone (``mesh.eval_rows``). The evaluators' records are merged
    on rank 0 in the global scene order (``mesh.gather_records``), which
    computes the metrics and writes ``diag_path``; every rank returns its
    dict.

    Each val batch is an ``eval.batch`` span, from asking the loader for
    it (``data.wait``) to its captions scored: ``data.h2d``,
    ``eval.detector`` (to its proposals read back), ``eval.speaker`` (to
    its captions read back) and ``eval.score``."""
    subs = {1: ("speaker",), 2: ("listener",),
            3: ("speaker", "listener")}.get(mode)
    if subs is None:
        raise ValueError(f"pipeline validation mode {mode}: 1, 2 or 3")
    for sub in subs:
        if not hasattr(model, sub):
            raise ValueError(f"validation mode {mode} needs the {sub}")
    captions, grounding = mode in (1, 3), mode in (2, 3)
    dev = next(model.parameters()).device
    model.eval()
    emb_t = torch.from_numpy(emb).to(dev)
    chunk = int(cfg.data.num_des_per_scene)
    cap_eval = CaptionEvaluator(min_iou=cfg.eval.min_iou_threshold)
    grd_eval = GroundingEvaluator()
    rng_np = np.random.default_rng(0)
    n_refs = int(cfg.eval.get("num_caption_refs", 4) or 1)

    def score_captions(ids, scenes, corners, mask):
        for i, scene in enumerate(scenes):
            nb = len(scene.instance_bboxes)
            gt_c = np.stack([
                box_corners(bb[:3], bb[3:6])
                for bb in scene.instance_bboxes
            ]) if nb else np.zeros((0, 8, 3))
            cap_eval.add_scene(
                scene.scene_id, decode_captions(ids[i], vocab),
                corners[i], mask[i], gt_c, np.ones(nb),
                caption_references(scene, n_refs))

    def score(batch_np, scenes, lang_np):
        """One val batch's rows (``scenes``, ``lang_np``: this rank's) into
        the evaluators."""
        batch = batch_to_torch(batch_np, dev)
        with trace.span("eval.detector"):
            det_out = model.run_detector(batch)
            corners = det_out["proposal_bbox_batched"].cpu().numpy()
            mask = det_out["proposal_batch_mask"].cpu().numpy()
        if captions:
            with trace.span("eval.speaker"):
                data = model.run_speaker(
                    {**det_out, "glove_embeddings": emb_t}, mode="eval")
                ids = data["lang_cap"].cpu().numpy()
            with trace.span("eval.score"):
                score_captions(ids, scenes, corners, mask)
        if grounding:
            lang = lang_rows(lang_np, emb, dev)
            data = model.run_listener(
                {**det_out, **lang}, emb_t[lang["lang_ids"].long()],
                lang["lang_len"], chunk)
            flat = {k: v.reshape((-1,) + v.shape[2:])
                    for k, v in lang_np.items()}
            grd_eval.add(
                data["cluster_ref"].cpu().numpy(),
                np.repeat(corners, chunk, axis=0),
                np.repeat(mask, chunk, axis=0),
                flat["ref_box_corner_label"], flat["annotated"],
                unique_multiple=flat["unique_multiple"],
                object_cat=flat["ref_cat_label"])

    items = iter(val_it)
    for b in itertools.count():
        with torch.no_grad(), trace.span("eval.batch") as batch_span:
            with trace.span("data.wait"):
                item = next(items, None)
            if item is None:
                batch_span.drop()
                break
            batch_np, scenes = item
            # drawn over the global batch's scenes on every rank
            lang_np = build_lang_batch(
                scenes, vocab, chunk, cfg.data.max_spk_len, rng_np,
                val_it.spec.max_instances) if grounding else None
            with mesh.eval_rows(val_it.splits(b)) as mine:
                if mine:
                    lo, hi = mesh.split_rows(len(scenes))
                    cap_eval.batch = grd_eval.batch = b
                    score(batch_np, scenes[lo:hi],
                          None if lang_np is None
                          else mesh.shard_host_batch(lang_np))

    out: Dict[str, float] = {}
    if not mesh.gather_records(cap_eval, grd_eval):
        return mesh.broadcast_from_main(out)
    if captions:
        out.update(cap_eval.compute())
        diag = cap_eval.diagnostics()
        if diag:
            out["cap_frac_replaced"] = diag["frac_replaced"]
            out["cap_assign_iou_mean"] = diag["assign_iou_mean"]
            out["cider_raw"] = diag["cider_raw"]
            if diag_path:
                with open(diag_path, "w") as f:
                    json.dump(diag, f, indent=1)
    if grounding:
        # overall acc@K -> the reference's ref_iou_rate_K name; the
        # breakdown keys (unique_/multiple_/others_...) keep their prefix
        out.update({f"ref_iou_rate_{k.split('@')[-1]}" if k.startswith("acc@")
                    else k: v for k, v in grd_eval.compute().items()})
    if "cider" in out and "ref_iou_rate_0.5" in out:
        out["combined"] = out["cider"] + out["ref_iou_rate_0.5"]
    return mesh.broadcast_from_main(out)
