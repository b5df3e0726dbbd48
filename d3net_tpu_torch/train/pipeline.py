"""The pipeline's construction and validation (counterpart of
``d3net_tpu/train/pipeline_loop.py``).

Ported: ``pipeline_from_cfg``, ``build_vocab`` and
``run_pipeline_validation`` for mode 1 (detector -> speaker): every val
scene's proposals captioned greedily and scored by ``CaptionEvaluator``
against several grammar descriptions of each GT object (CIDEr, BLEU-4,
ROUGE-L and METEOR at ``eval.min_iou_threshold``). The speaker's training
(mode 1), the listener (mode 2) and joint RL (mode 3) are ROADMAP.md queue
A items 13-15.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from d3net_tpu_torch.config import Config
from d3net_tpu_torch.data.collate import batch_to_torch
from d3net_tpu_torch.data.language import base_corpus, describe_instance
from d3net_tpu_torch.data.vocab import Vocabulary, embedding_matrix
from d3net_tpu_torch.eval.caption_eval import CaptionEvaluator, decode_captions
from d3net_tpu_torch.models.pipeline import PipelineNet
from d3net_tpu_torch.train.loop import detector_cfg_dict, in_channels_from_cfg
from d3net_tpu_torch.utils.bbox import box_corners


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
        use_relation=cfg.model.use_relation,
        use_orientation=cfg.model.use_orientation,
        no_captioning=bool(cfg.model.no_captioning),
        no_grounding=bool(cfg.model.no_grounding),
    )


def build_vocab(cfg: Config) -> Tuple[Vocabulary, np.ndarray]:
    vocab = Vocabulary.build(base_corpus())
    return vocab, embedding_matrix(vocab, cfg.get("glove_path"))


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
    """Caption CIDEr@kIoU over the val split (ref ``validation_epoch_end``
    :645-735) with ``model`` in eval mode on its own device; ``val_it``
    yields (batch, scenes). Returns the metrics, with the evaluator's
    ``cap_frac_replaced``, ``cap_assign_iou_mean`` and ``cider_raw``; its
    whole ``diagnostics()`` go to ``diag_path`` when given."""
    if mode != 1:
        raise NotImplementedError(
            f"pipeline validation mode {mode}: the listener and joint RL are "
            "not ported (ROADMAP.md, queue A items 14 and 15)")
    dev = next(model.parameters()).device
    model.eval()
    emb_t = torch.from_numpy(emb).to(dev)
    cap_eval = CaptionEvaluator(min_iou=cfg.eval.min_iou_threshold)
    n_refs = int(cfg.eval.get("num_caption_refs", 4) or 1)
    with torch.no_grad():
        for batch_np, scenes in val_it:
            det_out = model.run_detector(batch_to_torch(batch_np, dev))
            data = model.run_speaker({**det_out, "glove_embeddings": emb_t},
                                     mode="eval")
            ids = data["lang_cap"].cpu().numpy()
            corners = det_out["proposal_bbox_batched"].cpu().numpy()
            mask = det_out["proposal_batch_mask"].cpu().numpy()
            for i, scene in enumerate(scenes):
                nb = len(scene.instance_bboxes)
                gt_c = np.stack([
                    box_corners(bb[:3], bb[3:6]) for bb in scene.instance_bboxes
                ]) if nb else np.zeros((0, 8, 3))
                cap_eval.add_scene(scene.scene_id, decode_captions(ids[i], vocab),
                                   corners[i], mask[i], gt_c, np.ones(nb),
                                   caption_references(scene, n_refs))

    out = dict(cap_eval.compute())
    diag = cap_eval.diagnostics()
    if diag:
        out["cap_frac_replaced"] = diag["frac_replaced"]
        out["cap_assign_iou_mean"] = diag["assign_iou_mean"]
        out["cider_raw"] = diag["cider_raw"]
        if diag_path:
            with open(diag_path, "w") as f:
                json.dump(diag, f, indent=1)
    return out
