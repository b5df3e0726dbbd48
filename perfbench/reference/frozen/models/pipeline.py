"""PipelineNet: detector -> speaker / listener (counterpart of
``d3net_tpu/models/pipeline.py``; parity: ``model/pipeline.py``).

One module holding the submodules so parameters nest as the Flax tree's
``{detector, speaker, listener}``: the speaker unless ``no_captioning``,
the listener unless ``no_grounding``, both for a joint config (so the eval
of either task loads a joint run's checkpoint).

The moderator (ref :759-892) turns the speaker's RL captions into listener
inputs with fixed-shape mask arithmetic (``moderate_captions``: prepend
sos, force eos where missing, pad after the first eos, lengths, the cut to
``max_spk_len + 2``) and gives the pseudo-GT from the speaker's *target
proposal*, not the GT object (the JAX module's choice).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from perfbench.reference.frozen.models.listener import ListenerDraws, ListenerNet
from perfbench.reference.frozen.models.pointgroup import PointGroup
from perfbench.reference.frozen.models.speaker import SpeakerNet


def moderate_captions(ids: torch.Tensor, sos_id: int, eos_id: int,
                      pad_id: int, max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speaker ids (..., T) -> listener ids (..., min(T+1, max_len)) and
    lengths: sos prepended; eos forced at the last slot (T) when the row
    has none; every token after the first eos set to pad; the length is
    sos..eos inclusive, at most ``max_len``. The cut to ``max_len`` comes
    last, so a row of T+1 > ``max_len`` whose only eos is the forced one
    loses it and keeps length ``max_len`` (the JAX function does the
    same)."""
    out = torch.cat([ids.new_full(ids.shape[:-1] + (1,), sos_id), ids], -1)
    has_eos = (out == eos_id).any(-1)
    out[..., -1] = torch.where(has_eos, out[..., -1], eos_id)
    first_eos = (out == eos_id).to(torch.int32).argmax(-1)
    pos = torch.arange(out.shape[-1], device=out.device)
    out = torch.where(pos <= first_eos[..., None], out, pad_id)
    return out[..., :max_len], (first_eos + 1).clamp(max=max_len)


class PipelineNet(nn.Module):
    """``in_channels`` is the detector's input width; the other arguments
    are the JAX module's fields that the detector, the speaker and the
    listener read."""

    def __init__(self, in_channels: int, detector_cfg: Dict[str, Any],
                 num_vocabs: int = 44, sos_id: int = 2, eos_id: int = 3,
                 pad_id: int = 0, num_graph_steps: int = 2,
                 num_locals: int = 10, max_spk_len: int = 30,
                 min_iou_threshold: float = 0.25, use_relation: bool = True,
                 use_orientation: bool = True,
                 use_lang_classifier: bool = True, use_bidir: bool = False,
                 match_type: str = "Transformer", num_text_classes: int = 18,
                 no_captioning: bool = False, no_grounding: bool = False,
                 beam_group_size: int = 1, diversity_lambda: float = 0.5):
        super().__init__()
        self.sos_id, self.eos_id, self.pad_id = sos_id, eos_id, pad_id
        self.max_spk_len = max_spk_len
        self.use_orientation = use_orientation
        self.detector = PointGroup(in_channels, **detector_cfg)
        # the proposal features are the ScoreNet's pooled first level
        feat_size = (detector_cfg.get("m", 16)
                     * tuple(detector_cfg.get("cluster_blocks", (1, 2)))[0])
        if not no_captioning:
            self.speaker = SpeakerNet(
                num_vocabs=num_vocabs, sos_id=sos_id, eos_id=eos_id,
                pad_id=pad_id, m=feat_size,
                num_graph_steps=num_graph_steps, num_locals=num_locals,
                max_len=max_spk_len, min_iou_threshold=min_iou_threshold,
                use_relation=use_relation,
                use_orientation=use_orientation,
                beam_group_size=beam_group_size,
                diversity_lambda=diversity_lambda)
        if not no_grounding:
            self.listener = ListenerNet(
                feat_size, num_text_classes=num_text_classes,
                match_type=match_type,
                use_lang_classifier=use_lang_classifier, use_bidir=use_bidir)

    def run_detector(self, batch, train: bool = False,
                     do_clustering: bool = True, **draws):
        """The detector; ``draws`` are its keyword arguments ``generator``,
        ``jitter_u`` and ``proposal_perm``."""
        return self.detector(batch, train=train, do_clustering=do_clustering,
                             **draws)

    def run_speaker(self, data, mode: str = "tf", chunk_size: int = 1,
                    gumbel: Optional[torch.Tensor] = None, beam_size: int = 1,
                    sample_topn: int = 1):
        return self.speaker(data, mode=mode, chunk_size=chunk_size,
                            gumbel=gumbel, beam_size=beam_size,
                            sample_topn=sample_topn)

    def run_listener(self, data, word_embs, lang_len, chunk_size: int,
                     train: bool = False,
                     draws: Optional[ListenerDraws] = None):
        return self.listener(data, word_embs, lang_len, chunk_size=chunk_size,
                             train=train, draws=draws)

    def moderator(self, data: Dict[str, Any], sample_topn: int
                  ) -> Dict[str, Any]:
        """The speaker's RL outputs (``sampled_cap`` (N, topn, T),
        ``baseline_cap`` (N, T'), ``target_ids``, the rows' proposals
        ``proposal_bbox_batched`` and ``proposal_sem_cls_batched_rows``)
        -> ``data`` with the listener's inputs, topn folded into rows
        (N·topn): ``mod_{sampled,baseline}_{ids,lens,embs}``, and the
        pseudo-GT ``mod_ref_box_corner_label`` (the target proposal's box)
        and ``mod_ref_cat_label`` (its class - 2, 17 where negative)."""
        emb = data["glove_embeddings"]
        max_t = self.max_spk_len + 2
        s_ids, s_lens = moderate_captions(data["sampled_cap"], self.sos_id,
                                          self.eos_id, self.pad_id, max_t)
        b_ids, b_lens = moderate_captions(
            data["baseline_cap"][:, None, :].expand(-1, sample_topn, -1),
            self.sos_id, self.eos_id, self.pad_id, max_t)
        out = dict(data)
        for name, ids, lens in (("sampled", s_ids, s_lens),
                                ("baseline", b_ids, b_lens)):
            ids = ids.flatten(0, 1)
            out[f"mod_{name}_ids"] = ids
            out[f"mod_{name}_lens"] = lens.flatten(0, 1)
            out[f"mod_{name}_embs"] = emb[ids.long()]
        rows = torch.arange(data["target_ids"].shape[0],
                            device=emb.device)
        tgt = data["target_ids"].long()
        ref_corner = data["proposal_bbox_batched"][rows, tgt]
        ref_cat = data["proposal_sem_cls_batched_rows"][rows, tgt] - 2
        ref_cat = torch.where(ref_cat < 0, 17, ref_cat)
        out["mod_ref_box_corner_label"] = ref_corner.repeat_interleave(
            sample_topn, 0)
        out["mod_ref_cat_label"] = ref_cat.to(torch.int32).repeat_interleave(
            sample_topn, 0)
        return out
