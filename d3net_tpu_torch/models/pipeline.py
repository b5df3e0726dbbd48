"""PipelineNet: detector -> speaker / listener (counterpart of
``d3net_tpu/models/pipeline.py``; parity: ``model/pipeline.py``).

One module holding the submodules so parameters nest as the Flax tree's
``{detector, speaker, listener}``: the speaker unless ``no_captioning``,
the listener unless ``no_grounding``, both for a joint config (so the eval
of either task loads a joint run's checkpoint). The moderator waits for
joint RL (ROADMAP.md queue A item 15).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from d3net_tpu_torch.models.listener import ListenerDraws, ListenerNet
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.models.speaker import SpeakerNet


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
                 no_captioning: bool = False, no_grounding: bool = False):
        super().__init__()
        self.pad_id = pad_id
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
                use_orientation=use_orientation)
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
                    gumbel: Optional[torch.Tensor] = None):
        return self.speaker(data, mode=mode, chunk_size=chunk_size,
                            gumbel=gumbel)

    def run_listener(self, data, word_embs, lang_len, chunk_size: int,
                     train: bool = False,
                     draws: Optional[ListenerDraws] = None):
        return self.listener(data, word_embs, lang_len, chunk_size=chunk_size,
                             train=train, draws=draws)
