"""SpeakerNet: relational graph + caption decoder (counterpart of
``d3net_tpu/models/speaker.py``; parity: ``model/speaker.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from d3net_tpu_torch import trace
from d3net_tpu_torch.models.caption import CaptionModule
from d3net_tpu_torch.models.graph import GraphModule

# the scene-level tensors that the training modes repeat per description
EXPAND_KEYS = ("bbox_feature", "proposal_batch_mask", "proposal_bbox_batched",
               "edge_feature", "local_ids", "local_mask")


def expand_to_rows(data: Dict[str, Any], chunk_size: int) -> Dict[str, Any]:
    """``data`` with each of ``EXPAND_KEYS`` repeated ``chunk_size`` times
    per scene: one row per description."""
    return {k: v.repeat_interleave(chunk_size, dim=0) if k in EXPAND_KEYS
            else v for k, v in data.items()}


class SpeakerNet(nn.Module):
    """``m`` is the width of the detector's proposal features (the graph's
    input); the JAX module infers it."""

    def __init__(self, num_vocabs: int, sos_id: int, eos_id: int,
                 pad_id: int = 0, m: int = 16, feat_size: int = 128,
                 num_graph_steps: int = 2, num_locals: int = 10,
                 max_len: int = 30, min_iou_threshold: float = 0.25,
                 use_relation: bool = True, use_orientation: bool = True,
                 beam_group_size: int = 1, diversity_lambda: float = 0.5):
        super().__init__()
        self.num_graph_steps = num_graph_steps
        if num_graph_steps > 0:
            self.graph = GraphModule(
                m, out_size=feat_size, num_layers=num_graph_steps,
                num_locals=num_locals, return_orientation=use_orientation)
        self.caption = CaptionModule(
            num_vocabs=num_vocabs, sos_id=sos_id, eos_id=eos_id,
            pad_id=pad_id, feat_size=feat_size, num_locals=num_locals,
            max_len=max_len, min_iou_threshold=min_iou_threshold,
            use_relation=use_relation, beam_group_size=beam_group_size,
            diversity_lambda=diversity_lambda)

    def forward(self, data: Dict[str, Any], mode: str = "tf",
                chunk_size: int = 1, gumbel: Optional[torch.Tensor] = None,
                beam_size: int = 1, sample_topn: int = 1) -> Dict[str, Any]:
        """The graph over the scenes' proposals, then the caption head in
        ``mode`` (``CaptionModule.forward``'s). In modes other than 'eval'
        the scene-level keys are repeated ``chunk_size`` times each, one
        row per description; the graph's other outputs
        (``edge_orientations``, ``adjacent_mat``) stay per scene. The
        ``spk.graph`` and ``spk.decode`` spans."""
        if self.num_graph_steps > 0:
            with trace.span("spk.graph"):
                data = self.graph(data)
        if mode != "eval":
            data = expand_to_rows(data, chunk_size)
        with trace.span("spk.decode"):
            return self.caption(data, mode=mode, gumbel=gumbel,
                                beam_size=beam_size, sample_topn=sample_topn)
