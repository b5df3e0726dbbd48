"""SpeakerNet: relational graph + caption decoder (counterpart of
``d3net_tpu/models/speaker.py``; parity: ``model/speaker.py``)."""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from d3net_tpu_torch.models.caption import NOT_PORTED, CaptionModule
from d3net_tpu_torch.models.graph import GraphModule


class SpeakerNet(nn.Module):
    """``m`` is the width of the detector's proposal features (the graph's
    input); the JAX module infers it."""

    def __init__(self, num_vocabs: int, sos_id: int, eos_id: int,
                 pad_id: int = 0, m: int = 16, feat_size: int = 128,
                 num_graph_steps: int = 2, num_locals: int = 10,
                 max_len: int = 30, use_relation: bool = True,
                 use_orientation: bool = True):
        super().__init__()
        self.num_graph_steps = num_graph_steps
        if num_graph_steps > 0:
            self.graph = GraphModule(
                m, out_size=feat_size, num_layers=num_graph_steps,
                num_locals=num_locals, return_orientation=use_orientation)
        self.caption = CaptionModule(
            num_vocabs=num_vocabs, sos_id=sos_id, eos_id=eos_id,
            pad_id=pad_id, feat_size=feat_size, num_locals=num_locals,
            max_len=max_len, use_relation=use_relation)

    def forward(self, data: Dict[str, Any], mode: str = "tf") -> Dict[str, Any]:
        if self.num_graph_steps > 0:
            data = self.graph(data)
        if mode != "eval":
            raise NotImplementedError(f"SpeakerNet mode {mode!r} {NOT_PORTED}")
        return self.caption(data, mode=mode)
