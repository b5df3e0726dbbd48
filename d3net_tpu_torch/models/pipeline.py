"""PipelineNet: detector -> speaker (counterpart of
``d3net_tpu/models/pipeline.py``; parity: ``model/pipeline.py``).

One module holding the submodules so parameters nest as the Flax tree's
``{detector, speaker}``. The listener (``no_grounding=False``) is ROADMAP.md
queue A item 14 and raises; the moderator waits for joint RL (item 15).
"""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.models.speaker import SpeakerNet


class PipelineNet(nn.Module):
    """``in_channels`` is the detector's input width; the other arguments
    are the JAX module's fields that the detector and the speaker's eval
    mode read."""

    def __init__(self, in_channels: int, detector_cfg: Dict[str, Any],
                 num_vocabs: int = 44, sos_id: int = 2, eos_id: int = 3,
                 pad_id: int = 0, num_graph_steps: int = 2,
                 num_locals: int = 10, max_spk_len: int = 30,
                 use_relation: bool = True, use_orientation: bool = True,
                 no_captioning: bool = False, no_grounding: bool = False):
        super().__init__()
        if not no_grounding:
            raise NotImplementedError(
                "PipelineNet with the listener (no_grounding=False) is not "
                "ported (ROADMAP.md, queue A item 14)")
        self.detector = PointGroup(in_channels, **detector_cfg)
        if not no_captioning:
            self.speaker = SpeakerNet(
                num_vocabs=num_vocabs, sos_id=sos_id, eos_id=eos_id,
                pad_id=pad_id,
                # the proposal features are the ScoreNet's pooled first level
                m=detector_cfg.get("m", 16)
                * tuple(detector_cfg.get("cluster_blocks", (1, 2)))[0],
                num_graph_steps=num_graph_steps, num_locals=num_locals,
                max_len=max_spk_len, use_relation=use_relation,
                use_orientation=use_orientation)

    def run_detector(self, batch, train: bool = False,
                     do_clustering: bool = True):
        return self.detector(batch, train=train, do_clustering=do_clustering)

    def run_speaker(self, data, mode: str = "tf"):
        return self.speaker(data, mode=mode)
