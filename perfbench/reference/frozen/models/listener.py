"""ListenerNet: language encoder + match module (counterpart of
``d3net_tpu/models/listener.py``; parity: ``model/listener.py``).

``ListenerDraws`` holds one training forward's random draws: each
dropout's keep mask by its path in the listener (``lang.cls_dropout``,
``match.lang_dropout``, ``match.cross_attn_0.Dropout_0``, ...) and the
copy-paste Bernoulli and (B, P, P) Gumbel. They come from a
``torch.Generator`` in call order, or are given as tensors (tests hold the
port to JAX on the same draws).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from perfbench.reference.frozen.models.lang import LangModule
from perfbench.reference.frozen.models.match import (
    MatchModule, TransformerMatchModule, gumbel_draw,
)
from perfbench.reference.frozen.models.transformer import name_dropouts
from perfbench.reference.frozen.parallel import mesh


class ListenerDraws:
    """The listener's draws for one training forward. ``masks``: keep masks
    by dropout path; ``copy_paste``: (apply, a 0-dim bool tensor; gumbel,
    (B, P, P)). What is not given is drawn from ``generator`` (torch's
    default generator when None), but a dropout whose path has a mask of
    the same shape in ``shared`` (an earlier forward's ``drawn``) takes
    it: two forwards under one JAX key draw the same bits where the shapes
    agree. The keep masks used stay in ``drawn``, by path, and the
    copy-paste draw in ``copy_paste_draw``.

    Under a process group (``parallel.mesh``) every draw is made at the
    global batch's rows and each rank keeps its own; given masks and
    copy-paste draws may hold the global batch's rows, and each rank takes
    its own. ``drawn`` keeps this rank's rows."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 masks: Optional[Mapping[str, torch.Tensor]] = None,
                 copy_paste: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None,
                 shared: Optional[Mapping[str, torch.Tensor]] = None):
        self.generator = generator
        self.masks = masks
        self.copy_paste_draw = copy_paste
        self.shared = shared or {}
        self.drawn: Dict[str, torch.Tensor] = {}

    def keep(self, path: str, shape, rate: float, device) -> torch.Tensor:
        if self.masks is not None:
            return mesh.local_rows(self.masks[path].to(device), shape[0])
        same = self.shared.get(path)
        if same is not None and tuple(same.shape) == tuple(shape):
            self.drawn[path] = same
        else:
            self.drawn[path] = mesh.draw_rows(lambda n: torch.rand(
                (n,) + tuple(shape[1:]), generator=self.generator,
                device=device) < 1.0 - rate, shape[0])
        return self.drawn[path]

    def copy_paste(self, shape, prob: float, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.copy_paste_draw is None:
            apply = torch.rand((), generator=self.generator,
                               device=device) < prob
            self.copy_paste_draw = (apply, mesh.draw_rows(
                lambda n: gumbel_draw((n,) + tuple(shape[1:]),
                                      self.generator, device), shape[0]))
        apply, g = self.copy_paste_draw
        return apply.to(device), mesh.local_rows(g.to(device), shape[0])


class ListenerNet(nn.Module):
    """``feat_size`` is the width of the detector's proposal features; the
    other arguments are the JAX module's fields."""

    def __init__(self, feat_size: int, num_text_classes: int = 18,
                 lang_hidden: int = 256, match_hidden: int = 128,
                 match_type: str = "Transformer",
                 use_lang_classifier: bool = True, use_bidir: bool = False):
        super().__init__()
        self.match_type = match_type
        self.lang = LangModule(num_text_classes=num_text_classes,
                               hidden_size=lang_hidden,
                               use_lang_classifier=use_lang_classifier,
                               use_bidir=use_bidir)
        if match_type == "Transformer":
            self.match = TransformerMatchModule(
                feat_size, lang_size=lang_hidden, hidden_size=match_hidden)
        elif match_type == "ScanRefer":
            self.match = MatchModule(feat_size, hidden_size=match_hidden,
                                     lang_size=lang_hidden)
        else:
            raise ValueError(match_type)
        name_dropouts(self)

    def forward(self, data: Dict[str, Any], word_embs, lang_len,
                chunk_size: int, train: bool = False,
                draws: Optional[ListenerDraws] = None) -> Dict[str, Any]:
        """word_embs (B·chunk, T, E); lang_len (B·chunk,). In training the
        draws come from ``draws`` (a ``ListenerDraws`` of torch's default
        generator when None)."""
        if train and draws is None:
            draws = ListenerDraws()
        d = draws if train else None
        lang_out = self.lang(word_embs, lang_len, d)
        data = dict(data)
        data.update(lang_out)
        if self.match_type == "Transformer":
            return self.match(data, chunk_size=chunk_size, train=train,
                              draws=d)
        feats = data["proposal_feats_batched"].repeat_interleave(chunk_size, 0)
        masks = data["proposal_batch_mask"].repeat_interleave(chunk_size, 0)
        data["cluster_ref"] = self.match(feats, masks, lang_out["lang_emb"])
        return data
