"""GRU language encoder (counterpart of ``d3net_tpu/models/lang.py``;
parity: ``model/lang_module.py``).

The reference packs padded sequences into cuDNN GRU calls; the JAX module
runs a masked scan over the fixed token horizon, and so does this one, with
the Flax-parameterised ``GRUCell`` (``models/caption.py``; not
``torch.nn.GRU``, whose gates carry two more biases). Per-step hiddens are
zeroed beyond each sequence's length and the "last" embedding is the hidden
state at step len-1 (pack_padded parity); a description of length 0 gives
zeros. The input gates of all T steps are one product before the loop.

The bidirectional pass flips the whole padded sequence, as the JAX module
does, not each sequence within its length.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from perfbench.reference.frozen.models.caption import GRUCell
from perfbench.reference.frozen.models.transformer import Dropout, name_dropouts


class LangModule(nn.Module):
    def __init__(self, num_text_classes: int = 18, emb_size: int = 300,
                 hidden_size: int = 256, use_lang_classifier: bool = True,
                 use_bidir: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.use_bidir = use_bidir
        self.use_lang_classifier = use_lang_classifier
        self.gru_fwd = GRUCell(emb_size, hidden_size)
        if use_bidir:
            self.gru_bwd = GRUCell(emb_size, hidden_size)
        if use_lang_classifier:
            self.lang_cls = nn.Linear(hidden_size, num_text_classes)
            self.cls_dropout = Dropout(0.5)
        name_dropouts(self)

    def _run(self, cell: GRUCell, embs, masks
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """embs (N, T, E), masks (N, T) -> (hiddens (N, T, H), last (N, H))."""
        gates = cell.input_gates(embs)                      # (N, T, 3H)
        h = embs.new_zeros(embs.shape[0], self.hidden_size)
        outs = []
        for t in range(embs.shape[1]):
            h_new = cell.step(h, gates[:, t])
            m = masks[:, t, None]
            h = torch.where(m > 0, h_new, h)
            outs.append(h_new * m)
        return torch.stack(outs, 1), h

    def forward(self, word_embs, lang_len,
                draws=None) -> Dict[str, torch.Tensor]:
        """word_embs (N, T, E); lang_len (N,) -> ``lang_hiddens`` (N, T, H),
        ``lang_emb`` (N, H), ``lang_masks`` (N, T) and ``lang_scores``;
        ``draws`` None is eval (no dropout on the scores)."""
        t = word_embs.shape[1]
        masks = (torch.arange(t, device=word_embs.device)[None, :]
                 < lang_len[:, None]).to(word_embs.dtype)
        hiddens, last = self._run(self.gru_fwd, word_embs, masks)
        if self.use_bidir:
            h_b, last_b = self._run(self.gru_bwd, word_embs.flip(1),
                                    masks.flip(1))
            hiddens = (hiddens + h_b.flip(1)) / 2
            last = (last + last_b) / 2
        out = {"lang_hiddens": hiddens, "lang_emb": last, "lang_masks": masks}
        if self.use_lang_classifier:
            out["lang_scores"] = self.cls_dropout(self.lang_cls(last), draws)
        return out
