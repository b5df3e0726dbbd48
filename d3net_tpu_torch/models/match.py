"""Grounding match module (counterpart of ``d3net_tpu/models/match.py``;
parity: ``model/match_module.py``).

``TransformerMatchModule``: proposal features -> fc, BatchNorm, PReLU, fc
-> visual self-attention with a detached inverse-distance prior added to
the logits -> alternating (distance-weighted self-attention, vision <->
language cross-attention) x depth -> fc head giving one confidence per
proposal and description row.

In training, the reference's **object copy-paste augmentation**
(``match_module.py:269-291``): with probability 0.5 for the whole batch,
every padded proposal slot takes the features of a valid proposal of the
previous scene in the batch (rolled by one), picked by a (B, P, P) Gumbel
draw; a scene whose donor has no valid proposal keeps its own. The draws
come from the listener's draws object (``ListenerDraws``).

``BatchNorm`` has Flax's semantics, not ``BatchNorm1d``'s: momentum 0.9 on
the running statistics, eps 1e-5, the fast variance, and a *biased*
running variance; it normalises over all B·P rows, padded slots included.
``PReLU`` is ``where(x >= 0, x, a·x)``, so the gradient at 0 is Flax's.

``MatchModule`` is the simpler ScanRefer-style fuse head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from d3net_tpu_torch.models.transformer import (
    Dropout, LayerNorm, MultiHeadAttention, fast_stats, flax_norm,
    name_dropouts,
)
from d3net_tpu_torch.parallel import mesh


def gumbel_draw(shape, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1)
    (``jax.random.gumbel``'s form)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the rows of
    (N, C): train normalises with the batch's mean and fast (biased)
    variance and moves ``mean``/``var`` by ``0.9·running + 0.1·batch``;
    eval normalises with them. Under a process group (``parallel.mesh``)
    the train statistics are the global batch's rows'."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return flax_norm(x, self.mean, self.var, self.scale, self.bias,
                             self.eps)
        if mesh.active():
            # the global batch's rows: [Σx, Σx², n] in one collective, then
            # the same fast variance
            c = x.shape[-1]
            s = mesh.all_reduce_sum(torch.cat([
                x.sum(0), (x * x).sum(0),
                x.new_full((1,), float(x.shape[0]))]))
            mean = (s[:c] / s[-1])[None]
            var = torch.clamp(s[c:2 * c][None] / s[-1] - mean * mean, min=0.0)
        else:
            mean, var = fast_stats(x, 0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean[0])
            self.var.copy_(m * self.var + (1.0 - m) * var[0])
        return flax_norm(x, mean, var, self.scale, self.bias, self.eps)


class PReLU(nn.Module):
    """``where(x >= 0, x, alpha·x)``, one ``alpha`` a channel (0.25 at
    init)."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class MatchModule(nn.Module):
    """ScanRefer-style matcher (ref ``MatchModule`` :11-141); layer names
    are the Flax auto-names."""

    def __init__(self, feat_size: int, hidden_size: int = 128,
                 lang_size: int = 256):
        super().__init__()
        self.Dense_0 = nn.Linear(feat_size, hidden_size)
        self.Dense_1 = nn.Linear(hidden_size + lang_size, hidden_size)
        self.Dense_2 = nn.Linear(hidden_size, hidden_size)
        self.Dense_3 = nn.Linear(hidden_size, 1)

    def forward(self, feats, masks, lang_emb) -> torch.Tensor:
        """feats (N, P, F), masks (N, P), lang_emb (N, L) -> (N, P)."""
        n, p, _ = feats.shape
        fused = self.Dense_0(feats)
        lang = lang_emb[:, None, :].expand(n, p, lang_emb.shape[-1])
        h = F.relu(self.Dense_1(torch.cat([fused, lang], -1)))
        h = F.relu(self.Dense_2(h))
        return self.Dense_3(h)[..., 0] * masks


class TransformerMatchModule(nn.Module):
    """``feat_size`` is the width of the detector's proposal features (the
    JAX module infers it); the other arguments are the JAX module's
    fields."""

    def __init__(self, feat_size: int, lang_size: int = 256,
                 hidden_size: int = 128, head: int = 4, depth: int = 2,
                 use_dist_weight_matrix: bool = True,
                 copy_paste_prob: float = 0.5):
        super().__init__()
        hs = hidden_size
        self.head, self.depth = head, depth
        self.use_dist_weight_matrix = use_dist_weight_matrix
        self.copy_paste_prob = copy_paste_prob
        self.feat_fc1 = nn.Linear(feat_size, hs)
        self.feat_bn = BatchNorm(hs)
        self.feat_prelu = PReLU(hs)
        self.feat_fc2 = nn.Linear(hs, hs)

        self.lang_fc = nn.Linear(lang_size, hs)
        self.lang_dropout = Dropout(0.1)
        self.lang_ln = LayerNorm(hs)
        self.lang_self_attn = MultiHeadAttention(hs, 16, 16, head)
        for i in range(depth):
            setattr(self, f"self_attn_{i}", MultiHeadAttention(
                hs, hs // head, hs // head, head))
            setattr(self, f"cross_attn_{i}", MultiHeadAttention(
                hs, hs // head, hs // head, head))
        self.match_fc1 = nn.Linear(hs, hs)
        self.match_bn1 = BatchNorm(hs)
        self.match_prelu1 = PReLU(hs)
        self.match_fc2 = nn.Linear(hs, hs)
        self.match_bn2 = BatchNorm(hs)
        self.match_prelu2 = PReLU(hs)
        self.match_fc3 = nn.Linear(hs, 1)
        name_dropouts(self)

    def attn(self, kind: str, i: int) -> MultiHeadAttention:
        return getattr(self, f"{kind}_attn_{i}")

    @staticmethod
    def _bn(bn: BatchNorm, h: torch.Tensor, train: bool) -> torch.Tensor:
        return bn(h.reshape(-1, h.shape[-1]), train).reshape(h.shape)

    def _features_concat(self, feats, train: bool):
        h = self._bn(self.feat_bn, self.feat_fc1(feats), train)
        return self.feat_fc2(self.feat_prelu(h))

    def _dist_weights(self, centers):
        """Detached inverse-distance attention prior (ref :220-241):
        (B, P, 3) -> (B, head, P, P)."""
        with torch.no_grad():
            d = torch.sqrt(((centers[:, None, :, :] - centers[:, :, None, :])
                            ** 2).sum(-1))
            w = 1.0 / (d + 1e-2)
            w = w / w.sum(dim=2, keepdim=True)
            return w[:, None].expand(w.shape[0], self.head, *w.shape[1:])

    def _copy_paste(self, feats, masks, draws):
        """Fill padded slots with real objects of the previous scene
        (p = ``copy_paste_prob`` for the whole batch)."""
        b, p, _ = feats.shape
        apply, g = draws.copy_paste((b, p, p), self.copy_paste_prob,
                                    feats.device)
        # the previous scene of the global batch (over the ranks)
        donor_feats = mesh.roll_rows(feats)
        donor_masks = mesh.roll_rows(masks)
        pick_logits = torch.where(donor_masks[:, None, :] > 0, g, -torch.inf)
        pick = pick_logits.argmax(-1)                       # (B, P)
        donor = torch.take_along_dim(donor_feats, pick[..., None], dim=1)
        has_donor = donor_masks.sum(-1, keepdim=True) > 0
        fill = torch.where((masks[..., None] > 0) | ~has_donor[..., None],
                           feats, donor)
        return torch.where(apply, fill, feats)

    def multiplex_attention(self, v_features, l_features, l_masks,
                            dist_weights, train: bool, draws=None):
        d = draws if train else None
        lang = self.lang_dropout(F.relu(self.lang_fc(l_features)), d)
        lang = self.lang_ln(lang)
        lang = self.lang_self_attn(lang, lang, lang, key_mask=l_masks,
                                   draws=d)
        v = self.cross_attn_0(v_features, lang, lang, key_mask=l_masks,
                              draws=d)
        for i in range(1, self.depth):
            v = self.attn("self", i)(v, v, v, attention_weights=dist_weights,
                                     way="add", draws=d)
            v = self.attn("cross", i)(v, lang, lang, key_mask=l_masks,
                                      draws=d)
        h = self._bn(self.match_bn1, self.match_fc1(v), train)
        h = self._bn(self.match_bn2, self.match_fc2(self.match_prelu1(h)),
                     train)
        return self.match_fc3(self.match_prelu2(h))[..., 0]   # (N, P)

    def forward(self, data: Dict[str, Any], chunk_size: int,
                train: bool = False, draws=None) -> Dict[str, Any]:
        """Scene-level proposals + description rows -> confidences.

        data requires: proposal_feats_batched (B, P, F),
        proposal_batch_mask, proposal_center_batched, lang_hiddens
        (B·chunk, T, H), lang_masks. Returns the dict with ``cluster_ref``
        (B·chunk, P). ``draws`` (training only) gives the dropout masks
        and, when given, the copy-paste draws."""
        feats = data["proposal_feats_batched"]
        masks = data["proposal_batch_mask"]
        dist_weights = (self._dist_weights(data["proposal_center_batched"])
                        if self.use_dist_weight_matrix else None)
        way = "add" if self.use_dist_weight_matrix else "mul"
        d = draws if train else None

        h = self._features_concat(feats, train)
        h = self.self_attn_0(h, h, h, attention_weights=dist_weights,
                             way=way, draws=d)
        if d is not None:
            h = self._copy_paste(h, masks, d)

        # expand scenes to their description rows
        v = h.repeat_interleave(chunk_size, dim=0)
        dw = (dist_weights.repeat_interleave(chunk_size, dim=0)
              if dist_weights is not None else None)
        conf = self.multiplex_attention(v, data["lang_hiddens"],
                                        data["lang_masks"], dw, train, d)
        out = dict(data)
        out["cluster_ref"] = conf
        return out
