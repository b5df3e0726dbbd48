"""Top-down attention caption decoder (counterpart of
``d3net_tpu/models/caption.py``; parity: ``model/caption_module.py``).

Eval-mode captioning folds the proposal dimension into the batch: every
proposal of every scene is a row (N = B·P) decoded greedily for
``max_len + 1`` steps. The decode loop stays on the device: no host sync,
no branch on a device value, so one step launches the same kernels every
time. The only change from the JAX step is that ``map_feat(obj_feats)``,
the same product at every step, is computed once before the loop.

Semantics preserved, including the reference's attention-mask quirk
(masked scores are set to 0, not -inf, before the softmax over all
proposals: masked proposals still receive e^0 weight,
``caption_module.py:108-116``).

The word embedding matrix arrives via ``data["glove_embeddings"]`` (V, E),
E = ``emb_size``.

Modes ``tf``/``free``/``rl``/``rl_tf``, target selection and beam search
are the speaker's training path and are not ported yet (ROADMAP.md queue
A item 13); they raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from d3net_tpu_torch.models.graph import box_centers, target_locals

NOT_PORTED = ("is the speaker's training path, not ported yet (ROADMAP.md, "
              "queue A item 13)")


class GRUCell(nn.Module):
    """Flax's ``nn.GRUCell``: gates ``ir/iz/in`` with bias, ``hr/hz``
    without, ``hn`` with,

        r = σ(W_ir x + b_ir + W_hr h),  z = σ(W_iz x + b_iz + W_hz h),
        n = tanh(W_in x + b_in + r ⊙ (W_hn h + b_hn)),
        h' = (1 - z) ⊙ n + z ⊙ h,

    as two fused products ``x·[W_ir|W_iz|W_in] + b`` and
    ``h·[W_hr|W_hz|W_hn]``. ``torch.nn.GRUCell`` would add the biases
    ``b_hr`` and ``b_hz``, which the Flax cell lacks."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        h = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * h, input_size))
        self.bias_ih = nn.Parameter(torch.zeros(3 * h))
        self.weight_hh = nn.Parameter(torch.empty(3 * h, h))
        self.bias_hn = nn.Parameter(torch.zeros(h))
        nn.init.xavier_uniform_(self.weight_ih)
        nn.init.orthogonal_(self.weight_hh)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = F.linear(x, self.weight_ih, self.bias_ih).chunk(3, -1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * h


class CaptionModule(nn.Module):
    """Speaker caption head over batched proposals. The arguments are the
    JAX module's fields that eval mode reads; the target selection's IoU
    threshold and the beam search's are the training path's."""

    def __init__(self, num_vocabs: int, sos_id: int, eos_id: int,
                 pad_id: int = 0, emb_size: int = 300, feat_size: int = 128,
                 hidden_size: int = 512, num_locals: int = 10,
                 max_len: int = 30, use_relation: bool = True):
        super().__init__()
        self.sos_id = sos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.hidden_size = hidden_size
        self.num_locals = num_locals
        self.max_len = max_len
        self.use_relation = use_relation
        e, f, h = emb_size, feat_size, hidden_size
        self.map_topdown = nn.Linear(e + h + f, e)
        self.cell_td = GRUCell(e, h)
        self.map_feat = nn.Linear(f, h, bias=False)
        self.map_hidd = nn.Linear(h, h, bias=False)
        self.attend = nn.Linear(h, 1, bias=False)
        self.map_lang = nn.Linear(f + h, e)
        self.cell_lang = GRUCell(e, h)
        self.cls_fc1 = nn.Linear(h, h)
        self.cls_fc2 = nn.Linear(h, num_vocabs)

    # ------------------------------------------------------------------
    def step(self, hiddens, word_emb, target_feat, obj_feats, valid_masks,
             feat_proj: Optional[torch.Tensor] = None):
        """One recurrent step (ref ``step`` :72-133).

        hiddens: (h1, h2) each (N, H); word_emb (N, E); obj_feats (N, P, F);
        valid_masks (N, P); ``feat_proj`` is ``map_feat(obj_feats)`` when the
        caller has it. Returns (logits (N, V), hiddens, attn (N, P)).
        """
        h1, h2 = hiddens
        if feat_proj is None:
            feat_proj = self.map_feat(obj_feats)
        x = self.map_topdown(torch.cat([word_emb, h2, target_feat], -1))
        h1 = self.cell_td(h1, x)

        combined = feat_proj + self.map_hidd(h1)[:, None, :]
        scores = self.attend(torch.tanh(combined))[..., 0]   # (N, P)
        # reference quirk: masked scores are zeroed (not -inf) pre-softmax
        scores = torch.where(valid_masks > 0, scores, 0.0)
        attn = torch.softmax(scores, dim=1)
        attended = torch.bmm(attn[:, None, :], obj_feats)[:, 0]

        lx = self.map_lang(torch.cat([attended, h1], -1))
        h2 = self.cell_lang(h2, lx)
        logits = self.cls_fc2(F.relu(self.cls_fc1(h2)))
        return logits, (h1, h2), attn

    def greedy_decode(self, embeddings, target_feat, obj_feats, valid_masks,
                      max_len: Optional[int] = None,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy rollout from sos -> (ids (N, T) int32, logits (N, T, V))."""
        n = target_feat.shape[0]
        t = (max_len or self.max_len) + 1
        feat_proj = self.map_feat(obj_feats)      # the same at every step
        h = target_feat.new_zeros(n, self.hidden_size)
        hiddens = (h, h)
        ids = torch.full((n,), self.sos_id, dtype=torch.long,
                         device=target_feat.device)
        all_ids, all_logits = [], []
        for _ in range(t):
            logits, hiddens, _ = self.step(hiddens, embeddings[ids],
                                           target_feat, obj_feats,
                                           valid_masks, feat_proj)
            ids = logits.argmax(-1)
            all_ids.append(ids)
            all_logits.append(logits)
        return (torch.stack(all_ids, 1).to(torch.int32),
                torch.stack(all_logits, 1))

    def beam_decode(self, *args, **kwargs):
        raise NotImplementedError(f"beam_decode {NOT_PORTED}")

    # ------------------------------------------------------------------
    @staticmethod
    def scatter_relation(rel, ids, msk, obj_feats):
        """Add each row's target edge features ``rel`` (N, L, C) at its
        locals ``ids`` (N, L), masked by ``msk`` (N, L), to ``obj_feats``
        (N, P, C)."""
        c = rel.shape[-1]
        scattered = torch.zeros_like(obj_feats).scatter_add_(
            1, ids.long()[..., None].expand(-1, -1, c), rel * msk[..., None])
        return obj_feats + scattered

    def add_relation_feat(self, edge_feature, local_ids, local_mask, obj_feats,
                          target_ids):
        """Scatter the target's edge features onto its local objects and add
        (ref ``_add_relation_feat`` :866-885)."""
        rows = torch.arange(target_ids.shape[0], device=target_ids.device)
        tid = target_ids.long()
        return self.scatter_relation(edge_feature[rows, tid],
                                     local_ids[rows, tid],
                                     local_mask[rows, tid], obj_feats)

    def eval_inputs(self, data: Dict[str, Any]):
        """Eval mode's decoder inputs with proposals folded into rows
        n = b·P + t: (target_feats (N, F), obj_feats (N, P, F), valid
        masks (N, P)). Row n's inputs are the JAX module's ``rep``-eated
        scene b with target t, computed per scene and not repeated where
        the values are the scene's."""
        obj_feats = data["bbox_feature"]            # (B, P, F)
        obj_masks = data["proposal_batch_mask"]     # (B, P)
        corners = data["proposal_bbox_batched"]     # (B, P, 8, 3)
        b, p, f = obj_feats.shape
        n = b * p
        of = obj_feats.repeat_interleave(p, dim=0)
        target_feats = obj_feats.reshape(n, f)
        if self.num_locals == -1:
            vm = obj_masks.repeat_interleave(p, dim=0)
        else:
            ids = torch.arange(p, device=corners.device).expand(b, p)
            vm = target_locals(corners, ids, corners, box_centers(corners),
                               obj_masks, self.num_locals,
                               True).reshape(n, p)
        if self.use_relation:
            of = self.scatter_relation(*(data[k].flatten(0, 1) for k in (
                "edge_feature", "local_ids", "local_mask")), of)
        return target_feats, of, vm

    # ------------------------------------------------------------------
    def forward(self, data: Dict[str, Any], mode: str = "tf") -> Dict[str, Any]:
        """mode 'eval': caption every proposal greedily -> ``lang_cap``
        (B, P, max_len + 1) int32 ids."""
        if mode != "eval":
            raise NotImplementedError(f"CaptionModule mode {mode!r} {NOT_PORTED}")
        b, p, _ = data["bbox_feature"].shape
        target_feats, of, vm = self.eval_inputs(data)
        ids, _ = self.greedy_decode(data["glove_embeddings"], target_feats,
                                    of, vm)
        out = dict(data)
        out["lang_cap"] = ids.reshape(b, p, -1)
        return out
