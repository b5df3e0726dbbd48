"""Top-down attention caption decoder (counterpart of
``d3net_tpu/models/caption.py``; parity: ``model/caption_module.py``).

Eval-mode captioning folds the proposal dimension into the batch: every
proposal of every scene is a row (N = B·P) decoded greedily for
``max_len + 1`` steps. The training modes ``tf`` (teacher forcing) and
``free`` (each step reads the previous step's argmax) run over description
rows N = B·chunk, each with a target proposal picked by ``select_target``.
Both loops stay on the device: no host sync, no branch on a device value,
so one step launches the same kernels every time. The only change from the
JAX step is that ``map_feat(obj_feats)``, the same product at every step,
is computed once before the loop.

Joint self-critical RL's modes: ``rl`` samples captions by (diverse) beam
search with the beam folded into the batch (``beam_decode``) beside a
greedy baseline; ``rl_tf`` teacher-forces a given rollout and takes its
tokens' log-probabilities under grad. Both can reuse a rollout's target
selection (``target_ids_in``).

Semantics preserved, including the reference's attention-mask quirk
(masked scores are set to 0, not -inf, before the softmax over all
proposals: masked proposals still receive e^0 weight,
``caption_module.py:108-116``).

The word embedding matrix arrives via ``data["glove_embeddings"]`` (V, E),
E = ``emb_size``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.frozen.models.graph import box_centers, query_locals, target_locals
from perfbench.reference.frozen.ops.cluster import topk_stable
from perfbench.reference.frozen.utils.bbox import aabb_iou_corners
from perfbench.reference.frozen.utils.nn_distance import nn_distance

_NEG = -1e9
MODES = ("eval", "tf", "free", "rl", "rl_tf")


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

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """``x·[W_ir|W_iz|W_in] + b`` (…, 3H): one product for every step
        of a sequence whose inputs are known."""
        return F.linear(x, self.weight_ih, self.bias_ih)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.step(h, self.input_gates(x))

    def step(self, h: torch.Tensor, gates_i: torch.Tensor) -> torch.Tensor:
        """The cell on the input gates of ``input_gates``."""
        i_r, i_z, i_n = gates_i.chunk(3, -1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * h


class CaptionModule(nn.Module):
    """Speaker caption head over batched proposals. The arguments are the
    JAX module's fields; a target whose IoU with its GT box exceeds
    ``min_iou_threshold`` is a good box, and mode ``rl``'s beam search
    splits its beams into ``beam_group_size`` groups with the same-step
    word-repeat penalty ``diversity_lambda`` between them."""

    def __init__(self, num_vocabs: int, sos_id: int, eos_id: int,
                 pad_id: int = 0, emb_size: int = 300, feat_size: int = 128,
                 hidden_size: int = 512, num_locals: int = 10,
                 max_len: int = 30, min_iou_threshold: float = 0.25,
                 use_relation: bool = True, beam_group_size: int = 1,
                 diversity_lambda: float = 0.5):
        super().__init__()
        self.num_vocabs = num_vocabs
        self.beam_group_size = beam_group_size
        self.diversity_lambda = diversity_lambda
        self.sos_id = sos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.hidden_size = hidden_size
        self.num_locals = num_locals
        self.max_len = max_len
        self.min_iou_threshold = min_iou_threshold
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

    def teacher_forcing(self, word_ids, embeddings, target_feat, obj_feats,
                        valid_masks, use_tf: bool = True) -> torch.Tensor:
        """word_ids (N, T) -> logits (N, T-1, V) (ref TF loop :636-667).
        Step t reads ``word_ids[:, t]``, or with ``use_tf`` False the
        previous step's argmax (``word_ids[:, 0]`` at t = 0)."""
        n, t = word_ids.shape
        feat_proj = self.map_feat(obj_feats)      # the same at every step
        h = target_feat.new_zeros(n, self.hidden_size)
        hiddens = (h, h)
        words = word_ids.long()
        all_logits = []
        for i in range(t - 1):
            ids = words[:, i] if use_tf or i == 0 else \
                all_logits[-1].argmax(-1)
            logits, hiddens, _ = self.step(
                hiddens, embeddings[ids], target_feat, obj_feats,
                valid_masks, feat_proj)
            all_logits.append(logits)
        return torch.stack(all_logits, 1)

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

    def beam_decode(self, embeddings, target_feat, obj_feats, valid_masks,
                    beam_size: int, max_len: Optional[int] = None,
                    group_size: int = 1, diversity_lambda: float = 0.5,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(Diverse) beam search with the beam folded into the batch (ref
        ``add_diversity`` and the beam of ``caption_module.py:139-156``,
        614; the JAX module's ``beam_decode``).

        ``beam_size`` splits into ``group_size`` groups of ``bd`` beams. At
        every step group g's log-probs are penalised by ``diversity_lambda``
        times the count of each word that groups < g chose at the same
        step (finished beams are exempt); selection uses the penalised
        scores, the recorded log-probs are the unpenalised ones. Each
        group's top ``bd`` is a stable descending sort's (``lax.top_k``'s
        order: ties to the lower index; they are real, as ``_NEG`` plus a
        log-prob rounds to ``_NEG`` in f32). A finished beam is frozen on
        pad with log-prob 0. The hidden states follow their source beams;
        the sequences are traced back over reversed time by one gather a
        step. The loops are static: no host sync.

        Returns (seqs (N, bm, T) int32, logps (N, bm, T), scores (N, bm)),
        T = ``max_len`` + 1, the groups concatenated in order, each sorted
        best-first.
        """
        n = target_feat.shape[0]
        t = (max_len or self.max_len) + 1
        bm, g_n = beam_size, max(1, int(group_size))
        if bm % g_n:
            raise ValueError(f"beam_size {bm} is not a multiple of "
                             f"group_size {g_n}")
        bd, v = bm // g_n, self.num_vocabs
        dev = target_feat.device

        tf_b = target_feat.repeat_interleave(bm, 0)
        of_b = obj_feats.repeat_interleave(bm, 0)
        vm_b = valid_masks.repeat_interleave(bm, 0)
        feat_proj = self.map_feat(of_b)           # the same at every step
        h = target_feat.new_zeros(n * bm, self.hidden_size)
        hiddens = (h, h)
        last = torch.full((n * bm,), self.sos_id, dtype=torch.long,
                          device=dev)
        scores = torch.full((n, g_n, bd), _NEG, device=dev)
        scores[:, :, 0] = 0.0
        scores = scores.reshape(n, bm)
        done = torch.zeros((n, bm), dtype=torch.bool, device=dev)
        pad_only = torch.full((n, bd, v), _NEG, device=dev)
        pad_only[:, :, self.pad_id] = 0.0
        base = (torch.arange(n, device=dev) * bm)[:, None]
        words, logps, srcs = [], [], []
        for _ in range(t):
            logits, (h1, h2), _ = self.step(hiddens, embeddings[last], tf_b,
                                            of_b, vm_b, feat_proj)
            logp_all = F.log_softmax(logits, -1).reshape(n, g_n, bd, v)
            done_g = done.reshape(n, g_n, bd)
            scores_g = scores.reshape(n, g_n, bd)
            counts = logits.new_zeros(n, v)
            parts = []
            for g in range(g_n):          # groups see earlier groups' words
                fin = done_g[:, g, :, None]
                lp_un = torch.where(fin, pad_only, logp_all[:, g])
                lp_aug = lp_un if g == 0 else torch.where(
                    fin, lp_un, lp_un - diversity_lambda * counts[:, None, :])
                cand = (scores_g[:, g, :, None] + lp_aug).reshape(n, bd * v)
                top_scores, top_idx = topk_stable(cand, bd)
                top_idx = top_idx.long()
                src = top_idx // v
                word = top_idx % v
                step_lp = lp_un.reshape(n, bd * v).gather(1, top_idx)
                dg = done_g[:, g].gather(1, src) | (word == self.eos_id)
                counts = counts.scatter_add(1, word, torch.ones_like(
                    step_lp))
                parts.append((word, src + g * bd, step_lp, top_scores, dg))
            word, src, step_lp, scores, done = (torch.cat(x, 1)
                                                for x in zip(*parts))
            gidx = (base + src).reshape(-1)
            hiddens = (h1[gidx], h2[gidx])
            last = word.reshape(-1)
            words.append(word)
            logps.append(step_lp)
            srcs.append(src)

        ptr = torch.arange(bm, device=dev).expand(n, bm)
        seqs, lps = [None] * t, [None] * t
        for i in range(t - 1, -1, -1):      # follow the pointers back
            seqs[i] = words[i].gather(1, ptr)
            lps[i] = logps[i].gather(1, ptr)
            ptr = srcs[i].gather(1, ptr)
        return (torch.stack(seqs, 2).to(torch.int32), torch.stack(lps, 2),
                scores)

    # ------------------------------------------------------------------
    @staticmethod
    def select_target(gumbel, obj_masks, centers, corners, center_labels,
                      corner_labels, ref_corner_label, is_annotated):
        """Each description row's target (ref ``select_target`` :416-508):
        an annotated row takes the proposal of highest IoU with its referred
        GT box; another row a random valid proposal, the argmax of the
        Gumbel draw ``gumbel`` (N, P) over the valid ones (over all when a
        scene has none), and that proposal's nearest GT box. Ties go to the
        first index, as ``jnp.argmax``'s. -> (target ids (N,) int32, target
        IoUs (N,), the random proposal's GT ids (N,) int32)."""
        rows = torch.arange(obj_masks.shape[0], device=obj_masks.device)
        iou_ann = aabb_iou_corners(corners, ref_corner_label[:, None])
        ann_iou, ann_id = iou_ann.amax(1), iou_ann.argmax(1)
        rand_id = torch.where(obj_masks > 0, gumbel, -torch.inf).argmax(1)
        rand_id = torch.where(obj_masks.sum(1) > 0, rand_id, gumbel.argmax(1))
        _, assign, _, _ = nn_distance(centers, center_labels)
        rand_assigned = assign[rows, rand_id].long()
        rand_iou = aabb_iou_corners(corners[rows, rand_id],
                                    corner_labels[rows, rand_assigned])
        ann = is_annotated > 0
        target_id = torch.where(ann, ann_id, rand_id).to(torch.int32)
        target_iou = torch.where(ann, ann_iou, rand_iou)
        return target_id, target_iou, rand_assigned.to(torch.int32)

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

    def train_inputs(self, data: Dict[str, Any],
                     gumbel: Optional[torch.Tensor]):
        """The training modes' targets and decoder inputs for description
        rows: (target ids, target IoUs, the random targets' GT ids, target
        feats (N, F), obj feats with the relation features (N, P, F), valid
        masks (N, P)). A rollout's ``target_ids_in``/``target_ious_in`` in
        ``data`` are taken as they are (the GT ids are then 0, as in the
        JAX module); else ``select_target`` picks on the Gumbel draw."""
        obj_feats = data["bbox_feature"]            # (N, P, F)
        obj_masks = data["proposal_batch_mask"]     # (N, P)
        corners = data["proposal_bbox_batched"]     # (N, P, 8, 3)
        centers = box_centers(corners)
        with torch.no_grad():                       # integers and masks
            if "target_ids_in" in data:
                target_ids = data["target_ids_in"]
                target_ious = data["target_ious_in"]
                assigned = torch.zeros_like(target_ids)
            elif gumbel is None:
                raise ValueError("the training modes need the Gumbel draw "
                                 "of select_target (N, P) or a rollout's "
                                 "target_ids_in")
            else:
                target_ids, target_ious, assigned = self.select_target(
                    gumbel, obj_masks, centers, corners,
                    data["center_label_chunk"], data["gt_bbox_chunk"],
                    data["ref_box_corner_label"], data["annotated"])
            vm = obj_masks if self.num_locals == -1 else query_locals(
                corners, centers, target_ids, obj_masks, self.num_locals)
        rows = torch.arange(target_ids.shape[0], device=target_ids.device)
        target_feats = obj_feats[rows, target_ids.long()]
        if self.use_relation:
            obj_feats = self.add_relation_feat(
                data["edge_feature"], data["local_ids"], data["local_mask"],
                obj_feats, target_ids)
        return target_ids, target_ious, assigned, target_feats, obj_feats, vm

    def rollout_logits(self, sampled, embeddings, target_feats, obj_feats,
                       valid_masks) -> torch.Tensor:
        """The logits (N·topn, T, V) of teacher forcing a rollout's tokens
        ``sampled`` (N, topn, T) from sos, each row's inputs repeated
        ``topn`` times: step t predicts ``sampled[..., t]``."""
        n, topn, t = sampled.shape
        flat = sampled.reshape(n * topn, t).long()
        full = torch.cat([flat.new_full((n * topn, 1), self.sos_id), flat], 1)
        return self.teacher_forcing(
            full, embeddings, target_feats.repeat_interleave(topn, 0),
            obj_feats.repeat_interleave(topn, 0),
            valid_masks.repeat_interleave(topn, 0))

    def rollout_logps(self, sampled, embeddings, target_feats, obj_feats,
                      valid_masks) -> torch.Tensor:
        """The log-probs (N, topn, T) of a rollout's tokens ``sampled``
        (N, topn, T) under grad: ``rollout_logits``' log-softmax at the
        token taken, 0 at every position strictly after the first eos (a
        finished beam emits pad with log-prob 0)."""
        n, topn, t = sampled.shape
        flat = sampled.reshape(n * topn, t).long()
        logits = self.rollout_logits(sampled, embeddings, target_feats,
                                     obj_feats, valid_masks)
        step_lp = F.log_softmax(logits, -1).gather(-1, flat[..., None])[..., 0]
        is_eos = (flat == self.eos_id).to(torch.int32)
        after_eos = torch.cumsum(is_eos, -1) - is_eos
        step_lp = torch.where(after_eos > 0, 0.0, step_lp)
        return step_lp.reshape(n, topn, t)

    # ------------------------------------------------------------------
    def forward(self, data: Dict[str, Any], mode: str = "tf",
                gumbel: Optional[torch.Tensor] = None, beam_size: int = 1,
                sample_topn: int = 1) -> Dict[str, Any]:
        """mode 'eval': caption every proposal greedily -> ``lang_cap``
        (B, P, max_len + 1) int32 ids. The other modes run over description
        rows (N = B·chunk) whose targets come from ``train_inputs`` (the
        (N, P) draw ``gumbel``, or a rollout's ``target_ids_in``) ->
        ``target_ids``, ``target_ious``, ``assigned_bbox_id_labels``,
        ``good_bbox_masks`` and, by mode:

        - 'tf' / 'free': ``lang_cap``, the logits (N, T-1, V) of
          ``teacher_forcing`` over ``lang_ids``;
        - 'rl': the first ``sample_topn`` sequences of ``beam_decode`` with
          ``beam_size`` beams as ``sampled_cap`` (N, topn, max_len + 1) and
          their ``sampled_logps``, and the greedy baseline ``baseline_cap``
          (N, max_len + 2): one step longer than the beam, as in the JAX
          module;
        - 'rl_tf': the rollout ``sampled_cap_in`` teacher-forced under
          grad (``rollout_logps``) as ``sampled_cap``/``sampled_logps``,
          with ``baseline_cap_in`` passed through as ``baseline_cap``."""
        if mode not in MODES:
            raise ValueError(f"CaptionModule mode {mode!r}: one of {MODES}")
        out = dict(data)
        embeddings = data["glove_embeddings"]
        if mode == "eval":
            b, p, _ = data["bbox_feature"].shape
            target_feats, of, vm = self.eval_inputs(data)
            ids, _ = self.greedy_decode(embeddings, target_feats, of, vm)
            out["lang_cap"] = ids.reshape(b, p, -1)
            return out

        target_ids, target_ious, assigned, target_feats, obj_feats, vm = \
            self.train_inputs(data, gumbel)
        out["target_ids"] = target_ids
        out["target_ious"] = target_ious
        out["assigned_bbox_id_labels"] = assigned
        out["good_bbox_masks"] = target_ious > self.min_iou_threshold
        if mode in ("tf", "free"):
            out["lang_cap"] = self.teacher_forcing(
                data["lang_ids"], embeddings, target_feats, obj_feats, vm,
                use_tf=mode == "tf")
        elif mode == "rl":
            seqs, lps, _ = self.beam_decode(
                embeddings, target_feats, obj_feats, vm, beam_size,
                group_size=self.beam_group_size,
                diversity_lambda=self.diversity_lambda)
            out["sampled_cap"] = seqs[:, :sample_topn]
            out["sampled_logps"] = lps[:, :sample_topn]
            out["baseline_cap"], _ = self.greedy_decode(
                embeddings, target_feats, obj_feats, vm, self.max_len + 1)
        else:
            out["sampled_cap"] = data["sampled_cap_in"]
            out["sampled_logps"] = self.rollout_logps(
                data["sampled_cap_in"], embeddings, target_feats, obj_feats,
                vm)
            out["baseline_cap"] = data["baseline_cap_in"]
        return out
