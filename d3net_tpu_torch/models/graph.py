"""Relational graph over proposals (counterpart of
``d3net_tpu/models/graph.py``; parity: ``model/graph_module.py``).

The graph is a dense masked (B, P, P) adjacency and EdgeConv is batched
products over all pairs, as in the JAX module. Semantics:

- adjacency row i = the ``num_locals`` nearest valid proposals of i by
  min corner-to-center distance, excluding boxes with IoU >= 0.5 and self.
  The pick is ``lax.top_k``'s: ties go to the lower index, which a stable
  sort gives (``torch.topk`` promises no order on ties). Every target's row
  comes from one batched (B, P, P) computation.
- EdgeConv message (src s -> tgt t) = MLP([x_t, x_s - x_t]), held at
  ``msg[b, s, t]`` and sum-aggregated at t over the adjacency's column:
  ``agg[b, t] = sum_s adj[b, s, t] msg[b, s, t]``. The adjacency is not
  symmetric (top-k is one-sided), so the index order matters.
- node output = map_input(x) + gcn stack (skip connection).
- edge_feature[b, i, k] = last-layer message for edge (i -> k-th local of
  i, ascending proposal index) plus a 6-bin orientation + distance head,
  whose messages are computed for those (i, local) pairs only (the JAX
  module computes all pairs and keeps these).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.nn import functional as F

from d3net_tpu_torch.utils.bbox import aabb_iou_corners

_BIG = 1e30


def box_centers(corners: torch.Tensor) -> torch.Tensor:
    """(…, 8, 3) corners -> (…, 3) centers."""
    return (corners.amin(-2) + corners.amax(-2)) * 0.5


def target_locals(target_corners, target_ids, corners, centers, object_masks,
                  num_locals: int, include_self: bool,
                  overlay_threshold: float = 0.5) -> torch.Tensor:
    """Local-context masks of T targets per scene.

    target_corners (B, T, 8, 3) are the corners of proposals ``target_ids``
    (B, T) among corners (B, P, 8, 3) / centers (B, P, 3) / object_masks
    (B, P) -> (B, T, P) 0/1 masks, as ``query_locals`` for each target.
    """
    p = object_masks.shape[1]
    diff = target_corners[:, :, :, None, :] - centers[:, None, None, :, :]
    sq = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    # min over the 8 target corners of the distance to each proposal center
    dist = torch.sqrt(sq + 1e-8).amin(2)                       # (B, T, P)
    dist = torch.where(object_masks[:, None, :] > 0, dist, _BIG)
    iou = aabb_iou_corners(target_corners[:, :, None], corners[:, None, :])
    dist = torch.where(iou >= overlay_threshold, _BIG, dist)
    is_self = target_ids[..., None] == torch.arange(p, device=dist.device)
    dist = torch.where(is_self, 0.0 if include_self else _BIG, dist)
    # lax.top_k(-dist, k): the k smallest, ties to the lower index
    pick = torch.sort(dist, dim=-1, stable=True).indices[..., :num_locals]
    # drop picks that were at infinite distance (fewer than k valid locals)
    near = (torch.gather(dist, -1, pick) < _BIG / 2).to(dist.dtype)
    return torch.zeros_like(dist).scatter_(-1, pick, near)


def query_locals(corners, centers, target_ids, object_masks, num_locals: int,
                 include_self: bool = True, overlay_threshold: float = 0.5):
    """Per-target local-context mask: corners (B,P,8,3), centers (B,P,3),
    target_ids (B,) -> (B,P) 0/1 mask."""
    idx = target_ids.long()
    tc = corners[torch.arange(corners.shape[0], device=corners.device), idx]
    return target_locals(tc[:, None], idx[:, None], corners, centers,
                         object_masks, num_locals, include_self,
                         overlay_threshold)[:, 0]


def adjacency_matrix(corners, centers, object_masks, num_locals: int,
                     overlay_threshold: float = 0.5):
    """(B, P, P) adjacency: row i = locals of proposal i (self excluded)."""
    b, p = object_masks.shape
    ids = torch.arange(p, device=corners.device).expand(b, p)
    rows = target_locals(corners, ids, corners, centers, object_masks,
                         num_locals, False, overlay_threshold)
    valid = object_masks[:, :, None] * object_masks[:, None, :]
    return rows * valid


class EdgeMLP(nn.Module):
    """Message MLP([x_tgt, x_src - x_tgt]) (Flax names ``Dense_0/1``)."""

    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.Dense_0 = nn.Linear(2 * in_size, out_size)
        self.Dense_1 = nn.Linear(out_size, out_size)

    def forward(self, tgt, src):
        tgt, src = torch.broadcast_tensors(tgt, src)
        e = torch.cat([tgt, src - tgt], dim=-1)
        return self.Dense_1(F.relu(self.Dense_0(e)))


class GraphModule(nn.Module):
    """``in_size`` is the proposal feature width (the detector's pooled
    ScoreNet features); the JAX module infers it."""

    def __init__(self, in_size: int, out_size: int = 128, num_layers: int = 2,
                 num_locals: int = 10, num_bins: int = 6,
                 return_orientation: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.num_locals = num_locals
        self.num_bins = num_bins
        self.return_orientation = return_orientation
        self.map_input = nn.Linear(in_size, out_size)
        for li in range(num_layers):
            setattr(self, f"gc_{li}", EdgeMLP(out_size, out_size))
        if return_orientation:
            self.edge_layer = EdgeMLP(out_size, out_size)
            self.edge_predict = nn.Linear(out_size, num_bins + 1)

    def forward(self, data: Dict) -> Dict:
        obj_feats = data["proposal_feats_batched"]       # (B, P, in)
        masks = data["proposal_batch_mask"]              # (B, P)
        corners = data["proposal_bbox_batched"]          # (B, P, 8, 3)
        b, p, _ = obj_feats.shape

        x = self.map_input(obj_feats)
        with torch.no_grad():
            adj = adjacency_matrix(corners, box_centers(corners), masks,
                                   self.num_locals)      # (B, P, P)

        h, msg = x, None
        for li in range(self.num_layers):
            # messages[b, s, t] for src s, tgt t
            msg = getattr(self, f"gc_{li}")(h[:, None, :, :], h[:, :, None, :])
            h = torch.einsum("bst,bstc->btc", adj, msg)
        new_feats = (x + h) * masks[..., None]

        # k-th local of i by ascending proposal index (PyG coo col order)
        idx = torch.arange(p, device=adj.device).expand(b, p, p)
        order_key = torch.where(adj > 0, idx, p)
        local_ids = torch.sort(order_key, dim=-1).values[..., :self.num_locals]
        local_mask = (local_ids < p).to(obj_feats.dtype)
        local_ids = local_ids.clamp(max=p - 1)

        out = dict(data)
        out["bbox_feature"] = new_feats
        out["adjacent_mat"] = adj
        out["local_ids"] = local_ids
        out["local_mask"] = local_mask
        # last-layer messages gathered per (i, k-th local)
        c = msg.shape[-1]
        gather_msg = torch.gather(
            msg, 2, local_ids[..., None].expand(-1, -1, -1, c))  # (B, P, L, C)
        out["edge_feature"] = gather_msg * local_mask[..., None]

        if self.return_orientation:
            # the orientation layer's messages of the pairs it keeps:
            # src i, tgt its k-th local
            tgt = torch.gather(
                new_feats[:, None].expand(-1, p, -1, -1), 2,
                local_ids[..., None].expand(-1, -1, -1, c))
            msg_o = self.edge_layer(tgt, new_feats[:, :, None, :])
            edge_pred = self.edge_predict(msg_o)         # (B, P, L, 7)
            out["edge_orientations"] = edge_pred[..., :self.num_bins]
            out["edge_distances"] = edge_pred[..., self.num_bins]
        return out
