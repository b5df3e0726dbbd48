"""PointGroup instance-segmentation detector.

Counterpart of ``d3net_tpu/models/pointgroup.py``: voxel scatter-mean,
7-level sparse U-Net, semantic + offset heads, dual-pass (original /
offset-shifted) on-device clustering, per-cluster
stats and dense 14^3 grids, dense ScoreNet, and score-ranked selection of
``max_num_proposal`` proposals. Submodule names follow the Flax setup
names so the converted ``state_dict`` keys line up (``params.py``).

Batch layout is JAX's: ``point_* (B, N, ·)``, ``p2v (B, N)`` with
INVALID = M0 cap, ``tables`` a list of per-level dicts. The JAX package
vmaps per scene; here every per-scene reduction runs once over the batch
folded into one segment domain (``segment_batched``) and every row gather
is one ``gather_rows`` launch over the flattened rows.

``compute_dtype="bfloat16"`` casts like JAX: the backbone and ScoreNet
run in bf16; heads, BN statistics, geometry and the grid scatter-mean
(accumulated in f32) stay f32.

``train=True`` uses batch statistics in every BN (and updates the running
ones), jitters each cluster's grid placement (``jitter_u``) and shuffles
the top-K proposal slots (``proposal_perm``); both come from an explicit
``torch.Generator`` or are passed in as tensors. Clustering is not
differentiable: its coordinates and weights are detached, as the JAX
module wraps them in ``stop_gradient``.

``pred_bbox=True`` adds the VoteNet-style box head on every cluster slot
(``bbox_fc1/bn1/fc2/bn2/bbox_out``; ``pred_center``, heading and size
scores and residuals, ``sem_cls_scores``), supervised by ``bbox_loss``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.frozen.models.blocks import (
    MaskedBatchNorm, SubmConv, UBlock, fold_tables,
)
from perfbench.reference.frozen.models.scorenet import ScoreNet
from perfbench.reference.frozen.ops import segment as seg
from perfbench.reference.frozen.ops.cluster import (
    compact_clusters, grid_cluster_batched, topk_stable,
)
from perfbench.reference.frozen.parallel import mesh
from perfbench.reference.frozen.utils.bbox import box_corners
from perfbench.reference.frozen.utils.nn_distance import nn_distance


def voxelize_feats(point_feats, p2v, num_voxels_cap: int, point_mask):
    """Scatter-mean (B, N, C) point feats into (B, M, C) voxels."""
    return seg.segment_batched(seg.segment_mean, point_feats, p2v,
                               num_voxels_cap, point_mask)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, idx, axis=1)`` with idx (B, K) broadcast."""
    idx = idx.long().reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.take_along_dim(a, idx, dim=1)


class PointGroup(nn.Module):
    """Detector. Arguments mirror the JAX module's fields (conf names)."""

    def __init__(
        self,
        in_channels: int,
        m: int = 16,
        classes: int = 20,
        blocks: Sequence[int] = (1, 2, 3, 4, 5, 6, 7),
        cluster_blocks: Sequence[int] = (1, 2),
        block_reps: int = 2,
        block_residual: bool = True,
        use_coords: bool = True,
        max_num_proposal: int = 128,
        cluster_radius: float = 0.03,
        cluster_cell_size: float = 0.015,
        cluster_ring: int = 2,   # accepted for config parity; band design
        cluster_npoint_thre: int = 50,
        cluster_prop_iters: int = 8,
        clusters_per_pass: int = 128,
        score_fullscale: int = 14,
        score_scale: float = 50.0,
        test_score_thresh: float = 0.09,
        test_npoint_thresh: int = 100,
        requires_gt_mask: bool = False,
        compute_dtype: Optional[str] = None,
        pred_bbox: bool = False,
        num_heading_bin: int = 1,
        num_size_cluster: int = 18,
        num_bbox_class: int = 18,
    ):
        super().__init__()
        del cluster_ring
        self.m = m
        self.classes = classes
        self.use_coords = use_coords
        self.max_num_proposal = max_num_proposal
        self.cluster_radius = cluster_radius
        self.cluster_cell_size = cluster_cell_size
        self.cluster_npoint_thre = cluster_npoint_thre
        self.cluster_prop_iters = cluster_prop_iters
        self.clusters_per_pass = clusters_per_pass
        self.score_fullscale = score_fullscale
        self.score_scale = score_scale
        self.test_score_thresh = test_score_thresh
        self.test_npoint_thresh = test_npoint_thresh
        self.requires_gt_mask = requires_gt_mask
        self.compute_dtype = compute_dtype

        planes = tuple(m * c for c in blocks)
        self.input_conv = SubmConv(in_channels, m)
        self.unet = UBlock(planes, block_reps, block_residual)
        self.out_bn = MaskedBatchNorm(m)
        self.sem_seg = nn.Linear(m, classes)
        self.offset_fc1 = nn.Linear(m, m)
        self.offset_bn = MaskedBatchNorm(m)
        self.offset_fc2 = nn.Linear(m, 3)
        self.score_net = ScoreNet(m, tuple(m * c for c in cluster_blocks),
                                  block_reps)
        self.pred_bbox = pred_bbox
        self.num_heading_bin = num_heading_bin
        self.num_size_cluster = num_size_cluster
        if pred_bbox:
            # VoteNet-parameterised box regression on the pooled cluster
            # features: center residual, heading bins and residuals, size
            # clusters and residuals, box class
            pooled = m * cluster_blocks[0]
            self.bbox_fc1 = nn.Linear(pooled, m, bias=False)
            self.bbox_bn1 = MaskedBatchNorm(m)
            self.bbox_fc2 = nn.Linear(m, m, bias=False)
            self.bbox_bn2 = MaskedBatchNorm(m)
            self.bbox_out = nn.Linear(m, 3 + num_heading_bin * 2
                                      + num_size_cluster * 4 + num_bbox_class)

    # ------------------------------------------------------------------
    def backbone(self, voxel_feats, tables, train: bool):
        h = self.input_conv(voxel_feats, tables[0]["nbr"])
        h = self.unet(h, tables, train)
        h = self.out_bn(h, tables[0]["mask"], train)
        return F.relu(h)

    def heads(self, vfeats, vmask, train: bool):
        x = vfeats.float()   # Flax Dense promotes bf16 feats to its f32 params
        sem_scores = self.sem_seg(x)
        h = F.relu(self.offset_bn(self.offset_fc1(x), vmask, train))
        return sem_scores, self.offset_fc2(h)

    def _proposal_valid(self, cluster_mask, objness, npoint):
        """The slots that may be selected: kept clusters over both test
        thresholds. (The port computes this inline; it is a method here
        so that the benchmark's reference can follow the program's
        decision.)"""
        return (cluster_mask & (objness > self.test_score_thresh)
                & (npoint > self.test_npoint_thresh))

    # ------------------------------------------------------------------
    def _cluster_batch(self, vxyz2, vsem, vvalid, vweight):
        """Both passes of all scenes in one clustering call (pass bit in the
        label key). vxyz2 (B, 2, M, 3) -> member (B, 2, M) slots in
        [0, 2*clusters_per_pass) or -1, slot mask and counts (B, 2P)."""
        b, _, m, _ = vxyz2.shape
        cpp = self.clusters_per_pass
        root2 = grid_cluster_batched(
            torch.cat([vxyz2[:, 0], vxyz2[:, 1]], dim=1),
            torch.cat([vsem, vsem + 32], dim=1),
            torch.cat([vvalid, vvalid], dim=1),
            cell_size=self.cluster_cell_size,
            num_iters=self.cluster_prop_iters,
            radius=self.cluster_radius,
        )
        # components never span halves (pass bit) -> split + rebase
        second = root2[:, m:]
        roots = torch.stack(
            [root2[:, :m],
             torch.where(second >= 0, second - m, torch.full_like(second, -1))],
            dim=1)
        member, cmask, npts = compact_clusters(
            roots,
            vweight[:, None].expand(b, 2, m),
            vvalid[:, None].expand(b, 2, m),
            max_clusters=cpp,
            min_points=float(self.cluster_npoint_thre),
        )
        member = torch.stack(
            [member[:, 0],
             torch.where(member[:, 1] >= 0, member[:, 1] + cpp,
                         torch.full_like(member[:, 1], -1))],
            dim=1)
        return member, cmask.reshape(b, 2 * cpp), npts.reshape(b, 2 * cpp)

    def _member_ids(self, member_pt, point_mask):
        """(B, 2N) slot ids with non-members routed to trash slot P."""
        b = member_pt.shape[0]
        p_total = 2 * self.clusters_per_pass
        flat_m = member_pt.reshape(b, -1)
        ok = (flat_m >= 0) & torch.cat([point_mask, point_mask], dim=1)
        return torch.where(ok, flat_m, torch.full_like(flat_m, p_total)), ok

    def _cluster_stats(self, member_pt, point_xyz, point_mask):
        """Per-cluster mean/min/max/center/size over true member points."""
        p_total = 2 * self.clusters_per_pass
        ids, ok = self._member_ids(member_pt, point_mask)
        means, mns, mxs = [], [], []
        for a in range(3):
            c = torch.cat([point_xyz[..., a], point_xyz[..., a]], dim=1)
            means.append(seg.segment_batched(seg.segment_mean, c, ids, p_total))
            mns.append(seg.segment_batched(seg.segment_min, c, ids, p_total))
            mxs.append(seg.segment_batched(seg.segment_max, c, ids, p_total))
        mean = torch.stack(means, -1)
        mn = torch.stack(mns, -1)
        mx = torch.stack(mxs, -1)
        npoint = seg.segment_count_batched(ids, p_total, ok)
        center = (mn + mx) * 0.5
        size = torch.clamp(mx - mn, min=0.0)
        return dict(mean=mean, min=mn, max=mx, center=center, size=size,
                    npoint=npoint)

    def _build_grids(self, member_pt, point_xyz, point_feats, point_mask,
                     stats, jitter_u):
        """Scatter member points into per-cluster dense G^3 grids (mean)."""
        g = self.score_fullscale
        b = member_pt.shape[0]
        p_total = 2 * self.clusters_per_pass
        cid, ok = self._member_ids(member_pt, point_mask)

        size = stats["size"]
        scale = 1.0 / torch.clamp(size.amax(-1) / g, min=1e-6) - 0.01
        scale = torch.clamp(scale, max=self.score_scale)            # (B, P)
        rng_span = torch.clamp(g - size * scale[..., None] - 0.001, min=0.0)
        offset = -(stats["min"] - stats["mean"]) * scale[..., None] \
            + rng_span * jitter_u

        cid_c = cid.clamp(0, p_total - 1).long()
        sc = scale.gather(1, cid_c)
        cells = []
        for a in range(3):
            xyz_a = torch.cat([point_xyz[..., a], point_xyz[..., a]], dim=1)
            rel_a = (xyz_a - stats["mean"][..., a].gather(1, cid_c)) * sc \
                + offset[..., a].gather(1, cid_c)
            cells.append(torch.floor(rel_a).to(torch.int32).clamp(0, g - 1))
        lin = ((cid * g + cells[0]) * g + cells[1]) * g + cells[2]
        n_cells = p_total * g * g * g
        lin = torch.where(ok, lin, torch.full_like(lin, n_cells))

        # mean-accumulate in f32 even under a bf16 compute dtype
        feats2 = torch.cat([point_feats, point_feats], dim=1).float()
        grid_feats = seg.segment_batched(seg.segment_mean, feats2, lin,
                                         n_cells, ok)
        grid_feats = grid_feats.to(point_feats.dtype)
        occ = seg.segment_count_batched(lin, n_cells, ok) > 0
        c = point_feats.shape[-1]
        return (grid_feats.reshape(b, p_total, g, g, g, c),
                occ.reshape(b, p_total, g, g, g).to(point_feats.dtype))

    def _proposal_sem(self, member_pt, sem_pred_pt, point_mask):
        """Majority semantic class per cluster slot (first class on ties)."""
        b = member_pt.shape[0]
        p_total = 2 * self.clusters_per_pass
        ids, ok = self._member_ids(member_pt, point_mask)
        cls = torch.cat([sem_pred_pt, sem_pred_pt], dim=1)
        votes = seg.segment_count_batched(ids * self.classes + cls,
                                          p_total * self.classes, ok)
        return votes.reshape(b, p_total, self.classes).argmax(-1).to(torch.int32)

    def _bbox_head(self, pooled, cluster_mask, center, train: bool):
        """Box regression on every cluster slot (B, P), decoded."""
        h = F.relu(self.bbox_bn1(self.bbox_fc1(pooled.float()), cluster_mask,
                                 train))
        h = F.relu(self.bbox_bn2(self.bbox_fc2(h), cluster_mask, train))
        enc = self.bbox_out(h)                               # (B, P, D)
        nh, ns = self.num_heading_bin, self.num_size_cluster
        hr = enc[..., 3 + nh:3 + 2 * nh]
        return {
            "pred_center": center + enc[..., :3],
            "heading_scores": enc[..., 3:3 + nh],
            "heading_residuals_normalized": hr,
            "heading_residuals": hr * (math.pi / nh),
            "size_scores": enc[..., 3 + 2 * nh:3 + 2 * nh + ns],
            "size_residuals_normalized": enc[
                ..., 3 + 2 * nh + ns:3 + 2 * nh + 4 * ns].reshape(
                    enc.shape[:-1] + (ns, 3)),
            "sem_cls_scores": enc[..., 3 + 2 * nh + 4 * ns:],
        }

    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, Any], train: bool = False,
                do_clustering: bool = True, *,
                generator: Optional[torch.Generator] = None,
                jitter_u: Optional[torch.Tensor] = None,
                proposal_perm: Optional[torch.Tensor] = None,
                ) -> Dict[str, Any]:
        """``do_clustering=False`` returns after the heads (the run loop's
        pre-clustering epochs). Under ``train``, ``jitter_u (B, P, 3)`` in
        [0, 1) and ``proposal_perm (B, K)`` are drawn from ``generator``
        unless given; at eval the jitter is 0.5 and there is no shuffle.
        Under a process group (``parallel.mesh``) they are drawn, or given,
        at the global batch's rows, and this rank takes its own."""
        point_xyz = batch["point_xyz"]          # (B, N, 3)
        point_feats = batch["point_feats"]      # (B, N, C)
        point_mask = batch["point_mask"]        # (B, N)
        p2v = batch["p2v"]                      # (B, N), INVALID = M0cap
        b = point_mask.shape[0]
        m0cap = batch["tables"][0]["mask"].shape[1]
        tables = fold_tables(batch["tables"])

        if self.use_coords:
            point_feats = torch.cat([point_feats, point_xyz], dim=-1)

        # --- voxelize + backbone -------------------------------------
        voxel_feats = voxelize_feats(point_feats, p2v, m0cap, point_mask)
        if self.compute_dtype in ("bfloat16", "bf16"):
            voxel_feats = voxel_feats.to(torch.bfloat16)
        vfeats = self.backbone(voxel_feats, tables, train)   # (B, M0, m)
        vmask = batch["tables"][0]["mask"]

        sem_scores_v, offsets_v = self.heads(vfeats, vmask, train)
        out: Dict[str, Any] = {
            "semantic_scores": seg.gather_padded_batched(sem_scores_v, p2v),
            "pt_offsets": seg.gather_padded_batched(offsets_v, p2v),
            "pt_feats": seg.gather_padded_batched(vfeats, p2v),
        }
        if not do_clustering:
            return out
        sem_scores = out["semantic_scores"]
        pt_feats = out["pt_feats"]
        p_total = 2 * self.clusters_per_pass
        dev = point_xyz.device

        if self.requires_gt_mask:
            # GT instances as proposals (modes 4-6): pass 0 carries the GT
            # membership, pass 1 is empty
            inst = batch["instance_ids"]
            gt_member = torch.where(
                point_mask & (inst >= 0) & (inst < p_total), inst,
                torch.full_like(inst, -1)).to(torch.int32)
            member_pt = torch.stack(
                [gt_member, torch.full_like(gt_member, -1)], dim=1)
            counts = seg.segment_count_batched(
                torch.where(gt_member >= 0, gt_member,
                            torch.full_like(gt_member, p_total)),
                p_total, point_mask & (gt_member >= 0))
            cluster_mask = counts >= float(self.cluster_npoint_thre)
        else:
            # --- clustering (voxel level) -----------------------------
            vxyz = voxelize_feats(point_xyz, p2v, m0cap, point_mask)
            vweight = seg.segment_count_batched(p2v, m0cap, point_mask)
            vsem_pred = sem_scores_v.argmax(-1).to(torch.int32)
            vvalid = vmask.bool() & (vsem_pred > 0)
            vshift = vxyz + offsets_v
            # grouping is not differentiable (JAX: stop_gradient)
            member_v, cluster_mask, _ = self._cluster_batch(
                torch.stack([vxyz, vshift], dim=1).detach(), vsem_pred,
                vvalid, vweight.detach())

            # point-level membership: one int32 gather for both passes
            mp = seg.gather_padded_batched(
                member_v.permute(0, 2, 1).contiguous(), p2v)   # (B, N, 2)
            invalid = (p2v >= m0cap)[..., None] | ~point_mask[..., None]
            member_pt = torch.where(invalid, torch.full_like(mp, -1), mp)
            member_pt = member_pt.permute(0, 2, 1).contiguous()  # (B, 2, N)
        out["member_pt"] = member_pt
        out["cluster_mask_all"] = cluster_mask              # (B, P)

        stats = self._cluster_stats(member_pt, point_xyz, point_mask)
        out["cluster_npoint"] = stats["npoint"]
        out["cluster_center"] = stats["center"]
        out["cluster_size"] = stats["size"]

        # --- scorenet --------------------------------------------------
        if not train:
            jitter_u = torch.full((b, p_total, 3), 0.5, device=dev)
        elif jitter_u is None:
            jitter_u = mesh.draw_rows(lambda n: torch.rand(
                (n, p_total, 3), generator=generator, device=dev), b)
        else:
            jitter_u = mesh.local_rows(jitter_u, b)
        grids, occ = self._build_grids(member_pt, point_xyz, pt_feats,
                                       point_mask, stats, jitter_u)
        g = self.score_fullscale
        scores_flat, pooled_flat = self.score_net(
            grids.reshape(b * p_total, g, g, g, -1),
            occ.reshape(b * p_total, g, g, g), train)
        scores = scores_flat.reshape(b, p_total)
        pooled = pooled_flat.reshape(b, p_total, -1)
        out["proposal_scores_all"] = scores                 # (B, P) logits

        sem_pred_pt = sem_scores.argmax(-1).to(torch.int32)
        cluster_sem = self._proposal_sem(member_pt, sem_pred_pt, point_mask)

        # --- proposal selection to max_num_proposal --------------------
        objness = torch.sigmoid(scores)
        valid = self._proposal_valid(cluster_mask, objness, stats["npoint"])
        rank = torch.where(valid, objness, torch.full_like(objness, -1.0))
        _, top_idx = topk_stable(rank, self.max_num_proposal)  # (B, K)
        if train:
            if proposal_perm is None:
                proposal_perm = mesh.draw_rows(lambda n: torch.stack([
                    torch.randperm(self.max_num_proposal, generator=generator,
                                   device=dev) for _ in range(n)]), b)
            proposal_perm = mesh.local_rows(proposal_perm, b)
            top_idx = torch.take_along_dim(
                top_idx, proposal_perm.long().to(dev).expand(b, -1), dim=1)

        proposal_mask = _take(valid, top_idx)
        fmask = proposal_mask[..., None]
        center = _take(stats["center"], top_idx)
        size = _take(stats["size"], top_idx)
        out["proposal_slot"] = top_idx
        out["proposal_batch_mask"] = proposal_mask.float()
        out["proposal_feats_batched"] = _take(pooled, top_idx).float() * fmask
        out["proposal_center_batched"] = center * fmask
        out["proposal_size_batched"] = size * fmask
        out["proposal_bbox_batched"] = (box_corners(center, size)
                                        * proposal_mask[..., None, None])
        out["proposal_sem_cls_batched"] = torch.where(
            proposal_mask, _take(cluster_sem, top_idx),
            torch.zeros_like(top_idx))
        out["proposal_scores_batched"] = _take(objness, top_idx) * proposal_mask
        if self.pred_bbox:
            out.update(self._bbox_head(pooled, cluster_mask, stats["center"],
                                       train))

        # GT object assignment (training/eval bookkeeping)
        if "center_label" in batch:
            _, ind1, _, _ = nn_distance(
                out["proposal_center_batched"], batch["center_label"],
                l1=True, mask2=batch.get("gt_box_mask"))
            out["object_assignment"] = ind1
        return out
