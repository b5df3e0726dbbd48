"""On-device instance clustering (PointGroup grouping).

Counterpart of ``d3net_tpu/ops/cluster.py``, in plain PyTorch ops:

1. Sort points by (scene/label key, Morton code of the quantized cell), on
   two decorrelated Morton curves.
2. Banded edges between ranks i and i-s for a static ladder of shifts s,
   each gated by the true squared distance and label equality.
3. Min-label propagation over both curves' bands with two pointer jumps
   per round; the root of a component is its least point index.

Bit-exactness with the JAX package rests on two orderings. The two-key
sort is one stable sort of the int64 key ``khi << 30 | klo`` (ties keep
index order, which is what XLA's CPU sort gives). ``top_k`` prefers the
lower index on ties, so the top-K is a stable descending sort.
"""

from __future__ import annotations

import math

import torch

_GRID = 1024
_SHIFTS = tuple(range(1, 17)) + (24, 32, 48, 64, 96, 128, 192, 256)
_CURVE2_OFFSET = (341, 682, 170)
_SHIFTS2 = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def _morton10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10-bit int32 lanes to every 3rd bit (Morton interleave part)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_code(cell: torch.Tensor) -> torch.Tensor:
    """(M, 3) int32 cell coords in [0, 1024) -> (M,) int32 Morton code."""
    return (_morton10(cell[:, 0]) | (_morton10(cell[:, 1]) << 1)
            | (_morton10(cell[:, 2]) << 2))


def _morton_code_curve2(cell: torch.Tensor) -> torch.Tensor:
    """Axis-permuted (z,x,y) Morton code of translated cell coords."""
    off = torch.tensor(_CURVE2_OFFSET, dtype=torch.int32, device=cell.device)
    c = (cell + off[None, :]) & (_GRID - 1)
    return (_morton10(c[:, 2]) | (_morton10(c[:, 0]) << 1)
            | (_morton10(c[:, 1]) << 2))


def grid_cluster_batched(coords, sem_labels, valid, *, cell_size: float = 0.015,
                         num_iters: int = 8, radius: float = 0.03):
    """Connected components of the same-label radius graph, all scenes in
    one flat index domain.

    coords (B, M, 3) float; sem_labels (B, M) int (values up to 63, so a
    pass bit can be folded in); valid (B, M) bool. Returns per-scene root
    ids (B, M) int32: the least point index of the component, -1 invalid.
    """
    b, m, _ = coords.shape
    dev = coords.device
    scene = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(m)
    inf = torch.full_like(coords, float("inf"))
    origin = torch.where(valid[..., None], coords, inf).amin(dim=1, keepdim=True)
    origin = torch.where(torch.isfinite(origin), origin,
                         torch.zeros_like(origin))
    cell = torch.floor((coords - origin) / cell_size).to(torch.int32)
    cell = cell.clamp(0, _GRID - 1).reshape(b * m, 3)
    coords = coords.reshape(b * m, 3)
    valid = valid.reshape(b * m)
    sem = sem_labels.to(torch.int32).reshape(b * m).clamp(0, 63)
    # scene folded above the label: equal keys => same scene & same label
    khi = scene * 128 + torch.where(valid, sem, torch.full_like(sem, 127))
    idx = torch.arange(b * m, dtype=torch.int32, device=dev)
    root = _grid_cluster_flat(coords, cell, khi, valid, idx,
                              num_iters=num_iters, radius=radius,
                              cell_size=cell_size)
    out = torch.where(root >= 0, root - scene * m, torch.full_like(root, -1))
    return out.reshape(b, m)


def _grid_cluster_flat(coords, cell, khi, valid, idx, *, num_iters, radius,
                       cell_size):
    m = coords.shape[0]
    dev = coords.device
    gate2 = (radius + cell_size * math.sqrt(3.0)) ** 2
    ranks = torch.arange(m, device=dev)

    def curve_data(klo, curve_shifts):
        """Per-curve sort permutation + static banded edge masks."""
        key = (khi.to(torch.int64) << 30) | klo.to(torch.int64)
        perm = torch.sort(key, stable=True).indices
        sem_s = khi[perm]
        valid_s = valid[perm]
        cx, cy, cz = (coords[:, a][perm] for a in range(3))
        oks = []
        for s in curve_shifts:
            dx = cx - torch.roll(cx, s)
            dy = cy - torch.roll(cy, s)
            dz = cz - torch.roll(cz, s)
            d2 = dx * dx + dy * dy + dz * dz
            ok = ((sem_s == torch.roll(sem_s, s)) & valid_s
                  & torch.roll(valid_s, s) & (d2 <= gate2))
            # roll wraps: kill the first s entries (pair with the tail)
            oks.append(ok & (ranks >= s))
        return perm, curve_shifts, oks

    curves = [curve_data(morton_code(cell), _SHIFTS),
              curve_data(_morton_code_curve2(cell), _SHIFTS2)]
    big = torch.full((m,), m, dtype=torch.int32, device=dev)

    lbl = idx.clone()
    for _ in range(num_iters):
        for perm, curve_shifts, oks in curves:
            ls = lbl[perm]                   # point-space -> rank-space
            new = ls
            for s, ok in zip(curve_shifts, oks):
                back = torch.roll(ls, s)     # ls[i-s] at position i
                new = torch.minimum(new, torch.where(ok, back, big))
                fwd = torch.roll(ls, -s)     # ls[i+s] at position i
                ok_f = torch.roll(ok, -s)    # edge (i+s, i) seen from i
                new = torch.minimum(new, torch.where(ok_f, fwd, big))
            lbl = torch.empty_like(lbl)
            lbl[perm] = new
        # pointer jumping (point-space (M,)-sized pointer chases)
        lbl = lbl[lbl.long()]
        lbl = lbl[lbl.long()]
    return torch.where(valid, lbl, torch.full_like(lbl, -1))


def topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: on ties the lower index first."""
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k].to(torch.int32)


def compact_clusters(root, weights, valid, *, max_clusters: int,
                     min_points: float):
    """Top-K clusters by point count and dense membership.

    root (..., M) int32 component root (-1 none); weights (..., M) float
    points per voxel; valid (..., M) bool. Leading axes are independent
    problems. Returns member (..., M) int32 slot in [0, K) or -1,
    cluster_mask (..., K) bool and cluster_npoint (..., K) float.
    """
    lead = root.shape[:-1]
    m = root.shape[-1]
    root = root.reshape(-1, m)
    weights = weights.reshape(-1, m)
    valid = valid.reshape(-1, m)
    r = root.shape[0]
    ok = valid & (root >= 0)
    safe_root = torch.where(ok, root, torch.zeros_like(root)).long()
    npoint = torch.zeros_like(weights).scatter_add_(
        1, safe_root, torch.where(ok, weights, torch.zeros_like(weights)))
    ar = torch.arange(m, dtype=root.dtype, device=root.device)
    is_root = ok & (root == ar)
    size_of_root = torch.where(is_root & (npoint >= min_points), npoint,
                               torch.full_like(npoint, -1.0))
    top_size, top_idx = topk_stable(size_of_root, max_clusters)
    cluster_mask = top_size > 0
    # inverse map root index -> slot (column m collects the empty slots)
    slots = torch.arange(max_clusters, dtype=torch.int32, device=root.device)
    inv = torch.full((r, m + 1), -1, dtype=torch.int32, device=root.device)
    target = torch.where(cluster_mask, top_idx, torch.full_like(top_idx, m))
    inv.scatter_(1, target.long(), slots.expand(r, -1).contiguous())
    member = torch.where(ok, inv.gather(1, safe_root),
                         torch.full_like(root, -1))
    cluster_npoint = torch.where(cluster_mask, top_size,
                                 torch.zeros_like(top_size))
    return (member.reshape(lead + (m,)),
            cluster_mask.reshape(lead + (max_clusters,)),
            cluster_npoint.reshape(lead + (max_clusters,)))
