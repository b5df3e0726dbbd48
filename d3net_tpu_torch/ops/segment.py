"""Fixed-shape segment reductions and the padded row gather.

Counterpart of ``d3net_tpu/ops/segment.py``. All reductions take a
``num_segments`` and an optional validity mask; masked elements are routed
to a trash segment (index ``num_segments``) that is sliced off, so shapes
stay static. Sums use ``index_add_``, min/max use
``scatter_reduce(include_self=False)``; empty segments read ``fill``
(±1e30), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from d3net_tpu_torch.kernels import gather

_BIG = 1e30


def _route(seg_ids: torch.Tensor, mask: Optional[torch.Tensor],
           num_segments: int) -> torch.Tensor:
    if mask is None:
        return seg_ids
    return torch.where(mask, seg_ids, torch.full_like(seg_ids, num_segments))


def segment_sum(data, seg_ids, num_segments: int, mask=None):
    ids = _route(seg_ids, mask, num_segments).long()
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, ids, data)
    return out[:num_segments]


def segment_count(seg_ids, num_segments: int, mask=None,
                  dtype=torch.float32):
    ones = torch.ones(seg_ids.shape, dtype=dtype, device=seg_ids.device)
    return segment_sum(ones, seg_ids, num_segments, mask)


def segment_mean(data, seg_ids, num_segments: int, mask=None,
                 eps: float = 1e-8):
    s = segment_sum(data, seg_ids, num_segments, mask)
    n = segment_count(seg_ids, num_segments, mask, dtype=s.dtype)
    return s / torch.clamp(n, min=eps).reshape((-1,) + (1,) * (s.dim() - 1))


def _segment_extreme(data, seg_ids, num_segments, mask, reduce, init):
    ids = _route(seg_ids, mask, num_segments).long()
    ids = ids.reshape(ids.shape + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), init)
    out = out.scatter_reduce(0, ids, data, reduce=reduce, include_self=False)
    return out[:num_segments]


def segment_max(data, seg_ids, num_segments: int, mask=None, fill=-_BIG):
    out = _segment_extreme(data, seg_ids, num_segments, mask, "amax",
                           float("-inf"))
    keep = torch.isfinite(out) & (out > -_BIG / 2)
    return torch.where(keep, out, torch.full_like(out, fill))


def segment_min(data, seg_ids, num_segments: int, mask=None, fill=_BIG):
    out = _segment_extreme(data, seg_ids, num_segments, mask, "amin",
                           float("inf"))
    keep = torch.isfinite(out) & (out < _BIG / 2)
    return torch.where(keep, out, torch.full_like(out, fill))


def segment_batched(reduce, data, seg_ids, num_segments: int, mask=None):
    """``vmap(reduce)`` over a leading scene axis, run as ONE reduction.

    ``data (B, N, ...)``, ``seg_ids (B, N)``. Each scene's ids move into
    its own block of ``num_segments + 1`` segments (the last is its trash
    segment), so per-segment accumulation order is the per-scene order.
    Returns ``(B, num_segments, ...)``.
    """
    b = seg_ids.shape[0]
    ids = _route(seg_ids, mask, num_segments)
    offs = torch.arange(b, dtype=ids.dtype, device=ids.device)
    flat = (ids + offs[:, None] * (num_segments + 1)).reshape(-1)
    out = reduce(data.reshape((-1,) + tuple(data.shape[2:])), flat,
                 b * (num_segments + 1))
    return out.reshape((b, num_segments + 1) + tuple(out.shape[1:]))[
        :, :num_segments]


def segment_count_batched(seg_ids, num_segments: int, mask=None):
    ones = torch.ones(seg_ids.shape, dtype=torch.float32, device=seg_ids.device)
    return segment_batched(segment_sum, ones, seg_ids, num_segments, mask)


def gather_padded(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``feats (M, C)`` at ``idx (N,)``; ``idx == M`` (the INVALID
    sentinel of the host kernel maps) reads a zero row. Through the
    ``gather_rows`` kernel."""
    return gather.gather_rows(feats.contiguous(), idx.to(torch.int32).contiguous())


def fold_index(idx: torch.Tensor, m: int) -> torch.Tensor:
    """Per-scene row indices ``(B, ...)`` into ``m``-row tables -> indices
    into the ``(B*m, ...)`` flattened rows; INVALID (``>= m``) becomes the
    one global sentinel ``B*m``. One gather then serves the whole batch."""
    b = idx.shape[0]
    scene = torch.arange(b, dtype=torch.int32, device=idx.device)
    scene = scene.reshape((b,) + (1,) * (idx.dim() - 1))
    flat = torch.where(idx >= m, torch.full_like(idx, b * m), idx + scene * m)
    return flat.to(torch.int32)


def gather_padded_batched(feats: torch.Tensor, idx: torch.Tensor):
    """``vmap(gather_padded)`` with the batch folded into one launch:
    ``feats (B, M, C)``, ``idx (B, N)`` -> ``(B, N, C)``."""
    b, m, c = feats.shape
    flat = gather_padded(feats.reshape(b * m, c), fold_index(idx, m).reshape(-1))
    return flat.reshape(b, idx.shape[1], c)
