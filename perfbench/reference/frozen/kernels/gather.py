"""Row gather ``src[idx]`` with a zero pad row, plain PyTorch only.

The program's ``kernels/gather.py`` launches a CUDA kernel for a CUDA
tensor; the reference keeps its plain version on every device, with the
same gradient (the output rows scatter-added into zeros, sentinel and
out-of-range rows dropped).
"""

from __future__ import annotations

import torch


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cat([src, zeros(1, C)])[idx]``, with every index outside
    ``[0, n_src)`` sent to the zero row."""
    n_src = src.shape[0]
    padded = torch.cat([src, src.new_zeros(1, src.shape[1])])
    idx = idx.long()
    return padded[torch.where((idx >= 0) & (idx < n_src), idx, n_src)]


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r] = src[idx[r]]`` for ``0 <= idx[r] < n_src``, else a zero
    row. (n,) -> (n, C). Differentiable in ``src``."""
    if src.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(src, idx)
    return gather_rows_plain(src, idx)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n_src = src.shape[0]
        return gather_rows_plain(src, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n_src = ctx.n_src
        keep = torch.where((idx >= 0) & (idx < n_src), idx, n_src).long()
        out = g.new_zeros((n_src + 1, g.shape[1]))
        out.index_add_(0, keep, g.contiguous())
        return out[:n_src], None
