"""Sparse U-Net building blocks, gather mode (rows path).

Counterpart of ``d3net_tpu/models/blocks.py``: ``MaskedBatchNorm``,
``SubmConv``, ``ResidualBlock``, ``VGGBlock`` and the recursive ``UBlock``.
Submodule names repeat the Flax auto-names (``MaskedBatchNorm_0``,
``SubmConv_1``, ``UBlock_0``) and the explicit ``blk{r}``/``tail{i}``, so
a Flax variable path maps onto a ``state_dict`` key by joining with dots.

Features are ``(B, M_l, C)`` rows per level. Tables come folded by
:func:`fold_tables`: every scene's indices are offset into one flat row
domain with one zero-row sentinel, so each conv is one gather launch.

Every conv is ``sparse_conv_t``: its backward goes through the transpose
table (the table itself, mirrored, for submanifold convs; the sibling
``up``/``down`` table for the stride-2 pair), as the JAX ``SubmConv``
passes it. The JAX ``UBlock`` wraps its blocks in ``nn.remat`` because
TPU activations pad 2-8x in HBM; the port keeps every activation (the
flagship train step fits the card without recomputation, PERF.md).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from d3net_tpu_torch.ops.segment import fold_index
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.ops.sparse_conv import sparse_conv_t

LevelTables = Dict[str, torch.Tensor]


def fold_tables(tables: List[LevelTables]) -> List[LevelTables]:
    """Per-scene level tables -> flat-domain tables.

    In:  ``nbr (B, M_l, 27)``, ``mask (B, M_l)``, ``down (B, M_{l+1}, 8)``
    into level l and ``up (B, M_l, 8)`` into level l+1, INVALID = the
    target level's cap. Out: ``nbr (B*M_l, 27)``, ``down (B*M_{l+1}, 8)``,
    ``up (B*M_l, 8)`` indexing the flattened ``(B*M, C)`` rows, INVALID =
    ``B*M`` of the target level; ``mask`` unchanged.
    """
    out = []
    for li, t in enumerate(tables):
        m = t["mask"].shape[1]
        f = {"mask": t["mask"],
             "nbr": fold_index(t["nbr"], m).reshape(-1, t["nbr"].shape[-1])}
        if "down" in t:
            m_next = tables[li + 1]["mask"].shape[1]
            f["down"] = fold_index(t["down"], m).reshape(-1, 8)
            f["up"] = fold_index(t["up"], m_next).reshape(-1, 8)
        out.append(f)
    return out


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the active entries of a padded tensor.

    Eval normalizes with the running statistics. Train uses the *biased*
    masked batch variance and updates ``running = 0.9*running + 0.1*batch``
    (eps 1e-4, momentum 0.1) — not ``BatchNorm1d``, which keeps the
    unbiased variance. Output is masked to the active entries.

    Under a process group (``parallel.mesh``) the train statistics are the
    global batch's: the count and sums are all-reduced over the ranks.
    """

    def __init__(self, channels: int, eps: float = 1e-4, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, mask, train: bool = False, channel_dim: int = -1):
        cd = channel_dim % x.dim()
        shape = [1] * x.dim()
        shape[cd] = -1
        m = mask.to(x.dtype).unsqueeze(cd)
        if train:
            dims = [d for d in range(x.dim()) if d != cd]
            xf = x.float()
            if mesh.active():
                # the global batch's statistics, as GSPMD reduces JAX's:
                # the exact count and Σx·m in one collective, then
                # Σ(x - mean)²·m; the count is rounded to x's dtype once,
                # as one process rounds its m.sum()
                s = mesh.all_reduce_sum(torch.cat([
                    (xf * m).sum(dims), m.float().sum().reshape(1)]))
                count = torch.clamp(s[-1].to(x.dtype), min=1.0).float()
                mean = s[:-1] / count
            else:
                count = torch.clamp(m.sum(), min=1.0)
                mean = (xf * m).sum(dims) / count
            var = mesh.all_reduce_sum(
                (((xf - mean.reshape(shape)) ** 2) * m).sum(dims)) / count
            with torch.no_grad():
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        out = (x.float() - mean.reshape(shape)) * inv.reshape(shape) \
            + self.bias.reshape(shape)
        return out.to(x.dtype) * m


class SubmConv(nn.Module):
    """Sparse conv over a folded gather table; ``kernel (K, Cin, Cout)``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27):
        super().__init__()
        std = math.sqrt(2.0 / (kernel_volume * in_channels))
        self.kernel = nn.Parameter(
            torch.randn(kernel_volume, in_channels, out_channels) * std)

    def forward(self, feats: torch.Tensor, nbr: torch.Tensor,
                nbr_t=None, flip_t: bool = True) -> torch.Tensor:
        """feats (B, M_in, Cin), nbr (B*M_out, K) -> (B, M_out, Cout).

        ``nbr_t``/``flip_t`` route the backward (``sparse_conv_t``); a
        submanifold table is its own transpose under the mirror, so the
        defaults serve it.
        """
        b, _, cin = feats.shape
        out = sparse_conv_t(feats.reshape(-1, cin), nbr,
                            nbr if nbr_t is None else nbr_t, self.kernel,
                            flip_t)
        return out.reshape(b, -1, out.shape[-1])


class ResidualBlock(nn.Module):
    """(BN-ReLU-conv3)x2 + identity / 1x1 projection (pre-activation)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_channels)
        self.SubmConv_0 = SubmConv(in_channels, out_channels)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels)
        self.SubmConv_1 = SubmConv(out_channels, out_channels)
        if in_channels != out_channels:
            self.SubmConv_2 = SubmConv(in_channels, out_channels, 1)

    def forward(self, x, t: LevelTables, train: bool = False):
        h = F.relu(self.MaskedBatchNorm_0(x, t["mask"], train))
        h = self.SubmConv_0(h, t["nbr"])
        h = F.relu(self.MaskedBatchNorm_1(h, t["mask"], train))
        h = self.SubmConv_1(h, t["nbr"])
        if hasattr(self, "SubmConv_2"):
            # 1x1 projection: gather the centre tap (13) of the 3^3 table
            x = self.SubmConv_2(x, t["nbr"][:, 13:14])
        return h + x


class VGGBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_channels)
        self.SubmConv_0 = SubmConv(in_channels, out_channels)

    def forward(self, x, t: LevelTables, train: bool = False):
        h = F.relu(self.MaskedBatchNorm_0(x, t["mask"], train))
        return self.SubmConv_0(h, t["nbr"])


class UBlock(nn.Module):
    """Recursive sparse U-Net level: ``planes[i]`` channels at level i.

    Down is an 8-tap conv over the ``down`` table, up an 8-tap conv over
    the ``up`` table; the skip concatenates before the tail blocks.
    """

    def __init__(self, planes: Sequence[int], block_reps: int = 2,
                 residual: bool = True):
        super().__init__()
        block = ResidualBlock if residual else VGGBlock
        p0 = planes[0]
        self.block_reps = block_reps
        for r in range(block_reps):
            self.add_module(f"blk{r}", block(p0, p0))
        self.deeper = len(planes) > 1
        if self.deeper:
            p1 = planes[1]
            self.MaskedBatchNorm_0 = MaskedBatchNorm(p0)
            self.SubmConv_0 = SubmConv(p0, p1, 8)
            self.UBlock_0 = UBlock(planes[1:], block_reps, residual)
            self.MaskedBatchNorm_1 = MaskedBatchNorm(p1)
            self.SubmConv_1 = SubmConv(p1, p0, 8)
            for i in range(block_reps):
                self.add_module(f"tail{i}", block(2 * p0 if i == 0 else p0, p0))

    def forward(self, x, tables: List[LevelTables], train: bool = False):
        t0 = tables[0]
        for r in range(self.block_reps):
            x = getattr(self, f"blk{r}")(x, t0, train)
        if self.deeper:
            t1 = tables[1]
            h = F.relu(self.MaskedBatchNorm_0(x, t0["mask"], train))
            h = self.SubmConv_0(h, t0["down"], t0["up"], False)
            h = self.UBlock_0(h, tables[1:], train)
            h = F.relu(self.MaskedBatchNorm_1(h, t1["mask"], train))
            h = self.SubmConv_1(h, t0["up"], t0["down"], False)
            x = torch.cat([x, h], dim=-1)
            for i in range(self.block_reps):
                x = getattr(self, f"tail{i}")(x, t0, train)
        return x
