"""Dense per-cluster ScoreNet.

Counterpart of the dense path of ``d3net_tpu/models/scorenet.py``: a
masked dense 3D U-Net over ``(P, G, G, G, C)`` cluster grids (G = 14),
then a masked max-pool and a linear score. Submanifold semantics are kept
by masking activations to the occupancy after every conv.

The public layout is JAX's channels-last ``(P, G, G, G, C)``; inside, the
grids are NCDHW for ``F.conv3d``/``F.conv_transpose3d``. Flax ``'SAME'``
padding is padding 1 for k=3, 0 for k=1, and 0 for k=2/stride 2 on even
extents (odd extents get one always-empty ghost cell first). Convolutions
are bias-free and run in the activation dtype; BN statistics stay f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from perfbench.reference.frozen.models.blocks import MaskedBatchNorm
from perfbench.reference.precision import q


def _bn(bn: MaskedBatchNorm, x, occ, train: bool):
    """MaskedBatchNorm over an NCDHW grid with occupancy (P, D, H, W)."""
    return bn(x, occ, train, channel_dim=1)


class Conv(nn.Module):
    """Bias-free 3D conv; ``weight`` OIDHW (from Flax DHWIO)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = (kernel - 1) // 2 if stride == 1 else 0
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel, kernel, kernel))
        nn.init.kaiming_normal_(self.weight, nonlinearity="linear")

    def forward(self, x):
        return q(F.conv3d(q(x), q(self.weight.to(x.dtype)),
                          stride=self.stride, padding=self.padding))


class ConvTranspose(nn.Module):
    """Bias-free kernel-2 stride-2 transposed conv; ``weight`` (I, O, D, H, W).

    Flax's ``ConvTranspose`` (``transpose_kernel=False``) applies its kernel
    unflipped over the dilated input, so the torch weight is the Flax
    kernel flipped in all three spatial axes (``params.py`` converts).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 2,
                 stride: int = 2):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels, kernel, kernel, kernel))
        nn.init.kaiming_normal_(self.weight, nonlinearity="linear")

    def forward(self, x):
        return q(F.conv_transpose3d(q(x), q(self.weight.to(x.dtype)),
                                    stride=self.stride))


class DenseResBlock(nn.Module):
    """BN-relu-conv x2 + identity, masked to the occupancy pattern."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.MaskedBatchNorm_0 = MaskedBatchNorm(in_channels)
        self.Conv_0 = Conv(in_channels, out_channels, 3)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(out_channels)
        self.Conv_1 = Conv(out_channels, out_channels, 3)
        if in_channels != out_channels:
            self.Conv_2 = Conv(in_channels, out_channels, 1)

    def forward(self, x, occ, train: bool = False):
        m = occ.unsqueeze(1)
        h = F.relu(_bn(self.MaskedBatchNorm_0, x, occ, train))
        h = self.Conv_0(h) * m
        h = F.relu(_bn(self.MaskedBatchNorm_1, h, occ, train))
        h = self.Conv_1(h) * m
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x) * m
        return h + x


class GridUNet(nn.Module):
    """Recursive dense U-Net over NCDHW cluster grids."""

    def __init__(self, in_channels: int, planes: Sequence[int],
                 block_reps: int = 2):
        super().__init__()
        p0 = planes[0]
        self.block_reps = block_reps
        for i in range(block_reps):
            self.add_module(f"DenseResBlock_{i}",
                            DenseResBlock(in_channels if i == 0 else p0, p0))
        self.deeper = len(planes) > 1
        if self.deeper:
            p1 = planes[1]
            self.MaskedBatchNorm_0 = MaskedBatchNorm(p0)
            self.Conv_0 = Conv(p0, p1, 2, stride=2)
            self.GridUNet_0 = GridUNet(p1, planes[1:], block_reps)
            self.MaskedBatchNorm_1 = MaskedBatchNorm(p1)
            self.ConvTranspose_0 = ConvTranspose(p1, p0)
            for i in range(block_reps):
                self.add_module(f"DenseResBlock_{block_reps + i}",
                                DenseResBlock(2 * p0 if i == 0 else p0, p0))

    def forward(self, x, occ, train: bool = False):
        g = x.shape[2]
        for i in range(self.block_reps):
            x = getattr(self, f"DenseResBlock_{i}")(x, occ, train)
        if self.deeper and g >= 2:
            if g % 2:  # odd extents pad one ghost (always-empty) cell
                xp = F.pad(x, (0, 1, 0, 1, 0, 1))
                occ_p = F.pad(occ, (0, 1, 0, 1, 0, 1))
            else:
                xp, occ_p = x, occ
            occ2 = F.max_pool3d(occ_p.unsqueeze(1), 2, 2)[:, 0]
            h = F.relu(_bn(self.MaskedBatchNorm_0, xp, occ_p, train))
            h = self.Conv_0(h) * occ2.unsqueeze(1)
            h = self.GridUNet_0(h, occ2, train)
            h = F.relu(_bn(self.MaskedBatchNorm_1, h, occ2, train))
            h = self.ConvTranspose_0(h)
            h = h[:, :, :g, :g, :g] * occ.unsqueeze(1)
            x = torch.cat([x, h], dim=1)
            for i in range(self.block_reps):
                x = getattr(self, f"DenseResBlock_{self.block_reps + i}")(
                    x, occ, train)
        return x


class ScoreNet(nn.Module):
    """Cluster grids -> per-cluster scores + max-pooled features."""

    def __init__(self, in_channels: int, planes: Sequence[int],
                 block_reps: int = 2):
        super().__init__()
        self.GridUNet_0 = GridUNet(in_channels, planes, block_reps)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(planes[0])
        self.Dense_0 = nn.Linear(planes[0], 1)

    def forward(self, grids, occ, train: bool = False):
        """grids (P, G, G, G, C); occ (P, G, G, G) in {0,1}.

        Returns (scores (P,) f32, pooled (P, planes[0]) in the grid dtype).
        """
        p = grids.shape[0]
        x = grids.permute(0, 4, 1, 2, 3)
        h = self.GridUNet_0(x, occ, train)
        h = F.relu(_bn(self.MaskedBatchNorm_0, h, occ, train))
        hf = h.reshape(p, h.shape[1], -1)
        m = occ.reshape(p, 1, -1) > 0
        pooled = torch.where(m, hf, torch.full_like(hf, float("-inf"))).amax(-1)
        pooled = torch.where(torch.isfinite(pooled), pooled,
                             torch.zeros_like(pooled))
        scores = self.Dense_0(pooled.float())[:, 0]
        return scores, pooled
