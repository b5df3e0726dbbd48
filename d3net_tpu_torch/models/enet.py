"""ENet 2D encoder (counterpart of ``d3net_tpu/models/enet.py``).

The multiview channel's 128-d features are the encoder's map at 1/8 of
the frame: an initial block, 5 bottlenecks at 1/4 with 64 channels, one
down and 8 (light) or 16 (``full``) mixed bottlenecks at 1/8 with 128.

Layout: the public boundary is JAX's NHWC ((B, H, W, 3) in, (B, H/8, W/8,
128) out); inside, the maps are NCHW for cuDNN's ``conv2d`` and
``max_pool2d``. Modules carry the Flax auto names (``InitialBlock_0``,
``Bottleneck_i``, ``Conv_j``, ``BatchNorm_j``, ``PReLU_j``), so
``params.enet_flax_to_state_dict`` maps a Flax tree by path. Flax details
kept:

- ``"SAME"`` padding is worked out per dimension: the initial block's
  stride-2 3x3 conv pads (0, 1) on an even extent (``ref_pad=True``, the
  full layout's, pads (1, 1)); the stride-1 convs pad symmetrically; the
  2x2 stride-2 convs and the max-pools are ``VALID`` (floor).
- ``BatchNorm`` is Flax's default: momentum 0.99, the fast biased
  variance over N·H·W, here eps 1e-3.
- ``Dropout`` takes its keep mask from a draws object by its path in the
  encoder (``Bottleneck_3.Dropout_0``), in NHWC as JAX draws it; with no
  draws (eval) it is the identity. The draws object is the listener's
  ``ListenerDraws``: keep masks by path, given or drawn from a generator.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from d3net_tpu_torch.models.listener import ListenerDraws
from d3net_tpu_torch.models.match import BatchNorm, PReLU
from d3net_tpu_torch.models.transformer import fast_stats, flax_norm


def _same_pads(size: int, k: int, stride: int, dilation: int
               ) -> Tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding (low, high) of one extent."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """Flax ``nn.Conv`` over NCHW: ``weight`` OIHW (from HWIO), optional
    ``bias``; ``padding`` is ``"SAME"``, ``"VALID"`` or explicit
    ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int], stride: int = 1,
                 dilation: int = 1, padding="SAME", bias: bool = True):
        super().__init__()
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *kernel))
        nn.init.kaiming_normal_(self.weight, nonlinearity="linear")
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def _pads(self, h: int, w: int):
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SAME":
            return (_same_pads(h, self.kernel[0], self.stride, self.dilation),
                    _same_pads(w, self.kernel[1], self.stride, self.dilation))
        return self.padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = self._pads(x.shape[2], x.shape[3])
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (l, r, t, b))
            pad = 0
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=pad, dilation=self.dilation)


class BatchNorm2d(BatchNorm):
    """Flax's ``nn.BatchNorm`` over NCHW: statistics over N·H·W, the fast
    biased variance, momentum 0.99 and (ENet's) eps 1e-3."""

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.99):
        super().__init__(features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if not train:
            return flax_norm(x, self.mean.view(shape), self.var.view(shape),
                             self.scale.view(shape), self.bias.view(shape),
                             self.eps)
        rows = x.transpose(0, 1).reshape(x.shape[1], -1)
        mean, var = fast_stats(rows, 1)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean[:, 0])
            self.var.copy_(m * self.var + (1.0 - m) * var[:, 0])
        return flax_norm(x, mean.view(shape), var.view(shape),
                         self.scale.view(shape), self.bias.view(shape),
                         self.eps)


class PReLU2d(PReLU):
    """``where(x >= 0, x, alpha·x)`` over NCHW, one ``alpha`` a channel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.view(1, -1, 1, 1) * x)


class Dropout2d(nn.Module):
    """Flax's elementwise ``nn.Dropout`` over an NCHW map, its keep mask in
    NHWC by ``path``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.path = ""

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        if draws is None:
            return x
        n, c, h, w = x.shape
        keep = draws.keep(self.path, (n, h, w, c), self.rate,
                          x.device).permute(0, 3, 1, 2)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class InitialBlock(nn.Module):
    """A stride-2 3x3 conv (13 channels) beside a 2x2 max-pool of the
    input (3), then BatchNorm and PReLU: (B, 16, H/2, W/2)."""

    def __init__(self, ref_pad: bool = False):
        super().__init__()
        self.Conv_0 = Conv2d(3, 13, (3, 3), stride=2,
                             padding=((1, 1), (1, 1)) if ref_pad else "SAME")
        self.BatchNorm_0 = BatchNorm2d(16)
        self.PReLU_0 = PReLU2d(16)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = torch.cat([self.Conv_0(x), F.max_pool2d(x, 2, 2)], 1)
        return self.PReLU_0(self.BatchNorm_0(out, train))


class Bottleneck(nn.Module):
    """ENet's bottleneck: 1x1 (or 2x2 stride-2) projection, a regular,
    dilated or asymmetric conv, a 1x1 expansion, dropout, plus the
    (max-pooled, zero-padded) identity; the arguments are the Flax
    module's fields, ``in_channels`` the input's width."""

    def __init__(self, in_channels: int, out_channels: int,
                 downsample: bool = False, dilation: int = 1,
                 asymmetric: bool = False, projection_ratio: int = 4,
                 dropout: float = 0.1, ref_exact: bool = False):
        super().__init__()
        mid = out_channels // projection_ratio
        self.downsample, self.out_channels = downsample, out_channels
        if downsample:
            self.Conv_0 = Conv2d(in_channels, mid, (2, 2), stride=2,
                                 padding="VALID", bias=False)
        else:
            self.Conv_0 = Conv2d(in_channels, mid, (1, 1), padding="VALID",
                                 bias=False)
        if asymmetric and ref_exact:
            kernels, biases = ((1, 5), (5, 1)), (False, True)
        elif asymmetric:
            kernels, biases = ((5, 1), (1, 5)), (False, False)
        else:
            kernels, biases = ((3, 3),), (ref_exact,)
        for j, (k, b) in enumerate(zip(kernels, biases), start=1):
            setattr(self, f"Conv_{j}", Conv2d(mid, mid, k, dilation=dilation
                                              if k == (3, 3) else 1, bias=b))
        self.n_mid = len(kernels)
        setattr(self, f"Conv_{len(kernels) + 1}",
                Conv2d(mid, out_channels, (1, 1), bias=False))
        self.BatchNorm_0 = BatchNorm2d(mid)
        self.BatchNorm_1 = BatchNorm2d(mid)
        self.BatchNorm_2 = BatchNorm2d(out_channels)
        self.PReLU_0 = PReLU2d(mid)
        self.PReLU_1 = PReLU2d(mid)
        self.PReLU_2 = PReLU2d(out_channels)
        self.Dropout_0 = Dropout2d(dropout)

    def forward(self, x: torch.Tensor, train: bool,
                draws=None) -> torch.Tensor:
        h = self.PReLU_0(self.BatchNorm_0(self.Conv_0(x), train))
        for j in range(1, self.n_mid + 1):
            h = getattr(self, f"Conv_{j}")(h)
        h = self.PReLU_1(self.BatchNorm_1(h, train))
        h = getattr(self, f"Conv_{self.n_mid + 1}")(h)
        h = self.Dropout_0(self.BatchNorm_2(h, train),
                           draws if train else None)
        identity = F.max_pool2d(x, 2, 2) if self.downsample else x
        if identity.shape[1] != self.out_channels:
            identity = F.pad(identity, (0, 0, 0, 0, 0,
                                        self.out_channels - identity.shape[1]))
        return self.PReLU_2(h + identity)


def _layout(full: bool) -> Sequence[dict]:
    """The bottlenecks' Flax fields in call order."""
    out = [dict(out_channels=64, downsample=True, dropout=0.01,
                ref_exact=full)]
    out += [dict(out_channels=64, dropout=0.01, ref_exact=full)] * 4
    out += [dict(out_channels=128, downsample=True, ref_exact=full)]
    if full:
        for _ in range(2):
            for dil in (1, 2, -1, 4, 1, 8, -1, 16):
                out.append(dict(out_channels=128, dilation=max(dil, 1),
                                asymmetric=dil < 0, ref_exact=True))
    else:
        for _ in range(2):
            out += [dict(out_channels=128), dict(out_channels=128, dilation=2),
                    dict(out_channels=128, asymmetric=True),
                    dict(out_channels=128, dilation=4)]
    return out


class ENetEncoder(nn.Module):
    """(B, H, W, 3) -> (B, H/8, W/8, 128), NHWC at both ends.

    ``full=True`` is the reference-exact 22-bottleneck layout;
    ``full=False`` (default) the light 14-bottleneck one of the repo's
    trained weights (``outputs/enet/enet_weights.pkl``). ``draws`` (a
    ``ListenerDraws``) gives the train-mode dropout masks; without it a
    train forward draws them from torch's default generator.
    """

    def __init__(self, full: bool = False):
        super().__init__()
        self.full = full
        self.InitialBlock_0 = InitialBlock(ref_pad=full)
        width = 16
        self.n_blocks = 0
        for i, kw in enumerate(_layout(full)):
            setattr(self, f"Bottleneck_{i}", Bottleneck(width, **kw))
            width = kw["out_channels"]
            self.n_blocks += 1
        for name, mod in self.named_modules():
            if isinstance(mod, Dropout2d):
                mod.path = name

    def forward(self, x: torch.Tensor, train: bool = False,
                draws: Optional[ListenerDraws] = None) -> torch.Tensor:
        if train and draws is None:
            draws = ListenerDraws()
        h = self.InitialBlock_0(x.permute(0, 3, 1, 2), train)
        for i in range(self.n_blocks):
            h = getattr(self, f"Bottleneck_{i}")(h, train, draws)
        return h.permute(0, 2, 3, 1)


class ENetSemantic(nn.Module):
    """The encoder and a 1x1 ``classifier`` conv to ``classes`` logits
    (``scripts/train_enet.py``'s ``ENetSemantic``): (B, H/8, W/8,
    classes), NHWC."""

    def __init__(self, classes: int, full: bool = False):
        super().__init__()
        self.ENetEncoder_0 = ENetEncoder(full)
        self.classifier = Conv2d(128, classes, (1, 1))
        for name, mod in self.named_modules():
            if isinstance(mod, Dropout2d):
                mod.path = name

    def forward(self, x: torch.Tensor, train: bool = True,
                draws: Optional[ListenerDraws] = None) -> torch.Tensor:
        feats = self.ENetEncoder_0(x, train, draws)
        return self.classifier(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
