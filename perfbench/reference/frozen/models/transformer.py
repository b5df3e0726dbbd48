"""Transformer primitives (counterpart of ``d3net_tpu/models/transformer.py``;
parity: ``model/transformer/attention.py``).

Multi-head attention with optional additive/multiplicative attention-weight
injection (the listener's distance-weighted attention), key masking, and the
reference's post-LN residual wrapper (dropout -> add -> LayerNorm).

The attention is written as the JAX module writes it: a matmul, masked keys
set to -inf, a softmax, then every non-finite weight set to 0. A row whose
keys are all masked (an unannotated description has length 0) gives zeros,
where ``scaled_dot_product_attention`` would give NaN, and ``torch.where``
keeps its gradient finite.

Also here: ``LayerNorm`` with Flax's semantics (eps 1e-6, the variance as
E[x²] - E[x]², clipped at 0) and ``Dropout``, whose keep masks come from a
draws object (``models/listener.py`` ``ListenerDraws``) by module path.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn


def name_dropouts(root: nn.Module) -> None:
    """Give each ``Dropout`` under ``root`` its dotted path from ``root``:
    the key of its keep mask in the draws."""
    for name, mod in root.named_modules():
        if isinstance(mod, Dropout):
            mod.path = name


class Dropout(nn.Module):
    """Flax's ``nn.Dropout``: ``where(keep, x / (1 - rate), 0)``. With no
    draws (eval) it is the identity; otherwise ``draws.keep(path, shape,
    rate, device)`` gives the keep mask."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.path = ""

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        if draws is None:
            return x
        keep = draws.keep(self.path, tuple(x.shape), self.rate, x.device)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def flax_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``."""
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias


def fast_stats(x: torch.Tensor, dim: int):
    """Flax's ``use_fast_variance`` statistics over ``dim`` (kept):
    mean and ``max(0, E[x²] - E[x]²)``."""
    mean = x.mean(dim, keepdim=True)
    var = torch.clamp((x * x).mean(dim, keepdim=True) - mean * mean, min=0.0)
    return mean, var


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` over the last axis: eps 1e-6 (torch's is
    1e-5), the fast variance, ``scale`` and ``bias``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = fast_stats(x, -1)
        return flax_norm(x, mean, var, self.scale, self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """MHA + dropout + residual + post-LN (ref ``MultiHeadAttention``)."""

    def __init__(self, d_model: int, d_k: int, d_v: int, h: int,
                 dropout: float = 0.1):
        super().__init__()
        self.d_k, self.d_v, self.h = d_k, d_v, h
        # the f32 value of sqrt(d_k), as jnp.sqrt takes it
        self.scale = float(np.sqrt(np.float32(d_k)))
        self.fc_q = nn.Linear(d_model, h * d_k)
        self.fc_k = nn.Linear(d_model, h * d_k)
        self.fc_v = nn.Linear(d_model, h * d_v)
        self.fc_o = nn.Linear(h * d_v, d_model)
        self.Dropout_0 = Dropout(dropout)
        self.LayerNorm_0 = LayerNorm(d_model)
        name_dropouts(self)

    def forward(self, queries, keys, values,
                key_mask: Optional[torch.Tensor] = None,
                attention_weights: Optional[torch.Tensor] = None,
                way: str = "mul", draws=None) -> torch.Tensor:
        """queries (B, Nq, d_model), keys and values (B, Nk, d_model),
        ``key_mask`` (B, Nk) 1 = attend, ``attention_weights`` (B, h, Nq,
        Nk) multiplied into (``way`` "mul") or added to the logits;
        ``draws`` None is eval (no dropout)."""
        b, nq, _ = queries.shape
        nk = keys.shape[1]
        q = self.fc_q(queries).reshape(b, nq, self.h, self.d_k).transpose(1, 2)
        k = self.fc_k(keys).reshape(b, nk, self.h, self.d_k).permute(0, 2, 3, 1)
        v = self.fc_v(values).reshape(b, nk, self.h, self.d_v).transpose(1, 2)
        att = torch.matmul(q, k) / self.scale
        if attention_weights is not None:
            att = (att * attention_weights if way == "mul"
                   else att + attention_weights)
        if key_mask is not None:
            att = torch.where(key_mask[:, None, None, :] > 0, att, -math.inf)
        att = torch.softmax(att, dim=-1)
        # rows with no valid key give NaN from all -inf; zero them
        att = torch.where(torch.isfinite(att), att, 0.0)
        out = torch.matmul(att, v).transpose(1, 2).reshape(
            b, nq, self.h * self.d_v)
        out = self.Dropout_0(self.fc_o(out), draws)
        return self.LayerNorm_0(queries + out)
