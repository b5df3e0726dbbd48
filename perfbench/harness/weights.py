"""Seeded weights made on the device in one draw.

The initializers are those the port's ``params.init_flax_variables``
gives (Flax's): He-normal sparse and dense conv kernels, LeCun-normal
Dense layers and GRU input gates, orthogonal GRU recurrent gates, zero
biases and shifts, unit BN and LayerNorm scales, running mean 0 and var
1, PReLU slopes 0.25. Every normal entry comes from one ``torch.randn``
on the device; the weights are the benchmark's, handed to the program
and to the reference alike.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

# module class name -> {parameter or buffer: rule}; a rule is
# ("normal", gain, fan-in axes of the tensor) or ("const", value) or
# ("orthogonal3", None, None): three orthogonal (H, H) gate blocks
_RULES = {
    "SubmConv": {"kernel": ("normal", 2.0, (0, 1))},
    "Conv": {"weight": ("normal", 2.0, (1, 2, 3, 4))},
    "ConvTranspose": {"weight": ("normal", 2.0, (0, 2, 3, 4))},
    "Linear": {"weight": ("normal", 1.0, (1,)), "bias": ("const", 0.0)},
    "MaskedBatchNorm": {"scale": ("const", 1.0), "bias": ("const", 0.0),
                        "mean": ("const", 0.0), "var": ("const", 1.0)},
    "BatchNorm": {"scale": ("const", 1.0), "bias": ("const", 0.0),
                  "mean": ("const", 0.0), "var": ("const", 1.0)},
    "LayerNorm": {"scale": ("const", 1.0), "bias": ("const", 0.0)},
    "PReLU": {"alpha": ("const", 0.25)},
    "GRUCell": {"weight_ih": ("normal3", 1.0, (1,)),
                "weight_hh": ("orthogonal3", None, None),
                "bias_ih": ("const", 0.0), "bias_hn": ("const", 0.0)},
}


def _entries(model: nn.Module) -> List[Tuple[str, torch.Tensor, tuple]]:
    out = []
    for name, mod in model.named_modules():
        tensors = dict(mod.named_parameters(recurse=False))
        tensors.update(mod.named_buffers(recurse=False))
        if not tensors:
            continue
        rules = _RULES.get(type(mod).__name__)
        if rules is None:
            raise ValueError(f"no initializer for {type(mod).__name__} "
                             f"({name})")
        for key, t in tensors.items():
            if t is None:
                continue
            if key not in rules:
                raise ValueError(f"no initializer for {name}.{key}")
            out.append((f"{name}.{key}" if name else key, t, rules[key]))
    return out


def seeded_state(model: nn.Module, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` for ``model`` drawn on ``device`` from
    ``seed``; load it with ``model.load_state_dict``."""
    entries = _entries(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [t.numel() if r[0] != "const" else 0 for _, t, r in entries]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    state, off = {}, 0
    for (key, t, rule), n in zip(entries, sizes):
        kind = rule[0]
        if kind == "const":
            state[key] = torch.full(t.shape, rule[1], dtype=t.dtype,
                                    device=device)
            continue
        v = flat[off:off + n].reshape(t.shape)
        off += n
        if kind == "normal":
            fan_in = math.prod(t.shape[a] for a in rule[2])
            v = v * math.sqrt(rule[1] / fan_in)
        elif kind == "normal3":
            v = v * math.sqrt(rule[1] / t.shape[1])
        else:   # three (H, H) orthogonal blocks, Flax's QR with sign fix
            blocks = []
            for blk in v.reshape(3, -1, t.shape[1]):
                q, r = torch.linalg.qr(blk)
                blocks.append(q * torch.sign(torch.diagonal(r)))
            v = torch.cat(blocks)
        state[key] = v.to(t.dtype)
    return state
