"""The reference's precision: plain float32 with TF32 off, or, for the
control, its products' operands rounded to a lower type.

``products(dtype)`` makes every convolution of the frozen model (the
sparse convolutions' gathered operand and weight, forward and backward,
and ScoreNet's dense convolutions) round its two operands and its output
to ``dtype`` with a per-tensor scale (amax over the type's largest finite
value), as a scaled fp8 product does, accumulating in float32: the
activations between the layers are then held in ``dtype``, as the
program holds them in bfloat16. The rounding passes the gradient
straight through.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

_PRODUCT_DTYPE: Optional[torch.dtype] = None


@contextlib.contextmanager
def plain_f32() -> Iterator[None]:
    """Float32 products with TF32 and reduced-precision reductions off."""
    flags = ((torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cuda.matmul,
              "allow_bf16_reduced_precision_reduction"),
             (torch.backends.cuda.matmul,
              "allow_fp16_reduced_precision_reduction"))
    saved = [getattr(o, n) for o, n in flags]
    for o, n in flags:
        setattr(o, n, False)
    try:
        yield
    finally:
        for (o, n), v in zip(flags, saved):
            setattr(o, n, v)


@contextlib.contextmanager
def products(dtype: Optional[torch.dtype]) -> Iterator[None]:
    """Round the products' operands to ``dtype`` inside the block (None:
    leave them in float32)."""
    global _PRODUCT_DTYPE
    saved, _PRODUCT_DTYPE = _PRODUCT_DTYPE, dtype
    try:
        yield
    finally:
        _PRODUCT_DTYPE = saved


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a product operand under the current setting."""
    dt = _PRODUCT_DTYPE
    if dt is None or not x.is_floating_point():
        return x
    with torch.no_grad():
        xf = x.float()
        if dt.is_floating_point and dt.itemsize == 1:
            top = torch.finfo(dt).max
        else:
            top = None
        if top is None:
            y = xf.to(dt).float()
        else:
            scale = xf.abs().amax().clamp(min=1e-30) / top
            y = (xf / scale).clamp(-top, top).to(dt).float() * scale
        y = y.to(x.dtype)
    return x + (y - x).detach()
