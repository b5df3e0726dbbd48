"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly.
With no device given and no GPU present they raise: nothing carries on
quietly on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); otherwise the named device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "d3net_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def parity_precision() -> Iterator[None]:
    """Full-f32 matmuls and convolutions inside the block, for parity runs
    against f32 references; the previous settings come back on exit.

    cuDNN convolutions default to TF32 (about three decimal digits), and
    cuBLAS may reduce bf16 products in bf16; both are switched off here.
    Timed runs stay outside the block, at the settings users get.
    """
    flags = ((torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cuda.matmul,
              "allow_bf16_reduced_precision_reduction"))
    saved = [getattr(obj, name) for obj, name in flags]
    for obj, name in flags:
        setattr(obj, name, False)
    try:
        yield
    finally:
        for (obj, name), val in zip(flags, saved):
            setattr(obj, name, val)
