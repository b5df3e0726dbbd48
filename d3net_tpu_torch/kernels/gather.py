"""Row gather ``src[idx]`` with a zero pad row: the CUDA kernel and its
plain PyTorch version.

``gather_rows`` is the port's counterpart of the JAX package's one Pallas
kernel, ``band_gather`` (``d3net_tpu/ops/pallas_gather.py``). Every row
gather of the detector forward goes through it: the sparse-conv operand
gathers (``ops/sparse_conv.py``) and ``segment.gather_padded``. The kernel
is ``csrc/gather_rows.cu``; its note gives the bound and the design.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. ``gather_rows.launches`` counts kernel launches.

Under autograd (``src.requires_grad`` with grad mode on) the gather is a
``torch.autograd.Function`` whose backward is the gradient XLA gives a
gather: the output gradient rows scatter-added into zeros ``(n_src, C)``
with ``index_add_``, sentinel and out-of-range rows dropped. The JAX
``band_gather`` has no VJP kernel of its own, so neither has this one.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from d3net_tpu_torch.kernels import build
from d3net_tpu_torch.kernels.launch import launch

SOURCE = "gather_rows.cu"
DTYPES = (torch.float32, torch.bfloat16, torch.int32)

_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/gather_rows.cu``."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        lib.d3_gather_rows.restype = ctypes.c_int
        lib.d3_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 2:
        raise ValueError(f"src must be (n_src, C), got {tuple(src.shape)}")
    if src.dtype not in DTYPES:
        raise TypeError(f"src dtype {src.dtype} not in {DTYPES}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(
            f"idx must be 1-D int32, got {tuple(idx.shape)} {idx.dtype}")
    if src.device != idx.device:
        raise ValueError(f"src on {src.device}, idx on {idx.device}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``cat([src, zeros(1, C)])[idx]``, with
    every index outside ``[0, n_src)`` sent to the zero row."""
    n_src = src.shape[0]
    padded = torch.cat([src, src.new_zeros(1, src.shape[1])])
    idx = idx.long()
    return padded[torch.where((idx >= 0) & (idx < n_src), idx, n_src)]


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r] = src[idx[r]]`` for ``0 <= idx[r] < n_src``; any other index
    reads a zero row — ``idx[r] == n_src`` is the kernel-map INVALID
    sentinel. (n,) -> (n, C). Differentiable in ``src``.
    """
    _check(src, idx)
    if src.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(src, idx)
    return _gather(src, idx)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n_src = src.shape[0]
        return _gather(src, idx)

    @staticmethod
    def backward(ctx, g):
        """``dsrc[idx[r]] += g[r]``; rows outside ``[0, n_src)`` drop into
        a trash row."""
        (idx,) = ctx.saved_tensors
        n_src = ctx.n_src
        keep = torch.where((idx >= 0) & (idx < n_src), idx, n_src).long()
        out = g.new_zeros((n_src + 1, g.shape[1]))
        out.index_add_(0, keep, g.contiguous())
        return out[:n_src], None


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {src.device}")
    fn = load_library().d3_gather_rows
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype,
                      device=src.device)
    if idx.shape[0] == 0 or src.shape[1] == 0:
        return out
    launch("gather_rows", fn, src.get_device(), src.data_ptr(),
           idx.data_ptr(), out.data_ptr(), idx.shape[0], src.shape[0],
           src.shape[1] * src.element_size())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


class BandPlan(NamedTuple):
    """Host-precomputed memory plan of the JAX ``band_gather`` (a copy of
    ``d3net_tpu.ops.pallas_gather.BandPlan``).

    bases: (nchunk,) int32 — per-chunk window base, in ``wblk``-row units.
    rel:   (1, n) int32 — idx relative to its chunk's window base row.
    """

    bases: np.ndarray
    rel: np.ndarray
    chunk: int
    wblk: int
    nwin: int
    n_src: int


def plan_band_windows(idx: np.ndarray, n_src: int, *, chunk: int = 512,
                      wblk: int = 128, nwin: int = 6) -> Optional[BandPlan]:
    """Per-chunk window plan, or None if the band is violated (a copy of
    ``d3net_tpu.ops.pallas_gather.plan_band_windows``)."""
    idx = np.asarray(idx, np.int32)
    n = idx.shape[0]
    if n % chunk or n_src % wblk or n_src < nwin * wblk:
        return None
    nchunk = n // chunk
    wtot = nwin * wblk
    per = idx.reshape(nchunk, chunk)
    lo = per.min(axis=1)
    hi = per.max(axis=1)
    base = np.clip(lo // wblk, 0, (n_src - wtot) // wblk)
    if (hi - base * wblk >= wtot).any() or (lo - base * wblk < 0).any():
        return None
    rel = (per - (base * wblk)[:, None]).reshape(1, n).astype(np.int32)
    return BandPlan(base.astype(np.int32), rel, chunk, wblk, nwin, n_src)


def band_gather(src: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """``src[idx]`` for a planned banded ``idx``, through ``gather_rows``.

    The absolute index is ``bases[r // chunk] * wblk + rel[r]``; the TPU
    window plan itself is not needed on Hopper.
    """
    if src.shape[0] != plan.n_src:
        raise ValueError(f"src rows {src.shape[0]} != plan.n_src {plan.n_src}")
    bases = torch.as_tensor(plan.bases, device=src.device)
    rel = torch.as_tensor(plan.rel, device=src.device).reshape(-1)
    idx = bases.repeat_interleave(plan.chunk) * plan.wblk + rel
    return gather_rows(src, idx.to(torch.int32))
