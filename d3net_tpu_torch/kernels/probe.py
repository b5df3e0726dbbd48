"""The banded-gather probe's three kernels and their plain PyTorch versions.

Counterparts of the Pallas TPU kernels of ``scripts/pallas_probe.py``
(``csrc/probe_kernels.cu`` holds the CUDA kernels, and its note the
bounds and the design):

- ``probe_scale2``: ``2 * x`` in bf16 (``probe_smoke.kernel``);
- ``window3_gather``: the probe's band kernel (``_band_gather_pallas``):
  chunk ``j`` of ``ch`` output rows reads from source chunks
  ``[max(j-1, 0), j, min(j+1, nchunk-1)]`` at ``rel = idx - (j-1)*ch``,
  a zero row where ``rel`` is outside ``[0, 3*ch)``;
- ``prefetch_window_gather``: the prefetch kernel (``probe_prefetch.f``,
  the JAX ``band_gather`` memory plan): ``out[r] = src[bases[r // chunk]
  * wblk + rel[r]]`` for ``0 <= rel[r] < nwin*wblk``, else a zero row.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from d3net_tpu_torch.kernels import build, gather

SOURCE = "probe_kernels.cu"
DTYPES = (torch.float32, torch.bfloat16)
SMEM_MAX = 232448          # bytes of shared memory a Hopper block may use

_lib: Optional[ctypes.CDLL] = None
_P, _L = ctypes.c_void_p, ctypes.c_longlong


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/probe_kernels.cu``."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        for fn, args in (
                ("d3_probe_scale2", [_P, _P, _L, _P]),
                ("d3_window3_gather", [_P, _P, _P, _L, _L, _L, _P]),
                ("d3_prefetch_window_gather",
                 [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _P])):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
        _lib = lib
    return _lib


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev.type == "cuda"


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# -- #2: probe_smoke -------------------------------------------------------
def probe_scale2_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def probe_scale2(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for a bf16 tensor (exact barring overflow)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"probe_scale2 takes bf16, got {x.dtype}")
    if not _on_card("probe_scale2", x):
        return probe_scale2_plain(x)
    out = torch.empty_like(x)
    _launch("probe_scale2", load_library().d3_probe_scale2, x.device,
            x.data_ptr(), out.data_ptr(), x.numel())
    probe_scale2.launches += 1
    return out


probe_scale2.launches = 0


# -- shared checks of the two window gathers --------------------------------
def _check_window(name, src, index, n_rows_window):
    if src.dim() != 2 or src.dtype not in DTYPES:
        raise TypeError(f"{name}: src must be (n, C) f32/bf16, got "
                        f"{tuple(src.shape)} {src.dtype}")
    if index.dim() != 1 or index.dtype != torch.int32:
        raise TypeError(f"{name}: index must be 1-D int32")
    row = src.shape[1] * src.element_size()
    if row % 16 or n_rows_window * 16 > SMEM_MAX:
        raise ValueError(f"{name}: {row}-byte rows or a {n_rows_window}-row "
                         f"window do not fit 16-byte slices in shared memory")
    return row


# -- #3: the probe's band kernel ---------------------------------------------
def window3_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                         ch: int) -> torch.Tensor:
    n = src.shape[0]
    nchunk = n // ch
    j = torch.arange(idx.shape[0], device=src.device) // ch
    rel = idx.long() - (j - 1) * ch
    ok = (rel >= 0) & (rel < 3 * ch)
    w = rel.clamp(0, 3 * ch - 1)
    row = (j - 1 + w // ch).clamp(0, nchunk - 1) * ch + w % ch
    return gather.gather_rows_plain(src, torch.where(ok, row, -1).int())


def window3_gather(src: torch.Tensor, idx: torch.Tensor,
                   ch: int) -> torch.Tensor:
    """``src (n, C)``, ``idx (n,)`` int32, ``n % ch == 0`` -> ``(n, C)``."""
    row = _check_window("window3_gather", src, idx, 3 * ch)
    n = src.shape[0]
    if ch <= 0 or n % ch or idx.shape[0] != n:
        raise ValueError(f"window3_gather: n={n}, len(idx)={idx.shape[0]}, "
                         f"ch={ch}: needs len(idx) == n and n % ch == 0")
    if not _on_card("window3_gather", src, idx):
        return window3_gather_plain(src, idx, ch)
    out = torch.empty_like(src)
    _launch("window3_gather", load_library().d3_window3_gather, src.device,
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), n, ch, row)
    window3_gather.launches += 1
    return out


window3_gather.launches = 0


# -- #4: the prefetch kernel -------------------------------------------------
def prefetch_window_gather_plain(src, rel, bases, *, chunk: int, wblk: int,
                                 nwin: int) -> torch.Tensor:
    j = torch.arange(rel.shape[0], device=src.device) // chunk
    rel = rel.long()
    row = bases.long()[j] * wblk + rel
    ok = (rel >= 0) & (rel < nwin * wblk)
    # rows outside the source read zeros in gather_rows_plain too
    return gather.gather_rows_plain(src, torch.where(ok, row, -1).int())


def prefetch_window_gather(src: torch.Tensor, rel: torch.Tensor,
                           bases: torch.Tensor, *, chunk: int, wblk: int,
                           nwin: int) -> torch.Tensor:
    """``src (n_src, C)``, ``rel (n,)`` int32, ``bases (ceil(n / chunk),)``
    int32 -> ``(n, C)``."""
    row = _check_window("prefetch_window_gather", src, rel, nwin * wblk)
    n = rel.shape[0]
    if bases.dtype != torch.int32 or bases.shape != (-(-n // chunk),):
        raise ValueError(f"prefetch_window_gather: bases {tuple(bases.shape)}"
                         f" {bases.dtype}, want ({-(-n // chunk)},) int32")
    if not _on_card("prefetch_window_gather", src, rel, bases):
        return prefetch_window_gather_plain(src, rel, bases, chunk=chunk,
                                            wblk=wblk, nwin=nwin)
    out = torch.empty((n, src.shape[1]), dtype=src.dtype, device=src.device)
    _launch("prefetch_window_gather",
            load_library().d3_prefetch_window_gather, src.device,
            src.data_ptr(), rel.data_ptr(), bases.data_ptr(), out.data_ptr(),
            n, src.shape[0], chunk, wblk, nwin, row)
    prefetch_window_gather.launches += 1
    return out


prefetch_window_gather.launches = 0
