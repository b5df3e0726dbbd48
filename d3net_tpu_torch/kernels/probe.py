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
import functools
from typing import List, NamedTuple, Optional, Sequence

import torch

from d3net_tpu_torch.kernels import build, gather
from d3net_tpu_torch.kernels.launch import launch

SOURCE = "probe_kernels.cu"
DTYPES = (torch.float32, torch.bfloat16)
SMEM_MAX = 232448          # bytes of shared memory a Hopper block may use
SMEM_PER_SM = 233472       # an H100 SM's 228 KB; each block reserves 1 KB
THREADS_PER_SM = 2048
SM_COUNT = 132             # H100 SXM
RING_SLOTS = 4             # csrc/probe_kernels.cu kRingSlots
RING_THREADS = 512         # csrc/probe_kernels.cu kRingThreads
TMA_BOX_ROWS = 256         # the most rows one TMA box may hold
INT32_MAX = 2**31 - 1      # TMA row coordinates are int32

_lib: Optional[ctypes.CDLL] = None
_P, _L = ctypes.c_void_p, ctypes.c_longlong


def load_library() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/probe_kernels.cu``."""
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE)
        for fn, args in (
                ("d3_probe_scale2", [_P, _P, _L, _P]),
                ("d3_window3_gather",
                 [_P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _P]),
                ("d3_prefetch_window_gather",
                 [_P, _P, _P, _P] + [_L] * 11 + [_P])):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
        _lib = lib
    return _lib


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for contiguous tensors on one CUDA device, False for contiguous
    CPU tensors; raises on anything else."""
    index = tensors[0].get_device()           # -1 on the CPU
    for t in tensors:
        if t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on one "
                             f"device, got {[str(u.device) for u in tensors]}")
    if index < 0 and tensors[0].device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    return index >= 0


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
    launch("probe_scale2", load_library().d3_probe_scale2, x.get_device(),
           x.data_ptr(), out.data_ptr(), x.numel())
    probe_scale2.launches += 1
    return out


probe_scale2.launches = 0


# -- shared checks of the two window gathers --------------------------------
def _check_window(name, src, index):
    if src.dim() != 2 or src.dtype not in DTYPES:
        raise TypeError(f"{name}: src must be (n, C) f32/bf16, got "
                        f"{tuple(src.shape)} {src.dtype}")
    if index.dim() != 1 or index.dtype != torch.int32:
        raise TypeError(f"{name}: index must be 1-D int32")
    row = src.shape[1] * src.element_size()
    if row % 16:
        raise ValueError(f"{name}: {row}-byte rows are not 16-byte vectors")
    return row


def _box(rows: int):
    """The TMA boxes ``(box_rows, nbox)`` of a ring slot of ``rows`` rows:
    at most 256 rows each and a multiple of 8, so that a box of 16-byte
    columns stays 128-byte aligned in shared memory."""
    nbox = -(-rows // TMA_BOX_ROWS)
    return -(-(-(-rows // nbox)) // 8) * 8, nbox


# -- #3: the probe's band kernel ---------------------------------------------
class RingPlan(NamedTuple):
    """How the ring kernel of ``window3_gather`` cuts its work
    (``csrc/probe_kernels.cu``)."""

    slice_bytes: int    # S: the column slice of every row that a block owns
    run_chunks: int     # L: consecutive output chunks that a block gathers
    box_rows: int       # rows of one TMA box: a multiple of 8, at most 256
    nbox: int           # boxes per chunk slot, nbox * box_rows >= ch
    slices: int         # row_bytes // S
    runs: int           # ceil(nchunk / L)
    blocks: int         # slices * runs
    blocks_per_sm: int  # resident at once on one SM at this shared memory
    smem_bytes: int     # per block: 4 slots, two index buffers, barriers
    moved_bytes: int    # read (source slots, indices) and written (output)


@functools.lru_cache(maxsize=64)
def window3_ring_plan(n: int, ch: int, row_bytes: int,
                      sms: int = SM_COUNT) -> RingPlan:
    """The ring kernel's plan for ``n`` rows of ``row_bytes`` bytes in
    chunks of ``ch`` rows, on a card of ``sms`` SMs.

    ``S`` is the widest of 16, 32, 64, 128 and 256 bytes (a power of two,
    at most one TMA box's 256) that divides the row and keeps
    ``RING_SLOTS`` chunk slots and the two index buffers inside a block's
    shared memory. ``L`` is the fewest chunks per run that keep every block
    in one wave (so fewer SMs give longer runs), and every chunk lies in
    exactly one run. Raises ValueError when no slice fits."""
    if ch <= 0 or n <= 0 or n % ch:
        raise ValueError(f"window3_ring_plan: n={n}, ch={ch}: needs n > 0 "
                         f"and n % ch == 0")
    if row_bytes <= 0 or row_bytes % 16:
        raise ValueError(f"window3_ring_plan: {row_bytes}-byte rows are not "
                         f"16-byte vectors")
    nchunk = n // ch
    box_rows, nbox = _box(ch)
    slot_rows = nbox * box_rows
    fixed = 2 * 4 * ch + 8 * RING_SLOTS
    fits = [s for s in (16, 32, 64, 128, 256)
            if row_bytes % s == 0
            and RING_SLOTS * slot_rows * s + fixed <= SMEM_MAX]
    if not fits:
        raise ValueError(f"window3_gather: {RING_SLOTS} slots of {ch}-row "
                         f"chunks do not fit {SMEM_MAX} bytes of shared "
                         f"memory")
    s = fits[-1]
    smem = RING_SLOTS * slot_rows * s + fixed
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024),
                        THREADS_PER_SM // RING_THREADS))
    slices = row_bytes // s
    run_chunks = -(-nchunk // max(1, sms * per_sm // slices))
    runs = -(-nchunk // run_chunks)
    rows_read = 0           # each run's chunks [j0-1, j0+L] clamped, once
    for r in range(runs):
        j0, j1 = r * run_chunks, min((r + 1) * run_chunks, nchunk)
        for c in range(max(j0 - 1, 0), min(j1, nchunk - 1) + 1):
            rows_read += min(slot_rows, n - c * ch)
    moved = (rows_read + n) * row_bytes + slices * 4 * n
    return RingPlan(s, run_chunks, box_rows, nbox, slices, runs,
                    slices * runs, per_sm, smem, moved)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def window3_gather(src: torch.Tensor, idx: torch.Tensor, ch: int,
                   plan: Optional[RingPlan] = None) -> torch.Tensor:
    """``src (n, C)``, ``idx (n,)`` int32, ``n % ch == 0`` -> ``(n, C)``.

    On the card the ring kernel runs with ``window3_ring_plan``'s plan for
    this card. ``plan`` is the card checks' hook: a plan made for fewer SMs
    puts the run edges elsewhere."""
    row = _check_window("window3_gather", src, idx)
    n = src.shape[0]
    if ch <= 0 or n % ch or idx.shape[0] != n:
        raise ValueError(f"window3_gather: n={n}, len(idx)={idx.shape[0]}, "
                         f"ch={ch}: needs len(idx) == n and n % ch == 0")
    if not _on_card("window3_gather", src, idx):
        return window3_gather_plain(src, idx, ch)
    out = torch.empty_like(src)
    if n == 0:
        return out
    if plan is None:
        plan = window3_ring_plan(n, ch, row, _sm_count(src.get_device()))
    launch("window3_gather", load_library().d3_window3_gather,
           src.get_device(), src.data_ptr(), idx.data_ptr(), out.data_ptr(),
           n, ch, row, plan.slice_bytes, plan.run_chunks, plan.box_rows,
           plan.nbox)
    window3_gather.launches += 1
    return out


window3_gather.launches = 0


# -- #4: the prefetch kernel -------------------------------------------------
class PrefetchPlan(NamedTuple):
    """How the ring kernel of ``prefetch_window_gather`` cuts its work
    (``csrc/probe_kernels.cu``)."""

    slice_bytes: int    # S: the column slice of every row that a block owns
    run_chunks: int     # L: consecutive output chunks that a block gathers
    slots: int          # R = nwin + ceil(chunk / wblk) window-block slots
    box_rows: int       # rows of one TMA box: a multiple of 8, at most 256
    nbox: int           # boxes per slot, nbox * box_rows >= wblk
    slices: int         # row_bytes // S
    runs: int           # ceil(nchunk / L)
    blocks: int         # slices * runs
    blocks_per_sm: int  # resident at once on one SM at this shared memory
    smem_bytes: int     # per block: slots, slot state, maps, rel buffers


@functools.lru_cache(maxsize=64)
def prefetch_ring_plan(n: int, chunk: int, wblk: int, nwin: int,
                       row_bytes: int, sms: int = SM_COUNT) -> PrefetchPlan:
    """The ring kernel's plan for ``n`` output rows of ``row_bytes`` bytes
    in chunks of ``chunk`` rows, each reading a window of ``nwin`` blocks
    of ``wblk`` source rows, on a card of ``sms`` SMs.

    ``R = nwin + ceil(chunk / wblk)`` slots: the window plus the blocks a
    banded window gains per chunk. ``S`` is the widest of 16, 32, 64, 128
    and 256 bytes that divides the row and keeps ``R`` slots, their state,
    two window maps and two rel buffers inside a block's shared memory.
    ``L`` is the fewest chunks per run that keep every block in one wave,
    and every chunk lies in exactly one run. Raises ValueError when no
    slice fits."""
    if min(n, chunk, wblk, nwin) <= 0:
        raise ValueError(f"prefetch_ring_plan: n={n}, chunk={chunk}, "
                         f"wblk={wblk}, nwin={nwin} must be positive")
    if row_bytes <= 0 or row_bytes % 16:
        raise ValueError(f"prefetch_ring_plan: {row_bytes}-byte rows are not "
                         f"16-byte vectors")
    nchunk = -(-n // chunk)
    slots = nwin + -(-chunk // wblk)
    box_rows, nbox = _box(wblk)
    fixed = slots * 24 + 2 * 4 * nwin + 2 * 4 * chunk
    fits = [s for s in (16, 32, 64, 128, 256)
            if row_bytes % s == 0 and row_bytes // s <= 65535
            and slots * nbox * box_rows * s + fixed <= SMEM_MAX]
    if not fits:
        raise ValueError(f"prefetch_window_gather: {slots} slots of "
                         f"{wblk}-row blocks do not fit {SMEM_MAX} bytes of "
                         f"shared memory")
    s = fits[-1]
    smem = slots * nbox * box_rows * s + fixed
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024),
                        THREADS_PER_SM // RING_THREADS))
    slices = row_bytes // s
    run_chunks = -(-nchunk // max(1, sms * per_sm // slices))
    runs = -(-nchunk // run_chunks)
    return PrefetchPlan(s, run_chunks, slots, box_rows, nbox, slices, runs,
                        slices * runs, per_sm, smem)


def prefetch_ring_loads(bases: Sequence[int], plan: PrefetchPlan, n_src: int,
                        wblk: int, nwin: int) -> List[List[tuple]]:
    """The ring kernel's slot schedule (warp 0's ``assign`` in
    ``csrc/probe_kernels.cu``), replayed on the host for ``bases``: per
    chunk, one ``(block, slot, fill, when)`` per window block, ``when``
    being ``"held"`` (a slot already holds the block), ``"now"`` (copied
    while the chunk before is gathered), ``"deferred"`` (copied once the
    chunk before is done, which still reads that slot) or ``"zeros"`` (the
    block lies wholly outside the source: no slot, no copy). Each run
    starts with empty slots."""
    r, out = plan.slots, []
    for j0 in range(0, len(bases), plan.run_chunks):
        tag, last, fills = [None] * r, [-2] * r, [0] * r
        for t, base in enumerate(bases[j0:j0 + plan.run_chunks]):
            window = []
            for b in range(int(base), int(base) + nwin):
                if b * wblk + wblk <= 0 or b * wblk >= n_src:
                    window.append((b, -1, 0, "zeros"))
                    continue
                s, when = b % r, "held"
                if tag[s] != b:
                    when = "deferred" if last[s] >= t - 1 else "now"
                    tag[s] = b
                    fills[s] += 1
                last[s] = t
                window.append((b, s, fills[s] - 1, when))
            out.append(window)
    return out


def prefetch_ring_moved_bytes(bases: Sequence[int], plan: PrefetchPlan,
                              n: int, n_src: int, wblk: int, nwin: int,
                              row_bytes: int) -> int:
    """Bytes the ring kernel moves for ``bases``: the source rows of every
    copy (TMA reads only the rows inside the source), summed over the
    slices into whole rows; the output written; rel and bases read once
    per slice."""
    rows = plan.nbox * plan.box_rows
    read = sum(max(0, min(b * wblk + rows, n_src) - max(b * wblk, 0))
               for window in prefetch_ring_loads(bases, plan, n_src, wblk,
                                                 nwin)
               for b, _, _, when in window if when in ("now", "deferred"))
    return (read + n) * row_bytes + plan.slices * 4 * (n + len(bases))


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
                           nwin: int, plan: Optional[PrefetchPlan] = None
                           ) -> torch.Tensor:
    """``src (n_src, C)``, ``rel (n,)`` int32, ``bases (ceil(n / chunk),)``
    int32 -> ``(n, C)``.

    On the card the ring kernel runs with ``prefetch_ring_plan``'s plan for
    this card, which raises ValueError for a window that does not fit (on
    the CPU too, so both take the same inputs). ``plan`` is the card
    checks' hook: a plan made for fewer SMs puts the run edges elsewhere."""
    row = _check_window("prefetch_window_gather", src, rel)
    n, n_src = rel.shape[0], src.shape[0]
    if min(chunk, wblk, nwin) <= 0:
        raise ValueError(f"prefetch_window_gather: chunk={chunk}, "
                         f"wblk={wblk}, nwin={nwin} must be positive")
    if bases.dtype != torch.int32 or bases.shape != (-(-n // chunk),):
        raise ValueError(f"prefetch_window_gather: bases {tuple(bases.shape)}"
                         f" {bases.dtype}, want ({-(-n // chunk)},) int32")
    if n_src > INT32_MAX:
        raise ValueError(f"prefetch_window_gather: {n_src} source rows, at "
                         f"most {INT32_MAX}")
    if n == 0:
        return src.new_empty((0, src.shape[1]))
    if not _on_card("prefetch_window_gather", src, rel, bases):
        prefetch_ring_plan(n, chunk, wblk, nwin, row)   # the same refusal
        return prefetch_window_gather_plain(src, rel, bases, chunk=chunk,
                                            wblk=wblk, nwin=nwin)
    if n_src == 0:
        raise ValueError("prefetch_window_gather: an empty source has no "
                         "tensor map")
    if plan is None:
        plan = prefetch_ring_plan(n, chunk, wblk, nwin, row,
                                  _sm_count(src.get_device()))
    out = torch.empty((n, src.shape[1]), dtype=src.dtype, device=src.device)
    launch("prefetch_window_gather",
           load_library().d3_prefetch_window_gather, src.get_device(),
           src.data_ptr(), rel.data_ptr(), bases.data_ptr(), out.data_ptr(),
           n, n_src, chunk, wblk, nwin, row, plan.slice_bytes,
           plan.run_chunks, plan.slots, plan.box_rows, plan.nbox)
    prefetch_window_gather.launches += 1
    return out


prefetch_window_gather.launches = 0
