"""Bytes a row gather needs, and a recorder of the gathers a unit makes.

Rule: the output rows are written once, the distinct source rows the
indices reach are read once and the indices are read once, whatever the
kernel reads again. Sentinel and out-of-range indices read the zero row,
which counts nothing.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch


def gather_bytes(rows: int, distinct: int, row_bytes: int) -> int:
    """``rows`` output rows of ``row_bytes``, ``distinct`` source rows
    read, int32 indices."""
    return rows * row_bytes + distinct * row_bytes + rows * 4


@contextlib.contextmanager
def recording(module, calls: List[Tuple[int, int, int]]):
    """Wrap ``module.gather_rows`` (the program's, looked up at each call
    by its callers): every call appends ``(rows, distinct valid source
    rows, row bytes)`` to ``calls``. Each call adds a count on the device:
    use it outside the timed and traced units."""
    inner = module.gather_rows

    def wrapper(src, idx):
        out = inner(src, idx)
        n_src = src.shape[0]
        if idx.numel() and src.shape[1]:
            valid = idx[(idx >= 0) & (idx < n_src)]
            seen = torch.zeros(n_src, dtype=torch.bool, device=idx.device)
            seen[valid.long()] = True
            calls.append((idx.numel(), seen.sum(),
                          src.shape[1] * src.element_size()))
        return out

    # the program counts its launches on the module's ``gather_rows``
    wrapper.launches = getattr(inner, "launches", 0)
    module.gather_rows = wrapper
    try:
        yield
    finally:
        module.gather_rows = inner
        if hasattr(inner, "launches"):
            inner.launches = wrapper.launches
        for i, (r, d, b) in enumerate(calls):
            calls[i] = (r, int(d), b)
