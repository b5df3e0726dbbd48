"""Readings shared by metrics that differ only in the cells they serve
(``idle.train`` and ``idle.eval`` read the same quantity)."""

from __future__ import annotations

from typing import Optional


def idle_pct(r) -> Optional[float]:
    """Share of the traced window in which no kernel, copy or set ran on
    the device, in %."""
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def mfu_pct(r) -> Optional[float]:
    """The operations the window's units need (``perfbench/work``) over
    the window's time at the configuration's peak, in %."""
    fl = r.work.get("flops_per_unit")
    if not fl or r.window.seconds <= 0:
        return None
    done = fl * len(r.window.units)
    return 100.0 * done / (r.window.seconds * r.work["peak_flops"])


def gather_roofline_pct(r) -> Optional[float]:
    """The least time the traced unit's ``gather_rows`` calls need at the
    card's peak bandwidth (bytes from ``work/gather.py``) over the device
    time of its ``gather_rows_kernel`` launches, in %. Nothing where the
    counted and the traced units launched different numbers."""
    if r.trace is None or not r.extras or not r.extras.get("gather_bytes"):
        return None
    n, secs = r.trace.kernel_time(lambda k: "gather_rows_kernel" in k)
    if n != r.extras["gather_launches"] or secs <= 0:
        return None
    least = r.extras["gather_bytes"] / r.work["peak_bytes_per_s"]
    return 100.0 * least / secs

