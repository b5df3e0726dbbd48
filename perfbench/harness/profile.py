"""One unit of work under ``torch.profiler``, reduced to what the per-layer
metrics read: the device's busy time (the union of its kernel, copy and
set intervals) inside the traced window, each kernel's time and count by
name, and the longest idle gaps named by what the host was doing then.

The trace is written as a Chrome trace into ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

MARK = "perfbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")


@dataclass
class TraceSummary:
    """The traced window of one unit, seconds throughout."""

    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    idle_gaps: Dict[str, float] = field(default_factory=dict)

    def kernel_time(self, match: Callable[[str], bool]) -> Tuple[int, float]:
        """(count, seconds) of the kernels whose name ``match`` takes."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if match(name):
                n, s = n + c, s + t
        return n, s

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict]) -> TraceSummary:
    """The Chrome trace's events -> the window's summary (``MARK`` is the
    user annotation around the unit)."""
    marks = [e for e in events if e.get("name") == MARK
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {MARK} annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, kernels = [], {}
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a, d = float(e["ts"]), float(e["dur"])
        if cat in _DEVICE_CATS:
            a0, b0 = max(a, w0), min(a + d, w1)
            if b0 <= a0:
                continue
            dev.append((a0, b0))
            name = e.get("name", "?")
            c, t = kernels.get(name, (0, 0.0))
            kernels[name] = (c + 1, t + (b0 - a0) * 1e-6)
        elif cat in _HOST_CATS and e.get("name") != MARK:
            host.append((a, a + d, e.get("name", "?")))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    # each idle gap is named after the innermost host event open at its
    # start (the latest-starting one that covers it)
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        j = bisect.bisect_right(starts, g0)
        name = "host idle"
        for k in range(j - 1, max(-1, j - 2000), -1):
            if host[k][1] > g0:
                name = host[k][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) * 1e-6
    return TraceSummary((w1 - w0) * 1e-6, busy_s, kernels, gaps)


def traced(unit: Callable[[], object], device: torch.device):
    """Run ``unit()`` under the profiler: (its return, TraceSummary)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(MARK):
            out = unit()
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, summarize(events)
