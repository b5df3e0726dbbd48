"""One run of one cell: set-up, the measured window, the traced unit, the
check against the reference, and the result line.

The last line of standard output is one JSON object::

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown"], "first_run_builds", "setup_phases_s", "checks"}

``metrics`` holds the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``), each read by ``perfbench/metrics/
<name>.py``; ``checks`` (last) holds each number compared with its limit,
and the same numbers are the last lines of standard error.

A cell on ``chips`` cards runs one process a card: this process is rank 0
and prints the result; ranks 1.. are started here and joined before it
prints. The ranks join one NCCL group (``tcp://localhost``, a free port)
through the program's ``parallel.mesh``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from perfbench.harness.names import Cell, load_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "d3net_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run must not hold,
    compared whole (``d3net_tpu_torch`` is not ``d3net_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    rank: int = 0
    world: int = 1


@dataclass
class Window:
    """The measured window: each unit's host clock span and counts."""

    start: float
    units: List[tuple]

    @property
    def end(self) -> float:
        return self.units[-1][1] if self.units else self.start

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def total(self, key: str) -> float:
        return sum(u[2].get(key, 0) for u in self.units)


@dataclass
class Readings:
    """What a metric reader gets."""

    setup_s: float
    window: Window
    work: Dict[str, float]
    trace: Optional[Any] = None          # profile.TraceSummary of rank 0
    busy_s: Optional[float] = None       # averaged over the ranks
    extras: Optional[Dict[str, Any]] = None


def _builds_present() -> bool:
    """Whether the program's kernel libraries are built already (a first
    run in a checkout builds them inside its set-up)."""
    from d3net_tpu_torch.kernels import build

    d = build.BUILD_DIR
    return os.path.isdir(d) and any(f.endswith(".so") for f in os.listdir(d))


def measure(drv, seconds: float, world: int, device) -> Window:
    """Units until ``seconds`` have passed at a unit's end; every rank
    runs as many (rank 0 decides and tells the others)."""
    import torch

    start = time.perf_counter()
    units = []
    while True:
        a = time.perf_counter()
        counts = drv.unit()
        b = time.perf_counter()
        units.append((a, b, counts))
        go = b - start < seconds
        if world > 1:
            import torch.distributed as dist

            flag = torch.tensor([int(go)], device=device)
            dist.broadcast(flag, 0)
            go = bool(flag.item())
        if not go:
            return Window(start, units)


def run_rank(rank: int, world: int, args, port: int, t0: float,
             cell: Optional[Cell] = None, device: Optional[str] = None,
             ) -> Optional[Dict[str, Any]]:
    """Set up, measure, trace and check on this rank; rank 0 returns what
    the result line needs. ``cell`` and ``device`` (the tests' tiny cells
    on the CPU) default to ``args.workload``'s cell and this rank's card."""
    import torch

    from d3net_tpu_torch.parallel import mesh
    from perfbench.harness import profile
    from perfbench.harness.names import driver_module, metric_reader

    cell = cell or load_cell(args.workload)
    dev = torch.device(device or f"cuda:{rank}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1:
        mesh.setup(rank, world, f"tcp://localhost:{port}",
                   backend="nccl" if dev.type == "cuda" else "gloo")
    built = dev.type != "cuda" or _builds_present()
    run = Run(cell, int(args.seed), float(args.seconds), bool(args.trace),
              dev, rank, world)
    drv = driver_module(cell.driver).Driver(run)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    window = measure(drv, run.seconds, world, dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    summary, extras = None, None
    if run.trace:
        _, summary = profile.traced(drv.unit, dev)
        extras = drv.trace_extras()
    drv.release()
    shared = {"peak": peak,
              "busy_s": summary.busy_s if summary else None}
    if world > 1:
        every = mesh.gather_to_main(shared)
        mesh.teardown()
        if rank:
            return None
        peak = max(e["peak"] for e in every)
        busy = ([e["busy_s"] for e in every] if run.trace else None)
    else:
        busy = [summary.busy_s] if summary else None

    readings = Readings(setup_s, window, drv.work(), summary,
                        sum(busy) / len(busy) if busy else None, extras)
    wanted = cell.per_layer if run.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = metric_reader(m["name"])(readings)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    from perfbench.reference.compare import judge

    try:
        numbers = drv.check()
    except Exception:   # a check that cannot run is a failed check
        traceback.print_exc()
        numbers = {}

    checks = judge(numbers, cell.limits())
    attempted = int(window.total("attempted") or window.total("steps"))
    out = {
        "correct": bool(checks) and all(ok for *_, ok in checks),
        "attempted": attempted,
        "failed": int(window.total("failed")),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": world, "memory_peak_bytes": int(peak)},
    }
    if out["failed"]:
        out["correct"] = False
    if run.trace:
        out["device"]["busy_s"] = readings.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["first_run_builds"] = not built
    out["setup_phases_s"] = getattr(drv, "phases", {})
    # a number that could not be read (a missing leaf, a failed check) is
    # null: JSON has no infinity
    out["checks"] = {k: {"value": v if math.isfinite(v) else None,
                         "limit": lim} for k, v, lim, _ in checks}
    return out


def _rank_entry(rank: int, world: int, args, port: int,
                cell: Optional[Cell] = None,
                device: Optional[str] = None) -> None:
    run_rank(rank, world, args, port, time.perf_counter(), cell, device)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse(argv: List[str]):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(out: Dict[str, Any]) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    world = cell.chips
    port = _free_port() if world > 1 else 0
    procs = []
    if world > 1:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        for r in range(1, world):
            p = ctx.Process(target=_rank_entry, args=(r, world, args, port))
            p.start()
            procs.append(p)
    try:
        out = run_rank(0, world, args, port, t0)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode for p in procs):
        print(f"perfbench: rank exit codes {[p.exitcode for p in procs]}",
              file=sys.stderr)
        return 5
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 4
    report(out)
    return 0
