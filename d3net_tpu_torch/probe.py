"""Banded-gather probe: does staging a window of source rows in shared
memory beat a direct row gather?

    python -m d3net_tpu_torch.probe [--what smoke,band,prefetch,gather]
                                    [--n 262144 --c 128 --ch 512]
                                    [--device cpu]

Counterpart of ``scripts/pallas_probe.py`` (its TPU question, asked of
Hopper). Each probe builds the TPU probe's own data (same construction,
numpy seeds 0 and 1), checks its kernel bit-exact against the plain
version, and on the card reports two times per call: ``ms``, what a caller
pays (CUDA events, median of ``REPS`` passes of ``INNER`` back-to-back
calls, the calls compared taking turns), and ``device_ms``, the device
time of what one call launches (``torch.profiler`` over ``INNER`` calls,
read after every ``ms`` of the run):

- ``smoke``:    ``probe_scale2`` on a (256, 128) bf16 block of ones, beside
  ``torch.mul(x, 2.0)``;
- ``band``:     ``window3_gather`` (three-chunk window, the ring kernel) on
  in-band indices, with the ring's plan (``window3_ring_plan``) and the
  bytes its blocks move (``moved_bytes``);
- ``prefetch``: ``prefetch_window_gather`` (``nwin * wblk``-row window
  from a per-chunk base, the ring kernel) on indices that fit their
  window, with the ring's plan (``prefetch_ring_plan``) and the bytes its
  blocks move for these bases (``moved_bytes``);
- ``gather``:   ``gather_rows`` and ``torch.index_select`` on banded and on
  random indices (the TPU probe's "XLA take" baseline);
- ``launch`` (only when named): the host µs of one ``probe_scale2`` call,
  of ``torch.mul``'s, and of each step of the launch (``host_us``).

``band`` and ``prefetch`` report ns/row for four gathers of the same rows:
the window kernel, ``gather_rows``, the plain version and
``torch.index_select`` (the library yardstick; the port never calls it),
beside the bytes bound at 3.35 TB/s. The bound counts the bytes the
gather needs (each distinct source row it reaches read once, the output
written, the index read); ``plan_bytes`` counts what the TPU window plan
moves (every window read in full). One JSON line per probe.

Runs on the card unless ``--device cpu`` is given; on the CPU it runs the
plain versions and times nothing. Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from d3net_tpu_torch.device import resolve_device
from d3net_tpu_torch.kernels import gather, launch, probe

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
REPS = 11
INNER = 10
HOST_REPS = 200           # calls per round: well inside the launch queue
HOST_ROUNDS = 5


def time_ms(fns: Dict[str, Callable[[], object]], reps: int = REPS,
            inner: int = INNER) -> Dict[str, float]:
    """Per-call time of each of ``fns``: the median over ``reps`` of the
    mean time of ``inner`` back-to-back calls (CUDA events), after one
    warm-up call each. The functions take turns within each rep, so that a
    drift of the host's speed reaches them all alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times: Dict[str, list] = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b) / inner)
    return {k: statistics.median(v) for k, v in times.items()}


def device_ms(fn: Callable[[], object], inner: int = INNER) -> float:
    """Device time per call of ``fn``: the self device time of every kernel
    (and copy) that ``inner`` calls launch, read with ``torch.profiler``
    after one warm-up call, over ``inner``. Raises without a card, and when
    the profiler records no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA card; a CPU run has no "
                           "device time")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / inner


def host_us(fns: Dict[str, Callable[[], object]], reps: int = HOST_REPS,
            rounds: int = HOST_ROUNDS) -> Dict[str, float]:
    """Host time per call of each of ``fns`` in µs: the median over
    ``rounds`` of ``perf_counter`` over ``reps`` back-to-back calls, the
    functions taking turns within each round and the card synchronised
    before each. ``reps`` launches stay well inside the card's launch
    queue, so the host never waits for the device."""
    for fn in fns.values():
        fn()
    times: Dict[str, list] = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[k].append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def make_banded_indices(n: int, seed: int = 0) -> np.ndarray:
    """Monotonic-ish indices with drift, like real column tables (a copy of
    ``scripts/pallas_probe.py`` ``make_banded_indices``)."""
    rng = np.random.default_rng(seed)
    drift = np.cumsum(rng.integers(-2, 3, size=n))
    return np.clip(np.arange(n) + drift, 0, n - 1).astype(np.int32)


def _bf16(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev, torch.bfloat16)


def check_exact(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference of a kernel's output and its plain version's
    (0 where both hold the same inf); raises unless they are bit-exact."""
    diff = torch.where(got == want, 0.0, (got.float() - want.float()).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (max abs err {err})")
    return err


def gather_bytes(src: torch.Tensor, idx: torch.Tensor,
                 index_bytes: int) -> int:
    """Bytes a gather of ``src[idx]`` must move: each distinct source row
    it reaches read once, the output written, the index read."""
    row = src.shape[1] * src.element_size()
    reached = idx[(idx >= 0) & (idx < src.shape[0])]
    return (int(torch.unique(reached).numel()) + idx.shape[0]) * row \
        + index_bytes


def _gathers(name: str, kernel: Callable[[], torch.Tensor],
             plain: Callable[[], torch.Tensor], src: torch.Tensor,
             idx: torch.Tensor, index_bytes: int, plan_bytes: int):
    """Check ``kernel`` against ``plain`` and against ``src[idx]`` (``idx``
    the absolute indices, all inside their windows); on the card, time the
    four gathers of the same rows. Returns the result and the calls whose
    device time ``run`` reads."""
    n = idx.shape[0]
    got, want = kernel(), plain()
    res: Dict[str, object] = {"probe": name, "rows": n,
                              "max_abs_err": check_exact(name, got, want)}
    check_exact(f"{name} vs src[idx]", want, src[idx.long()])
    if not src.is_cuda:
        return res, {}
    idx_l = idx.long()
    calls = {"kernel": kernel,
             "gather_rows": lambda: gather.gather_rows(src, idx),
             "plain": plain,
             "index_select": lambda: torch.index_select(src, 0, idx_l)}
    res["ms"] = time_ms(calls)
    res["ns_per_row"] = {k: v * 1e6 / n for k, v in res["ms"].items()}
    res["bound_bytes"] = gather_bytes(src, idx, index_bytes)
    res["bound_ms"] = res["bound_bytes"] / HBM_BYTES_PER_S * 1e3
    res["plan_bytes"] = plan_bytes
    del calls["plain"]
    return res, calls


def probe_smoke(dev: torch.device):
    x = torch.ones((256, 128), dtype=torch.bfloat16, device=dev)
    out = probe.probe_scale2(x)
    if not bool((out == 2.0).all()):
        raise AssertionError("smoke: 2 * ones is not all 2")
    res: Dict[str, object] = {
        "probe": "smoke", "ok": True,
        "max_abs_err": check_exact("smoke", out, probe.probe_scale2_plain(x))}
    if dev.type != "cuda":
        return res, {}
    calls = {"kernel": lambda: probe.probe_scale2(x),
             "torch.mul": lambda: torch.mul(x, 2.0),
             "plain": lambda: probe.probe_scale2_plain(x)}
    res["ms"] = time_ms(calls)
    res["bound_bytes"] = 2 * x.numel() * x.element_size()
    del calls["plain"]
    return res, calls


def probe_launch(dev: torch.device):
    """Host µs of one ``probe_scale2`` call beside ``torch.mul``'s, and of
    each step of the wrapper's launch: its checks, ``empty_like``, the
    device and stream reads, the C call itself (straight through ctypes, so
    not counted in ``probe_scale2.launches``), and the two paths of
    ``kernels/launch.py`` that this card does not take: the device switch
    and the public stream read."""
    res: Dict[str, object] = {"probe": "launch"}
    if dev.type != "cuda":
        return res, {}
    x = torch.ones((256, 128), dtype=torch.bfloat16, device=dev)
    index = x.get_device()
    fn = probe.load_library().d3_probe_scale2
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), x.numel(),
            launch.current_stream(index))

    def device_switch():
        with torch.cuda.device(index):
            pass

    res["host_us"] = host_us({
        "probe_scale2": lambda: probe.probe_scale2(x),
        "torch.mul": lambda: torch.mul(x, 2.0),
        "checks": lambda: probe._on_card("probe_scale2", x),
        "empty_like": lambda: torch.empty_like(x),
        "current_device": launch._current_device,
        "raw_stream": lambda: launch.current_stream(index),
        "c_call": lambda: fn(*args),
        "device_switch": device_switch,
        "public_stream": lambda: torch.cuda.current_stream(index).cuda_stream,
    })
    return res, {}


def band_case(n: int, c: int, ch: int):
    """The TPU probe's band data (seed 0): src (n, c) and indices strictly
    inside the three-chunk band of their chunk."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal((n, c))
    base = np.arange(n)
    off = rng.integers(-ch // 2, ch // 2, size=n)
    idx = np.clip(base + off, 0, n - 1)
    j = base // ch
    idx = np.clip(idx, np.maximum((j - 1) * ch, 0),
                  np.minimum((j + 2) * ch, n) - 1).astype(np.int32)
    return src, idx


def probe_band(dev: torch.device, n: int, c: int, ch: int):
    src_np, idx_np = band_case(n, c, ch)
    src, idx = _bf16(src_np, dev), torch.from_numpy(idx_np).to(dev)
    b = src.element_size()
    res, calls = _gathers("band", lambda: probe.window3_gather(src, idx, ch),
                          lambda: probe.window3_gather_plain(src, idx, ch),
                          src, idx, 4 * n, 3 * n * c * b + n * c * b + 4 * n)
    if dev.type == "cuda":
        plan = probe.window3_ring_plan(n, ch, c * b,
                                       probe._sm_count(src.get_device()))
        res["plan"] = plan._asdict()
        res["moved_bytes"] = plan.moved_bytes
    return res, calls


def prefetch_case(n: int, c: int, ch: int, wblk: int, nwin: int):
    """The TPU probe's prefetch data (seed 1): src, absolute indices, the
    per-chunk window bases (wblk units) and rel = idx - base * wblk."""
    rng = np.random.default_rng(1)
    src = rng.standard_normal((n, c)).astype(np.float32)
    wtot = nwin * wblk
    spread = (wtot - wblk - ch) // 2
    idx = np.clip(np.arange(n) + rng.integers(-spread, spread + 1, size=n),
                  0, n - 1).astype(np.int32)
    per = idx.reshape(n // ch, ch)
    bases = np.minimum(np.maximum(per.min(1) // wblk, 0),
                       (n - wtot) // wblk).astype(np.int32)
    rel = (per - bases[:, None] * wblk).reshape(n).astype(np.int32)
    if (rel < 0).any() or (rel >= wtot).any():
        raise AssertionError("prefetch: band violated")
    return src, idx, bases, rel


def prefetch_patterns(nchunk: int, chunk: int, wblk: int, nwin: int,
                      n_src: int) -> Dict[str, np.ndarray]:
    """Window bases (wblk units) of ``nchunk`` chunks that put the ring
    kernel of ``prefetch_window_gather`` through each of its cases:
    ``banded`` (about ``chunk / wblk`` blocks a chunk, as the probe's
    data), ``constant``, an advance of exactly ``R - nwin`` blocks a chunk
    (``advance_max``, the most that needs no deferred copy) and of one more
    (``advance_over``), ``backward``, ``negative`` (windows wholly and
    partly below row 0), ``past_end`` (wholly and partly past ``n_src``)
    and ``random`` jumps both ways (numpy seed 0); ``R`` as
    ``prefetch_ring_plan`` makes it."""
    step = -(-chunk // wblk)
    top = -(-n_src // wblk)                 # source blocks, the last partial
    j = np.arange(nchunk)
    rng = np.random.default_rng(0)
    pats = {"banded": np.maximum(j * step - 1, 0),
            "constant": np.full(nchunk, top // 2),
            "advance_max": j * step,
            "advance_over": j * (step + 1),
            "backward": (nchunk - 1 - j) * step,
            "negative": j % (nwin + 3) - nwin - 1,
            "past_end": top - nwin + j % (nwin + 2),
            "random": rng.integers(-nwin - 2, top + 2, nchunk)}
    return {k: v.astype(np.int32) for k, v in pats.items()}


def probe_prefetch(dev: torch.device, n: int, c: int, ch: int,
                   wblk: int = 128, nwin: int = 6):
    src_np, idx_np, bases_np, rel_np = prefetch_case(n, c, ch, wblk, nwin)
    src = _bf16(src_np, dev)
    idx = torch.from_numpy(idx_np).to(dev)
    rel = torch.from_numpy(rel_np).to(dev)
    bases = torch.from_numpy(bases_np).to(dev)
    kw = dict(chunk=ch, wblk=wblk, nwin=nwin)
    b = src.element_size()
    nchunk = n // ch
    index_bytes = 4 * n + 4 * nchunk
    plan_bytes = nchunk * nwin * wblk * c * b + n * c * b + index_bytes
    res, calls = _gathers(
        "prefetch",
        lambda: probe.prefetch_window_gather(src, rel, bases, **kw),
        lambda: probe.prefetch_window_gather_plain(src, rel, bases, **kw),
        src, idx, index_bytes, plan_bytes)
    if dev.type == "cuda":
        plan = probe.prefetch_ring_plan(n, ch, wblk, nwin, c * b,
                                        probe._sm_count(src.get_device()))
        res["plan"] = plan._asdict()
        res["moved_bytes"] = probe.prefetch_ring_moved_bytes(
            bases_np, plan, n, n, wblk, nwin, c * b)
    return res, calls


def probe_gather(dev: torch.device, n: int, c: int):
    """``gather_rows`` and ``index_select`` on banded and random indices."""
    rng = np.random.default_rng(0)
    src = _bf16(rng.standard_normal((n, c)), dev)
    res: Dict[str, object] = {"probe": "gather", "rows": n}
    for name, idx_np in (("banded", make_banded_indices(n)),
                         ("random", rng.integers(0, n, size=n)
                          .astype(np.int32))):
        idx = torch.from_numpy(idx_np).to(dev)
        got = gather.gather_rows(src, idx)
        check_exact(f"gather {name}", got, gather.gather_rows_plain(src, idx))
        if dev.type == "cuda":
            idx_l = idx.long()
            ms = time_ms({"gather_rows": lambda: gather.gather_rows(src, idx),
                          "index_select": lambda: torch.index_select(
                              src, 0, idx_l)})
            res[name] = {
                "ms": ms, "ns_per_row": {k: v * 1e6 / n for k, v in ms.items()},
                "bound_ms": gather_bytes(src, idx, 4 * n)
                / HBM_BYTES_PER_S * 1e3}
    return res, {}


PROBES = ("smoke", "band", "prefetch", "gather")   # the default run
EXTRA = ("launch",)                                # asked for by name


def run(what, dev: torch.device, n: int, c: int,
        ch: int) -> List[Dict[str, object]]:
    """Run the named probes in order; one result dict each. On the card
    every per-call and host time of the run is taken first and the device
    times (``device_ms``) after them all, so that no ``torch.profiler``
    session runs before a timed call."""
    probes = {"smoke": lambda: probe_smoke(dev),
              "band": lambda: probe_band(dev, n, c, ch),
              "prefetch": lambda: probe_prefetch(dev, n, c, ch),
              "gather": lambda: probe_gather(dev, n, c),
              "launch": lambda: probe_launch(dev)}
    for w in what:
        if w not in probes:
            raise ValueError(f"unknown probe {w!r}; choose from "
                             f"{PROBES + EXTRA}")
    done = [probes[w]() for w in what]
    for res, profiled in done:
        if profiled:
            res["device_ms"] = {k: device_ms(fn) for k, fn in profiled.items()}
    return [res for res, _ in done]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", default=",".join(PROBES),
                    help=f"comma-separated, of {PROBES + EXTRA}")
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--c", type=int, default=128)
    ap.add_argument("--ch", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"device": name, "n": args.n, "c": args.c,
                      "ch": args.ch}), flush=True)
    for res in run(args.what.split(","), dev, args.n, args.c, args.ch):
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
