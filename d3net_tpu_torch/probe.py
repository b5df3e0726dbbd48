"""Banded-gather probe: does staging a window of source rows in shared
memory beat a direct row gather?

    python -m d3net_tpu_torch.probe [--what smoke,band,prefetch,gather]
                                    [--n 262144 --c 128 --ch 512]
                                    [--device cpu]

Counterpart of ``scripts/pallas_probe.py`` (its TPU question, asked of
Hopper). Each probe builds the TPU probe's own data (same construction,
numpy seeds 0 and 1), checks its kernel bit-exact against the plain
version, and on the card times with CUDA events (median of 5 passes of
``INNER`` launches):

- ``smoke``:    ``probe_scale2`` on a (256, 128) bf16 block of ones;
- ``band``:     ``window3_gather`` (three-chunk window) on in-band indices;
- ``prefetch``: ``prefetch_window_gather`` (``nwin * wblk``-row window
  from a per-chunk base) on indices that fit their window;
- ``gather``:   ``gather_rows`` and ``torch.index_select`` on banded and on
  random indices (the TPU probe's "XLA take" baseline).

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
from typing import Callable, Dict, Optional

import numpy as np
import torch

from d3net_tpu_torch.device import resolve_device
from d3net_tpu_torch.kernels import gather, probe

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
REPS = 5
INNER = 10


def time_ms(fn: Callable[[], object], reps: int = REPS,
            inner: int = INNER) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


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
             idx: torch.Tensor, index_bytes: int,
             plan_bytes: int) -> Dict[str, object]:
    """Check ``kernel`` against ``plain`` and against ``src[idx]`` (``idx``
    the absolute indices, all inside their windows); on the card, time the
    four gathers of the same rows."""
    n = idx.shape[0]
    got, want = kernel(), plain()
    res: Dict[str, object] = {"probe": name, "rows": n,
                              "max_abs_err": check_exact(name, got, want)}
    check_exact(f"{name} vs src[idx]", want, src[idx.long()])
    if src.is_cuda:
        idx_l = idx.long()
        ms = {"kernel": time_ms(kernel),
              "gather_rows": time_ms(lambda: gather.gather_rows(src, idx)),
              "plain": time_ms(plain),
              "index_select": time_ms(
                  lambda: torch.index_select(src, 0, idx_l))}
        res["ms"] = ms
        res["ns_per_row"] = {k: v * 1e6 / n for k, v in ms.items()}
        res["bound_bytes"] = gather_bytes(src, idx, index_bytes)
        res["bound_ms"] = res["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        res["plan_bytes"] = plan_bytes
    return res


def probe_smoke(dev: torch.device) -> Dict[str, object]:
    x = torch.ones((256, 128), dtype=torch.bfloat16, device=dev)
    out = probe.probe_scale2(x)
    if not bool((out == 2.0).all()):
        raise AssertionError("smoke: 2 * ones is not all 2")
    res: Dict[str, object] = {
        "probe": "smoke", "ok": True,
        "max_abs_err": check_exact("smoke", out, probe.probe_scale2_plain(x))}
    if dev.type == "cuda":
        res["ms"] = time_ms(lambda: probe.probe_scale2(x))
        res["bound_bytes"] = 2 * x.numel() * x.element_size()
    return res


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


def probe_band(dev: torch.device, n: int, c: int,
               ch: int) -> Dict[str, object]:
    src_np, idx_np = band_case(n, c, ch)
    src, idx = _bf16(src_np, dev), torch.from_numpy(idx_np).to(dev)
    b = src.element_size()
    return _gathers("band", lambda: probe.window3_gather(src, idx, ch),
                    lambda: probe.window3_gather_plain(src, idx, ch),
                    src, idx, 4 * n, 3 * n * c * b + n * c * b + 4 * n)


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


def probe_prefetch(dev: torch.device, n: int, c: int, ch: int,
                   wblk: int = 128, nwin: int = 6) -> Dict[str, object]:
    src_np, idx_np, bases_np, rel_np = prefetch_case(n, c, ch, wblk, nwin)
    src = _bf16(src_np, dev)
    idx = torch.from_numpy(idx_np).to(dev)
    rel = torch.from_numpy(rel_np).to(dev)
    bases = torch.from_numpy(bases_np).to(dev)
    kw = dict(chunk=ch, wblk=wblk, nwin=nwin)
    b = src.element_size()
    nchunk = n // ch
    index_bytes = 4 * n + 4 * nchunk
    plan = nchunk * nwin * wblk * c * b + n * c * b + index_bytes
    return _gathers("prefetch",
                    lambda: probe.prefetch_window_gather(src, rel, bases, **kw),
                    lambda: probe.prefetch_window_gather_plain(src, rel, bases,
                                                               **kw),
                    src, idx, index_bytes, plan)


def probe_gather(dev: torch.device, n: int, c: int) -> Dict[str, object]:
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
            ms = {"gather_rows": time_ms(lambda: gather.gather_rows(src, idx)),
                  "index_select": time_ms(
                      lambda: torch.index_select(src, 0, idx_l))}
            res[name] = {
                "ms": ms, "ns_per_row": {k: v * 1e6 / n for k, v in ms.items()},
                "bound_ms": gather_bytes(src, idx, 4 * n)
                / HBM_BYTES_PER_S * 1e3}
    return res


PROBES = ("smoke", "band", "prefetch", "gather")


def run(what, dev: torch.device, n: int, c: int, ch: int):
    """Run the named probes in order; yields one result dict each."""
    for w in what:
        if w == "smoke":
            yield probe_smoke(dev)
        elif w == "band":
            yield probe_band(dev, n, c, ch)
        elif w == "prefetch":
            yield probe_prefetch(dev, n, c, ch)
        elif w == "gather":
            yield probe_gather(dev, n, c)
        else:
            raise ValueError(f"unknown probe {w!r}; choose from {PROBES}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", default=",".join(PROBES))
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
