#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``d3net_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   — the card's name and ``nvidia-smi`` name/power limit.
2. build    — nvcc builds every kernel source of ``csrc/`` (one nvcc per
              source, all started together).
3. kernel   — each kernel against its plain PyTorch version on the card,
              bit-exact: random f32/bf16/int32 rows with pad sentinels and
              out-of-range indices, and the JAX band_gather test plans.
4. probe    — the three probe kernels (``kernels/probe.py``) bit-exact
              against their plain versions on random cases (edge chunks,
              out-of-window rel, f32/bf16, C in 64/128/256, and both
              rings' run edges: nchunk in {1, 2, 3, L-1, L, L+1, 2L+1} at
              rows of 128-1024 bytes, with every plan that a card of 1 to
              all of this card's SMs gets; ``prefetch_window_gather`` also
              on every bases pattern of ``probe.prefetch_patterns``), the
              two rings' plans at the probe's size (line ``probe_plan``),
              then the probe entry point
              (``d3net_tpu_torch.probe``) at its own size (n=262144, c=128
              bf16, ch=512, wblk=128, nwin=6), its launches counted (counts
              set to 0 just before), with per-call ``ms`` of each kernel
              beside its plain version and library call (taking turns),
              then their profiled ``device_ms``.
5. parity   — the tests/test_detector.py config in f32 with TF32 off
              (``device.parity_precision``, this phase only): the
              port on ``cuda`` against the port on ``cpu``, same weights.
              Floats within rtol 1e-4 / atol 1e-5; integer outputs are
              reported (atomic sums may flip a clustering threshold).
6. train_parity — one train step of that config, f32 with TF32 off, on
              ``cuda`` against ``cpu``, same weights, same injected
              ``jitter_u`` and ``proposal_perm``, with and without
              clustering: losses and grad_norm rtol 1e-4, every gradient
              rtol 1e-3 / atol 1e-6, new BN statistics rtol 1e-4 / atol
              1e-5; integer outputs reported (with clustering, a reported
              flip leaves only the pre-clustering losses held). The cuda
              step takes each ReLU's side from the cpu step's input, and
              an input that changes side must lie within 1e-5 (relative)
              of the kink.
7. flagship — the B=4 flagship detector forward (7-level U-Net, 131072
              voxel caps, 134 input channels, bf16) through
              ``load_detector``, at PyTorch's default precision settings
              (those a user gets): the batch's real kernel maps through
              ``gather_rows`` and ``band_gather`` (bit-exact), host collate
              time, forward time (CUDA events, median of 7), peak memory,
              finite outputs, and the gather launches of one forward
              (counts reset just before).
8. profile  — device time by kernel and by op over one flagship forward
              (torch.profiler) and the device's idle share.
9. kernels  — every gather of that forward replayed through the kernel,
              its plain version and ``torch.index_select`` (the library
              yardstick; the port never calls it); any call whose kernel
              output differs from the plain version's fails the run, naming
              its dtype and width. The bound is the bytes at 3.35 TB/s;
              ``device_ms`` is the profiled device time of one replay.
10. train   — the flagship B=4 train step through ``create_train_state``
              and ``detector_train_step`` at PyTorch's defaults: 2 warm-up
              and 5 timed steps (CUDA events), peak memory, every step's
              losses and grad_norm (all finite), the gather launches of one
              step (counts set to 0 just before: forward 71 convs + 4 row
              gathers, a dW re-gather per conv, a dx gather per conv but
              the input conv's), each of them held bit-exact against the
              plain version as it runs and its bytes counted (the train
              path's bound), and one profiled step (train_profile, which
              gives the train path's ``gather_rows`` device time).

Then the ``kernels`` line: one entry per kernel, with its launches on its
path, ``max_abs_err``, per-call ``ms``, profiled ``device_ms``, the plain
version's and the library call's time (``library_ms``,
``library_device_ms``) and the bound; the two rings add the bytes their
blocks move (``moved_bytes``). The last two lines are
``nvidia-smi``'s name/power limit and ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, the script exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from d3net_tpu_torch import device
from d3net_tpu_torch import probe as probe_cli
from d3net_tpu_torch.probe import check_exact, device_ms, time_ms
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.kernels import gather, probe
from d3net_tpu_torch.models.blocks import SubmConv, fold_tables
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.ops import segment, sparse_conv
from d3net_tpu_torch.params import (
    flagship_config, flatten, init_flax_variables, load_detector,
    state_dict_to_flax,
)
from d3net_tpu_torch.train.trainer import (
    create_train_state, detector_train_step,
)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
KINK_NOISE = 1e-5     # largest ReLU input, relative, that may change side
FWD_REPS = 7
KERNEL_REPS = 5
TRAIN_WARMUP, TRAIN_REPS = 2, 5

SMALL_CFG = dict(m=8, blocks=(1, 2, 3), cluster_blocks=(1, 2),
                 clusters_per_pass=16, max_num_proposal=8,
                 cluster_npoint_thre=30, test_npoint_thresh=30,
                 test_score_thresh=0.0, cluster_ring=1, cluster_cell_size=0.03,
                 cluster_prop_iters=4)
SMALL_SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
                   floor_points=1000, room=4.0)
SMALL_SPEC = dict(max_points=3072, voxel_caps=[3072, 1536, 768],
                  max_instances=8, use_multiview=False, use_normal=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def randomize(tree, rng):
    """Nonzero biases and BN statistics (as the CPU parity tests use)."""
    for k, val in tree.items():
        if isinstance(val, dict):
            randomize(val, rng)
        elif k in ("bias", "mean"):
            tree[k] = rng.normal(0.0, 0.1, val.shape).astype(np.float32)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    return tree


# --------------------------------------------------------------------------
def phase_build():
    """Each kernel module's ``load_library`` (nvcc at first use), all
    started together."""
    t0 = time.time()
    modules = (gather, probe)
    with ThreadPoolExecutor(len(modules)) as pool:
        list(pool.map(lambda m: m.load_library(), modules))
    emit({"phase": "build", "sources": [m.SOURCE for m in modules],
          "seconds": round(time.time() - t0, 3)})


def phase_kernel():
    """Kernel vs plain, bit-exact, on random rows and band plans."""
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = 0
    for dtype in gather.DTYPES:
        for c in (1, 2, 3, 16, 20, 32, 48, 112, 134):
            src = torch.randint(-1000, 1000, (4099, c), generator=g,
                                device="cuda").to(dtype)
            if dtype != torch.int32:
                src = src / 7
            # 4099 is the pad sentinel; -2, -1, 4100 and 4101 out of range
            idx = torch.randint(-2, 4102, (50001,), generator=g, device="cuda",
                                dtype=torch.int32)
            got = gather.gather_rows(src, idx)
            want = gather.gather_rows_plain(src, idx)
            if not torch.equal(got, want):
                raise AssertionError(f"gather_rows {dtype} C={c} disagrees")
            if not (got[(idx < 0) | (idx >= 4099)] == 0).all():
                raise AssertionError("pad or out-of-range index did not read "
                                     "zeros")
            cases += 1
    rng = np.random.default_rng(0)
    for n, spread, chunk, nwin, c, dtype in (
            (4096, 150, 512, 8, 128, torch.bfloat16),
            (4096, 150, 512, 8, 256, torch.bfloat16),
            (2048, 40, 256, 4, 128, torch.float32)):
        idx = np.clip(np.arange(n) + rng.integers(-spread, spread + 1, n),
                      0, n - 1).astype(np.int32)
        if n == 2048:
            idx[:64] = 0
            idx[100:110] = idx[99]
        plan = gather.plan_band_windows(idx, n, chunk=chunk, wblk=128,
                                        nwin=nwin)
        src = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
        src = src.to("cuda", dtype)
        got = gather.band_gather(src, plan)
        if not torch.equal(got, src[torch.from_numpy(idx).cuda().long()]):
            raise AssertionError(f"band_gather n={n} C={c} disagrees")
        cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel", "cases": cases, "exact": True})


def phase_probe():
    """The probe kernels on random cases, then the probe entry point at its
    own size with its launches counted; returns their ``kernels`` entries."""
    g = torch.Generator(device="cuda").manual_seed(2)
    err = {"probe_scale2": 0.0, "window3_gather": 0.0,
           "prefetch_window_gather": 0.0}
    cases = 0
    for n in (1, 7, 8, 4096, 100003):
        x = (torch.randn(n + 1, generator=g, device="cuda") * 1e3).bfloat16()
        x[n // 2] = 3.0e38                  # 2x overflows to inf in both
        for t in (x[:n], x[1:]):            # 16-byte aligned, and 2 B off
            err["probe_scale2"] = max(err["probe_scale2"], check_exact(
                f"probe_scale2 n={n}", probe.probe_scale2(t),
                probe.probe_scale2_plain(t)))
            cases += 1

    def window3_case(dtype, c, ch, nchunk, plan=None):
        n = ch * nchunk
        src = torch.randn(n, c, generator=g, device="cuda").to(dtype)
        # below 0 aliases into chunk 0's repeated block, past n into the
        # last chunk's; beyond a chunk's band reads zeros
        idx = torch.randint(-ch - 3, n + ch + 3, (n,), generator=g,
                            device="cuda", dtype=torch.int32)
        err["window3_gather"] = max(err["window3_gather"], check_exact(
            f"window3_gather {dtype} C={c} ch={ch} n={n} plan={plan}",
            probe.window3_gather(src, idx, ch, plan),
            probe.window3_gather_plain(src, idx, ch)))

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def prefetch_case(dtype, c, n_src, n, bases, chunk, wblk, nwin, what):
        """Random rel (a margin outside the window too), with every plan
        that a card of 1 to `sms` SMs gets; returns the number of plans."""
        src = torch.randn(n_src, c, generator=g, device="cuda").to(dtype)
        rel = torch.randint(-20, nwin * wblk + 20, (n,), generator=g,
                            device="cuda", dtype=torch.int32)
        bases = torch.from_numpy(bases).cuda()
        kw = dict(chunk=chunk, wblk=wblk, nwin=nwin)
        want = probe.prefetch_window_gather_plain(src, rel, bases, **kw)
        row = c * src.element_size()
        plans = {p.run_chunks: p for p in (
            probe.prefetch_ring_plan(n, chunk, wblk, nwin, row, s)
            for s in range(1, sms + 1))}
        for plan in plans.values():
            err["prefetch_window_gather"] = max(
                err["prefetch_window_gather"], check_exact(
                    f"prefetch_window_gather {dtype} C={c} n={n} chunk={chunk}"
                    f" wblk={wblk} nwin={nwin} {what} plan={plan}",
                    probe.prefetch_window_gather(src, rel, bases, plan=plan,
                                                 **kw), want))
        return len(plans)

    for dtype in probe.DTYPES:
        for c in (64, 128, 256):
            for ch, nchunk in ((512, 6), (128, 1), (128, 5)):
                window3_case(dtype, c, ch, nchunk)
                cases += 1
            # the ring's run edges: L is the plan's run length at the
            # probe's size for this row width; each nchunk runs with every
            # plan that a card of 1 to `sms` SMs gets (this card's among
            # them), so runs of every length the plan picks end everywhere
            row = c * torch.empty((), dtype=dtype).element_size()
            for ch in (128, 512):
                run = probe.window3_ring_plan(262144, ch, row, sms).run_chunks
                for nchunk in sorted({1, 2, 3, max(run - 1, 1), run, run + 1,
                                      2 * run + 1}):
                    plans = {p.run_chunks: p for p in (
                        probe.window3_ring_plan(ch * nchunk, ch, row, s)
                        for s in range(1, sms + 1))}
                    for plan in plans.values():
                        window3_case(dtype, c, ch, nchunk, plan)
                        cases += 1
            # prefetch_window_gather's ring: its run edges (nchunk in {1, 2,
            # 3, L-1, L, L+1, 2L+1}, whole and ragged) on banded bases at the
            # probe's geometry, then every bases pattern of
            # probe_cli.prefetch_patterns at three block geometries
            # (100-row blocks: the division path; 384-row blocks: two TMA
            # boxes a slot), a ragged last chunk and a partial last block
            run = probe.prefetch_ring_plan(262144, 512, 128, 6, row,
                                           sms).run_chunks
            for nchunk in sorted({1, 2, 3, max(run - 1, 1), run, run + 1,
                                  2 * run + 1}):
                n_src = nchunk * 512 + 3 * 128 - 37
                bases = probe_cli.prefetch_patterns(nchunk, 512, 128, 6,
                                                    n_src)["banded"]
                for n in (nchunk * 512, nchunk * 512 - 37):
                    cases += prefetch_case(dtype, c, n_src, n, bases, 512,
                                           128, 6, "banded")
            for chunk, wblk, nwin in ((512, 128, 6), (200, 100, 3),
                                      (300, 384, 2)):
                nchunk, step = 13, -(-chunk // wblk)
                n_src = ((nchunk - 1) * (step + 1) + nwin + 1) * wblk - 37
                for what, bases in probe_cli.prefetch_patterns(
                        nchunk, chunk, wblk, nwin, n_src).items():
                    cases += prefetch_case(dtype, c, n_src,
                                           nchunk * chunk - 37, bases, chunk,
                                           wblk, nwin, what)
    torch.cuda.synchronize()

    emit({"phase": "probe_plan", "n": 262144, "row_bytes": 256, "sms": sms,
          "window3_gather": {"ch": 512, **probe.window3_ring_plan(
              262144, 512, 256, sms)._asdict()},
          "prefetch_window_gather": {
              "chunk": 512, "wblk": 128, "nwin": 6,
              **probe.prefetch_ring_plan(262144, 512, 128, 6, 256,
                                         sms)._asdict()}})

    # the probe path, counted: counts set to 0 just before, read after
    kernels = (probe.probe_scale2, probe.window3_gather,
               probe.prefetch_window_gather)
    for k in kernels:
        k.launches = 0
    dev = torch.device("cuda")
    res = {r["probe"]: r for r in probe_cli.run(
        probe_cli.PROBES, dev, n=262144, c=128, ch=512)}
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    if not all(launches.values()):
        raise AssertionError(f"a probe kernel was not launched: {launches}")
    emit({"phase": "probe", "random_cases": cases, "launches": launches,
          "results": res})

    smoke = res["smoke"]
    entries = [{
        "name": "probe_scale2", "route": "cuda",
        "source": "d3net_tpu_torch/csrc/probe_kernels.cu",
        "replaces": "scripts/pallas_probe.py:62",
        "launches": launches["probe_scale2"],
        "max_abs_err": max(err["probe_scale2"], smoke["max_abs_err"]),
        "ms": smoke["ms"]["kernel"], "device_ms": smoke["device_ms"]["kernel"],
        "plain_ms": smoke["ms"]["plain"],
        "bound_ms": smoke["bound_bytes"] / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": smoke["ms"]["torch.mul"],
        "library_device_ms": smoke["device_ms"]["torch.mul"],
    }]
    for name, key, line in (("window3_gather", "band", 84),
                            ("prefetch_window_gather", "prefetch", 210)):
        r = res[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "d3net_tpu_torch/csrc/probe_kernels.cu",
            "replaces": f"scripts/pallas_probe.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(err[name], r["max_abs_err"]),
            "ms": r["ms"]["kernel"], "device_ms": r["device_ms"]["kernel"],
            "plain_ms": r["ms"]["plain"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "plan_bytes": r["plan_bytes"],
            "library_ms": r["ms"]["index_select"],
            "library_device_ms": r["device_ms"]["index_select"]})
    entries[1]["moved_bytes"] = res["band"]["moved_bytes"]
    entries[2]["moved_bytes"] = res["prefetch"]["moved_bytes"]
    return entries


def small_case():
    """The small config's B=2 batch and random weights."""
    scenes = [make_scene(seed=i, **SMALL_SCENE) for i in range(2)]
    batch_np = build_batch(scenes, BatchSpec(**SMALL_SPEC))
    in_ch = batch_np["point_feats"].shape[-1] + 3
    variables = init_flax_variables(PointGroup(in_ch, **SMALL_CFG), seed=0)
    randomize(variables, np.random.default_rng(0))
    return batch_np, variables


def phase_parity():
    """Small config: the port on cuda vs the port on cpu, same weights."""
    batch_np, variables = small_case()
    outs = {}
    with device.parity_precision(), torch.no_grad():
        for dev in ("cpu", "cuda"):
            model = load_detector(variables, SMALL_CFG, device=dev)
            out = model(batch_to_torch(batch_np, dev))
            outs[dev] = {k: v.cpu() for k, v in out.items()}
    cpu, gpu = outs["cpu"], outs["cuda"]
    ints = {k: bool(torch.equal(cpu[k], gpu[k])) for k in cpu
            if not cpu[k].is_floating_point()}
    errs, bad = {}, []
    for k in cpu:
        if cpu[k].is_floating_point():
            d = (gpu[k] - cpu[k]).abs()
            errs[k] = float(d.max())
            if not torch.allclose(gpu[k], cpu[k], rtol=PARITY_RTOL,
                                  atol=PARITY_ATOL):
                bad.append(k)
    # with equal clusters everything must agree; after a reported flip only
    # the stages before clustering are held to the tolerance
    held = bad if all(ints.values()) else [
        k for k in bad if k in ("semantic_scores", "pt_offsets", "pt_feats")]
    emit({"phase": "parity", "integers_equal": ints, "max_abs_err": errs,
          "outside_tolerance": bad, "rtol": PARITY_RTOL, "atol": PARITY_ATOL})
    if held:
        raise AssertionError(f"cuda vs cpu outside tolerance: {held}")


@contextlib.contextmanager
def relu_sides(ref, record):
    """Stands in for ``F.relu`` for one train step. ``record``: keeps each
    call's input (the reference step, on the cpu). Otherwise each call
    takes the side of the kink the reference's input took (``x * (ref >
    0)``), and the yielded dict counts the inputs whose own side differs
    and the largest of those inputs, relative to the call's largest input.

    An input within float noise of 0 can land on either side of the kink
    when sums run in another order, and that one element's gradient then
    reaches every layer before it (seen on the card: one ScoreNet element
    at 1e-8 on the cpu, -1e-7 on cuda). Following the reference's side
    keeps the gradients comparable; ``KINK_NOISE`` bounds the crossings."""
    real = F.relu
    calls = iter(ref)
    seen = {"crossings": 0, "largest": 0.0}

    def relu(x, inplace=False):
        if record:
            ref.append(x.detach().clone())
            return real(x, inplace)
        want = next(calls).to(x.device)
        side = want > 0
        cross = side != (x.detach() > 0)
        if bool(cross.any()):
            size = max(float(want.abs().max()), 1e-30)
            near = torch.maximum(want[cross].abs(), x.detach()[cross].abs())
            seen["crossings"] += int(cross.sum())
            seen["largest"] = max(seen["largest"], float(near.max()) / size)
        return x * side

    F.relu = relu
    try:
        yield seen
    finally:
        F.relu = real
    if not record and next(calls, None) is not None:
        raise AssertionError("the step made fewer ReLU calls than the "
                             "reference")


def _train_once(variables, batch_np, dev, do_clustering, jitter, perm,
                relu_ref, record):
    """One small-config train step on ``dev`` (ReLU sides recorded into or
    taken from ``relu_ref``): metrics, gradients, new BN statistics, the
    kink crossings, and (with clustering) the integer outputs of the same
    train-mode forward."""
    model = load_detector(variables, SMALL_CFG, device=dev)
    state = create_train_state(model)
    batch = batch_to_torch(batch_np, dev)
    kw = dict(jitter_u=torch.from_numpy(jitter).to(dev),
              proposal_perm=torch.from_numpy(perm).to(dev)[None])
    with relu_sides(relu_ref, record) as kinks:
        _, metrics = detector_train_step(state, batch,
                                         do_clustering=do_clustering, **kw)
    grads = flatten(state_dict_to_flax(
        model, {n: p.grad for n, p in model.named_parameters()})["params"])
    stats = flatten(state_dict_to_flax(model)["batch_stats"])
    ints = {}
    if do_clustering:
        fresh = load_detector(variables, SMALL_CFG, device=dev)
        with torch.no_grad():
            out = fresh(batch, train=True, **kw)
        ints = {k: v.cpu() for k, v in out.items()
                if not v.is_floating_point()}
    return ({k: float(v) for k, v in metrics.items()}, grads, stats, ints,
            kinks)


def phase_train_parity():
    """Small config, f32, TF32 off: a train step on cuda vs on cpu."""
    batch_np, variables = small_case()
    rng = np.random.default_rng(3)
    b = batch_np["point_mask"].shape[0]
    jitter = rng.random((b, 2 * SMALL_CFG["clusters_per_pass"], 3)).astype(
        np.float32)
    perm = rng.permutation(SMALL_CFG["max_num_proposal"])
    report, held_bad = {}, []
    with device.parity_precision():
        for do_clustering in (True, False):
            relu_ref = []
            cpu, gpu = (_train_once(variables, batch_np, dev, do_clustering,
                                    jitter, perm, relu_ref, dev == "cpu")
                        for dev in ("cpu", "cuda"))
            kinks, bad = gpu[4], []
            if kinks["largest"] > KINK_NOISE:
                bad.append("relu_kink_crossing")
            ints = {k: bool(torch.equal(cpu[3][k], gpu[3][k])) for k in cpu[3]}
            clusters_equal = all(ints.values())
            for k, want in cpu[0].items():
                if not np.isclose(gpu[0][k], want, rtol=PARITY_RTOL, atol=0):
                    bad.append(k)
            for name, (group, rtol, atol) in (
                    ("grad", (1, GRAD_RTOL, GRAD_ATOL)),
                    ("bn", (2, PARITY_RTOL, PARITY_ATOL))):
                for k, want in cpu[group].items():
                    if not np.allclose(gpu[group][k], want, rtol=rtol,
                                       atol=atol):
                        bad.append(f"{name}:{k}")
            grad_err = max(float(np.abs(gpu[1][k] - v).max())
                           for k, v in cpu[1].items())
            held = bad if clusters_equal else [
                k for k in bad if k in ("semantic_loss", "offset_norm_loss",
                                        "offset_dir_loss")]
            held_bad += held
            report["clustering" if do_clustering else "no_clustering"] = {
                "losses_cpu": cpu[0], "losses_cuda": gpu[0],
                "integers_equal": ints, "grad_max_abs_err": grad_err,
                "relu_kink_crossings": kinks, "outside_tolerance": bad}
    emit({"phase": "train_parity", **report, "loss_rtol": PARITY_RTOL,
          "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL})
    if held_bad:
        raise AssertionError(f"train step cuda vs cpu outside tolerance: "
                             f"{held_bad}")


class GatherRecorder:
    """Stands in for the ``gather`` module inside the ops that call it; the
    real wrapper (and its launch count) still runs every call. It keeps
    each call's tensors for the kernel replay, or with ``check`` holds each
    call's output against the plain version on the same tensors as the
    call happens (in the backward too) and keeps only a count and the bytes
    the calls need (``probe.gather_bytes``: distinct source rows reached,
    output, index)."""

    def __init__(self, real, check=False):
        self.real = real
        self.check = check
        self.calls = []
        self.checked = 0
        self.bytes_needed = 0

    def gather_rows(self, src, idx):
        out = self.real.gather_rows(src, idx)
        if not self.check:
            self.calls.append((src, idx))
            return out
        with torch.no_grad():
            want = self.real.gather_rows_plain(src.detach(), idx)
        if not torch.equal(out, want):
            raise AssertionError(
                f"gather {self.checked} of the train step ({src.dtype}, width "
                f"{src.shape[1]}, {idx.numel()} rows): kernel disagrees with "
                f"the plain version")
        self.checked += 1
        self.bytes_needed += probe_cli.gather_bytes(src, idx, 4 * idx.numel())
        return out


def phase_flagship():
    flag = flagship_config()
    t0 = time.time()
    scenes = [make_scene(seed=i, **flag.scene_kwargs)
              for i in range(flag.batch_size)]
    scene_s = time.time() - t0
    t0 = time.time()
    batch_np = build_batch(scenes, flag.spec)
    host_collate_s = time.time() - t0
    batch = batch_to_torch(batch_np, "cuda")
    in_ch = flag.spec.feat_dim() + 3
    variables = init_flax_variables(PointGroup(in_ch, **flag.model), seed=0)
    model = load_detector(variables, flag.model)      # cuda by default
    expected = sum(isinstance(m, SubmConv) for m in model.modules()) + 4

    # the real kernel maps of this batch through the kernel, bit-exact
    g = torch.Generator(device="cuda").manual_seed(1)
    for li, t in enumerate(fold_tables(batch["tables"])):
        for name in ("nbr", "down", "up"):
            if name not in t:
                continue
            n_src = int(t[name].max())          # the global zero-row sentinel
            src = torch.randn(n_src, 16, generator=g, device="cuda").bfloat16()
            idx = t[name].reshape(-1).contiguous()
            if not torch.equal(gather.gather_rows(src, idx),
                               gather.gather_rows_plain(src, idx)):
                raise AssertionError(f"level {li} {name}: kernel disagrees")
    # band_gather on every tap of scene 0's level-0 table that a window plan
    # fits (INVALID -> own row, as the JAX band_gather tests do); the z+-1
    # taps 12-14 are banded by the key order, so at least those plan
    nbr0 = batch_np["tables"][0]["nbr"][0]
    cap = nbr0.shape[0]
    src = torch.randn(cap, 16, generator=g, device="cuda").bfloat16()
    planned = []
    for tap in range(nbr0.shape[1]):
        idx = np.where(nbr0[:, tap] >= cap, np.arange(cap), nbr0[:, tap])
        plan = gather.plan_band_windows(idx, cap, chunk=512, wblk=128, nwin=8)
        if plan is None:
            continue
        planned.append(tap)
        want = src[torch.from_numpy(idx).to("cuda")]
        if not torch.equal(gather.band_gather(src, plan), want):
            raise AssertionError(f"band_gather on level-0 tap {tap} disagrees")
    if not {12, 13, 14} <= set(planned):
        raise AssertionError(f"z taps did not plan: planned {planned}")

    with torch.no_grad():
        model(batch)                                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev_ms, wall_ms = [], []
        for _ in range(FWD_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.time()
            a.record()
            model(batch)
            b.record()
            torch.cuda.synchronize()
            wall_ms.append((time.time() - t0) * 1e3)
            ev_ms.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()

        # the main path, counted: counts set to 0 just before, read after
        rec = GatherRecorder(gather)
        sparse_conv.gather, segment.gather = rec, rec
        try:
            gather.gather_rows.launches = 0
            out = model(batch)
            torch.cuda.synchronize()
            launches = gather.gather_rows.launches
        finally:
            sparse_conv.gather, segment.gather = gather, gather

    b_, n = batch["point_mask"].shape
    p, k = 2 * 128, 128
    shapes = {"semantic_scores": (b_, n, 20), "pt_offsets": (b_, n, 3),
              "member_pt": (b_, 2, n), "proposal_scores_all": (b_, p),
              "proposal_feats_batched": (b_, k, 16),
              "proposal_bbox_batched": (b_, k, 8, 3),
              "object_assignment": (b_, k)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key} shape {tuple(out[key].shape)}")
    for key, v in out.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{key} has non-finite values")
    if launches != expected or len(rec.calls) != expected:
        raise AssertionError(
            f"gather launches {launches} (recorded {len(rec.calls)}), "
            f"expected {expected} per forward")
    fwd_ms = statistics.median(ev_ms)
    emit({"phase": "flagship", "batch": b_, "points_cap": n,
          "voxels_l0": [int(x) for x in batch_np["tables"][0]["mask"].sum(1)],
          "in_channels": in_ch, "compute_dtype": flag.model["compute_dtype"],
          "scene_gen_s": round(scene_s, 3),
          "host_collate_s": round(host_collate_s, 3),
          "detector_fwd_ms": fwd_ms, "detector_fwd_ms_all": ev_ms,
          "detector_fwd_wall_ms": statistics.median(wall_ms),
          "scenes_per_sec": b_ / (fwd_ms / 1e3),
          "max_memory_allocated": peak,
          "gather_launches_per_forward": launches,
          "clusters": int(out["cluster_mask_all"].sum()),
          "proposals": int(out["proposal_batch_mask"].sum()),
          "band_taps_planned": planned})
    return rec.calls, launches, model, batch, variables


def phase_profile(name, fn):
    """Device time by kernel and by launching op over one call of ``fn``
    (torch.profiler), and the device's idle share of that call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if ms > 0:
            row = [e.key[:90], round(ms, 3), e.count]
            (kernels if e.device_type == DeviceType.CUDA else ops).append(row)
    kernels.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    emit({"phase": name, "wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / wall_ms,
          "kernel_launches": sum(r[2] for r in kernels),
          "top_kernels": kernels[:15], "top_ops": ops[:15]})
    return kernels


def phase_kernels(calls, launches):
    """Replay the forward's gathers: kernel, plain, index_select. Every
    call must be bit-exact against the plain version."""
    err = 0.0
    bytes_needed = 0
    padded = []
    for i, (src, idx) in enumerate(calls):
        got = gather.gather_rows(src, idx)
        want = gather.gather_rows_plain(src, idx)
        err = max(err, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(
                f"gather {i} of the forward ({src.dtype}, width "
                f"{src.shape[1]}, {idx.numel()} rows): kernel disagrees with "
                f"the plain version")
        row = src.shape[1] * src.element_size()
        rows_read = int(torch.unique(idx[idx < src.shape[0]]).numel())
        bytes_needed += rows_read * row + 4 * idx.numel() + idx.numel() * row
        padded.append(torch.cat([src, src.new_zeros(1, src.shape[1])]))
        del got, want
    torch.cuda.synchronize()

    def kernel():
        for src, idx in calls:
            gather.gather_rows(src, idx)

    def plain():
        for src, idx in calls:
            gather.gather_rows_plain(src, idx)

    def library():
        for (_, idx), src in zip(calls, padded):
            torch.index_select(src, 0, idx)

    ms = time_ms({"kernel": kernel, "plain": plain, "library": library},
                 KERNEL_REPS, inner=1)
    dev_ms = device_ms(kernel, inner=2)
    library_dev_ms = device_ms(library, inner=2)
    by_width = {}
    for src, idx in calls:
        key = f"{src.dtype}".replace("torch.", "") + f"x{src.shape[1]}"
        by_width[key] = by_width.get(key, 0) + idx.numel()
    emit({"phase": "kernels", "gathers_per_forward": len(calls),
          "rows_by_dtype_width": by_width, "bytes_needed": bytes_needed,
          "ms": ms})
    return [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "d3net_tpu_torch/csrc/gather_rows.cu",
        "replaces": "d3net_tpu/ops/pallas_gather.py:100",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms["kernel"],
        "device_ms": dev_ms,
        "plain_ms": ms["plain"],
        "bound_ms": bytes_needed / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": ms["library"],
        "library_device_ms": library_dev_ms,
    }]


def phase_train(variables, batch):
    """The flagship B=4 train step: timed steps, peak memory, finite losses,
    the gather launches of one step and the bytes they need, and one
    profiled step. Returns the train path's ``gather_rows`` numbers for its
    ``kernels`` entry."""
    flag = flagship_config()
    model = load_detector(variables, flag.model)       # cuda by default
    n_conv = sum(isinstance(m, SubmConv) for m in model.modules())
    # forward: every conv + 4 row gathers to points; backward: a dW
    # re-gather per conv and a dx gather per conv but the input conv's
    expected = (n_conv + 4) + n_conv + (n_conv - 1)
    state = create_train_state(model)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        return detector_train_step(state, batch, gen)[1]

    history = []
    for _ in range(TRAIN_WARMUP):
        history.append({k: float(v) for k, v in step().items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev_ms, wall_ms = [], []
    for _ in range(TRAIN_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        a.record()
        metrics = step()
        b.record()
        torch.cuda.synchronize()
        wall_ms.append((time.time() - t0) * 1e3)
        ev_ms.append(a.elapsed_time(b))
        history.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated()

    # the train path, counted: counts set to 0 just before, read after;
    # every gather of the step (forward, dW re-gathers, dx gathers) is held
    # bit-exact against the plain version as it runs
    rec = GatherRecorder(gather, check=True)
    sparse_conv.gather, segment.gather = rec, rec
    try:
        gather.gather_rows.launches = 0
        history.append({k: float(v) for k, v in step().items()})
        torch.cuda.synchronize()
        launches = gather.gather_rows.launches
    finally:
        sparse_conv.gather, segment.gather = gather, gather
    for i, h in enumerate(history):
        bad = [k for k, v in h.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"train step {i}: non-finite {bad}")
    if launches != expected or rec.checked != expected:
        raise AssertionError(f"gather launches {launches} per train step "
                             f"(checked {rec.checked}), expected {expected}")
    emit({"phase": "train", "batch": batch["point_mask"].shape[0],
          "compute_dtype": flag.model["compute_dtype"],
          "detector_train_step_ms": statistics.median(ev_ms),
          "detector_train_step_ms_all": ev_ms,
          "detector_train_step_wall_ms": statistics.median(wall_ms),
          "scenes_per_sec": batch["point_mask"].shape[0]
          / (statistics.median(ev_ms) / 1e3),
          "max_memory_allocated": peak,
          "gather_launches_per_step": launches, "convs": n_conv,
          "gathers_checked_exact": rec.checked,
          "gather_bytes_needed": rec.bytes_needed,
          "steps": history})
    prof = phase_profile("train_profile", step)
    return {"train_launches": launches,
            "train_bound_ms": rec.bytes_needed / HBM_BYTES_PER_S * 1e3,
            "train_device_ms": sum(r[1] for r in prof
                                   if "gather_rows_kernel" in r[0])}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    t_start = time.time()
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          # the private helpers of kernels/launch.py (else public calls)
          "torch_C_cuda_getDevice": hasattr(torch._C, "_cuda_getDevice"),
          "torch_C_cuda_getCurrentRawStream": hasattr(
              torch._C, "_cuda_getCurrentRawStream")})
    phase_build()
    phase_kernel()
    probe_entries = phase_probe()
    phase_parity()
    phase_train_parity()
    calls, launches, model, batch, variables = phase_flagship()

    def forward():
        with torch.no_grad():
            model(batch)

    phase_profile("profile", forward)
    del model
    kernels = phase_kernels(calls, launches)
    del calls
    kernels[0].update(phase_train(variables, batch))
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    emit({"kernels": kernels + probe_entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
