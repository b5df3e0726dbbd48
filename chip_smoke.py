#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``d3net_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   — the card's name and ``nvidia-smi`` name/power limit.
2. build    — nvcc builds every kernel source of ``csrc/`` and g++ the
              host library (one compiler per source, all started together).
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

11. host_lib — the C++ host library (``csrc/host_voxelize.cc``, built by
              g++ in ``build``) against the numpy plain versions on the
              flagship batch's four scenes: the whole collated batch byte-
              identical both ways, ``host_collate_s`` of each (C++ twice,
              numpy once) and each table's seconds on scene 0's level 0.
12. run     — ``run_detector_training`` on conf/pointgroup.yaml at its
              published widths (m 16, 7 levels, caps 131072..2048, 250000
              points, 128 instances, B=4, 134 input channels, 8 collate
              workers, elastic on, bf16; 64 + 8 scenes) in a temporary run
              dir for one epoch of 16 steps, the loop waiting for the card
              around each part of a step; per step the wall time with the
              host, the time blocked on the batch iterator, the
              host-to-device copy, the step, the ``gather_rows`` launches
              (each must equal the ``train`` phase's) and how many batch
              builds ran on average during its copy and its step (the
              steps with a build against those without), peak memory,
              finite losses and the ``metrics.jsonl`` keys. Then a fresh
              state restored from the run dir must equal the run's final
              state bit for bit (parameters, BN statistics, optimizer,
              scheduler, step), and a second call with a larger
              ``max_steps`` resumes there and trains one more epoch as
              users run it, with no waits for the card and the config's
              log cadence: its wall time per step over steps 2..15 of that
              epoch taken as one window (line ``resume``).
13. eval    — ``python -m d3net_tpu_torch.scripts.eval --task detection``
              on that run dir (in-process): ``eval_detection.json`` with
              finite mAP and AR at IoU 0.25 and 0.5, stamped with its
              checkpoint, and its ``gather_rows`` launches.
14. caption_parity — the speaker at conf/debug/tiny_captioning.yaml's
              widths (orientation on, random weights with nonzero biases)
              on seeded fake proposals, on ``cuda`` against ``cpu`` inside
              ``device.parity_precision()``: ``adjacent_mat``,
              ``local_ids``, ``local_mask`` equal; ``bbox_feature``,
              ``edge_feature``, ``edge_orientations`` within rtol 1e-4 /
              atol 1e-5; the greedy ids equal; each device's logits,
              teacher-forced on the cpu's ids, within the same tolerance;
              for a row whose ids differ, the cpu's top-2 logit margin at
              its first difference (``checks.speaker_cuda_vs_cpu``, which
              the card test of the speaker also runs).
15. caption — the mode-1 eval forward (``run_detector`` then
              ``run_speaker(mode="eval")``) of a B=4 batch of
              conf/pointgroup_captioning.yaml's own val scenes at its
              widths (f32, 128 proposals, 512 decoded rows of 31 steps),
              at PyTorch's default settings, with the ``run`` phase's
              detector and a seeded random speaker: ``caption_fwd_ms``
              (median of 5 after 2 warm-up, CUDA events) split into
              ``detector_ms`` and ``speaker_ms``, ``graph_ms`` and
              ``decode_ms`` timed alone, the decode run once under CUDA's
              sync debug mode "error" (no host sync in its loop), peak
              memory, the ``gather_rows`` launches of one batch (75), each
              of those gathers (f32 rows at this config, and one of int32
              pairs) held bit-exact against
              ``gather_rows_plain`` on its own tensors as it runs, with the
              largest error and the rows by dtype and width, and
              two profiles (the forward:
              busy, idle, top ops, launches; the decode: launches a step).
16. caption_eval — ``python -m d3net_tpu_torch.scripts.eval --task
              captioning`` (in-process) on a run dir the phase writes: the
              config above, one checkpoint of a ``PipelineNet`` whose
              detector is the ``run`` phase's and whose speaker is seeded
              random; one val batch of 4 scenes (``D3NET_VAL_SCENES``).
              Finite BLEU-4, CIDEr, ROUGE-L and METEOR (0.0: the card's
              machine has no nltk), a best or last checkpoint, and 75
              ``gather_rows`` launches per val batch.

17. spk_train_parity — one mode-1 train step at the tiny captioning
              widths (orientation on, seeded rotations), cuda vs cpu, the
              detector trained and frozen (``checks.
              speaker_step_cuda_vs_cpu``).
18. spk_train — ``prepare_weights`` on the ``run`` phase's detector, then
              the train CLI on conf/pointgroup_captioning.yaml for 8
              steps, half an epoch (``_stage_train``: per-step times and peaks, one
              step's 216 gathers checked bit-exact, one val batch, the
              restored state bit-exact), the step timed alone and
              profiled, the speaker's and the teacher-forced loop's
              forward and backward timed.
19. grounding_parity — the listener at conf/debug/tiny_grounding.yaml's
              widths on seeded proposals and descriptions (lengths 0 and
              T among them), cuda vs cpu inside
              ``device.parity_precision()``: eval and train forward with
              the same dropout masks and copy-paste draws, every output
              and the BN statistics within rtol 1e-4 / atol 1e-5
              (``checks.listener_cuda_vs_cpu``).
20. grounding — the mode-2 eval forward (``run_detector`` then
              ``run_listener``) of a B=4 batch of
              conf/pointgroup_grounding.yaml's own val scenes and their 32
              descriptions (T = 32) at its widths, the ``run`` phase's
              detector and a seeded random listener: ``ground_fwd_ms``
              (median of 5 after 2 warm-up, CUDA events) split into
              ``detector_ms`` and ``listener_ms``, ``lang_ms`` and
              ``match_ms`` timed alone, peak memory, the 75 gathers of
              one batch each held bit-exact against ``gather_rows_plain``,
              two profiles (the forward; the GRU encoder: launches a
              step).
21. grounding_eval — ``python -m d3net_tpu_torch.scripts.eval --task
              grounding`` (in-process) on a run dir holding one pipeline
              checkpoint (the run phase's detector, a seeded random
              listener), one val batch: finite Acc@0.25/0.5 and mean IoU,
              the checkpoint stamped, 75 gathers a batch.
22. lis_train_parity — one mode-2 train step at the tiny grounding
              widths (dropout and copy-paste on), cuda vs cpu, the
              detector trained and frozen (``checks.
              listener_step_cuda_vs_cpu``).
23. lis_train — the listener's stage as ``spk_train`` runs the speaker's,
              on conf/pointgroup_grounding.yaml (validated by
              ``ref_iou_rate_0.5``); then the step timed alone and
              profiled, the listener's and its GRU encoder's forward and
              backward timed, the encoder's launches a GRU step.
24. joint_parity — one mode-3 (joint self-critical RL) train step at
              conf/debug/tiny_joint.yaml's widths with the published beam
              (3 in 3 groups), the XE anchor and the same draws, cuda vs
              cpu, the detector trained and frozen: the rollout ids equal
              (the cuda search run once under CUDA's sync debug mode
              "error"; a differing row reports the cpu's top-2 margin),
              then on the cpu's rollout the metrics, gradients, BN
              statistics and host scores (``checks.
              joint_step_cuda_vs_cpu``, shared with the card test).
25. joint_train — the curriculum's stage 4 as users run it:
              ``prepare_weights`` on the run phase's detector and on the
              ``spk_train`` and ``lis_train`` run dirs, then the train CLI
              on conf/pointgroup_joint.yaml pointed at those pickles for
              one epoch of 16 steps (``_stage_train``: per-step times and
              peaks, step 2's 432 gathers, two detector passes with their
              backward, checked bit-exact, one val batch with ``cider``,
              ``ref_iou_rate_0.5`` and ``combined``, the restored state
              bit-exact); then the step timed alone (``joint_train_step_
              ms``, median of 5 after 1 warm-up) and profiled (launches,
              idle share, the gathers' device time against their bound),
              its parts timed (``rollout_ms``: beam and baseline, the
              beam's launches a step; ``reward_ms``: the host CIDEr, both
              calls; ``spk_stream_ms`` and ``lis_stream_ms``, forward and
              backward) and its peak memory.
26. joint_eval — the eval CLI's ``captioning`` and ``grounding`` tasks on
              that run dir, one val batch each: finite metrics, the
              checkpoint stamped, 75 gathers a batch.

Then the ``kernels`` line: one entry per kernel, with its launches on its
path, ``max_abs_err``, per-call ``ms``, profiled ``device_ms``, the plain
version's and the library call's time (``library_ms``,
``library_device_ms``) and the bound; the two rings add the bytes their
blocks move (``moved_bytes``), and ``gather_rows`` its launches per step
of the ``run``, ``spk_train``, ``lis_train`` and ``joint_train`` phases
and per batch of the ``caption`` and ``grounding`` phases, with the three
train stages' bounds and device times (its ``max_abs_err`` covers every checked
gather). The last two
lines are
``nvidia-smi``'s name/power limit and ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, the script exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from d3net_tpu_torch import device
from d3net_tpu_torch import probe as probe_cli
from d3net_tpu_torch.checks import (
    joint_parity_config, joint_step_case, joint_step_cuda_vs_cpu,
    joint_step_kw, listener_cuda_vs_cpu, listener_step_case,
    listener_step_cuda_vs_cpu, randomize, relu_sides, speaker_cuda_vs_cpu,
    speaker_step_case, speaker_step_cuda_vs_cpu,
)
from d3net_tpu_torch.config import save as save_cfg
from d3net_tpu_torch.probe import check_exact, device_ms, time_ms
from d3net_tpu_torch.data import collate
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.dataset import BatchIterator
from d3net_tpu_torch.data.language import build_lang_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.kernels import gather, probe
from d3net_tpu_torch.models.blocks import SubmConv, fold_tables
from d3net_tpu_torch.models.listener import ListenerDraws
from d3net_tpu_torch.models.speaker import expand_to_rows
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.ops import native, segment, sparse_conv
from d3net_tpu_torch.ops import voxelize as vox
from d3net_tpu_torch.params import (
    flagship_config, flatten, flax_to_state_dict, init_flax_variables,
    load_detector, load_pipeline, state_dict_to_flax,
)
from d3net_tpu_torch.scripts import eval as eval_cli
from d3net_tpu_torch.scripts import prepare_weights
from d3net_tpu_torch.scripts import train as train_cli
from d3net_tpu_torch.scripts.train import load_task_config
from d3net_tpu_torch.train import pipeline
from d3net_tpu_torch.train.loop import (
    Checkpointer, detector_from_cfg, init_detector, make_val_loader,
    run_detector_training, spec_from_cfg,
)
from d3net_tpu_torch.train.losses_slt import (
    caption_loss, grounding_loss, lang_cls_loss,
)
from d3net_tpu_torch.train.trainer import (
    create_train_state, detector_train_step,
)
from d3net_tpu_torch.utils.bbox import box_corners

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
KINK_NOISE = 1e-5     # largest ReLU input, relative, that may change side
FWD_REPS = 7
KERNEL_REPS = 5
TRAIN_WARMUP, TRAIN_REPS = 2, 5

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_CONFIG = os.path.join(ROOT, "conf", "pointgroup.yaml")
RUN_STEPS = 16          # one epoch: the config's 64 train scenes at B=4
RUN_RESUME_STEPS = 16   # one more epoch after the resume
COLLATE_BUSY = 0.5      # batch builds in flight, on average, that make a
                        # step one "with collate"
CAPTION_CONFIG = os.path.join(ROOT, "conf", "pointgroup_captioning.yaml")
TINY_CAPTION_CONFIG = os.path.join(ROOT, "conf", "debug",
                                   "tiny_captioning.yaml")
CAPTION_WARMUP, CAPTION_REPS = 2, 5
SPK_STEPS = 8           # half an epoch of the captioning config's 64 scenes
                        # at B=4, to keep the whole run near 7 minutes
SPK_CHECKED_STEP = 2    # the step whose gathers are held to the plain version
SPK_REPS = 5
GROUNDING_CONFIG = os.path.join(ROOT, "conf", "pointgroup_grounding.yaml")
TINY_GROUNDING_CONFIG = os.path.join(ROOT, "conf", "debug",
                                     "tiny_grounding.yaml")
GROUND_WARMUP, GROUND_REPS = 2, 5
LIS_STEPS = 8           # half an epoch, as SPK_STEPS
LIS_CHECKED_STEP = 2    # the step whose gathers are held to the plain version
LIS_REPS = 5
JOINT_CONFIG = os.path.join(ROOT, "conf", "pointgroup_joint.yaml")
TINY_JOINT_CONFIG = os.path.join(ROOT, "conf", "debug", "tiny_joint.yaml")
JOINT_STEPS = 16        # one epoch: the joint config's 64 scenes at B=4
JOINT_CHECKED_STEP = 2  # the step whose gathers are held to the plain version
JOINT_REPS = 5

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


# --------------------------------------------------------------------------
def phase_build():
    """Each kernel module's ``load_library`` (nvcc at first use) and the
    host library (g++), all started together."""
    t0 = time.time()
    builds = {gather.SOURCE: gather.load_library,
              probe.SOURCE: probe.load_library, native.SOURCE: native.get_lib}
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda f: f(), builds.values()))
    emit({"phase": "build", "sources": list(builds),
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
    call happens (in the backward too) and keeps only a count, the largest
    error, the rows gathered by dtype and width, and the bytes the calls
    need (``probe.gather_bytes``: distinct source rows reached, output,
    index)."""

    def __init__(self, real, check=False, where="the train step"):
        self.real = real
        self.check = check
        self.where = where
        self.calls = []
        self.checked = 0
        self.max_abs_err = 0.0
        self.rows_by_dtype_width = {}
        self.bytes_needed = 0

    def gather_rows(self, src, idx):
        out = self.real.gather_rows(src, idx)
        if not self.check:
            self.calls.append((src, idx))
            return out
        with torch.no_grad():
            want = self.real.gather_rows_plain(src.detach(), idx)
            if out.numel():
                self.max_abs_err = max(self.max_abs_err, float(
                    (out.float() - want.float()).abs().max()))
        if not torch.equal(out, want):
            raise AssertionError(
                f"gather {self.checked} of {self.where} ({src.dtype}, width "
                f"{src.shape[1]}, {idx.numel()} rows): kernel disagrees with "
                f"the plain version")
        self.checked += 1
        key = f"{src.dtype}".replace("torch.", "") + f"x{src.shape[1]}"
        self.rows_by_dtype_width[key] = (
            self.rows_by_dtype_width.get(key, 0) + idx.numel())
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
            "step_ms": statistics.median(ev_ms),
            "train_bound_ms": rec.bytes_needed / HBM_BYTES_PER_S * 1e3,
            "train_device_ms": sum(r[1] for r in prof
                                   if "gather_rows_kernel" in r[0])}


@contextlib.contextmanager
def numpy_tables():
    """The collate's voxelization and tables on the numpy plain versions
    (``ops/voxelize.py`` ``*_plain``) instead of the C++ host library."""
    names = ("voxelize", "submanifold_table", "downsample_level",
             "upsample_table")
    saved = {n: getattr(vox, n) for n in names}
    saved_collate = collate.voxelize
    for n in names:
        setattr(vox, n, getattr(vox, f"{n}_plain"))
    collate.voxelize = vox.voxelize_plain
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(vox, n, f)
        collate.voxelize = saved_collate


def assert_same_arrays(got, want, where="batch") -> int:
    """Every array of two collated batches equal in dtype, shape and bytes;
    returns how many were compared."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{where}: keys differ")
        return sum(assert_same_arrays(got[k], want[k], f"{where}.{k}")
                   for k in want)
    if isinstance(want, list):
        return sum(assert_same_arrays(g, w, f"{where}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    if (got.dtype != want.dtype or got.shape != want.shape
            or not np.array_equal(got, want)):
        raise AssertionError(f"{where}: C++ and numpy tables differ")
    return 1


def phase_host_lib():
    """The C++ host library against the numpy plain versions on the
    flagship batch's four scenes."""
    flag = flagship_config()
    scenes = [make_scene(seed=i, **flag.scene_kwargs)
              for i in range(flag.batch_size)]
    seconds = {"cpp": [], "numpy": []}
    batches = {}
    for kind in ("cpp", "numpy", "cpp"):
        with numpy_tables() if kind == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            batches[kind] = build_batch(scenes, flag.spec)
            seconds[kind].append(time.perf_counter() - t0)
    arrays = assert_same_arrays(batches["cpp"], batches["numpy"])

    # each table on scene 0's level 0, both ways (C++ and numpy in turns)
    xyz = scenes[0].xyz[:flag.spec.max_points]
    coords = np.floor((xyz - xyz.min(0)) * flag.spec.scale).astype(np.int32)
    vc = vox.voxelize_plain(coords)[0]
    coarse = vox.downsample_level_plain(vc)[0]
    tables = {}
    for name, args in (("voxelize", (coords,)), ("submanifold_table", (vc,)),
                       ("downsample_level", (vc,)),
                       ("upsample_table", (vc, coarse))):
        row = {}
        for kind, fn in (("cpp", getattr(native, name)),
                         ("numpy", getattr(vox, f"{name}_plain"))):
            t0 = time.perf_counter()
            fn(*args)
            row[kind] = time.perf_counter() - t0
        tables[name] = row
    emit({"phase": "host_lib", "scenes": len(scenes),
          "points": [len(sc.xyz) for sc in scenes],
          "voxels_l0": [int(x) for x in
                        batches["cpp"]["tables"][0]["mask"].sum(1)],
          "identical_arrays": arrays, "host_collate_s": seconds,
          "level0_table_s": tables})


def run_config(root):
    """conf/pointgroup.yaml (over conf/path.yaml) into ``root``."""
    cfg = load_task_config(RUN_CONFIG)
    cfg.general.output_root = root
    return cfg


@contextlib.contextmanager
def val_scenes(n):
    """The loaders' ``D3NET_VAL_SCENES`` at ``n`` while open: one val batch
    of the config's scenes."""
    saved = os.environ.get("D3NET_VAL_SCENES")
    os.environ["D3NET_VAL_SCENES"] = str(n)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["D3NET_VAL_SCENES"]
        else:
            os.environ["D3NET_VAL_SCENES"] = saved


@contextlib.contextmanager
def build_spans():
    """Every batch build of ``BatchIterator`` (train and val) while open,
    as (start, end) on the host's clock."""
    spans = []
    build = BatchIterator._build_one

    def timed(self, order, b):
        t0 = time.perf_counter()
        try:
            return build(self, order, b)
        finally:
            spans.append((t0, time.perf_counter()))

    BatchIterator._build_one = timed
    try:
        yield spans
    finally:
        BatchIterator._build_one = build


def builds_during(spans, t0, t1):
    """How many batch builds ran on average over [t0, t1]."""
    busy = sum(max(0.0, min(e, t1) - max(s, t0)) for s, e in spans)
    return busy / (t1 - t0) if t1 > t0 else 0.0


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _state_copy(state):
    """The model state_dict, optimizer and scheduler state and step, copied."""
    def copy(v):
        if torch.is_tensor(v):
            return v.detach().clone()
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, list):
            return [copy(x) for x in v]
        return v
    return {"model": copy(state.model.state_dict()),
            "optimizer": copy(state.optimizer.state_dict()),
            "scheduler": copy(state.scheduler.state_dict()),
            "step": state.step}


def _first_difference(got, want, where=""):
    if torch.is_tensor(want):
        return None if (torch.is_tensor(got) and got.dtype == want.dtype
                        and got.device == want.device
                        and torch.equal(got, want)) else where
    if isinstance(want, dict):
        if set(got) != set(want):
            return f"{where} keys"
        for k in want:
            d = _first_difference(got[k], want[k], f"{where}.{k}")
            if d:
                return d
        return None
    if isinstance(want, list):
        if len(got) != len(want):
            return f"{where} length"
        for i, (g, w) in enumerate(zip(got, want)):
            d = _first_difference(g, w, f"{where}[{i}]")
            if d:
                return d
        return None
    return None if got == want else where


def _train_run(cfg, run_dir, max_steps, sync_steps=True):
    """``run_detector_training`` with every step's timings and
    ``gather_rows`` launches recorded; returns (state, steps, launches,
    batch build spans)."""
    steps = []
    seen = [0]

    def on_step(rec):
        rec["gather_launches"] = gather.gather_rows.launches - seen[0]
        seen[0] = gather.gather_rows.launches
        steps.append(rec)

    with build_spans() as spans:
        gather.gather_rows.launches = 0      # the main path, counted from here
        state = run_detector_training(cfg, run_dir, max_steps=max_steps,
                                      on_step=on_step, sync_steps=sync_steps)
        torch.cuda.synchronize()
    return state, steps, gather.gather_rows.launches, spans


def _median(recs, key, scale=1e3):
    return statistics.median(r[key] for r in recs) * scale


def _by_collate(recs, keys):
    """Records split by whether batch builds ran during them (``builds``
    at least COLLATE_BUSY on average) or not: each part's steps and the
    median of each key, in ms."""
    out = {}
    for name, part in (
            ("with_collate", [r for r in recs if r["builds"] >= COLLATE_BUSY]),
            ("without_collate", [r for r in recs if r["builds"] < COLLATE_BUSY])):
        out[name] = {"steps": [r["step"] for r in part],
                     **{k[:-2] + "_ms": _median(part, k) for k in keys
                        if part}}
    return out


def _check_launches(where, steps, launches, per_step, val_launches):
    per = [r["gather_launches"] for r in steps]
    if any(n != per_step for n in per) or launches != sum(per) + val_launches:
        raise AssertionError(
            f"{where}: gather_rows launches per step {per} (train phase: "
            f"{per_step}), {launches} in all")
    return per[0]


def phase_run(root, per_step, per_forward, train_step_ms):
    """The detector's run loop on conf/pointgroup.yaml for one epoch, the
    loop waiting for the card around each part of a step; then the resume
    and one more epoch with no such waits."""
    cfg = run_config(root)
    log_every = cfg.train.log_every_n_steps
    cfg.train.log_every_n_steps = 1
    syn = cfg.data.synthetic
    # the loop's default: an eighth of the train scenes, at least 2
    val_scenes = max(2, syn.num_scenes // 8)
    val_batches = -(-val_scenes // cfg.data.batch_size)
    run_dir = os.path.join(root, cfg.general.experiment)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, steps, launches, spans = _train_run(cfg, run_dir, RUN_STEPS)
    run_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    recs = _metrics(run_dir)
    train = [r for r in recs if "train/total_loss" in r]
    val = [r for r in recs if "val/total_loss" in r]
    bad = [(r["step"], k) for r in recs for k, v in r.items()
           if not math.isfinite(v)]
    if len(steps) != RUN_STEPS or [r["step"] for r in train] != list(
            range(1, RUN_STEPS + 1)) or len(val) != 1:
        raise AssertionError(f"run: {len(steps)} steps, metrics steps "
                             f"{[r['step'] for r in recs]}")
    if bad:
        raise AssertionError(f"run: non-finite metrics {bad}")
    run_per_step = _check_launches("run", steps, launches, per_step,
                                   val_batches * per_forward)
    for r in steps:
        t_copy = r["t_start"] + r["data_wait_s"]
        t_step = t_copy + r["h2d_s"]
        r["builds_in_copy"] = builds_during(spans, t_copy, t_step)
        r["builds"] = builds_during(spans, t_step, t_step + r["step_s"])
    timed = ("wall_s", "data_wait_s", "h2d_s", "step_s")
    emit({"phase": "run", "config": "conf/pointgroup.yaml",
          "widths": {"m": cfg.model.m, "levels": len(cfg.model.blocks),
                     "voxel_caps": list(cfg.tpu.voxel_caps),
                     "max_num_point": cfg.data.max_num_point,
                     "max_num_instance": cfg.data.max_num_instance,
                     "batch_size": cfg.data.batch_size,
                     "in_channels": state.model.input_conv.kernel.shape[1],
                     "num_workers": cfg.data.get("num_workers"),
                     "elastic": cfg.data.get("elastic"),
                     "activation_dtype": cfg.tpu.get("activation_dtype")},
          "scenes": {"train": syn.num_scenes, "val": val_scenes},
          "reduced": [f"one epoch of {RUN_STEPS} steps (max_steps "
                      f"{RUN_STEPS}) of the config's {cfg.train.epochs}, "
                      f"then a resume for {RUN_RESUME_STEPS} more",
                      f"log_every_n_steps 1 in the first epoch (the "
                      f"config's {log_every} after the resume)"],
          "timing": "the loop waits for the card around each part of a step",
          "run_step_ms": _median(steps, "wall_s"),
          "data_wait_ms": _median(steps, "data_wait_s"),
          "h2d_ms": _median(steps, "h2d_s"),
          "h2d_bytes": steps[0]["h2d_bytes"],
          "h2d_gb_per_s": statistics.median(r["h2d_bytes"] / r["h2d_s"]
                                            for r in steps) / 1e9,
          "step_ms": _median(steps, "step_s"),
          "train_phase_step_ms": train_step_ms,
          # steps 2.. with a batch build running during the step, or not
          "later_steps": _by_collate(steps[1:], timed),
          "steps": [{(k[:-2] + "_ms" if k.endswith("_s") else k):
                     (round(v * 1e3, 3) if k.endswith("_s")
                      else round(v, 3) if isinstance(v, float) else v)
                     for k, v in r.items() if k != "t_start"}
                    for r in steps],
          "max_memory_allocated": peak, "run_s": round(run_s, 3),
          "gather_launches": launches, "gather_launches_per_step": per_step,
          "val_batches": val_batches, "losses_finite": True,
          "train_losses": [r["train/total_loss"] for r in train],
          "val_total_loss": val[0]["val/total_loss"],
          "metrics_keys": sorted({k for r in recs for k in r}),
          "run_dir": sorted(os.listdir(run_dir))})
    saved = _state_copy(state)
    del state
    torch.cuda.empty_cache()

    # a fresh state restored from the run dir equals the run's final state
    fresh = create_train_state(
        init_detector(detector_from_cfg(cfg), 0).cuda(),
        lr=cfg.train.optim.lr, optim=cfg.train.optim.classname,
        weight_decay=cfg.train.optim.weight_decay,
        step_epoch=cfg.train.step_epoch, multiplier=cfg.train.multiplier)
    ckpt = Checkpointer(run_dir, "total_loss")
    if ckpt.restore_last(fresh) is None:
        raise AssertionError("resume: no checkpoint in the run dir")
    diff = _first_difference(_state_copy(fresh), saved)
    if diff is not None:
        raise AssertionError(f"resume: restored state differs at {diff}")
    del fresh

    # one more epoch as users run it: no waits for the card, the config's
    # log cadence
    cfg.train.log_every_n_steps = log_every
    state, steps2, launches2, spans2 = _train_run(
        cfg, run_dir, RUN_STEPS + RUN_RESUME_STEPS, sync_steps=False)
    resumed = [r["step"] for r in steps2]
    train2 = [r["step"] for r in _metrics(run_dir) if "train/total_loss" in r]
    want = list(range(RUN_STEPS + 1, RUN_STEPS + RUN_RESUME_STEPS + 1))
    if resumed != want or train2 != list(range(1, RUN_STEPS + 1)) + [
            s for s in want if s % log_every == 0]:
        raise AssertionError(f"resume: stepped {resumed}, metrics {train2}")
    _check_launches("resume", steps2, launches2, per_step,
                    val_batches * per_forward)
    # steps 2..N-1 of the epoch: each from asking for its batch to asking
    # for the next (a pageable copy waits for the card's earlier work)
    starts = [r["t_start"] for r in steps2]
    window = [{"step": r["step"], "wall_s": b - a,
               "data_wait_s": r["data_wait_s"],
               "builds": builds_during(spans2, a, b)}
              for r, a, b in zip(steps2[1:-1], starts[1:-1], starts[2:])]
    emit({"phase": "resume", "restored_step": saved["step"],
          "restored_bit_exact": ["model", "optimizer", "scheduler", "step"],
          "tensors_compared": sum(1 for _ in _tensors(saved)),
          "resumed_steps": resumed, "final_step": state.step,
          "timing": "no waits for the card; log_every_n_steps "
                    f"{log_every}",
          "window_steps": [window[0]["step"], window[-1]["step"]],
          "run_window_ms_per_step":
              (starts[-1] - starts[1]) / len(window) * 1e3,
          "window_steps_by_collate": _by_collate(
              window, ("wall_s", "data_wait_s")),
          "window": [{"step": r["step"],
                      "wall_ms": round(r["wall_s"] * 1e3, 3),
                      "data_wait_ms": round(r["data_wait_s"] * 1e3, 3),
                      "builds": round(r["builds"], 3)} for r in window],
          "first_step_data_wait_ms": steps2[0]["data_wait_s"] * 1e3,
          "gather_launches": launches2,
          "checkpoints": sorted(os.listdir(os.path.join(run_dir, "ckpt")))})
    del state
    torch.cuda.empty_cache()
    return run_dir, val_batches, run_per_step


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)


def phase_eval(run_dir, val_batches, per_forward):
    """The detection eval CLI on the run dir."""
    gather.gather_rows.launches = 0
    t0 = time.time()
    eval_cli.main(["--folder", run_dir, "--task", "detection"])
    torch.cuda.synchronize()
    launches = gather.gather_rows.launches
    with open(os.path.join(run_dir, "eval_detection.json")) as f:
        res = json.load(f)
    keys = ("mAP@0.25", "mAP@0.5", "AR@0.25", "AR@0.5")
    if not all(math.isfinite(res[k]) for k in keys):
        raise AssertionError(f"eval: non-finite {[res[k] for k in keys]}")
    if res["checkpoint"].get("kind") not in ("best", "last"):
        raise AssertionError(f"eval: checkpoint {res['checkpoint']}")
    if launches != val_batches * per_forward:
        raise AssertionError(f"eval: {launches} gather_rows launches")
    emit({"phase": "eval", **{k: res[k] for k in keys},
          "checkpoint": res["checkpoint"], "gather_launches": launches,
          "seconds": round(time.time() - t0, 3)})


# --------------------------------------------------------------------------
def fake_proposals(rng, b, p, width):
    """Seeded proposals: random boxes and features, 3 invalid slots a
    scene (zeroed, as the detector leaves them)."""
    centers = rng.uniform(0, 4, (b, p, 3)).astype(np.float32)
    sizes = rng.uniform(0.2, 1.0, (b, p, 3)).astype(np.float32)
    mask = np.ones((b, p), np.float32)
    mask[:, -3:] = 0
    feats = rng.normal(size=(b, p, width)).astype(np.float32)
    return {"proposal_feats_batched": feats * mask[..., None],
            "proposal_batch_mask": mask,
            "proposal_bbox_batched": box_corners(centers, sizes)
            * mask[..., None, None]}


def phase_caption_parity():
    """The speaker at the tiny captioning widths: cuda vs cpu."""
    t0 = time.time()
    cfg = load_task_config(TINY_CAPTION_CONFIG)
    cfg.model.use_orientation = True
    vocab, emb = pipeline.build_vocab(cfg)
    variables = randomize(init_flax_variables(
        pipeline.pipeline_from_cfg(cfg, vocab), seed=0),
        np.random.default_rng(4))
    data_np = fake_proposals(np.random.default_rng(5), 4,
                             cfg.model.max_num_proposal,
                             cfg.model.m * cfg.model.cluster_blocks[0])
    data_np["glove_embeddings"] = emb
    report = speaker_cuda_vs_cpu(variables, cfg, vocab, data_np,
                                 rtol=PARITY_RTOL, atol=PARITY_ATOL)
    emit({"phase": "caption_parity", "config": "conf/debug/tiny_captioning"
          ".yaml (use_orientation on), fake proposals", **report,
          "seconds": round(time.time() - t0, 3)})
    if not report["ok"]:
        raise AssertionError(
            f"speaker cuda vs cpu: integers {report['integers_equal']}, "
            f"outside tolerance {report['outside_tolerance']}, "
            f"{report['rows_differing']} rows of ids differ")


def run_detector_weights(run_dir):
    """The detector state_dict of the run dir's best checkpoint, else its
    last."""
    ck = Checkpointer(run_dir, "total_loss")
    mgr = ck.best_mgr if ck.best_mgr.latest_step() is not None else ck.mgr
    return mgr.restore(mgr.latest_step())["model"]


def pipeline_model(cfg, vocab, det_weights):
    """The config's pipeline on the card: ``det_weights`` in the detector,
    its speaker or listener of seeded random weights."""
    model = load_pipeline(init_flax_variables(
        pipeline.pipeline_from_cfg(cfg, vocab), seed=0), cfg, vocab)
    model.detector.load_state_dict(det_weights)
    return model


def phase_caption(det_weights, per_forward):
    """The mode-1 eval forward of a B=4 batch of the captioning config's
    val scenes: times, peak, gather launches, profiles."""
    t_phase = time.time()
    cfg = load_task_config(CAPTION_CONFIG)
    vocab, emb = pipeline.build_vocab(cfg)
    spec = spec_from_cfg(cfg)
    val_it = make_val_loader(cfg, spec)
    t0 = time.time()
    batch_np = build_batch([val_it.scenes[i]
                            for i in range(cfg.data.batch_size)], spec)
    collate_s = time.time() - t0
    batch = batch_to_torch(batch_np, "cuda")
    model = pipeline_model(cfg, vocab, det_weights)
    speaker, emb_t = model.speaker, torch.from_numpy(emb).cuda()

    def forward(marks=None):
        det = model.run_detector(batch)
        if marks:
            marks[1].record()
        return det, model.run_speaker({**det, "glove_embeddings": emb_t},
                                      mode="eval")

    with torch.no_grad():
        for _ in range(CAPTION_WARMUP):
            forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(CAPTION_REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            det, out = forward(ev)
            ev[2].record()
            torch.cuda.synchronize()
            runs.append((ev[0].elapsed_time(ev[2]), ev[0].elapsed_time(ev[1]),
                         ev[1].elapsed_time(ev[2])))
        peak = torch.cuda.max_memory_allocated()

        # the main path, counted: counts set to 0 just before, read after;
        # each gather's output held bit-exact against the plain version on
        # the same tensors as it happens (the plain calls launch no kernel)
        rec = GatherRecorder(gather, check=True, where="the caption forward")
        sparse_conv.gather, segment.gather = rec, rec
        try:
            gather.gather_rows.launches = 0
            forward()
            torch.cuda.synchronize()
            launches = gather.gather_rows.launches
        finally:
            sparse_conv.gather, segment.gather = gather, gather

        # the speaker's parts alone, on the last run's inputs
        data = {**det, "glove_embeddings": emb_t}
        inputs = speaker.caption.eval_inputs(speaker.graph(data))
        parts = time_ms({
            "speaker": lambda: model.run_speaker(data, mode="eval"),
            "graph": lambda: speaker.graph(data),
            "caption_inputs": lambda: speaker.caption.eval_inputs(
                speaker.graph(data)),
            "decode": lambda: speaker.caption.greedy_decode(emb_t, *inputs)},
            CAPTION_REPS, inner=1)
        # the decode loop never waits for the card: any synchronising
        # call inside it raises in this mode
        torch.cuda.set_sync_debug_mode("error")
        try:
            speaker.caption.greedy_decode(emb_t, *inputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        fwd_kernels = phase_profile("caption_profile", forward)
        dec_kernels = phase_profile(
            "caption_decode_profile",
            lambda: speaker.caption.greedy_decode(emb_t, *inputs))

    ids = out["lang_cap"]
    b, k = cfg.data.batch_size, cfg.model.max_num_proposal
    steps = cfg.data.max_spk_len + 1
    if tuple(ids.shape) != (b, k, steps) or ids.dtype != torch.int32 or not (
            (ids >= 0) & (ids < len(vocab))).all():
        raise AssertionError(f"lang_cap {tuple(ids.shape)} {ids.dtype}")
    for key in ("bbox_feature", "edge_feature", "edge_orientations"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{key} has non-finite values")
    if launches != per_forward or rec.checked != launches:
        raise AssertionError(f"caption: {launches} gather_rows launches a "
                             f"batch ({rec.checked} checked), expected "
                             f"{per_forward}")
    med = [statistics.median(r[i] for r in runs) for i in range(3)]
    dec_launches = sum(r[2] for r in dec_kernels)
    emit({"phase": "caption", "config": "conf/pointgroup_captioning.yaml",
          "widths": {"batch": b, "max_num_point": cfg.data.max_num_point,
                     "max_num_instance": cfg.data.max_num_instance,
                     "m": cfg.model.m, "levels": len(cfg.model.blocks),
                     "proposals": k, "graph_steps": cfg.model.num_graph_steps,
                     "num_locals": cfg.model.num_locals,
                     "decode_rows": b * k, "decode_steps": steps,
                     "vocab": len(vocab),
                     "activation_dtype": cfg.tpu.get("activation_dtype")},
          "weights": "the run phase's detector, a seeded random speaker",
          "host_collate_s": round(collate_s, 3),
          "caption_fwd_ms": med[0], "detector_ms": med[1],
          "speaker_ms": med[2], "caption_fwd_ms_all": [r[0] for r in runs],
          "detector_ms_all": [r[1] for r in runs],
          "speaker_ms_all": [r[2] for r in runs],
          "speaker_alone_ms": parts["speaker"], "graph_ms": parts["graph"],
          "caption_inputs_ms": parts["caption_inputs"] - parts["graph"],
          "decode_ms": parts["decode"],
          "speaker_share": med[2] / med[0],
          "max_memory_allocated": peak,
          "gather_launches_per_batch": launches,
          "gathers_checked_exact": rec.checked,
          "gather_max_abs_err": rec.max_abs_err,
          "gather_rows_by_dtype_width": rec.rows_by_dtype_width,
          "kernel_launches_per_batch": sum(r[2] for r in fwd_kernels),
          "decode_launches": dec_launches,
          "decode_launches_per_step": dec_launches / steps,
          "decode_host_syncs": 0,
          "proposals_valid": int(det["proposal_batch_mask"].sum()),
          "distinct_words": int(torch.unique(ids).numel()),
          "seconds": round(time.time() - t_phase, 3)})
    del model, batch, out, det, data, inputs
    torch.cuda.empty_cache()
    return launches, rec.max_abs_err


def phase_pipeline_eval(name, config, task, monitor, keys, root,
                        det_weights, per_forward):
    """The eval CLI's ``task`` on a run dir holding one pipeline checkpoint
    of ``config`` (the run phase's detector, a seeded random speaker or
    listener): its ``keys`` finite, the checkpoint stamped, 75
    ``gather_rows`` launches per val batch."""
    t0 = time.time()
    cfg = load_task_config(config)
    run_dir = os.path.join(root, cfg.general.experiment)
    os.makedirs(run_dir)
    cfg.general.output_root = root
    save_cfg(cfg, os.path.join(run_dir, "config.yaml"))
    vocab, _ = pipeline.build_vocab(cfg)
    model = pipeline_model(cfg, vocab, det_weights)
    Checkpointer(run_dir, monitor, "max").save(
        RUN_STEPS, create_train_state(model), {monitor: 0.0})
    del model
    torch.cuda.empty_cache()
    setup_s = time.time() - t0
    val_batches = 1
    t1 = time.time()
    with val_scenes(cfg.data.batch_size):
        gather.gather_rows.launches = 0
        eval_cli.main(["--folder", run_dir, "--task", task])
        torch.cuda.synchronize()
        launches = gather.gather_rows.launches
    cli_s = time.time() - t1
    with open(os.path.join(run_dir, f"eval_{task}.json")) as f:
        res = json.load(f)
    if not all(math.isfinite(res[k]) for k in keys):
        raise AssertionError(f"{name}: non-finite {res}")
    if res["checkpoint"].get("kind") not in ("best", "last"):
        raise AssertionError(f"{name}: checkpoint {res['checkpoint']}")
    if launches != val_batches * per_forward:
        raise AssertionError(f"{name}: {launches} gather_rows launches")
    emit({"phase": name, **res,
          "reduced": [f"{cfg.data.batch_size} val scenes, one batch, of "
                      f"the config's {max(2, cfg.data.synthetic.num_scenes // 8)}"],
          "val_batches": val_batches, "gather_launches": launches,
          "setup_s": round(setup_s, 3), "cli_s": round(cli_s, 3),
          "seconds": round(time.time() - t0, 3)})


# --------------------------------------------------------------------------
def phase_spk_train_parity():
    """One mode-1 train step at the tiny captioning widths: cuda vs cpu,
    with the detector trained and frozen."""
    t0 = time.time()
    cfg = load_task_config(TINY_CAPTION_CONFIG)
    cfg.model.use_orientation = True
    cfg.data.min_iou_threshold = 0.0   # good rows from a random detector
    vocab, emb = pipeline.build_vocab(cfg)
    case = speaker_step_case(cfg, vocab, seed=0)
    reports = {}
    for freeze in (False, True):
        reports["frozen_detector" if freeze else "trained_detector"] = \
            speaker_step_cuda_vs_cpu(
                cfg, vocab, emb, case, freeze, loss_rtol=PARITY_RTOL,
                grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL,
                bn_rtol=PARITY_RTOL, bn_atol=PARITY_ATOL,
                kink_noise=KINK_NOISE)
    emit({"phase": "spk_train_parity", "config": "conf/debug/tiny_captioning"
          ".yaml (use_orientation on, min_iou_threshold 0, seeded object "
          "rotations)", **reports, "loss_rtol": PARITY_RTOL,
          "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL,
          "seconds": round(time.time() - t0, 3)})
    bad = {k: r["outside_tolerance"] for k, r in reports.items()
           if not r["ok"]}
    if bad:
        raise AssertionError(f"speaker train step cuda vs cpu: {bad}, "
                             f"integers {[r['integers_equal'] for r in reports.values()]}")


def _stage_train(root, det_run_dir, config, steps_n, checked_step,
                 per_step, per_forward, monitor, where, submodules=()):
    """A pipeline stage as users run it: ``prepare_weights`` on the run
    phase's detector (and on the run dir of each (submodule, run dir) of
    ``submodules``, whose pickle the config then names), then the train
    CLI on ``config`` for ``steps_n``
    steps, the loop waiting for the card around each part of a
    step and the gathers of step ``checked_step`` each held to the plain
    version as they run; then a fresh state restored from the run dir must
    equal the run's final state bit for bit. Returns what the phase
    reports and the restored state."""
    pre = os.path.join(root, "pretrained")
    prepare_weights.main(["--folder", det_run_dir, "--name", "run", "--out",
                          pre])
    cfg = load_task_config(config)
    cfg.general.output_root = root
    cfg.model.pretrained_detector = os.path.join(pre, "run_detector.pkl")
    for sub, folder in submodules:
        prepare_weights.main(["--folder", folder, "--name", sub, "--out",
                              pre])
        setattr(cfg.model, f"pretrained_{sub}",
                os.path.join(pre, f"{sub}_{sub}.pkl"))
    log_every = cfg.train.log_every_n_steps
    cfg.train.log_every_n_steps = 1
    config_path = os.path.join(root, os.path.basename(config))
    save_cfg(cfg, config_path)
    run_dir = os.path.join(root, cfg.general.experiment)

    steps, states, seen = [], [], [0]
    rec = GatherRecorder(gather, check=True, where=f"the {where} train step")

    def on_step(r):
        r["gather_launches"] = gather.gather_rows.launches - seen[0]
        seen[0] = gather.gather_rows.launches
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps.append(r)
        mod = rec if r["step"] == checked_step - 1 else gather
        sparse_conv.gather, segment.gather = mod, mod

    real = pipeline.run_pipeline_training

    def run(*args, **kw):
        states.append(real(*args, on_step=on_step, **kw))
        return states[-1]

    pipeline.run_pipeline_training = run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # what earlier phases hold
    t0 = time.time()
    try:
        with val_scenes(cfg.data.batch_size):
            gather.gather_rows.launches = 0  # the main path, counted from here
            train_cli.main(["--config", config_path, "--max_steps",
                            str(steps_n)])
            torch.cuda.synchronize()
    finally:
        pipeline.run_pipeline_training = real
        sparse_conv.gather, segment.gather = gather, gather
    run_s = time.time() - t0
    val_peak = torch.cuda.max_memory_allocated()   # validation, checkpoint
    launches = gather.gather_rows.launches
    recs = _metrics(run_dir)
    train = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if f"val/{monitor}" in r]
    bad = [(r["step"], k) for r in recs for k, v in r.items()
           if not math.isfinite(v)]
    if len(steps) != steps_n or [r["step"] for r in train] != list(
            range(1, steps_n + 1)) or len(val) != 1:
        raise AssertionError(f"{where}: {len(steps)} steps, metrics steps "
                             f"{[r['step'] for r in recs]}")
    if bad:
        raise AssertionError(f"{where}: non-finite metrics {bad}")
    if rec.checked != per_step:
        raise AssertionError(f"{where}: {rec.checked} gathers checked in "
                             f"step {checked_step}, expected {per_step}")
    per = _check_launches(where, steps, launches, per_step, per_forward)
    best = json.load(open(os.path.join(run_dir, "ckpt_best", "best.json")))
    if best["monitor"] != monitor or best["step"] != steps_n:
        raise AssertionError(f"{where}: best checkpoint {best}")
    state = states[0]
    saved = _state_copy(state)
    del state, states[:]
    torch.cuda.empty_cache()

    # a fresh state restored from the run dir equals the run's final state
    vocab, emb = pipeline.build_vocab(cfg)
    model = pipeline.pipeline_from_cfg(cfg, vocab)
    model.load_state_dict(flax_to_state_dict(init_flax_variables(model, 1),
                                             model))
    o = cfg.train.optim
    fresh = create_train_state(
        model.cuda(), lr=o.lr, optim=o.classname,
        weight_decay=o.weight_decay, step_epoch=cfg.train.step_epoch,
        multiplier=cfg.train.multiplier)
    if Checkpointer(run_dir, monitor, "max").restore_last(fresh) is None:
        raise AssertionError(f"{where}: no checkpoint in the run dir")
    diff = _first_difference(_state_copy(fresh), saved)
    if diff is not None:
        raise AssertionError(f"{where}: restored state differs at {diff}")
    n_tensors = sum(1 for _ in _tensors(saved))
    del saved

    # one batch of the config's val scenes (no augmentation), its rows
    chunk = int(cfg.data.num_des_per_scene)
    with val_scenes(cfg.data.batch_size):
        val_it = make_val_loader(cfg, spec_from_cfg(cfg), return_scenes=True)
        batch_np, scenes = next(iter(val_it))
    lang_np = build_lang_batch(
        scenes, vocab, chunk, cfg.data.max_spk_len, np.random.default_rng(0),
        cfg.data.max_num_instance, apply_word_erase=True,
        num_refs=int(cfg.train.get("num_caption_refs", 1) or 1))
    timed = [r for r in steps if r["step"] not in (1, checked_step)]
    report = {
        "reduced": [f"{steps_n} steps (max_steps {steps_n}) of the config's "
                    f"{cfg.train.epochs} epochs of "
                    f"{cfg.data.synthetic.num_scenes // cfg.data.batch_size}",
                    f"{cfg.data.batch_size} val scenes, one batch, of the "
                    f"config's {max(2, cfg.data.synthetic.num_scenes // 8)}",
                    f"log_every_n_steps 1 (the config's {log_every})"],
        "timing": "the loop waits for the card around each part of a "
                  f"step; medians over steps but 1 and {checked_step} (the "
                  "checked one)",
        "run_step_ms": _median(timed, "wall_s"),
        "data_wait_ms": _median(timed, "data_wait_s"),
        "h2d_ms": _median(timed, "h2d_s"),
        "h2d_bytes": steps[0]["h2d_bytes"],
        "step_ms": _median(timed, "step_s"),
        "steps": [{(k[:-2] + "_ms" if k.endswith("_s") else k):
                   (round(v * 1e3, 3) if k.endswith("_s")
                    else round(v, 3) if isinstance(v, float) else v)
                   for k, v in r.items() if k != "t_start"} for r in steps],
        "max_memory_allocated": max([val_peak] + [r["peak_bytes"]
                                                  for r in steps]),
        "allocated_before_run": base, "val_peak": val_peak,
        "run_s": round(run_s, 3), "gather_launches": launches,
        "gather_launches_per_step": per,
        "gathers_checked_exact": rec.checked,
        "gather_max_abs_err": rec.max_abs_err,
        "gather_rows_by_dtype_width": rec.rows_by_dtype_width,
        "gather_bytes_needed": rec.bytes_needed,
        "gather_bound_ms": rec.bytes_needed / HBM_BYTES_PER_S * 1e3,
        "losses_finite": True,
        "train_losses": [r["train/loss"] for r in train],
        "val": {k[4:]: v for k, v in val[0].items() if k != "step"},
        "best": best, "restored_bit_exact": ["model", "optimizer",
                                             "scheduler", "step"],
        "tensors_compared": n_tensors, "run_dir": sorted(os.listdir(run_dir))}
    return SimpleNamespace(
        cfg=cfg, vocab=vocab, emb=emb, chunk=chunk, fresh=fresh,
        run_dir=run_dir,
        batch=batch_to_torch(batch_np, "cuda"),
        lang=pipeline.lang_rows(lang_np, emb, "cuda"), train=train,
        report=report)


def stage_run_dir(root, config):
    """The run dir ``_stage_train`` gives the stage of ``config`` under
    ``root``."""
    return os.path.join(root, load_task_config(config).general.experiment)


def phase_spk_train(root, det_run_dir, per_step, per_forward):
    """The speaker's stage as users run it (``_stage_train`` on
    conf/pointgroup_captioning.yaml), then the step timed alone, its
    profile and the teacher-forced decoder's launches. Returns its
    ``gather_rows`` launches a step, the checked gathers' largest error,
    the bound of the checked step's gathers (the bytes they need over
    HBM's rate) and their device time in the profiled step."""
    t_phase = time.time()
    st = _stage_train(root, det_run_dir, CAPTION_CONFIG, SPK_STEPS,
                      SPK_CHECKED_STEP, per_step, per_forward, "cider",
                      "spk_train")
    cfg, fresh, batch, lang, chunk = st.cfg, st.fresh, st.batch, st.lang, \
        st.chunk
    lw = tuple(cfg.train.loss_weight[:4])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        return pipeline.speaker_train_step(fresh, batch, lang, gen,
                                           chunk_size=chunk, loss_weight=lw)[1]

    torch.cuda.reset_peak_memory_stats()
    med = time_ms({"step": step}, SPK_REPS, inner=1)["step"]
    step_peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in step().items()}
    prof = phase_profile("spk_train_profile", step)

    # the speaker's forward and backward alone (graph, target selection,
    # teacher-forced decoder, caption loss), on detached detector outputs;
    # then the teacher-forced decoder alone, forward and backward
    spk = fresh.model.speaker
    with torch.no_grad():
        det = fresh.model.run_detector(batch, train=True, generator=gen)
    det = {k: v.detach() for k, v in det.items()}
    det["proposal_feats_batched"].requires_grad_()
    data = {**det, **lang, **pipeline.expand_rows(det, batch, chunk)}
    n_rows = lang["lang_ids"].shape[0]
    g = pipeline.gumbel_draw((n_rows, cfg.model.max_num_proposal), gen, "cuda")

    def speaker_fwd_bwd():
        out = fresh.model.run_speaker(data, mode="tf", chunk_size=chunk,
                                      gumbel=g)
        loss, _ = caption_loss(
            out["lang_cap"], lang["lang_ids"],
            out["good_bbox_masks"] & (lang["annotated"] > 0))
        loss.backward()

    rows = expand_to_rows(spk.graph(data), chunk)
    inputs = [x.detach() for x in spk.caption.train_inputs(rows, g)[3:]]
    inputs[0].requires_grad_()
    inputs[1].requires_grad_()
    steps_tf = lang["lang_ids"].shape[1] - 1

    def tf_fwd_bwd():
        spk.caption.teacher_forcing(lang["lang_ids"], lang["glove_embeddings"],
                                    *inputs).sum().backward()

    parts = time_ms({"speaker_fwd_bwd": speaker_fwd_bwd,
                     "tf_fwd_bwd": tf_fwd_bwd}, SPK_REPS, inner=1)
    tf_kernels = phase_profile("spk_tf_profile", tf_fwd_bwd)
    tf_launches = sum(r[2] for r in tf_kernels)
    gather_dev_ms = sum(r[1] for r in prof if "gather_rows_kernel" in r[0])
    rep = st.report
    o = cfg.train.optim
    emit({"phase": "spk_train", "config": "conf/pointgroup_captioning.yaml",
          "widths": {"batch": cfg.data.batch_size,
                     "max_num_point": cfg.data.max_num_point,
                     "max_num_instance": cfg.data.max_num_instance,
                     "m": cfg.model.m, "levels": len(cfg.model.blocks),
                     "proposals": cfg.model.max_num_proposal,
                     "description_rows": n_rows,
                     "teacher_forced_steps": steps_tf,
                     "graph_steps": cfg.model.num_graph_steps,
                     "num_locals": cfg.model.num_locals,
                     "vocab": len(st.vocab),
                     "freeze_detector": bool(cfg.model.freeze_detector),
                     "optimizer": o.classname, "lr": o.lr,
                     "num_workers": cfg.data.get("num_workers"),
                     "activation_dtype": cfg.tpu.get("activation_dtype")},
          "weights": "the run phase's detector through prepare_weights, a "
                     "seeded random speaker",
          **rep,
          "spk_train_step_ms": med,
          "speaker_fwd_bwd_ms": parts["speaker_fwd_bwd"],
          "speaker_share": parts["speaker_fwd_bwd"] / med,
          "tf_fwd_bwd_ms": parts["tf_fwd_bwd"],
          "tf_launches": tf_launches,
          "tf_launches_per_step": tf_launches / steps_tf,
          "step_peak": step_peak,
          "gather_device_ms": gather_dev_ms,
          "kernel_launches_per_step": sum(r[2] for r in prof),
          "captioning_losses": [r["train/captioning_loss"] for r in st.train],
          "step_losses": losses,
          "seconds": round(time.time() - t_phase, 3)})
    for key in ("cider", "bleu4", "rouge"):
        if not math.isfinite(rep["val"][key]):
            raise AssertionError(f"spk_train: val {key} not finite")
    del fresh, batch, lang, data, det, inputs, rows, st
    torch.cuda.empty_cache()
    return {"spk_train_launches_per_step": rep["gather_launches_per_step"],
            "spk_train_max_abs_err": rep["gather_max_abs_err"],
            "spk_train_bound_ms": rep["gather_bound_ms"],
            "spk_train_device_ms": gather_dev_ms}


# --------------------------------------------------------------------------
def phase_grounding_parity():
    """The listener at the tiny grounding widths on seeded proposals and
    descriptions (lengths 0 and T among them): cuda vs cpu, eval and train
    forward with the same draws."""
    t0 = time.time()
    cfg = load_task_config(TINY_GROUNDING_CONFIG)
    vocab, emb = pipeline.build_vocab(cfg)
    variables = randomize(init_flax_variables(
        pipeline.pipeline_from_cfg(cfg, vocab), seed=0),
        np.random.default_rng(4))
    rng = np.random.default_rng(5)
    b, p = 4, cfg.model.max_num_proposal
    rows, t = b * int(cfg.data.num_des_per_scene), cfg.data.max_spk_len + 2
    data = fake_proposals(rng, b, p, cfg.model.m * cfg.model.cluster_blocks[0])
    data["proposal_center_batched"] = data.pop("proposal_bbox_batched").mean(-2)
    lens = rng.integers(1, t + 1, rows)
    lens[0], lens[1] = 0, t
    data["word_embs"] = emb[rng.integers(0, len(vocab), (rows, t))]
    data["lang_len"] = lens.astype(np.int64)
    report = listener_cuda_vs_cpu(variables, cfg, vocab, data, seed=0,
                                  rtol=PARITY_RTOL, atol=PARITY_ATOL)
    emit({"phase": "grounding_parity", "config": "conf/debug/"
          "tiny_grounding.yaml, fake proposals and descriptions", **report,
          "seconds": round(time.time() - t0, 3)})
    if not report["ok"]:
        raise AssertionError(f"listener cuda vs cpu: outside tolerance "
                             f"{report['outside_tolerance']}")


def phase_grounding(det_weights, per_forward):
    """The mode-2 eval forward of a B=4 batch of the grounding config's
    val scenes and their descriptions: times, peak, gather launches,
    profiles."""
    t_phase = time.time()
    cfg = load_task_config(GROUNDING_CONFIG)
    vocab, emb = pipeline.build_vocab(cfg)
    spec = spec_from_cfg(cfg)
    val_it = make_val_loader(cfg, spec)
    scenes = [val_it.scenes[i] for i in range(cfg.data.batch_size)]
    chunk = int(cfg.data.num_des_per_scene)
    t0 = time.time()
    batch_np = build_batch(scenes, spec)
    collate_s = time.time() - t0
    lang_np = build_lang_batch(scenes, vocab, chunk, cfg.data.max_spk_len,
                               np.random.default_rng(0), spec.max_instances)
    batch = batch_to_torch(batch_np, "cuda")
    lang = pipeline.lang_rows(lang_np, emb, "cuda")
    model = pipeline_model(cfg, vocab, det_weights)
    lis = model.listener

    def forward(marks=None):
        det = model.run_detector(batch)
        if marks:
            marks[1].record()
        return det, model.run_listener(
            {**det, **lang}, lang["glove_embeddings"][lang["lang_ids"].long()],
            lang["lang_len"], chunk)

    with torch.no_grad():
        for _ in range(GROUND_WARMUP):
            forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(GROUND_REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            det, out = forward(ev)
            ev[2].record()
            torch.cuda.synchronize()
            runs.append((ev[0].elapsed_time(ev[2]), ev[0].elapsed_time(ev[1]),
                         ev[1].elapsed_time(ev[2])))
        peak = torch.cuda.max_memory_allocated()

        # the main path, counted: counts set to 0 just before, read after;
        # each gather's output held bit-exact against the plain version on
        # the same tensors as it happens (the plain calls launch no kernel)
        rec = GatherRecorder(gather, check=True, where="the grounding forward")
        sparse_conv.gather, segment.gather = rec, rec
        try:
            gather.gather_rows.launches = 0
            forward()
            torch.cuda.synchronize()
            launches = gather.gather_rows.launches
        finally:
            sparse_conv.gather, segment.gather = gather, gather

        # the listener's parts alone, on the last run's inputs
        word_embs = lang["glove_embeddings"][lang["lang_ids"].long()]
        lang_out = lis.lang(word_embs, lang["lang_len"])
        data = {**det, **lang, **lang_out}
        parts = time_ms({
            "listener": lambda: model.run_listener(
                {**det, **lang}, lang["glove_embeddings"][
                    lang["lang_ids"].long()], lang["lang_len"], chunk),
            "lang": lambda: lis.lang(word_embs, lang["lang_len"]),
            "match": lambda: lis.match(data, chunk)}, GROUND_REPS, inner=1)
        fwd_kernels = phase_profile("grounding_profile", forward)
        lang_kernels = phase_profile(
            "grounding_lang_profile",
            lambda: lis.lang(word_embs, lang["lang_len"]))

    ref = out["cluster_ref"]
    b, k = cfg.data.batch_size, cfg.model.max_num_proposal
    t = lang["lang_ids"].shape[1]
    if tuple(ref.shape) != (b * chunk, k):
        raise AssertionError(f"cluster_ref {tuple(ref.shape)}")
    for key in ("cluster_ref", "lang_scores", "lang_emb", "lang_hiddens"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{key} has non-finite values")
    if launches != per_forward or rec.checked != launches:
        raise AssertionError(f"grounding: {launches} gather_rows launches a "
                             f"batch ({rec.checked} checked), expected "
                             f"{per_forward}")
    med = [statistics.median(r[i] for r in runs) for i in range(3)]
    lang_launches = sum(r[2] for r in lang_kernels)
    emit({"phase": "grounding", "config": "conf/pointgroup_grounding.yaml",
          "widths": {"batch": b, "max_num_point": cfg.data.max_num_point,
                     "max_num_instance": cfg.data.max_num_instance,
                     "m": cfg.model.m, "levels": len(cfg.model.blocks),
                     "proposals": k, "description_rows": b * chunk,
                     "gru_steps": t, "lang_hidden": lis.lang.hidden_size,
                     "match_type": cfg.model.match_type,
                     "activation_dtype": cfg.tpu.get("activation_dtype")},
          "weights": "the run phase's detector, a seeded random listener",
          "host_collate_s": round(collate_s, 3),
          "ground_fwd_ms": med[0], "detector_ms": med[1],
          "listener_ms": med[2], "ground_fwd_ms_all": [r[0] for r in runs],
          "detector_ms_all": [r[1] for r in runs],
          "listener_ms_all": [r[2] for r in runs],
          "listener_alone_ms": parts["listener"], "lang_ms": parts["lang"],
          "match_ms": parts["match"], "listener_share": med[2] / med[0],
          "max_memory_allocated": peak,
          "gather_launches_per_batch": launches,
          "gathers_checked_exact": rec.checked,
          "gather_max_abs_err": rec.max_abs_err,
          "gather_rows_by_dtype_width": rec.rows_by_dtype_width,
          "kernel_launches_per_batch": sum(r[2] for r in fwd_kernels),
          "lang_launches": lang_launches,
          "lang_launches_per_step": lang_launches / t,
          "annotated_rows": int(lang["annotated"].sum()),
          "proposals_valid": int(det["proposal_batch_mask"].sum()),
          "seconds": round(time.time() - t_phase, 3)})
    del model, batch, lang, out, det, data, lang_out, word_embs
    torch.cuda.empty_cache()
    return launches, rec.max_abs_err


def phase_lis_train_parity():
    """One mode-2 train step at the tiny grounding widths: cuda vs cpu,
    with the detector trained and frozen."""
    t0 = time.time()
    cfg = load_task_config(TINY_GROUNDING_CONFIG)
    vocab, emb = pipeline.build_vocab(cfg)
    case = listener_step_case(cfg, vocab, emb, seed=0)
    reports = {}
    for freeze in (False, True):
        reports["frozen_detector" if freeze else "trained_detector"] = \
            listener_step_cuda_vs_cpu(
                cfg, vocab, emb, case, freeze, loss_rtol=PARITY_RTOL,
                grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL,
                bn_rtol=PARITY_RTOL, bn_atol=PARITY_ATOL,
                kink_noise=KINK_NOISE)
    emit({"phase": "lis_train_parity", "config": "conf/debug/"
          "tiny_grounding.yaml (copy-paste applied, dropout on)", **reports,
          "loss_rtol": PARITY_RTOL, "grad_rtol": GRAD_RTOL,
          "grad_atol": GRAD_ATOL, "seconds": round(time.time() - t0, 3)})
    bad = {k: r["outside_tolerance"] for k, r in reports.items()
           if not r["ok"]}
    if bad:
        raise AssertionError(f"listener train step cuda vs cpu: {bad}")


def phase_lis_train(root, det_run_dir, per_step, per_forward):
    """The listener's stage as users run it (``_stage_train`` on
    conf/pointgroup_grounding.yaml), then the step timed alone, its
    profile, the listener's and its GRU encoder's forward and backward.
    Returns the ``gather_rows`` numbers of the stage's steps."""
    t_phase = time.time()
    st = _stage_train(root, det_run_dir, GROUNDING_CONFIG, LIS_STEPS,
                      LIS_CHECKED_STEP, per_step, per_forward,
                      "ref_iou_rate_0.5", "lis_train")
    cfg, fresh, batch, lang, chunk = st.cfg, st.fresh, st.batch, st.lang, \
        st.chunk
    lw = tuple(cfg.train.loss_weight[:4])
    loss_type = str(cfg.model.get("loss_type", "cross_entropy"))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        return pipeline.listener_train_step(
            fresh, batch, lang, gen, chunk_size=chunk, loss_weight=lw,
            loss_type=loss_type)[1]

    torch.cuda.reset_peak_memory_stats()
    med = time_ms({"step": step}, LIS_REPS, inner=1)["step"]
    step_peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in step().items()}
    prof = phase_profile("lis_train_profile", step)

    # the listener's forward and backward alone (GRU encoder, match module,
    # grounding and lang-cls losses) on detached detector outputs; then the
    # GRU encoder alone, forward and backward
    lis = fresh.model.listener
    with torch.no_grad():
        det = fresh.model.run_detector(batch, train=True, generator=gen)
    det = {k: v.detach() for k, v in det.items()}
    det["proposal_feats_batched"].requires_grad_()
    rows = pipeline.expand_rows(det, batch, chunk)
    word_embs = lang["glove_embeddings"][lang["lang_ids"].long()]
    word_embs.requires_grad_()
    t = lang["lang_ids"].shape[1]

    def listener_fwd_bwd():
        out = fresh.model.run_listener({**det, **lang}, word_embs,
                                       lang["lang_len"], chunk, train=True,
                                       draws=ListenerDraws(gen))
        ref_l, _ = grounding_loss(out["cluster_ref"],
                                  rows["proposal_bbox_rows"],
                                  lang["ref_box_corner_label"],
                                  lang["annotated"], loss_type=loss_type)
        cls_l, _ = lang_cls_loss(out["lang_scores"], lang["ref_cat_label"],
                                 lang["annotated"])
        (ref_l + cls_l).backward()

    def lang_fwd_bwd():
        out = lis.lang(word_embs, lang["lang_len"], ListenerDraws(gen))
        (out["lang_hiddens"].sum() + out["lang_emb"].sum()
         + out["lang_scores"].sum()).backward()

    parts = time_ms({"listener_fwd_bwd": listener_fwd_bwd,
                     "lang_fwd_bwd": lang_fwd_bwd}, LIS_REPS, inner=1)
    lang_kernels = phase_profile("lis_lang_profile", lang_fwd_bwd)
    lang_launches = sum(r[2] for r in lang_kernels)
    gather_dev_ms = sum(r[1] for r in prof if "gather_rows_kernel" in r[0])
    rep = st.report
    o = cfg.train.optim
    emit({"phase": "lis_train", "config": "conf/pointgroup_grounding.yaml",
          "widths": {"batch": cfg.data.batch_size,
                     "max_num_point": cfg.data.max_num_point,
                     "max_num_instance": cfg.data.max_num_instance,
                     "m": cfg.model.m, "levels": len(cfg.model.blocks),
                     "proposals": cfg.model.max_num_proposal,
                     "description_rows": lang["lang_ids"].shape[0],
                     "gru_steps": t, "lang_hidden": lis.lang.hidden_size,
                     "match_type": cfg.model.match_type,
                     "loss_type": loss_type,
                     "freeze_detector": bool(cfg.model.freeze_detector),
                     "optimizer": o.classname, "lr": o.lr,
                     "num_workers": cfg.data.get("num_workers"),
                     "activation_dtype": cfg.tpu.get("activation_dtype")},
          "weights": "the run phase's detector through prepare_weights, a "
                     "seeded random listener",
          **rep,
          "lis_train_step_ms": med,
          "listener_fwd_bwd_ms": parts["listener_fwd_bwd"],
          "listener_share": parts["listener_fwd_bwd"] / med,
          "lang_fwd_bwd_ms": parts["lang_fwd_bwd"],
          "lang_launches": lang_launches,
          "lang_launches_per_step": lang_launches / t,
          "step_peak": step_peak,
          "gather_device_ms": gather_dev_ms,
          "kernel_launches_per_step": sum(r[2] for r in prof),
          "grounding_losses": [r["train/grounding_loss"] for r in st.train],
          "step_losses": losses,
          "seconds": round(time.time() - t_phase, 3)})
    for key in ("ref_iou_rate_0.25", "ref_iou_rate_0.5"):
        if not math.isfinite(rep["val"][key]):
            raise AssertionError(f"lis_train: val {key} not finite")
    del fresh, batch, lang, det, rows, word_embs, st
    torch.cuda.empty_cache()
    return {"lis_train_launches_per_step": rep["gather_launches_per_step"],
            "lis_train_max_abs_err": rep["gather_max_abs_err"],
            "lis_train_bound_ms": rep["gather_bound_ms"],
            "lis_train_device_ms": gather_dev_ms}


# --------------------------------------------------------------------------
def phase_joint_parity():
    """One mode-3 train step at the tiny joint widths: cuda vs cpu, with
    the detector trained and frozen."""
    t0 = time.time()
    cfg = joint_parity_config(load_task_config(TINY_JOINT_CONFIG))
    vocab, emb = pipeline.build_vocab(cfg)
    case = joint_step_case(cfg, vocab, emb, seed=0)
    reports = {}
    for freeze in (False, True):
        reports["frozen_detector" if freeze else "trained_detector"] = \
            joint_step_cuda_vs_cpu(
                cfg, vocab, emb, case, freeze, loss_rtol=PARITY_RTOL,
                grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL,
                bn_rtol=PARITY_RTOL, bn_atol=PARITY_ATOL,
                kink_noise=KINK_NOISE)
    emit({"phase": "joint_parity", "config": "conf/debug/tiny_joint.yaml "
          "(beam 3 in 3 groups, lambda 0.5, top 3, 4 caption references, "
          "rl_xe_weight 0.2, min_iou_threshold 0; copy-paste applied, "
          "dropout on)", **reports, "loss_rtol": PARITY_RTOL,
          "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL,
          "seconds": round(time.time() - t0, 3)})
    bad = {k: (r["outside_tolerance"], r["rollout_ids_equal"],
               r["first_difference"]) for k, r in reports.items()
           if not r["ok"]}
    if bad:
        raise AssertionError(f"joint train step cuda vs cpu: {bad}")


def phase_joint_train(root, det_run_dir, spk_run_dir, lis_run_dir,
                      per_step, per_forward):
    """Joint RL's stage as users run it (``_stage_train`` on
    conf/pointgroup_joint.yaml from the detector, speaker and listener
    stages' pickles), then the step timed alone, profiled and split.
    Returns the stage's run dir and its ``gather_rows`` numbers."""
    t_phase = time.time()
    st = _stage_train(root, det_run_dir, JOINT_CONFIG, JOINT_STEPS,
                      JOINT_CHECKED_STEP, 2 * per_step, per_forward,
                      "combined", "joint_train",
                      submodules=(("speaker", spk_run_dir),
                                  ("listener", lis_run_dir)))
    cfg, fresh, batch, lang, chunk = st.cfg, st.fresh, st.batch, st.lang, \
        st.chunk
    model, spk = fresh.model, fresh.model.speaker
    kw = joint_step_kw(cfg)
    topn = kw["sample_topn"]
    reward_fn = pipeline.make_caption_reward_fn(st.vocab)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        # both streams on the val batch: the step's shapes, one batch
        return pipeline.joint_rl_train_step(fresh, batch, lang, batch, lang,
                                            reward_fn, gen, **kw)[1]

    torch.cuda.reset_peak_memory_stats()
    med = time_ms({"step": step}, JOINT_REPS, inner=1)["step"]
    step_peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in step().items()}
    prof = phase_profile("joint_train_profile", step)

    # the parts: the rollout on the detector's output (no grad), the host
    # reward of its samples and baseline, each stream forward and backward
    b, p = batch["point_mask"].shape[0], cfg.model.max_num_proposal
    n_rows = lang["lang_ids"].shape[0]
    det = model.detector
    jitter = torch.rand((b, 2 * det.clusters_per_pass, 3), generator=gen,
                        device="cuda")
    perm = torch.randperm(p, generator=gen, device="cuda")[None]
    g = pipeline.gumbel_draw((n_rows, p), gen, "cuda")
    with torch.no_grad():
        out = model.run_detector(batch, train=True, jitter_u=jitter,
                                 proposal_perm=perm)
    data = {**out, **lang, **pipeline.expand_rows(out, batch, chunk)}

    def rollout():
        return pipeline.sample_caption_ids(
            model, data, chunk_size=chunk, beam_size=kw["beam_size"],
            sample_topn=topn, gumbel=g)

    roll = rollout()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")      # no host sync in the search
    try:
        rollout()
    finally:
        torch.cuda.set_sync_debug_mode("default")

    def reward():
        return pipeline.caption_scores(reward_fn, roll, lang, topn)

    reward_s = []
    for _ in range(JOINT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reward()
        reward_s.append(time.perf_counter() - t0)
    sw = {k: v for k, v in kw.items() if k not in ("beam_size",
                                                   "sample_topn")}

    def spk_stream():
        pipeline.speaker_stream_losses(
            model, batch, lang, reward_fn, beam_size=kw["beam_size"],
            sample_topn=topn, jitter_u=jitter, proposal_perm=perm, gumbel=g,
            draws=ListenerDraws(gen), **sw)[0].backward()

    def lis_stream():
        pipeline.listener_losses(
            model, batch, lang, chunk_size=chunk,
            loss_weight=kw["loss_weight"], loss_type=kw["loss_type"],
            jitter_u=jitter, proposal_perm=perm,
            draws=ListenerDraws(gen))[0].backward()

    parts = time_ms({"rollout": rollout, "spk_stream": spk_stream,
                     "lis_stream": lis_stream}, JOINT_REPS, inner=1)
    with torch.no_grad():
        rows = expand_to_rows(spk.graph(data), chunk)
        rows.update(target_ids_in=roll["target_ids"],
                    target_ious_in=roll["target_ious"])
        beam_in = spk.caption.train_inputs(rows, None)[3:]
    t_beam = cfg.data.max_spk_len + 1

    def beam():
        with torch.no_grad():
            spk.caption.beam_decode(
                lang["glove_embeddings"], *beam_in, kw["beam_size"],
                group_size=spk.caption.beam_group_size,
                diversity_lambda=spk.caption.diversity_lambda)

    beam_kernels = phase_profile("joint_beam_profile", beam)
    beam_launches = sum(r[2] for r in beam_kernels)
    rollout_kernels = phase_profile("joint_rollout_profile", rollout)
    gather_dev_ms = sum(r[1] for r in prof if "gather_rows_kernel" in r[0])
    rep = st.report
    o = cfg.train.optim
    emit({"phase": "joint_train", "config": "conf/pointgroup_joint.yaml",
          "widths": {"batch": cfg.data.batch_size,
                     "max_num_point": cfg.data.max_num_point,
                     "max_num_instance": cfg.data.max_num_instance,
                     "m": cfg.model.m, "levels": len(cfg.model.blocks),
                     "proposals": p, "description_rows": n_rows,
                     "beam_size": kw["beam_size"],
                     "beam_group_size": spk.caption.beam_group_size,
                     "diversity_lambda": spk.caption.diversity_lambda,
                     "sample_topn": topn, "beam_steps": t_beam,
                     "sampled_rows": n_rows * topn,
                     "num_caption_refs": cfg.train.num_caption_refs,
                     "rl_xe_weight": kw["xe_weight"],
                     "match_type": cfg.model.match_type,
                     "freeze_detector": bool(cfg.model.freeze_detector),
                     "optimizer": o.classname, "lr": o.lr,
                     "num_workers": cfg.data.get("num_workers"),
                     "activation_dtype": cfg.tpu.get("activation_dtype")},
          "weights": "prepare_weights of the run phase's detector, the "
                     "spk_train phase's speaker and the lis_train phase's "
                     "listener",
          **rep,
          "joint_train_step_ms": med,
          "rollout_ms": parts["rollout"],
          "reward_ms": statistics.median(reward_s) * 1e3,
          "spk_stream_ms": parts["spk_stream"],
          "lis_stream_ms": parts["lis_stream"],
          "timing_note": "joint_train_step_ms: CUDA events, median of 5 "
                         "after 1 warm-up, both streams on the val batch; "
                         "reward_ms on the host clock (one sync, two "
                         "CIDEr calls); spk_stream_ms (rollout and reward "
                         "included) and lis_stream_ms forward + backward",
          "rollout_host_syncs": 0,
          "rollout_launches": sum(r[2] for r in rollout_kernels),
          "beam_launches": beam_launches,
          "beam_launches_per_step": beam_launches / t_beam,
          "step_peak": step_peak,
          "kernel_launches_per_step": sum(r[2] for r in prof),
          "gather_device_ms": gather_dev_ms,
          "joint_train_bound_ms": rep["gather_bound_ms"],
          "train_rewards": [r["train/ttl_rwd"] for r in st.train],
          "captioning_losses": [r["train/captioning_loss"] for r in st.train],
          "step_losses": losses,
          "seconds": round(time.time() - t_phase, 3)})
    for key in ("cider", "ref_iou_rate_0.5", "combined"):
        if not math.isfinite(rep["val"][key]):
            raise AssertionError(f"joint_train: val {key} not finite")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"joint_train: step losses {losses}")
    run_dir = st.run_dir
    del fresh, batch, lang, data, out, rows, beam_in, roll, st, model, spk
    torch.cuda.empty_cache()
    return run_dir, {
        "joint_train_launches_per_step": rep["gather_launches_per_step"],
        "joint_train_max_abs_err": rep["gather_max_abs_err"],
        "joint_train_bound_ms": rep["gather_bound_ms"],
        "joint_train_device_ms": gather_dev_ms}


def phase_joint_eval(run_dir, per_forward):
    """The eval CLI's captioning and grounding tasks on the joint run dir,
    one val batch each: finite metrics, the checkpoint stamped, 75
    ``gather_rows`` launches a batch."""
    t0 = time.time()
    cfg = load_task_config(os.path.join(run_dir, "config.yaml"))
    report = {}
    for task, keys in (("captioning", ("bleu4", "cider", "rouge")),
                       ("grounding", ("ref_iou_rate_0.25", "ref_iou_rate_0.5",
                                      "iou_mean"))):
        t1 = time.time()
        with val_scenes(cfg.data.batch_size):
            gather.gather_rows.launches = 0
            eval_cli.main(["--folder", run_dir, "--task", task])
            torch.cuda.synchronize()
            launches = gather.gather_rows.launches
        with open(os.path.join(run_dir, f"eval_{task}.json")) as f:
            res = json.load(f)
        if not all(math.isfinite(res[k]) for k in keys):
            raise AssertionError(f"joint_eval {task}: non-finite {res}")
        if res["checkpoint"] != {"kind": "best", "step": JOINT_STEPS}:
            raise AssertionError(f"joint_eval {task}: {res['checkpoint']}")
        if launches != per_forward:
            raise AssertionError(f"joint_eval {task}: {launches} gathers")
        report[task] = {**{k: res[k] for k in keys},
                        "checkpoint": res["checkpoint"],
                        "gather_launches": launches,
                        "cli_s": round(time.time() - t1, 3)}
    emit({"phase": "joint_eval", **report,
          "reduced": [f"{cfg.data.batch_size} val scenes, one batch, of the "
                      f"config's {max(2, cfg.data.synthetic.num_scenes // 8)}"],
          "seconds": round(time.time() - t0, 3)})


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
    train = phase_train(variables, batch)
    kernels[0].update({k: v for k, v in train.items() if k != "step_ms"})
    del batch, variables
    torch.cuda.empty_cache()
    phase_host_lib()
    with tempfile.TemporaryDirectory(prefix="d3net_run_") as root:
        run_dir, val_batches, run_per_step = phase_run(
            root, train["train_launches"], launches, train["step_ms"])
        phase_eval(run_dir, val_batches, launches)
        phase_caption_parity()
        det_weights = run_detector_weights(run_dir)
        caption_launches, caption_err = phase_caption(det_weights, launches)
        phase_pipeline_eval("caption_eval", CAPTION_CONFIG, "captioning",
                            "cider", ("bleu4", "cider", "rouge", "meteor"),
                            os.path.join(root, "captioning"), det_weights,
                            launches)
        phase_spk_train_parity()
        spk = phase_spk_train(
            os.path.join(root, "spk"), run_dir, train["train_launches"],
            launches)
        phase_grounding_parity()
        grounding_launches, grounding_err = phase_grounding(det_weights,
                                                            launches)
        phase_pipeline_eval("grounding_eval", GROUNDING_CONFIG, "grounding",
                            "ref_iou_rate_0.5",
                            ("ref_iou_rate_0.25", "ref_iou_rate_0.5",
                             "iou_mean"),
                            os.path.join(root, "grounding"), det_weights,
                            launches)
        phase_lis_train_parity()
        lis = phase_lis_train(
            os.path.join(root, "lis"), run_dir, train["train_launches"],
            launches)
        phase_joint_parity()
        joint_run, joint = phase_joint_train(
            os.path.join(root, "joint"), run_dir,
            stage_run_dir(os.path.join(root, "spk"), CAPTION_CONFIG),
            stage_run_dir(os.path.join(root, "lis"), GROUNDING_CONFIG),
            train["train_launches"], launches)
        phase_joint_eval(joint_run, launches)
    kernels[0]["run_launches_per_step"] = run_per_step
    kernels[0]["caption_launches_per_batch"] = caption_launches
    kernels[0]["caption_max_abs_err"] = caption_err
    kernels[0]["grounding_launches_per_batch"] = grounding_launches
    kernels[0]["grounding_max_abs_err"] = grounding_err
    kernels[0].update(spk)
    kernels[0].update(lis)
    kernels[0].update(joint)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], caption_err,
                                    spk["spk_train_max_abs_err"],
                                    grounding_err,
                                    lis["lis_train_max_abs_err"],
                                    joint["joint_train_max_abs_err"])
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    emit({"kernels": kernels + probe_entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
