#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``d3net_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards N

With ``--cards N`` it runs only the train entry (``scripts.train.train``)
on conf/pointgroup.yaml for CARDS_STEPS steps on one card and then over N
cards (one NCCL process a card), after the host's cost of a rank's batch
build: lines ``cards_collate`` and ``cards_run`` (rank 0's ``iter_time``
a step, its traced device and NCCL ms a step); then the detection eval
of the N-card run dir on one card and over N (line ``cards_eval``: the
eval entry's seconds of each at the default settings, then both under
parity precision and deterministic algorithms, their metrics held equal);
then ``benchmark_grounding`` on an imported full-width joint run dir (the
``import_run`` phase's archive) over one card and N (line ``cards_tools``:
the seconds of each as users call it, then both under the exact settings,
their files held as ``dist_tools`` holds them); then ``nvidia-smi``'s line.

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
              (torch.profiler), the host's self time by op, and the
              device's idle share.
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
              the train CLI on conf/pointgroup_captioning.yaml for
              SPK_STEPS steps (``_stage_train``: per-step times and peaks, one
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
              JOINT_STEPS steps (``_stage_train``: per-step times and
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
27. tools   — the user-facing tools after training, in process on the
              card (``main([...])``) on that run dir, one val batch of 4
              scenes: ``benchmark_captioning`` (every scene in the JSON,
              well-formed entries, the proposals kept at the config's
              ``TEST_SCORE_THRESH``), ``benchmark_grounding`` (every scene,
              well-formed entries), ``visualize_captioning`` and
              ``visualize_grounding`` (every PLY read back through
              ``utils/ply.read_ply`` with its vertex count), each with its
              seconds and 75 ``gather_rows`` launches; then
              ``visualize_scannet --synthetic 2 --pred <dir>`` (numpy).
    Then each of the four again under the exact settings
              (``checks.tool_rank``: parity precision, deterministic
              algorithms, every gather checked): the one-process files
              ``dist_tools`` holds the ranks' to.
28. tools_parity — ``benchmark_captioning`` and ``benchmark_grounding`` on
              a tiny joint run dir (seeded weights) and ``port_enet_weights
              --selftest``, cuda against cpu inside
              ``device.parity_precision()``: captions, classes and ids
              equal, boxes, scores and the selftest forward within rtol
              1e-4 / atol 1e-5 (``checks.tools_cuda_vs_cpu``, shared with
              the card test).
29. import_run — a run of the JAX package carried onto the card as users
              carry it: a run archive of conf/pointgroup_joint.yaml at its
              published widths (f32, 128 proposals, beam 3 in 3 groups)
              written by the port's numpy writer (``jax_run``; weights
              from ``init_flax_variables``, the pipeline loop's AdamW
              multi_transform state with seeded non-zero moments at the
              update before a ``step_epoch`` boundary; 8 train scenes of
              64, so the boundary is update 960), ``import_jax_run`` on the
              card, a fresh state restored from the run dir holding the
              archive's step, lr, moments and weights exactly, then the
              train CLI resuming it for 2 steps across the boundary: the
              first step's 432 gathers each checked exact, each step's ms,
              one val batch, the new last checkpoint at the lr past the
              boundary, ``imported_from`` kept in ``run_meta.json``.
30. enet_parity — ENet's eval forward (light and full layouts, f32) and
              one ``train_enet`` step (f64, same dropout masks) at tiny
              size on uniform-noise images, cuda against cpu inside
              ``device.parity_precision()`` (``checks.enet_cuda_vs_cpu``,
              shared with the card test).
31. multiview — the flagship recipe's first two commands in process:
              ``train_enet`` at its published size (16 scenes x 8
              frames, 256x328, batch 8) for ENET_STEPS steps, its peak,
              a step timed alone (``enet_train_step_ms``, CUDA events) and
              profiled; then ``compute_multiview_features --config
              conf/flagship_converge.yaml --weights
              outputs/enet/enet_weights.pkl`` into a temporary store: its
              24 scenes (140-232k points), seconds a scene split into
              render, ENet and projection, the share of points seen,
              finite (N, 128) features.
32. flagship_train — the train CLI on a copy of
              conf/flagship_converge.yaml pointed at that store (published
              widths: 131,072 points, 7 levels, 134 channels, bf16, 128
              clusters a pass, 16 + 8 scenes, 12 steps a dispatch, 2
              augmented variants) for SCAN_DISPATCHES dispatches through
              ``run_detector_training_scan``: ``scan_step_ms`` (the last
              dispatch's CUDA-event ms / 12) and ``steps_per_sec``, the
              host syncs of dispatch 2's steps (sync debug "warn") and
              their call sites, the peak by dispatch (dispatch 1 holds the
              checked step) and the resident stack's bytes, 216
              ``gather_rows`` launches every
              step with step SCAN_CHECKED_STEP's held bit-exact against
              ``gather_rows_plain`` (their bytes: ``scan_train_bound_ms``),
              finite losses, the restored state bit-exact, one step
              profiled (``scan_train_device_ms``).
33. scannet_eval — ``eval --task detection`` and ``--task scannet`` on
              that run dir, one val batch each: finite metrics, the
              checkpoint stamped, the ``split_pred/val`` txt tree, 75
              gathers a batch.
34. dist    — data-parallel training and evaluation (``parallel/mesh.py``).
              ``dist_step`` (right after ``train``, on its flagship
              batch and weights): the detector train step through the
              distributed path on a one-rank NCCL group against the
              ``train`` phase's step with no group on the same draws
              (``checks.world1_group_step``: bit-equal where that step is
              bit-reproducible; the card's atomic adds make it not, and
              then within 4x the step's own run-to-run difference,
              tensor by tensor), its 216 gathers checked exact; then
              ``dist_step_ms`` (2 warm-up + 5 timed, CUDA events) beside
              ``train``'s, the all-reduces a step and their device ms in
              one profiled step, the peak. Then, after ``import_run``,
              one start of two ranks on cuda:0 over gloo (NCCL takes one
              rank a card) for four lines (``phase_dist``):
              ``dist_ranks``: against world size 1 on the card at
              conf/debug/ widths, TF32 off: the detector step with and
              without clustering and the mode-3 joint step (rollout ids,
              host scores, losses), parameters bit-identical across the
              ranks, every gather of every rank exact
              (``checks.dist_ranks_on_one_card``), and
              ``MaskedBatchNorm`` in bf16 at counts bf16 rounds.
              ``dist_dryrun``: ``parallel/dryrun.py``'s two steps, its two
              lines printed, finite losses. ``dist_eval``: the eval CLI's
              ``captioning`` and ``grounding`` on the ``joint_train`` run
              dir (f32; one val batch of 4, two scenes a rank) held
              against the ``joint_eval`` phase's one-process evals;
              ``detection`` on the ``run`` phase's (bf16, two batches)
              beside the ``eval`` phase's, reported (the bf16 eval forward
              does not reproduce itself run to run at the default
              settings), and held under parity precision and
              deterministic algorithms against a one-process eval under
              the same settings (metrics and the json file: ints and
              strings exact, floats within rtol 1e-5; both ranks'
              metrics equal); each rank's seconds beside the one
              process's. ``dist_tools``: the four model-running tools on
              the joint run dir's val batch under the exact settings
              against the ``tools`` phase's exact one-process files: text
              files byte-equal, JSON and PLY files byte-equal or within
              rtol 1e-5 by value (the f32 ScoreNet's scores move by ulps
              with the batch's size). Every ``gather_rows`` call of every
              rank exact against ``gather_rows_plain`` as it runs, 75 a
              rank a val batch.
35. prepare_scannet — (right after ``dist_step``) PREP_SCANS synthetic
              scans in ScanNet's raw layout at its size
              (``data/raw_scans.py``: 100-250k mesh vertices with faces,
              20 objects, a rigid alignment) through ``python -m
              d3net_tpu_torch.scripts.prepare_scannet --workers 8
              --write-inst-gt`` in a process of its own: seconds a scene,
              every npz read back through ``NpzScenes`` (points, finite
              arrays, labels, GT rows), then the scenes cropped and
              collated at the flagship spec and the bf16 detector forward
              on each batch of 4, its 75 gathers held exact.
36. profile_ops — the profiler CLI (``scripts/profile_ops.py``) in process
              for ``--what fwd``, ``train`` and ``conv0``: the first and
              second call's wall time, the profiled call's total device
              ms and events, its categories, its top 10 kernels and its
              ``gather_rows`` launches (75, 216, 3 over three convs); the
              first call's gathers held exact as they run.
37. curriculum — (started after ``joint_eval``, running beside
              ``tools``, ``tools_parity``, ``import_run`` and the two
              ranks of ``dist``, its line after theirs and before
              ``enet_parity``, ``multiview``, ``flagship_train`` and
              ``scannet_eval``; all of them mostly host work, and the
              lines of all carry ``ran_beside``: their times are
              contended) the port's
              ``run_r5_curriculum.sh`` on the four ``*_converge`` configs
              at their published widths in a temporary tree (a copy of
              conf/ and the script, the repo on PYTHONPATH), cut by
              CURRICULUM_ENV and CURRICULUM_DET_SCENES, its 11 processes
              watched by a ``sitecustomize`` hook
              (``checks.watch_process``): every gather held against the
              plain version on the card, each loop step timed with the
              card waited on, the scan dispatch's CUDA-event ms; each
              stage's seconds, step ms and finite losses, the evals'
              finite CIDEr, BLEU-4 and ``ref_iou_rate_0.5``, each
              process's gathers, each process's start, watched seconds
              and exit; the repo's outputs/ and pretrained/ left as they
              were.

The run keeps one bytecode cache (``PYTHONPYCACHEPREFIX``, a temp dir)
for itself and every Python process it starts.

Every phase line carries ``at_s``, the seconds since the run began.

Then the ``kernels`` line: one entry per kernel, with its launches on its
path, ``max_abs_err``, per-call ``ms``, profiled ``device_ms``, the plain
version's and the library call's time (``library_ms``,
``library_device_ms``) and the bound; the two rings add the bytes their
blocks move (``moved_bytes``), and ``gather_rows`` its launches per step
of the ``run``, ``spk_train``, ``lis_train`` and ``joint_train`` phases
and per batch of the ``caption``, ``grounding`` and ``tools`` phases, with
the three train stages' bounds and device times, and the same three for
the ``flagship_train`` scan step (its ``max_abs_err`` covers every checked
gather), the ``dist_step``'s launches per step, ``dist_eval``'s and
``dist_tools``' a rank a val batch, ``import_run``'s a resumed step,
``prepare_scannet``'s a batch, ``profile_ops``' profiled calls and each
curriculum process's.
The last two lines are
``nvidia-smi``'s name/power limit and ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, the script exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

if __name__ == "__main__" and os.path.isdir(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "d3net_tpu_torch")):
    # One bytecode cache for this run and every Python process it starts
    # (ranks, CLIs, the curriculum's 11): where the PyTorch installation
    # holds no bytecode and takes none, each start would compile some 2,000
    # modules again, 7 s a process on an H100 host (PERF.md).
    PYCACHE = tempfile.mkdtemp(prefix="d3net_pycache_")
    sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE, False
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    atexit.register(shutil.rmtree, PYCACHE, True)

import numpy as np
import torch

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch import device
from d3net_tpu_torch import probe as probe_cli
from d3net_tpu_torch import jax_run
from d3net_tpu_torch import trace
from d3net_tpu_torch.checks import (
    EVAL_RTOL, GatherRecorder, checked_gathers, detector_case, detector_repro,
    dist_ranks_on_one_card, enet_cuda_vs_cpu, eval_calls, eval_outputs,
    eval_reports,
    evals_world_vs_one, joint_parity_config, joint_step_case,
    joint_step_cuda_vs_cpu, joint_step_kw, listener_cuda_vs_cpu,
    listener_step_case, listener_step_cuda_vs_cpu, randomize, rank_calls,
    relu_sides, speaker_cuda_vs_cpu, speaker_step_case,
    speaker_step_cuda_vs_cpu, tool_calls, tool_reports, tools_cuda_vs_cpu,
    tools_world_vs_one, val_scene_count as val_scenes, world1_group_step,
)
from d3net_tpu_torch.config import dump_yaml, save as save_cfg
from d3net_tpu_torch.probe import check_exact, device_ms, time_ms
from d3net_tpu_torch.data import collate
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.dataset import BatchIterator, NpzScenes, crop_scene
from d3net_tpu_torch.data.language import build_lang_batch
from d3net_tpu_torch.data.raw_scans import write_raw_scan
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.kernels import gather, probe
from d3net_tpu_torch.models.blocks import SubmConv, fold_tables
from d3net_tpu_torch.models.listener import ListenerDraws
from d3net_tpu_torch.models.speaker import expand_to_rows
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.ops import native, segment, sparse_conv
from d3net_tpu_torch.ops import voxelize as vox
from d3net_tpu_torch.parallel import dryrun
from d3net_tpu_torch.params import (
    flagship_config, flatten, flax_to_state_dict, init_flax_variables,
    load_detector, load_pipeline, state_dict_to_flax,
)
from d3net_tpu_torch.scripts import (
    benchmark_captioning, benchmark_grounding, visualize_captioning,
    visualize_grounding, visualize_scannet,
)
from d3net_tpu_torch.scripts import eval as eval_cli
from d3net_tpu_torch.scripts import (
    import_jax_run, prepare_weights, profile_ops,
)
from d3net_tpu_torch.scripts import train as train_cli
from d3net_tpu_torch.scripts.train import load_task_config
from d3net_tpu_torch.train import pipeline
from d3net_tpu_torch.train.loop import (
    Checkpointer, detector_cfg_dict, detector_from_cfg, init_detector,
    make_dataloaders, make_val_loader, optimizer_kw, run_detector_training,
    spec_from_cfg, train_steps_per_epoch,
)
from d3net_tpu_torch.train.losses_slt import (
    caption_loss, grounding_loss, lang_cls_loss,
)
from d3net_tpu_torch.train.trainer import (
    create_train_state, detector_train_step,
)
from d3net_tpu_torch.utils.bbox import box_corners
from d3net_tpu_torch.utils.ply import read_ply

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
CARDS_STEPS = 10        # --cards: steps of the config's 16-step epoch
CARDS_PROFILE_STEP = 2  # --cards: rank 0 traces steps 3-5
COLLATE_BUSY = 0.5      # batch builds in flight, on average, that make a
                        # step one "with collate"
CAPTION_CONFIG = os.path.join(ROOT, "conf", "pointgroup_captioning.yaml")
TINY_CAPTION_CONFIG = os.path.join(ROOT, "conf", "debug",
                                   "tiny_captioning.yaml")
CAPTION_WARMUP, CAPTION_REPS = 2, 5
SPK_STEPS = 4           # a quarter epoch of the captioning config's 64
                        # scenes at B=4 (cut from 8 to make room for the
                        # data, profiler and curriculum phases)
SPK_CHECKED_STEP = 2    # the step whose gathers are held to the plain version
SPK_REPS = 5
GROUNDING_CONFIG = os.path.join(ROOT, "conf", "pointgroup_grounding.yaml")
TINY_GROUNDING_CONFIG = os.path.join(ROOT, "conf", "debug",
                                     "tiny_grounding.yaml")
GROUND_WARMUP, GROUND_REPS = 2, 5
LIS_STEPS = 4           # a quarter epoch, as SPK_STEPS
LIS_CHECKED_STEP = 2    # the step whose gathers are held to the plain version
LIS_REPS = 5
JOINT_CONFIG = os.path.join(ROOT, "conf", "pointgroup_joint.yaml")
TINY_JOINT_CONFIG = os.path.join(ROOT, "conf", "debug", "tiny_joint.yaml")
JOINT_STEPS = 4         # a quarter epoch of the joint config's 64 scenes at
                        # B=4 (cut from one epoch, then from 8, as
                        # SPK_STEPS)
JOINT_CHECKED_STEP = 2  # the step whose gathers are held to the plain version
JOINT_REPS = 5

FLAGSHIP_CONFIG = os.path.join(ROOT, "conf", "flagship_converge.yaml")
ENET_WEIGHTS = os.path.join(ROOT, "outputs", "enet", "enet_weights.pkl")
ENET_STEPS = 20         # of train_enet's 400 (TRAINING.md's recipe)
ENET_REPS = 5
SCAN_DISPATCHES = 3     # of the flagship config's 64 epochs of 8 batches:
                        # the checked step in the first, the host syncs
                        # counted in the second, the third timed clean
SCAN_CHECKED_STEP = 6   # the step (1-based) whose gathers are checked
IMPORT_SCENES = 8       # import_run: train scenes of the joint config's 64
#                         (two batches an epoch)
IMPORT_STEPS = 2        # resumed steps: the last before a step_epoch
#                         boundary and the first after it
PREP_SCANS = 8          # prepare_scannet: raw scans, two flagship batches
PREP_WORKERS = 8        # the CLI's process pool (the card host's cores)
CURRICULUM_TIMEOUT = 600
SMALL_CFG = dict(m=8, blocks=(1, 2, 3), cluster_blocks=(1, 2),
                 clusters_per_pass=16, max_num_proposal=8,
                 cluster_npoint_thre=30, test_npoint_thresh=30,
                 test_score_thresh=0.0, cluster_ring=1, cluster_cell_size=0.03,
                 cluster_prop_iters=4)
SMALL_SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
                   floor_points=1000, room=4.0)
SMALL_SPEC = dict(max_points=3072, voxel_caps=[3072, 1536, 768],
                  max_instances=8, use_multiview=False, use_normal=True)


T_START = [None]      # main's start: each phase line gets its ``at_s``
RAN_BESIDE = [None]   # what runs beside the phases now emitting lines:
#                       each line gets ``ran_beside`` (its times contended)


def emit(obj) -> None:
    if "phase" in obj and T_START[0] is not None:
        obj = {**obj, "at_s": round(time.time() - T_START[0], 1)}
    if "phase" in obj and RAN_BESIDE[0]:
        obj = {**obj, "ran_beside": RAN_BESIDE[0]}
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
    kernels, ops, host = [], [], []
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if ms > 0:
            row = [e.key[:90], round(ms, 3), e.count]
            (kernels if e.device_type == DeviceType.CUDA else ops).append(row)
        if e.device_type != DeviceType.CUDA and e.self_cpu_time_total > 0:
            host.append([e.key[:90], round(e.self_cpu_time_total / 1e3, 3),
                         e.count])
    kernels.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    emit({"phase": name, "wall_ms": wall_ms, "device_busy_ms": busy,
          "idle_share": 1.0 - busy / wall_ms,
          "kernel_launches": sum(r[2] for r in kernels),
          "top_kernels": kernels[:15], "top_ops": ops[:15],
          "top_host_ms": host[:15]})
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


def phase_dist_step(variables, batch, train_step_ms, expected):
    """Phase ``dist`` (a): the flagship train step through the distributed
    path on a one-rank NCCL group against the step with no group
    (``checks.world1_group_step``: bit-equal where that step is
    reproducible, else within 4x its own run-to-run difference; gathers
    checked exact); then, with the
    group still up, its timed steps, the all-reduces a step and their
    device time in one profiled step, and the peak. Returns the step's
    gather launches."""
    flag = flagship_config()
    dist = torch.distributed

    def timings(state):
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step():
            return detector_train_step(state, batch, gen)[1]

        for _ in range(TRAIN_WARMUP):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev_ms = []
        for _ in range(TRAIN_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            metrics = step()
            b.record()
            torch.cuda.synchronize()
            ev_ms.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        calls = {"n": 0, "elements": 0}
        real = dist.all_reduce

        def counting(t, *a, **k):
            calls["n"] += 1
            calls["elements"] += t.numel()
            return real(t, *a, **k)

        dist.all_reduce = counting
        try:
            step()
            torch.cuda.synchronize()
        finally:
            dist.all_reduce = real
        prof = phase_profile("dist_step_profile", step)
        return {"ms": ev_ms, "peak": peak, "all_reduces": calls,
                "all_reduce_device_ms": sum(
                    r[1] for r in prof if "nccl" in r[0].lower()),
                "finite": all(np.isfinite(float(v))
                              for v in metrics.values())}

    res = world1_group_step(variables, flag.model, batch, seed=0,
                            then=timings)
    t = res["then"]
    emit({"phase": "dist_step", "world_size": 1, "backend": "nccl",
          "bit_equal_to_train_step": res["bit_equal"],
          "train_step_reproducible": res["step_reproducible"],
          "compare": {k: {x: v[x] for x in ("ref_vs_ref", "dist_vs_ref")}
                      | {"tensors_differing": len(v["differ"])}
                      for k, v in res["compare"].items()},
          "metrics": res["metrics"],
          "dist_step_ms": statistics.median(t["ms"]),
          "dist_step_ms_all": t["ms"],
          "train_step_ms_same_call": train_step_ms,
          "all_reduces_per_step": t["all_reduces"]["n"],
          "all_reduce_elements_per_step": t["all_reduces"]["elements"],
          "all_reduce_device_ms": t["all_reduce_device_ms"],
          "max_memory_allocated": t["peak"],
          "gather_launches_per_step": res["launches"],
          "gathers_checked_exact": res["checked"]})
    if not res["ok"]:
        raise AssertionError(f"the one-rank NCCL step differs from the step "
                             f"with no group beyond its own run-to-run "
                             f"differences: {res['compare']}")
    if res["launches"] != expected or res["checked"] != expected:
        raise AssertionError(f"dist step: {res['launches']} gather launches "
                             f"({res['checked']} checked), expected "
                             f"{expected}")
    if not t["finite"]:
        raise AssertionError("dist step: non-finite metrics")
    return res["launches"]


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
def shared_scenes():
    """The train loops' and evals' synthetic scenes (``train.loop.
    scenes_from_cfg``) made once for each scene count, split and scene
    settings while open: the ``run`` phase, the three stages, the evals and
    the import resume read the same deterministic scenes
    (``make_scene(seed)``), which the loaders only read; each phase's
    batches and steps are as before."""
    from d3net_tpu_torch.data.dataset import SyntheticScenes
    from d3net_tpu_torch.train import loop

    made = {}

    def shared(num_scenes=64, split="train", **kw):
        key = (num_scenes, split, tuple(sorted(kw.items())))
        if key not in made:
            made[key] = SyntheticScenes(num_scenes, split, **kw)
        return made[key]

    loop.SyntheticScenes = shared
    try:
        yield
    finally:
        loop.SyntheticScenes = SyntheticScenes


@contextlib.contextmanager
def build_spans():
    """Every batch build of ``BatchIterator`` (train and val) while open,
    as (start, end) in seconds on the clock of ``on_step``'s ``t_start``
    (``trace.clock_ns``)."""
    spans = []
    build = BatchIterator._build_one

    def timed(self, order, b):
        t0 = trace.clock_ns() * 1e-9
        try:
            return build(self, order, b)
        finally:
            spans.append((t0, trace.clock_ns() * 1e-9))

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
    """The detection eval CLI on the run dir; returns its outputs
    (``checks.eval_outputs``), metrics and seconds for ``dist_eval``."""
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
    seconds = time.time() - t0
    emit({"phase": "eval", **{k: res[k] for k in keys},
          "checkpoint": res["checkpoint"], "gather_launches": launches,
          "seconds": round(seconds, 3)})
    return world1_eval("detection", run_dir, seconds)


def world1_eval(task, run_dir, seconds):
    """A one-process eval CLI's outputs in ``checks.eval_rank``'s form."""
    out = eval_outputs(task, run_dir)
    metrics = json.loads(out["json"])
    metrics.pop("checkpoint")
    return {**out, "metrics": metrics, "seconds": seconds}


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
    ``gather_rows`` launches a batch. Returns each task's outputs for
    ``dist_eval``."""
    t0 = time.time()
    cfg = load_task_config(os.path.join(run_dir, "config.yaml"))
    report, outputs = {}, {}
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
        outputs[task] = world1_eval(task, run_dir, time.time() - t1)
        report[task] = {**{k: res[k] for k in keys},
                        "checkpoint": res["checkpoint"],
                        "gather_launches": launches,
                        "cli_s": round(outputs[task]["seconds"], 3)}
    emit({"phase": "joint_eval", **report,
          "reduced": [f"{cfg.data.batch_size} val scenes, one batch, of the "
                      f"config's {max(2, cfg.data.synthetic.num_scenes // 8)}"],
          "seconds": round(time.time() - t0, 3)})
    return outputs


def phase_dist(run_dir, joint_run, world1, tools_one, per_forward):
    """Phases ``dist_ranks``, ``dist_dryrun``, ``dist_eval`` and
    ``dist_tools`` in one start of two ranks on cuda:0 over gloo (NCCL
    takes one rank a card): ``checks.dist_ranks_on_one_card``'s steps
    against world size 1, then in the same ranks ``parallel/dryrun.py``'s
    two steps, the eval CLI's tasks and the four model-running tools.

    The evals: ``captioning`` and ``grounding`` on the joint run dir (f32;
    one val batch of 4, two scenes a rank), held against the
    ``joint_eval`` phase's one-process evals; ``detection`` on the ``run``
    phase's run dir (bf16; its 8 val scenes, two batches) at the default
    settings, beside the ``eval`` phase's, reported and not held: the bf16
    eval forward does not reproduce itself run to run at those settings
    (atomic adds, bf16 reductions); and ``detection`` again with ``exact``
    (``device.parity_precision()`` and ``checks.deterministic()``, where it
    reproduces itself whatever the batch's size) against a one-process
    eval under the same settings, held (``checks.eval_mismatches``: ints
    and strings exact, floats within rtol 1e-5; both ranks' metrics
    equal). The tools: each on the joint run dir's val batch under the
    exact settings against the ``tools`` phase's exact one-process run
    (``checks.tool_reports``): the same files, each byte-equal or, where
    the f32 ScoreNet's scores moved by ulps with the batch's size, its
    JSON values or PLY vertices within rtol 1e-5 (the count of byte-equal
    files reported). Every gather of every rank
    is held exact against the plain version as it runs, 75 a rank a val
    batch. Then ``checks.detector_repro`` on the run dir's detector and
    first val batch, the cause in numbers: run to run and in halves (two
    ranks' rows), at the default settings (reported) and under the exact
    ones (held: nothing differs run to run, no cluster id or proposal in
    halves). Returns the launches a rank makes a val batch in the evals
    and in the tools."""
    t0 = time.time()
    cfg = load_task_config(os.path.join(ROOT, "conf", "debug",
                                        "tiny_pointgroup.yaml"))
    train_it, _ = make_dataloaders(cfg, spec_from_cfg(cfg))
    det = detector_case(detector_cfg_dict(cfg), next(iter(train_it)))
    jcfg = joint_parity_config(load_task_config(TINY_JOINT_CONFIG))
    vocab, emb = pipeline.build_vocab(jcfg)
    case = joint_step_case(jcfg, vocab, emb)
    b = int(load_task_config(os.path.join(joint_run, "config.yaml"))
            .data.batch_size)
    evals = [("captioning", joint_run, b), ("grounding", joint_run, b),
             ("detection", run_dir, None), ("detection", run_dir, None, True)]
    one = [world1["captioning"], world1["grounding"], world1["detection"],
           rank_calls(eval_calls(evals[3:], "cuda:0", True))[0]]
    tools = tool_runs(joint_run, b)
    also = ([(dryrun.dryrun_rank, (2, True), {})]
            + eval_calls(evals, None, True) + tool_calls(tools, None, True))
    t1 = time.time()
    res = dist_ranks_on_one_card(det, jcfg, case, also=also)
    spawn_s = time.time() - t1
    ranks = res.pop("also")
    emit({"phase": "dist_ranks", "spawn_seconds": round(spawn_s, 3), **res})
    dry = dryrun.report(2, ranks[0][0])
    emit({"phase": "dist_dryrun", "ranks": 2, "backend": "gloo",
          "det_total_loss": dry["det"]["total_loss"],
          "joint_loss": dry["joint"]["loss"],
          "joint_cap_rwd": dry["joint"]["cap_rwd"]})
    bad = [] if res["ok"] else [f"dist ranks against world 1: "
                                f"{res['outside_tolerance']}"]

    ne = len(evals)
    ev = eval_reports(evals, [r[1:1 + ne] for r in ranks], one)
    report = {}
    for rec in ev["evals"]:
        name = rec["task"] + ("_exact" if rec["exact"] else "")
        per_batch = [n // v for n, v in zip(rec["launches_per_rank"],
                                            rec["val_batches_per_rank"])]
        if per_batch != [per_forward] * ev["world"] or any(
                n % v for n, v in zip(rec["launches_per_rank"],
                                      rec["val_batches_per_rank"])):
            bad.append(f"{name}: launches {rec['launches_per_rank']} over "
                       f"batches {rec['val_batches_per_rank']}")
        gathers = [m for m in rec["mismatches"] if "gathers checked" in m]
        held = name != "detection"
        bad += [f"{name}: {m}" for m in (rec["mismatches"] if held
                                         else gathers)]
        report[name] = {
            "held": held,
            **{k: rec[k] for k in ("metrics_world1", "metrics_world2",
                                   "val_batches_per_rank",
                                   "launches_per_rank", "checked_per_rank",
                                   "max_abs_err", "mismatches")},
            "gathers_per_rank_per_batch": per_batch,
            "seconds_world1": round(rec["seconds_world1"], 3),
            "seconds_world2_per_rank": [round(x, 3)
                                        for x in rec["seconds_world2"]]}
    # why the bf16 detection eval is held under the exact settings: its
    # forward on the run dir's first val batch, run to run and in halves
    rcfg = load_task_config(os.path.join(run_dir, "config.yaml"))
    spec = spec_from_cfg(rcfg)
    state, _ = eval_cli.restore_for_eval(
        init_detector(detector_from_cfg(rcfg), 0).to("cuda"), rcfg, run_dir)
    _, scenes = next(iter(make_val_loader(rcfg, spec, return_scenes=True)))
    repro = detector_repro(state.model.eval(), scenes, spec, "cuda")
    del state
    if any(repro["exact"]["run_to_run"].values()) or any(
            v for k, v in repro["exact"]["halves"].items()
            if k.endswith("_differ")):
        bad.append(f"detector forward under the exact settings: {repro}")
    emit({"phase": "dist_eval", "ranks": 2, "backend": "gloo",
          "device": "cuda:0", **report, "detector_repro": repro})

    # the joint detector's f32 ScoreNet scores move by ulps with the
    # batch's size even under the exact settings: the JSON and PLY values
    # are held within EVAL_RTOL where their bytes differ
    tr = tool_reports(tools, [r[1 + ne:] for r in ranks], tools_one,
                      EVAL_RTOL)
    tool_per_batch = []
    for rec in tr["tools"]:
        per_batch = [n // v for n, v in zip(rec["launches_per_rank"],
                                            rec["val_batches_per_rank"])]
        tool_per_batch += per_batch
        if per_batch != [per_forward] * tr["world"]:
            bad.append(f"{rec['tool']}: launches {rec['launches_per_rank']}"
                       f" over batches {rec['val_batches_per_rank']}")
    bad += tr["mismatches"]
    emit({"phase": "dist_tools", "ranks": 2, "backend": "gloo",
          "device": "cuda:0", "exact": True,
          "tools": {rec["tool"]: {k: v for k, v in rec.items() if k != "tool"}
                    for rec in tr["tools"]},
          "seconds": round(time.time() - t0, 3)})
    if bad:
        raise AssertionError(f"dist phases against one process: {bad}")
    return (report["detection_exact"]["gathers_per_rank_per_batch"][0],
            tool_per_batch[0])


# --------------------------------------------------------------------------
def _ply_vertices(path, want):
    """The PLY at ``path``, read back through the port's ``read_ply``,
    must hold ``want`` finite vertices."""
    v = read_ply(path)["vertex"]
    if len(v) != want or not np.isfinite(v["x"]).all():
        raise AssertionError(f"tools: {path} holds {len(v)} vertices, "
                             f"not {want}")


def _box(box, where):
    if np.shape(box) != (8, 3) or not np.isfinite(box).all():
        raise AssertionError(f"tools: {where} box {box}")


def phase_tools(run_dir, per_forward):
    """The submission writers and the visualize scripts as users run them
    (``main([...])``, on the card) on the joint run dir, one val batch of
    the config's scenes: 75 ``gather_rows`` launches each, every scene in
    both JSONs with well-formed entries, every PLY read back with its
    vertex count; then ``visualize_scannet`` on ``--synthetic 2`` with a
    ``--pred`` dir; then the four again under the exact settings
    (``checks.tool_rank``: parity precision, deterministic algorithms,
    every gather checked), whose files ``dist_tools`` holds the ranks' to.
    Returns the launches a batch (each CLI's, all equal) and those four
    exact runs."""
    t0 = time.time()
    cfg = load_task_config(os.path.join(run_dir, "config.yaml"))
    n = cfg.data.batch_size
    with val_scenes(n):
        scenes = {s.scene_id: s for s in make_val_loader(
            cfg, spec_from_cfg(cfg), return_scenes=True).scenes}
    if len(scenes) != n:
        raise AssertionError(f"tools: val scenes {sorted(scenes)}")
    chunk = int(cfg.data.num_des_per_scene)
    report = {}

    def run(name, module, args):
        gather.gather_rows.launches = 0
        t1 = time.time()
        with val_scenes(n):
            res = module.main(["--folder", run_dir] + args)
        torch.cuda.synchronize()
        launches = gather.gather_rows.launches
        if launches != per_forward:
            raise AssertionError(f"tools: {name} made {launches} "
                                 f"gather_rows launches, not {per_forward}")
        report[name] = {"gather_launches": launches,
                        "seconds": round(time.time() - t1, 3)}
        return res

    sub = run("benchmark_captioning", benchmark_captioning, [])
    if sorted(sub) != sorted(scenes):
        raise AssertionError(f"tools: captioning scenes {sorted(sub)}")
    for sid, entries in sub.items():
        for e in entries:
            words = e["caption"].split()
            if set(e) != {"caption", "box", "sem_cls", "obj_prob"} \
                    or words[:1] != ["sos"] or words[-1:] != ["eos"] \
                    or not 0 <= e["sem_cls"] < cfg.model.num_bbox_class \
                    or not cfg.test.TEST_SCORE_THRESH < e["obj_prob"] <= 1:
                raise AssertionError(f"tools: captioning entry {e}")
            _box(e["box"], sid)
    report["benchmark_captioning"]["kept_proposals"] = {
        sid: len(v) for sid, v in sub.items()}

    sub = run("benchmark_grounding", benchmark_grounding, [])
    if {e["scene_id"] for e in sub} != set(scenes) \
            or not 0 < len(sub) <= n * chunk:
        raise AssertionError(f"tools: grounding covers "
                             f"{sorted({e['scene_id'] for e in sub})}")
    for e in sub:
        if set(e) != {"scene_id", "object_id", "bbox"} \
                or not 0 <= e["object_id"] < cfg.data.max_num_instance:
            raise AssertionError(f"tools: grounding entry {e}")
        _box(e["bbox"], e["scene_id"])
    report["benchmark_grounding"]["entries"] = len(sub)

    out = run("visualize_captioning", visualize_captioning,
              ["--scenes", str(n)])
    plys = kept = 0
    for sid, scene in scenes.items():
        sdir = os.path.join(out, sid)
        with open(os.path.join(sdir, "captions.txt")) as f:
            lines = f.read().splitlines()
        kept += len(lines)
        _ply_vertices(os.path.join(sdir, "scene.ply"), len(scene.xyz))
        boxes = os.path.join(sdir, "pred_boxes.ply")
        if lines:
            _ply_vertices(boxes, len(lines) * 12 * 20)
        plys += 1 + bool(lines)
    report["visualize_captioning"].update(plys=plys,
                                          proposals_captioned=kept)

    out = run("visualize_grounding", visualize_grounding,
              ["--scenes", str(n)])
    plys = queries = 0
    for sid, scene in scenes.items():
        sdir = os.path.join(out, sid)
        _ply_vertices(os.path.join(sdir, "scene.ply"), len(scene.xyz))
        with open(os.path.join(sdir, "queries.txt")) as f:
            rows = [int(line.split()[1].rstrip(":"))
                    for line in f.read().splitlines()]
        for c in rows:
            for side in ("pred", "gt"):
                _ply_vertices(os.path.join(sdir, f"query{c}_{side}.ply"),
                              12 * 20)
        plys += 1 + 2 * len(rows)
        queries += len(rows)
    report["visualize_grounding"].update(plys=plys, queries=queries)

    t1 = time.time()
    vis = os.path.join(os.path.dirname(run_dir), "vis_scannet")
    pred = os.path.join(vis, "pred")
    os.makedirs(pred)
    syn = [make_scene(seed=i) for i in range(2)]
    np.savez(os.path.join(pred, f"{syn[0].scene_id}.npz"),
             sem_pred=syn[0].sem_labels, inst_pred=syn[0].instance_ids)
    visualize_scannet.main(["--synthetic", "2", "--pred", pred, "--output",
                            os.path.join(vis, "out")])
    plys = 0
    for scene, tasks in zip(syn, (5, 3)):
        names = sorted(f for f in os.listdir(os.path.join(vis, "out"))
                       if f.startswith(scene.scene_id))
        if len(names) != tasks:
            raise AssertionError(f"tools: visualize_scannet wrote {names}")
        for name in names:
            _ply_vertices(os.path.join(vis, "out", name), len(scene.xyz))
        plys += len(names)
    with open(os.path.join(vis, "out", "index.html")) as f:
        index = f.read()
    if not all(s.scene_id in index for s in syn):
        raise AssertionError("tools: index.html misses a scene")
    report["visualize_scannet"] = {"plys": plys,
                                   "seconds": round(time.time() - t1, 3)}

    # the one-process files ``dist_tools`` holds the ranks' to: each tool
    # again under the exact settings, every gather checked
    one = [rank_calls(tool_calls([r], "cuda", True))[0]
           for r in tool_runs(run_dir, n)]
    for o in one:
        if o["checked"] != o["launches"] or o["launches"] != per_forward:
            raise AssertionError(f"tools: exact {o['tool']} checked "
                                 f"{o['checked']} of {o['launches']} gathers")
    report["exact_one_process"] = {
        o["tool"]: {"seconds": round(o["seconds"], 3),
                    "files": len(o["files"]), "launches": o["launches"],
                    "checked": o["checked"]}
        for o in one}
    emit({"phase": "tools", **report,
          "test_score_thresh": cfg.test.TEST_SCORE_THRESH,
          "reduced": [f"{n} val scenes, one batch, of the config's "
                      f"{max(2, cfg.data.synthetic.num_scenes // 8)}"],
          "seconds": round(time.time() - t0, 3)})
    return per_forward, one


def tool_runs(run_dir, n):
    """The four model-running tools on ``run_dir``'s first ``n`` val
    scenes under the exact settings (``checks.tool_rank``'s runs)."""
    return [(tool, run_dir, n, True) if tool.startswith("benchmark")
            else (tool, run_dir, n, True, {"scenes": n})
            for tool in ("benchmark_captioning", "benchmark_grounding",
                         "visualize_captioning", "visualize_grounding")]


def phase_tools_parity(root):
    """The submission writers on a tiny joint run dir (seeded weights) and
    ``port_enet_weights``' selftest, cuda against cpu
    (``checks.tools_cuda_vs_cpu``)."""
    t0 = time.time()
    res = tools_cuda_vs_cpu(TINY_JOINT_CONFIG, root)
    emit({"phase": "tools_parity", **res,
          "seconds": round(time.time() - t0, 3)})
    if not res["ok"]:
        raise AssertionError(f"tools_parity: {res['outside_tolerance']}")


# --------------------------------------------------------------------------
def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def joint_archive(root):
    """A run archive of conf/pointgroup_joint.yaml at its published widths,
    written by the port's numpy writer (``jax_run``: the card has no JAX):
    weights from ``params.init_flax_variables``, the pipeline loop's AdamW
    multi_transform state (every submodule ``train``: the config freezes
    none) with seeded non-zero moments at the update before a
    ``step_epoch`` boundary; the train scenes cut to IMPORT_SCENES (two
    batches an epoch, so the boundary is step_epoch · 2 updates in), every
    step logged.
    Returns (its ``.npz``, the config, the state written)."""
    os.makedirs(root, exist_ok=True)
    cfg = load_task_config(JOINT_CONFIG)
    cfg.general.output_root = root
    cfg.data.synthetic.num_scenes = IMPORT_SCENES
    cfg.train.log_every_n_steps = 1
    model = pipeline.pipeline_from_cfg(cfg, pipeline.build_vocab(cfg)[0])
    variables = init_flax_variables(model, 11)
    del model
    transition = cfg.train.step_epoch * train_steps_per_epoch(cfg)
    rng = np.random.default_rng(11)
    mu = _map_tree(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(
        np.float32), variables["params"])
    nu = _map_tree(lambda a: (rng.random(a.shape) * 1e-6).astype(np.float32),
                   variables["params"])
    flags = pipeline.freeze_flags(cfg, pipeline.pipeline_mode(cfg))
    labels = {k: "freeze" if flags.get(k) else "train"
              for k in variables["params"]}
    o = cfg.train.optim
    st = {"step": transition - 1, **variables,
          "opt_state": jax_run.optax_state(o.classname, transition - 1,
                                           [mu, nu], labels)}
    npz, _ = jax_run.write_archive(
        os.path.join(root, "joint_archive"),
        config_yaml=dump_yaml(cfg.to_dict()), loop="pipeline",
        schedule={"optim": o.classname, "lr": o.lr,
                  "multiplier": cfg.train.multiplier,
                  "transition_steps": transition},
        steps={"last": st, "best": st}, labels=labels,
        folder="chip_smoke.py joint_archive",
        best_json={"step": st["step"], "value": 0.0,
                   "monitor": cfg.general.monitor.split("/")[-1],
                   "mode": cfg.general.monitor_mode})
    return npz, cfg, st


def _adam_flax(state, key):
    """The optimizer's ``key`` state of every trainable parameter, Flax
    layout, flattened."""
    model = state.model
    return flatten(state_dict_to_flax(model, {
        n: state.optimizer.state[p][key] for n, p in model.named_parameters()
        if p.requires_grad})["params"])


def _restored_import(run_dir):
    """A fresh train state of the imported run dir's last checkpoint, as
    the pipeline loop builds and restores it."""
    cfg = load_task_config(os.path.join(run_dir, "config.yaml"))
    model = import_jax_run.model_of(cfg, "pipeline").cuda()
    state = create_train_state(
        model, **optimizer_kw(cfg))
    if Checkpointer(run_dir, "none").restore_last(state) is None:
        raise AssertionError(f"import_run: no checkpoint in {run_dir}")
    return state


def phase_import_run(root, per_step, per_forward):
    """A run of the JAX package carried onto the card as users carry it:
    ``joint_archive`` (conf/pointgroup_joint.yaml at its published widths,
    f32, 128 proposals, beam 3 in 3 groups; the step before a
    ``step_epoch`` boundary), ``import_jax_run`` on the card, a fresh
    state restored from the run dir holding the archive's step, lr,
    moments and weights exactly; then the train CLI resumes it for
    IMPORT_STEPS steps across the boundary, the first step's gathers each
    held to the plain version as they run, its launches (two detector
    passes and their backward) and each step's ms (the loop waiting for the
    card around each part), one val batch, and the new last checkpoint at
    the lr past the boundary. Returns the launches a resumed step and the
    checked gathers' largest error."""
    t0 = time.time()
    npz, cfg, st = joint_archive(root)
    archive_s = time.time() - t0
    run = os.path.join(root, "imported")
    t1 = time.time()
    imported = import_jax_run.main(["--archive", npz, "--out", run])
    import_s = time.time() - t1
    count = st["step"]
    transition = cfg.train.step_epoch * train_steps_per_epoch(cfg)
    lr0 = cfg.train.optim.lr
    bad = []

    state = _restored_import(run)
    adam = st["opt_state"].inner_states["train"].inner_state[0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got, want = _adam_flax(state, key), flatten(tree)
        if sorted(got) != sorted(want) or any(
                not np.array_equal(got[k], want[k]) for k in want):
            bad.append(f"restored {key} differs from the archive's")
    weights = flatten(state_dict_to_flax(state.model)["params"])
    if any(not np.array_equal(weights[k], v)
           for k, v in flatten(st["params"]).items()):
        bad.append("restored weights differ from the archive's")
    restored = {"step": state.step, "last_epoch": state.scheduler.last_epoch,
                "lr": state.optimizer.param_groups[0]["lr"],
                "adam_steps": sorted({float(v["step"]) for v in
                                      state.optimizer.state.values()})}
    if restored != {"step": count, "last_epoch": count, "lr": lr0,
                    "adam_steps": [float(count)]}:
        bad.append(f"restored {restored}")
    del state
    torch.cuda.empty_cache()

    steps, seen = [], [0]
    rec = GatherRecorder(gather, check=True, where="the resumed joint step")

    def on_step(r):
        r["gather_launches"] = gather.gather_rows.launches - seen[0]
        seen[0] = gather.gather_rows.launches
        steps.append(r)
        sparse_conv.gather, segment.gather = gather, gather

    real = pipeline.run_pipeline_training
    pipeline.run_pipeline_training = \
        lambda *a, **kw: real(*a, on_step=on_step, **kw)
    t2 = time.time()
    try:
        with val_scenes(cfg.data.batch_size):
            sparse_conv.gather, segment.gather = rec, rec
            gather.gather_rows.launches = 0  # the main path, counted from here
            train_cli.main(["--config", os.path.join(run, "config.yaml"),
                            "--folder", run, "--max_steps",
                            str(count + IMPORT_STEPS)])
            torch.cuda.synchronize()
    finally:
        pipeline.run_pipeline_training = real
        sparse_conv.gather, segment.gather = gather, gather
    resume_s = time.time() - t2
    launches = gather.gather_rows.launches
    if rec.checked != 2 * per_step:
        bad.append(f"{rec.checked} gathers checked in the first resumed "
                   f"step, expected {2 * per_step}")
    try:
        per = _check_launches("import_run", steps, launches, 2 * per_step,
                              per_forward)
    except AssertionError as e:
        bad.append(str(e))
        per = None
    recs = _metrics(run)
    train = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if "val/combined" in r]
    if [r["step"] for r in train] != [count + i + 1
                                      for i in range(IMPORT_STEPS)] \
            or len(val) != 1 or any(not math.isfinite(v)
                                    for r in recs for v in r.values()):
        bad.append(f"metrics {recs}")
    state = _restored_import(run)
    after = {"step": state.step, "last_epoch": state.scheduler.last_epoch,
             "lr": state.optimizer.param_groups[0]["lr"]}
    want_lr = lr0 * cfg.train.multiplier ** ((count + IMPORT_STEPS)
                                             // transition)
    if after != {"step": count + IMPORT_STEPS,
                 "last_epoch": count + IMPORT_STEPS, "lr": want_lr}:
        bad.append(f"resumed to {after}, lr expected {want_lr}")
    with open(os.path.join(run, "run_meta.json")) as f:
        meta = json.load(f)
    if meta.get("imported_from", {}).get("step") != count:
        bad.append(f"run_meta {meta.get('imported_from')}")
    del state
    torch.cuda.empty_cache()
    published = load_task_config(JOINT_CONFIG)
    emit({"phase": "import_run", "archive_bytes": os.path.getsize(npz),
          "archive_s": round(archive_s, 3), "import_s": round(import_s, 3),
          "imported": imported, "restored": restored,
          "boundary_update": transition, "lr_before": lr0,
          "lr_after": want_lr, "resumed": after,
          "step_ms": [round(r["step_s"] * 1e3, 3) for r in steps],
          "run_step_ms": [round(r["wall_s"] * 1e3, 3) for r in steps],
          "gather_launches_per_step": [r["gather_launches"] for r in steps],
          "gathers_checked_exact": rec.checked,
          "gather_max_abs_err": rec.max_abs_err,
          "val": {k[4:]: v for k, v in val[0].items() if k != "step"}
          if val else None,
          "resume_s": round(resume_s, 3),
          "reduced": [f"{IMPORT_SCENES} train scenes of the config's "
                      f"{published.data.synthetic.num_scenes}",
                      f"{IMPORT_STEPS} resumed steps",
                      f"{cfg.data.batch_size} val scenes, one batch",
                      "log_every_n_steps 1 (the config's "
                      f"{published.train.log_every_n_steps})"],
          "mismatches": bad, "seconds": round(time.time() - t0, 3)})
    if bad:
        raise AssertionError(f"import_run: {bad}")
    return per, rec.max_abs_err


# --------------------------------------------------------------------------
def phase_enet_parity():
    """ENet's eval forward (light and full layouts) and one ``train_enet``
    step at tiny size, cuda against cpu (``checks.enet_cuda_vs_cpu``)."""
    t0 = time.time()
    res = enet_cuda_vs_cpu()
    emit({"phase": "enet_parity", **res,
          "seconds": round(time.time() - t0, 3)})
    if not res["ok"]:
        raise AssertionError(f"enet_parity: {res['outside_tolerance']}")


def phase_multiview(root):
    """The flagship recipe's first two commands as users run them, in
    process: ``train_enet`` at its published size for ENET_STEPS steps
    (then a step timed alone), and ``compute_multiview_features --config
    conf/flagship_converge.yaml --weights outputs/enet/enet_weights.pkl``
    into a store under ``root``. Returns the store's path."""
    from d3net_tpu_torch.data.multiview import read_multiview_store
    from d3net_tpu_torch.models.listener import ListenerDraws
    from d3net_tpu_torch.scripts import compute_multiview_features as cmf
    from d3net_tpu_torch.scripts import train_enet

    os.makedirs(root, exist_ok=True)
    t_phase = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pkl = os.path.join(root, "enet_weights.pkl")
    t0 = time.time()
    hist = train_enet.main(["--steps", str(ENET_STEPS), "--output", pkl])
    torch.cuda.synchronize()
    enet_main_s = time.time() - t0
    enet_peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"multiview: train_enet losses {hist}")
    # one step timed alone at the published batch (8 frames, 256x328)
    t0 = time.time()
    colors, labels = train_enet.build_frame_dataset(16, 8, 256, 328)
    render_s = time.time() - t0
    model = train_enet.make_model(20, 0, "cuda")
    opt = train_enet.make_optimizer(model, 1e-3)
    imgs = torch.from_numpy(colors[:8]).cuda()
    labs = torch.from_numpy(labels[:8]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    def step():
        return train_enet.enet_train_step(model, opt, imgs, labs,
                                          ListenerDraws(gen))

    step_ms = time_ms({"step": step}, ENET_REPS, inner=1)["step"]
    step_peak = torch.cuda.max_memory_allocated()
    prof = phase_profile("enet_train_profile", step)
    enet_fwd_ms = time_ms({"fwd": lambda: model.ENetEncoder_0(
        imgs, train=False)}, ENET_REPS, inner=1)["fwd"]
    del model, opt, imgs, labs, colors, labels
    torch.cuda.empty_cache()

    store_key = os.path.join(root, "multiview_flagship.hdf5")
    t0 = time.time()
    report = cmf.main(["--config", FLAGSHIP_CONFIG, "--weights",
                       ENET_WEIGHTS, "--output", store_key])
    features_s = time.time() - t0
    store = os.path.splitext(store_key)[0] + ".mvstore"
    points, bad = [], []
    for scene_id, r in report.items():
        feats = read_multiview_store(store, scene_id)
        points.append(len(feats))
        if feats.shape[1] != 128 or not np.isfinite(feats).all():
            bad.append(scene_id)
    if bad or len(report) != 24:
        raise AssertionError(f"multiview: {len(report)} scenes, non-finite "
                             f"or misshapen features in {bad}")
    n = len(report)
    parts = {k: sum(r[k] for r in report.values()) / n
             for k in ("render_s", "enet_s", "project_s")}
    emit({"phase": "multiview",
          "train_enet": {"scenes": 16, "frames": 8, "height": 256,
                         "width": 328, "batch": 8, "steps": ENET_STEPS,
                         "losses": [h["loss"] for h in hist],
                         "pix_acc": [h["acc"] for h in hist],
                         "main_s": round(enet_main_s, 3),
                         "peak_bytes": enet_peak,
                         "allocated_before": base},
          "frame_render_s": round(render_s, 3),
          "enet_train_step_ms": step_ms, "enet_train_step_peak": step_peak,
          "enet_train_launches": sum(r[2] for r in prof),
          "enet_fwd_ms_8_frames": enet_fwd_ms,
          "features": {"config": "conf/flagship_converge.yaml",
                       "weights": "outputs/enet/enet_weights.pkl",
                       "scenes": n, "frames_per_scene": 8,
                       "points_min": min(points), "points_max": max(points),
                       "seconds": round(features_s, 3),
                       "s_per_scene": features_s / n,
                       **{f"{k[:-2]}_s_per_scene": v for k, v in
                          parts.items()},
                       "seen_share_min": min(r["seen"]
                                             for r in report.values()),
                       "seen_share_mean": sum(r["seen"] for r in
                                              report.values()) / n,
                       "finite": True},
          "reduced": [f"train_enet {ENET_STEPS} steps of the recipe's 400"],
          "seconds": round(time.time() - t_phase, 3)})
    return store


def phase_flagship_train(root, store, per_step, per_forward):
    """The flagship recipe's third command: the train CLI in process on a
    copy of conf/flagship_converge.yaml whose ``data.multiview_hdf5`` names
    the ``multiview`` phase's store, for SCAN_DISPATCHES dispatches of its
    12 steps (``run_detector_training_scan``). Dispatch times by CUDA
    events (``scan_step_ms`` from the last dispatch, which nothing
    instruments), the host syncs of dispatch 2's steps (sync debug "warn")
    and their call sites, the peak by dispatch and the resident stack's
    bytes, every step's ``gather_rows`` launches and step
    SCAN_CHECKED_STEP's gathers held bit-exact, finite losses, a bit-exact
    restore, then one step profiled. Returns the run dir and the
    ``kernels`` line's additions."""
    import warnings

    from d3net_tpu_torch.train import loop

    t_phase = time.time()
    cfg = load_task_config(FLAGSHIP_CONFIG)
    cfg.general.output_root = root
    cfg.data.multiview_hdf5 = store
    spd = int(cfg.tpu.steps_per_dispatch)
    steps_n = SCAN_DISPATCHES * spd
    os.makedirs(root, exist_ok=True)
    config_path = os.path.join(root, "flagship_converge.yaml")
    save_cfg(cfg, config_path)
    run_dir = os.path.join(root, cfg.general.experiment)

    dispatches, states, stacks, per, syncs = [], [], [], [], []
    sync_sites = {}
    seen = [0, 0]
    rec = GatherRecorder(gather, check=True, where="the flagship scan step")
    real_step, real_stack = loop.detector_train_step, loop.build_scan_stack
    real_run = loop.run_detector_training_scan

    def step(*a, **kw):
        seen[1] += 1
        seen[0] = gather.gather_rows.launches
        mod = rec if seen[1] == SCAN_CHECKED_STEP else gather
        sparse_conv.gather, segment.gather = mod, mod
        count = spd < seen[1] <= 2 * spd
        try:
            if count:
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        return real_step(*a, **kw)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                        hits = [x for x in w
                                if "synchroniz" in str(x.message)]
                        syncs.append(len(hits))
                        for x in hits:
                            site = (f"{os.path.relpath(x.filename, ROOT)}:"
                                    f"{x.lineno}")
                            sync_sites[site] = sync_sites.get(site, 0) + 1
            return real_step(*a, **kw)
        finally:
            sparse_conv.gather, segment.gather = gather, gather
            per.append(gather.gather_rows.launches - seen[0])

    def stack(*a):
        stacks.append(real_stack(*a))
        return stacks[-1]

    def on_dispatch(r):
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dispatches.append(r)

    def run(*args, **kw):
        states.append(real_run(*args, on_dispatch=on_dispatch, **kw))
        return states[-1]

    loop.detector_train_step, loop.build_scan_stack = step, stack
    loop.run_detector_training_scan = run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    try:
        gather.gather_rows.launches = 0  # the main path, counted from here
        train_cli.main(["--config", config_path, "--max_steps",
                        str(steps_n)])
        torch.cuda.synchronize()
    finally:
        loop.detector_train_step, loop.build_scan_stack = real_step, \
            real_stack
        loop.run_detector_training_scan = real_run
        sparse_conv.gather, segment.gather = gather, gather
    run_s = time.time() - t0
    launches = gather.gather_rows.launches
    recs = _metrics(run_dir)
    train = [r for r in recs if "train/total_loss" in r]
    val = [r for r in recs if "val/total_loss" in r]
    bad = [(r["step"], k) for r in recs for k, v in r.items()
           if not math.isfinite(v)]
    if [r["step"] for r in train] != [spd * (i + 1) for i in
                                      range(SCAN_DISPATCHES)] \
            or len(val) != SCAN_DISPATCHES or bad:
        raise AssertionError(f"flagship_train: metrics {recs}")
    if len(per) != steps_n or any(n != per_step for n in per):
        raise AssertionError(f"flagship_train: gather_rows launches per "
                             f"step {per} (train phase: {per_step})")
    if launches != sum(per) + SCAN_DISPATCHES * per_forward:
        raise AssertionError(f"flagship_train: {launches} launches in all")
    if rec.checked != per_step:
        raise AssertionError(f"flagship_train: {rec.checked} gathers checked")
    stack_tree, nb = stacks[0]
    stack_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors(stack_tree))
    state = states[0]
    saved = _state_copy(state)

    # a fresh state restored from the run dir equals the run's final state
    o = cfg.train.optim
    fresh = create_train_state(
        init_detector(detector_from_cfg(cfg), 1).cuda(), lr=o.lr,
        optim=o.classname, weight_decay=o.weight_decay,
        step_epoch=cfg.train.step_epoch, multiplier=cfg.train.multiplier,
        steps_per_epoch=nb)
    if Checkpointer(run_dir, "total_loss", "min").restore_last(fresh) is None:
        raise AssertionError("flagship_train: no checkpoint in the run dir")
    diff = _first_difference(_state_copy(fresh), saved)
    if diff is not None:
        raise AssertionError(f"flagship_train: restored state differs at "
                             f"{diff}")
    del fresh, saved
    torch.cuda.empty_cache()

    # one step of the run's state on stack batch 0, profiled
    batch0 = loop.stack_batch(stack_tree, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prof = phase_profile("flagship_train_profile", lambda: detector_train_step(
        state, batch0, gen)[1])
    gather_dev_ms = sum(r[1] for r in prof if "gather_rows_kernel" in r[0])
    disp_ms = [r["device_ms"] for r in dispatches]
    report = {
        "config": "conf/flagship_converge.yaml",
        "widths": {"batch": cfg.data.batch_size,
                   "max_num_point": cfg.data.max_num_point,
                   "voxel_caps": list(cfg.tpu.voxel_caps),
                   "levels": len(cfg.model.blocks),
                   "max_num_instance": cfg.data.max_num_instance,
                   "in_channels": loop.in_channels_from_cfg(cfg),
                   "clusters_per_pass": cfg.tpu.clusters_per_pass,
                   "activation_dtype": cfg.tpu.activation_dtype,
                   "train_scenes": cfg.data.synthetic.num_scenes,
                   "val_scenes": cfg.data.synthetic.num_val_scenes,
                   "steps_per_dispatch": spd,
                   "augment_variants": cfg.tpu.augment_variants,
                   "stack_batches": nb,
                   "conv_impl_requested": cfg.tpu.conv_impl},
        "features": "the multiview phase's store (outputs/enet/"
                    "enet_weights.pkl through compute_multiview_features)",
        "dispatch_device_ms": disp_ms,
        "dispatch_wall_s": [r["wall_s"] for r in dispatches],
        "scan_step_ms": disp_ms[-1] / spd,
        "scan_step_ms_by_dispatch": [ms / spd for ms in disp_ms],
        "dispatch_roles": ["warm-up, checked step", "host syncs counted",
                           "timed"],
        "steps_per_sec": [r["train/steps_per_sec"] for r in train],
        "host_syncs_per_dispatch": sum(syncs),
        "host_syncs_by_step": syncs,
        "host_sync_sites": sync_sites,
        "readbacks_per_dispatch": 1,
        "peak_bytes_by_dispatch": [r["peak_bytes"] for r in dispatches],
        "allocated_before_run": base, "stack_bytes": stack_bytes,
        "gather_launches": launches, "gather_launches_per_step": per[0],
        "gathers_checked_exact": rec.checked,
        "gather_max_abs_err": rec.max_abs_err,
        "gather_rows_by_dtype_width": rec.rows_by_dtype_width,
        "gather_bytes_needed": rec.bytes_needed,
        "scan_train_bound_ms": rec.bytes_needed / HBM_BYTES_PER_S * 1e3,
        "gather_device_ms": gather_dev_ms,
        "losses_finite": True,
        "train": [{k.split("/")[-1]: v for k, v in r.items()} for r in train],
        "val": [{k.split("/")[-1]: v for k, v in r.items()} for r in val],
        "restored_bit_exact": ["model", "optimizer", "scheduler", "step"],
        "run_s": round(run_s, 3),
        "reduced": [f"{steps_n} steps ({SCAN_DISPATCHES} dispatches) of the "
                    f"config's {cfg.train.epochs} epochs of {nb} batches "
                    f"({cfg.train.epochs * nb} steps)",
                    "features from the committed ENet weights (the recipe "
                    "retrains them; train_enet is timed for "
                    f"{ENET_STEPS} steps in the multiview phase)"],
        "seconds": round(time.time() - t_phase, 3)}
    emit({"phase": "flagship_train", **report})
    del state, states[:], stacks[:], stack_tree, batch0
    torch.cuda.empty_cache()
    return run_dir, {"scan_train_launches_per_step": per[0],
                     "scan_train_max_abs_err": rec.max_abs_err,
                     "scan_train_bound_ms": report["scan_train_bound_ms"],
                     "scan_train_device_ms": gather_dev_ms}


def phase_scannet_eval(run_dir, per_forward):
    """``eval --task detection`` and ``--task scannet`` on the flagship
    run dir, one val batch each (``D3NET_VAL_SCENES``): finite metrics,
    the checkpoint stamped, the txt tree written, 75 gathers a batch."""
    t0 = time.time()
    cfg = load_task_config(os.path.join(run_dir, "config.yaml"))
    out = {}
    with val_scenes(cfg.data.batch_size):
        for task, keys in (("detection", ("mAP@0.25", "mAP@0.5", "AR@0.25",
                                          "AR@0.5")),
                           ("scannet", ("mIoU", "accuracy", "AP", "AP@50",
                                        "AP@25"))):
            gather.gather_rows.launches = 0
            t1 = time.time()
            eval_cli.main(["--folder", run_dir, "--task", task])
            torch.cuda.synchronize()
            with open(os.path.join(run_dir, f"eval_{task}.json")) as f:
                res = json.load(f)
            if not all(math.isfinite(res[k]) for k in keys):
                raise AssertionError(f"scannet_eval: {task} {res}")
            if res["checkpoint"].get("kind") not in ("best", "last"):
                raise AssertionError(f"scannet_eval: checkpoint {res}")
            if gather.gather_rows.launches != per_forward:
                raise AssertionError(
                    f"scannet_eval: {task} ran {gather.gather_rows.launches} "
                    f"gathers")
            out[task] = {**{k: res[k] for k in keys},
                         "checkpoint": res["checkpoint"],
                         "seconds": round(time.time() - t1, 3)}
    pred = os.path.join(run_dir, "split_pred", "val")
    sem = sorted(os.listdir(os.path.join(pred, "semantic")))
    masks = os.listdir(os.path.join(pred, "instance", "predicted_masks"))
    if len(sem) != cfg.data.batch_size:
        raise AssertionError(f"scannet_eval: semantic files {sem}")
    emit({"phase": "scannet_eval", **out, "semantic_files": len(sem),
          "instance_masks": len(masks),
          "reduced": [f"{cfg.data.batch_size} val scenes, one batch, of the "
                      f"config's {cfg.data.synthetic.num_val_scenes}"],
          "seconds": round(time.time() - t0, 3)})


# the JAX package's last entry points: data preparation, the profiler and
# the round-5 curriculum
def _crop(scene, spec, seed):
    """``scene`` cropped to the spec's points as the loaders crop it."""
    if len(scene.xyz) <= spec.max_points:
        return scene
    return crop_scene(scene, spec.max_points, spec.scale, spec.full_scale,
                      np.random.default_rng(seed))


def _finite(x) -> bool:
    return bool(np.isfinite(np.asarray(x, np.float64)).all())


def phase_prepare_scannet(root, per_forward):
    """PREP_SCANS synthetic scans in ScanNet's raw layout at its size
    (``data.raw_scans``: 100-250k mesh vertices with faces, 20 objects, a
    rigid alignment) through the port's CLI in a process of its own with
    ``--workers PREP_WORKERS --write-inst-gt``; the npz files read back
    through ``NpzScenes``, cropped and collated at the flagship spec (no
    feature store: the multiview columns stay zero) and the bf16 detector
    forward on the card for each batch of 4, its 75 gathers held exact."""
    t0 = time.time()
    scans, out, gt = (os.path.join(root, d) for d in ("scans", "npz", "gt"))
    rng = np.random.default_rng(0)
    names = [f"scene{i:04d}_00" for i in range(PREP_SCANS)]
    raw = [write_raw_scan(scans, name, i, objects=20,
                          vertices=int(rng.integers(100_000, 250_001)))
           for i, name in enumerate(names)]
    write_s = time.time() - t0
    t1 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "d3net_tpu_torch.scripts.prepare_scannet",
         "--scans", scans, "--out", out, "--workers", str(PREP_WORKERS),
         "--write-inst-gt", gt], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    prep_s = time.time() - t1
    if res.returncode or res.stdout.split() != names:
        raise AssertionError(f"prepare_scannet: rc {res.returncode}, "
                             f"printed {res.stdout!r}, {res.stderr[-2000:]}")
    files = sorted(os.listdir(out))
    if files != [f"{n}.npz" for n in names] or \
            sorted(os.listdir(gt)) != [f"{n}.txt" for n in names]:
        raise AssertionError(f"prepare_scannet: wrote {files}")
    scenes = NpzScenes([os.path.join(out, f) for f in files])
    boxes = []
    for i, r in enumerate(raw):
        sc = scenes[i]
        n = len(sc.xyz)
        if n != r["vertices"] or sc.scene_id != names[i]:
            raise AssertionError(f"prepare_scannet: {names[i]} has {n} "
                                 f"points of {r['vertices']}")
        if not all(_finite(a) for a in (sc.xyz, sc.rgb, sc.normal,
                                        sc.instance_bboxes)):
            raise AssertionError(f"prepare_scannet: {names[i]} not finite")
        if sc.sem_labels.min() < -1 or sc.sem_labels.max() > 19:
            raise AssertionError(f"prepare_scannet: {names[i]} labels")
        with open(os.path.join(gt, f"{names[i]}.txt")) as f:
            if sum(1 for _ in f) != n:
                raise AssertionError(f"prepare_scannet: {names[i]} GT rows")
        boxes.append(len(sc.instance_bboxes))
    flag = flagship_config()
    in_ch = flag.spec.feat_dim() + 3
    model = load_detector(init_flax_variables(
        PointGroup(in_ch, **flag.model), seed=0), flag.model)
    fwd = []
    for b in range(0, len(scenes), flag.batch_size):
        batch_np = build_batch([_crop(scenes[i], flag.spec, i) for i in
                                range(b, b + flag.batch_size)], flag.spec)
        batch = batch_to_torch(batch_np, "cuda")
        with checked_gathers("the prepared scans' forward") as rec, \
                torch.no_grad():
            gather.gather_rows.launches = 0
            t2 = time.time()
            res = model(batch)
            torch.cuda.synchronize()
            fwd.append({"seconds": round(time.time() - t2, 3),
                        "launches": gather.gather_rows.launches,
                        "checked": rec.checked,
                        "max_abs_err": rec.max_abs_err,
                        "voxels_l0": [int(x) for x in
                                      batch_np["tables"][0]["mask"].sum(1)],
                        "proposals": int(res["proposal_batch_mask"].sum())})
        if fwd[-1]["launches"] != per_forward or rec.checked != per_forward:
            raise AssertionError(f"prepare_scannet: forward {fwd[-1]}")
        for key, v in res.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"prepare_scannet: {key} not finite")
    del model
    emit({"phase": "prepare_scannet", "scans": PREP_SCANS,
          "workers": PREP_WORKERS,
          "vertices": [r["vertices"] for r in raw],
          "faces": [r["faces"] for r in raw], "boxes": boxes,
          "write_raw_s": round(write_s, 3), "prepare_s": round(prep_s, 3),
          "seconds_per_scene": prep_s / PREP_SCANS, "forwards": fwd,
          "seconds": round(time.time() - t0, 3)})
    return fwd[0]["launches"], max(f["max_abs_err"] for f in fwd)


def phase_profile_ops(root, per_forward, per_step):
    """The profiler CLI (``scripts.profile_ops``) in process for ``fwd``,
    ``train`` and ``conv0`` on the card: its total device ms, categories,
    top 10 kernels and the gather launches of the profiled call (75, 216,
    one a conv); the first call's gathers held exact (the later ones are
    timed and profiled)."""
    out = {}
    for what, first in (("fwd", per_forward), ("train", per_step),
                        ("conv0", 1)):
        t0 = time.time()
        with checked_gathers(f"profile_ops --what {what}", first) as rec:
            res = profile_ops.main(["--what", what, "--top", "10", "--logdir",
                                    os.path.join(root, what)])
        want = first * res["calls"]
        if res["gather_launches"] != want or rec.checked != first:
            raise AssertionError(
                f"profile_ops {what}: {res['gather_launches']} launches "
                f"profiled (want {want}), {rec.checked} checked")
        if not (res["total_ms"] > 0 and res["categories"]["gather"] > 0
                and os.path.getsize(res["trace"]) > 0):
            raise AssertionError(f"profile_ops {what}: {res}")
        out[what] = {k: res[k] for k in ("total_ms", "events", "categories",
                                         "top", "first_s", "second_s",
                                         "calls", "gather_launches")}
        out[what].update(gathers_checked_exact=rec.checked,
                         max_abs_err=rec.max_abs_err,
                         seconds=round(time.time() - t0, 3))
        torch.cuda.empty_cache()
    emit({"phase": "profile_ops", **out})
    return ({f"profile_{w}_launches": out[w]["gather_launches"] for w in out},
            max(out[w]["max_abs_err"] for w in out))


CURRICULUM_SCRIPT = os.path.join(ROOT, "d3net_tpu_torch", "scripts",
                                 "run_r5_curriculum.sh")
CURRICULUM_ENV = {"DET_STEPS": "24",     # one dispatch of det_converge's 24
                  "SPK_STEPS": "2", "LIS_STEPS": "2", "JOINT_STEPS": "2",
                  "D3NET_VAL_SCENES": "4"}     # one val batch
CURRICULUM_DET_SCENES = 8    # of det_converge's 128 train scenes: its
#                              resident stack is 2 augmented epochs of them,
#                              4 batches the dispatch's 24 steps cycle over
CURRICULUM_HOOK = """import os
from d3net_tpu_torch import checks
checks.watch_process(os.environ["D3NET_WATCH_LOG"])
"""
CURRICULUM_STAGES = (      # the script's processes, as ``_process`` names them
    "train det_converge", "prepare_weights det_converge",
    "train spk_converge", "eval spk_converge_r5 captioning",
    "prepare_weights spk_converge", "train lis_converge",
    "eval lis_converge_r5 grounding", "prepare_weights lis_converge",
    "train joint_converge", "eval joint_converge_r5 captioning",
    "eval joint_converge_r5 grounding")


def _process(argv) -> str:
    """A curriculum process's name: its script and what it works on."""
    kind = os.path.basename(argv[0])[:-len(".py")]

    def arg(flag):
        return argv[argv.index(flag) + 1]
    if kind == "train":
        return f"train {os.path.basename(arg('--config'))[:-len('.yaml')]}"
    if kind == "eval":
        return f"eval {os.path.basename(arg('--folder'))} {arg('--task')}"
    return f"{kind} {arg('--name')}"


def stop_group(proc) -> None:
    """Kill every process of ``proc``'s session (started with
    ``start_new_session``) and reap ``proc``."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _repo_outputs():
    return {d: sorted(os.listdir(os.path.join(ROOT, d)))
            if os.path.isdir(os.path.join(ROOT, d)) else None
            for d in ("outputs", "pretrained")}


def start_curriculum(root):
    """Start the port's ``run_r5_curriculum.sh`` on the four ``*_converge``
    configs at their published widths, cut by CURRICULUM_ENV and
    CURRICULUM_DET_SCENES, in a temporary tree (a copy of conf/ and the
    script; the repo on PYTHONPATH, the smoke's interpreter as ``python``)
    so that nothing lands in the repo's outputs/ or pretrained/, in a
    session of its own with its output in files; ``phase_curriculum``
    waits for it. A ``sitecustomize`` hook (``checks.watch_process``)
    watches each of its 11 processes: every gather held against the plain
    version on the card, each loop step timed with the card waited on,
    each dispatch's CUDA-event ms; the ``python`` on its PATH logs each
    process's start and end."""
    run = {"t0": time.time(), "before": _repo_outputs(), "root": root,
           "tree": os.path.join(root, "tree"),
           "log": os.path.join(root, "watch.jsonl"),
           "procs": os.path.join(root, "procs.txt")}
    tree, hook = run["tree"], os.path.join(root, "hook")
    shutil.copytree(os.path.join(ROOT, "conf"), os.path.join(tree, "conf"))
    det_yaml = os.path.join(tree, "conf", "det_converge.yaml")
    det = cfg_lib.load(det_yaml).to_dict()
    det["data"]["synthetic"]["num_scenes"] = CURRICULUM_DET_SCENES
    with open(det_yaml, "w") as f:
        f.write(dump_yaml(det))
    script = os.path.join(tree, "d3net_tpu_torch", "scripts",
                          os.path.basename(CURRICULUM_SCRIPT))
    os.makedirs(os.path.dirname(script))
    shutil.copy2(CURRICULUM_SCRIPT, script)
    os.makedirs(os.path.join(hook, "bin"))
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(CURRICULUM_HOOK)
    python = os.path.join(hook, "bin", "python")
    with open(python, "w") as f:    # a venv's interpreter needs its path;
        f.write(                    # each process's start and end logged
            f'#!/bin/sh\nstart=$(date +%s.%N)\n"{sys.executable}" "$@"\n'
            f'rc=$?\necho "$start $(date +%s.%N)" >> "{run["procs"]}"\n'
            f'exit $rc\n')
    os.chmod(python, 0o755)
    # one card: the CLIs would run a rank a visible card, each watched
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([hook, ROOT]),
               PATH=os.pathsep.join([os.path.join(hook, "bin"),
                                     os.environ.get("PATH", "")]),
               CUDA_VISIBLE_DEVICES="0", D3NET_WATCH_LOG=run["log"],
               **CURRICULUM_ENV)
    torch.cuda.empty_cache()
    with open(os.path.join(root, "stdout.txt"), "w") as out, \
            open(os.path.join(root, "stderr.txt"), "w") as err:
        run["proc"] = subprocess.Popen(["bash", script], stdout=out,
                                       stderr=err, cwd=root, env=env,
                                       start_new_session=True)
    return run


def phase_curriculum(run):
    """Wait for ``start_curriculum``'s script (killing it past
    CURRICULUM_TIMEOUT): it must end with rc 0 and ``CURRICULUM DONE``, no
    traceback, its 11 processes in order; each process's wall time split
    into its start (the interpreter and imports before the hook), the
    watched seconds and its exit; each stage's step ms and finite losses,
    the evals' finite CIDEr, BLEU-4 and ref_iou_rate_0.5, each process's
    gathers all exact; the repo's outputs/ and pretrained/ as they were."""
    proc, root, tree, log = run["proc"], run["root"], run["tree"], run["log"]
    try:
        proc.wait(timeout=max(1.0, CURRICULUM_TIMEOUT
                              - (time.time() - run["t0"])))
    finally:
        stop_group(proc)
    seconds = time.time() - run["t0"]
    with open(os.path.join(root, "stdout.txt")) as f:
        stdout = f.read()
    with open(os.path.join(root, "stderr.txt")) as f:
        stderr = f.read()
    if (proc.returncode or "CURRICULUM DONE" not in stdout
            or "Traceback" in stderr):
        raise AssertionError(f"curriculum: rc {proc.returncode}\n"
                             f"{stderr[-4000:]}")
    with open(log) as f:
        procs = [json.loads(line) for line in f]
    with open(run["procs"]) as f:
        spans = [[float(t) for t in line.split()] for line in f]
    names = [_process(p["argv"]) for p in procs]
    if names != list(CURRICULUM_STAGES) or len(spans) != len(names):
        raise AssertionError(f"curriculum: processes {names}, {len(spans)} "
                             f"started")
    stages = []
    for name, p, (start, end) in zip(names, procs, spans):
        kind, arg = name.split()[0], name.split()[-1]
        rec = {"process": name, "process_s": round(end - start, 3),
               "start_s": round(p["t0"] - start, 3),
               "seconds": round(p["seconds"], 3),
               "exit_s": round(end - p["t0"] - p["seconds"], 3),
               "gather_launches": p["launches"],
               "gathers_checked_exact": p["checked"],
               "max_abs_err": p["max_abs_err"]}
        if p["checked"] != p["launches"]:
            raise AssertionError(f"curriculum: {name}: {p['checked']} of "
                                 f"{p['launches']} gathers checked")
        if kind != "prepare_weights" and not p["launches"]:
            raise AssertionError(f"curriculum: {name} ran no gather")
        if kind == "train":
            run_dir = os.path.join(tree, "outputs", f"{arg}_r5")
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                logged = [json.loads(line) for line in f]
            losses = {k: v for m in logged for k, v in m.items()
                      if k.endswith("loss")}
            for s in p["steps"]:
                losses.update({f"step{s['step']}/{k}": v for k, v in s.items()
                               if k.endswith("loss")})
            if not losses or not _finite(list(losses.values())):
                raise AssertionError(f"curriculum: {arg} losses {losses}")
            rec["losses"] = losses
            spd = int(load_task_config(os.path.join(
                tree, "conf", f"{arg}.yaml")).tpu.get("steps_per_dispatch", 0))
            rec["steps"] = len(p["steps"]) or spd * len(p["dispatches"])
            if p["steps"]:
                rec["step_ms"] = [s["step_s"] * 1e3 for s in p["steps"]]
                rec["run_step_ms"] = [s["wall_s"] * 1e3 for s in p["steps"]]
            for d in p["dispatches"]:
                rec["dispatch_wall_s"] = d["wall_s"]
                if "device_ms" in d:        # CUDA events: on the card
                    rec["scan_step_ms"] = d["device_ms"] / spd
        if kind == "eval":
            run_dir = os.path.join(
                tree, p["argv"][p["argv"].index("--folder") + 1])
            with open(os.path.join(run_dir, f"eval_{arg}.json")) as f:
                res_eval = json.load(f)
            keys = (("cider", "bleu4") if arg == "captioning"
                    else ("ref_iou_rate_0.5",))
            rec.update({k: res_eval[k] for k in keys})
            if not _finite([res_eval[k] for k in keys]):
                raise AssertionError(f"curriculum: {arg} eval {res_eval}")
        stages.append(rec)
    if _repo_outputs() != run["before"]:
        raise AssertionError("curriculum: the repo's outputs/ or pretrained/ "
                             "changed")
    emit({"phase": "curriculum", "stages": stages,
          "pretrained": sorted(os.listdir(os.path.join(tree, "pretrained"))),
          "reduced": [f"{k}={v}" for k, v in CURRICULUM_ENV.items()] + [
              f"det_converge's train scenes {CURRICULUM_DET_SCENES} of 128"],
          "seconds": round(seconds, 3)})
    return {"curriculum_launches": {s["process"]: s["gather_launches"]
                                    for s in stages},
            "curriculum_max_abs_err": max(s["max_abs_err"] for s in stages)}


# ``--cards N``: the train CLI's run on one card and across N cards
def collate_ms(cfg, world: int, reps: int = 3):
    """Host ms to build batch 0 of the first epoch for world size 1 (every
    scene augmented and collated) and for rank 0 of ``world`` ranks (every
    scene augmented, that rank's rows collated), median of ``reps``."""
    it, _ = make_dataloaders(cfg, spec_from_cfg(cfg))
    order = it._order()
    out = {}
    for name, w in (("all_rows", 1), (f"rank0_of_{world}", world)):
        it.rank, it.world = 0, w
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            it._build_one(order, 0)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"build_{name}_ms"] = statistics.median(times)
    return out


def cards_run(root, world: int):
    """``scripts.train.train`` (the CLI's entry after its arguments) on
    conf/pointgroup.yaml for CARDS_STEPS steps over ``world`` cards (one
    in this process with no group; else one NCCL process a card), logging
    every step: rank 0's ``iter_time`` a step (steps 2.., the traced ones
    left out) and, from its ``log.profile_step`` trace of the three steps
    after step CARDS_PROFILE_STEP, the device ms of all kernels and of the
    NCCL kernels a step."""
    cfg = run_config(root)
    cfg.train.log_every_n_steps = 1
    if cfg.get("log") is None:
        cfg["log"] = {}
    cfg.log["profile_step"] = CARDS_PROFILE_STEP
    run_dir = os.path.join(root, f"cards_{world}")
    t0 = time.time()
    train_cli.train(cfg, run_dir, CARDS_STEPS, "cuda", world_size=world)
    run_s = time.time() - t0
    recs = [r for r in _metrics(run_dir) if "train/iter_time" in r]
    if [r["step"] for r in recs] != list(range(1, CARDS_STEPS + 1)) or any(
            not math.isfinite(v) for r in recs for v in r.values()):
        raise AssertionError(f"cards {world}: metrics {recs}")
    traced = range(CARDS_PROFILE_STEP + 1, CARDS_PROFILE_STEP + 4)
    ms = [r["train/iter_time"] * 1e3 for r in recs
          if r["step"] > 1 and r["step"] not in traced]
    with open(os.path.join(run_dir, "profile", "trace.json")) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if "nccl" in e.get("name", "").lower()]
    with open(os.path.join(run_dir, "run_meta.json")) as f:
        meta = json.load(f)
    return {"phase": "cards_run", "world_size": world,
            "run_meta_world_size": meta.get("world_size"),
            "global_batch": int(cfg.data.batch_size), "steps": CARDS_STEPS,
            "step_ms": statistics.median(ms), "step_ms_all": ms,
            "device_busy_ms_per_step": sum(e["dur"] for e in kernels) / 3e3,
            "nccl_device_ms_per_step": sum(e["dur"] for e in nccl) / 3e3,
            "nccl_kernels_per_step": len(nccl) / 3,
            "train_losses": [r["train/total_loss"] for r in recs],
            "run_s": run_s}


def cards_eval(run_dir, n: int):
    """The detection eval of ``run_dir`` on one card and over ``n`` (one
    NCCL process a card): first the eval entry as users call it
    (``eval_detection(world_size=)``, default settings), the seconds of
    each and their metrics, reported (the bf16 forward differs run to run
    there); then both with ``exact`` settings (``checks.eval_rank``:
    parity precision, deterministic algorithms, where the forward
    reproduces itself), their seconds, and the metrics held equal (ints
    exact, floats within rtol 1e-5)."""
    cfg = load_task_config(os.path.join(run_dir, "config.yaml"))
    keys = ("mAP@0.25", "mAP@0.5", "AR@0.25", "AR@0.5")
    out = {"phase": "cards_eval", "task": "detection"}
    for world in (1, n):
        t0 = time.time()
        m = eval_cli.eval_detection(cfg, run_dir, "cuda", world_size=world)
        out[f"seconds_{world}_cards"] = time.time() - t0
        out.update({f"{k}_{world}_cards": m[k] for k in keys})
    res = evals_world_vs_one([("detection", run_dir, None, True)], world=n,
                             dev="cuda:0", backend="nccl",
                             devices=[f"cuda:{i}" for i in range(n)])
    rec = res["evals"][0]
    out.update({"exact_seconds_1_card": rec["seconds_world1"],
                f"exact_seconds_{n}_cards_per_rank": rec[
                    f"seconds_world{n}"],
                "exact_metrics": {k: rec["metrics_world1"][k] for k in keys},
                "exact_mismatches": rec["mismatches"]})
    emit(out)
    if not res["ok"]:
        raise AssertionError(f"cards_eval: {n} cards against one: "
                             f"{res['mismatches']}")


def cards_tools(root, n: int):
    """``benchmark_grounding`` on the imported full-width joint run dir
    (``joint_archive``, then ``import_jax_run``) over 2·B val scenes, one
    card and ``n``: first as users call it (``benchmark_grounding(
    world_size=)``, default settings), the seconds of each and whether the
    files are equal, reported; then both under the exact settings
    (``checks.tool_rank``), the files held as ``dist_tools`` holds them."""
    npz, cfg, _ = joint_archive(root)
    run = os.path.join(root, "imported")
    import_jax_run.import_run(npz, run)
    scenes = 2 * int(cfg.data.batch_size)
    out = {"phase": "cards_tools", "tool": "benchmark_grounding",
           "val_scenes": scenes}
    files = {}
    with val_scenes(scenes):
        for world in (1, n):
            path = os.path.join(root, f"grounding_{world}.json")
            t0 = time.time()
            benchmark_grounding.benchmark_grounding(
                cfg, run, "cuda", out=path, world_size=world)
            out[f"seconds_{world}_cards"] = time.time() - t0
            with open(path, "rb") as f:
                files[world] = f.read()
    out["default_settings_files_equal"] = files[1] == files[n]
    res = tools_world_vs_one([("benchmark_grounding", run, scenes, True)],
                             world=n, dev="cuda:0", backend="nccl",
                             devices=[f"cuda:{i}" for i in range(n)],
                             rtol=EVAL_RTOL)
    rec = res["tools"][0]
    out.update({"exact_seconds_1_card": rec["seconds_world1"],
                f"exact_seconds_{n}_cards_per_rank": rec[f"seconds_world{n}"],
                "exact_files": rec["files"], "exact_bytes": rec["bytes"],
                "exact_byte_equal": rec["byte_equal"],
                "exact_launches_per_rank": rec["launches_per_rank"],
                "exact_mismatches": rec["mismatches"]})
    emit(out)
    if not res["ok"]:
        raise AssertionError(f"cards_tools: {n} cards against one: "
                             f"{res['mismatches']}")


def cards_main(n: int) -> int:
    """The collate's cost of a rank's rows, then ``cards_run`` on one card
    and on ``n``, then ``cards_eval`` on the ``n``-card run dir, then
    ``cards_tools`` on an imported full-width joint run dir; the
    ``nvidia-smi`` line last."""
    smi = nvidia_smi_line()
    with tempfile.TemporaryDirectory(prefix="d3net_cards_") as root:
        emit({"phase": "cards_collate",
              **collate_ms(run_config(root), max(n, 2))})
        for world in sorted({1, n}):
            emit(cards_run(root, world))
        cards_eval(os.path.join(root, f"cards_{n}"), n)
        cards_tools(os.path.join(root, "tools"), n)
    print(smi, flush=True)
    return 0


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--cards", type=int, default=None,
                        help="only the train CLI's run on one card and on "
                             "this many (conf/pointgroup.yaml)")
    args = parser.parse_args(argv)
    if args.cards:
        return cards_main(args.cards)
    t_start = time.time()
    T_START[0] = t_start
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
    kernels[0]["dist_launches_per_step"] = phase_dist_step(
        variables, batch, train["step_ms"], train["train_launches"])
    del batch, variables
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="d3net_prep_") as root:
        prep_launches, prep_err = phase_prepare_scannet(root, launches)
        profile_launches, profile_err = phase_profile_ops(
            root, launches, train["train_launches"])
    phase_host_lib()
    with tempfile.TemporaryDirectory(prefix="d3net_run_") as root, \
            shared_scenes():
        run_dir, val_batches, run_per_step = phase_run(
            root, train["train_launches"], launches, train["step_ms"])
        world1 = {"detection": phase_eval(run_dir, val_batches, launches)}
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
        world1.update(phase_joint_eval(joint_run, launches))
        # the curriculum's 11 processes run beside the tools, the run
        # import and the two ranks of ``dist`` (all mostly host work: process
        # starts, scene builds); the lines of all of them carry
        # ``ran_beside``, and their times are contended
        curriculum_run = start_curriculum(os.path.join(root, "curriculum"))
        RAN_BESIDE[0] = "curriculum"
        try:
            tools_launches, tools_one = phase_tools(joint_run, launches)
            phase_tools_parity(os.path.join(root, "tools"))
            import_launches, import_err = phase_import_run(
                os.path.join(root, "import"), train["train_launches"],
                launches)
            dist_eval_launches, dist_tools_launches = phase_dist(
                run_dir, joint_run, world1, tools_one, launches)
        except BaseException:
            stop_group(curriculum_run["proc"])
            raise
        RAN_BESIDE[0] = "tools, tools_parity, import_run, dist"
        curriculum = phase_curriculum(curriculum_run)
        RAN_BESIDE[0] = None
        phase_enet_parity()
        store = phase_multiview(os.path.join(root, "mv"))
        flagship_run, scan = phase_flagship_train(
            os.path.join(root, "flagship"), store, train["train_launches"],
            launches)
        phase_scannet_eval(flagship_run, launches)
    kernels[0]["run_launches_per_step"] = run_per_step
    kernels[0]["caption_launches_per_batch"] = caption_launches
    kernels[0]["caption_max_abs_err"] = caption_err
    kernels[0]["grounding_launches_per_batch"] = grounding_launches
    kernels[0]["grounding_max_abs_err"] = grounding_err
    kernels[0]["tools_launches_per_batch"] = tools_launches
    kernels[0]["dist_eval_launches_per_rank_per_batch"] = dist_eval_launches
    kernels[0]["dist_tools_launches_per_rank_per_batch"] = \
        dist_tools_launches
    kernels[0]["import_run_launches_per_step"] = import_launches
    kernels[0]["import_run_max_abs_err"] = import_err
    kernels[0].update(spk)
    kernels[0].update(lis)
    kernels[0].update(joint)
    kernels[0].update(scan)
    kernels[0]["prepare_scannet_launches_per_batch"] = prep_launches
    kernels[0].update(profile_launches)
    kernels[0].update(curriculum)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], caption_err,
                                    spk["spk_train_max_abs_err"],
                                    grounding_err,
                                    lis["lis_train_max_abs_err"],
                                    joint["joint_train_max_abs_err"],
                                    scan["scan_train_max_abs_err"],
                                    import_err, prep_err, profile_err,
                                    curriculum["curriculum_max_abs_err"])
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    emit({"kernels": kernels + probe_entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
