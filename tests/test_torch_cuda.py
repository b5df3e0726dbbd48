"""Card-only checks of the port (marker ``cuda``): each kernel against its
plain version (the two ring kernels at their run edges too, and
``prefetch_window_gather``'s on every bases pattern of
``probe.prefetch_patterns``), the launch path on PyTorch's current stream
for every kernel, the detector on cuda
against the detector on cpu, the sparse conv's backward on cuda
against the same on cpu, and the run loop on cuda against the run loop on
cpu, with a checkpoint round trip on the card; the speaker (graph and
greedy decode) on cuda against cpu, its train step (detector trained and
frozen) on cuda against cpu, and the captioning eval CLI on cuda against
the same on cpu; the listener (eval and train forward) on cuda against
cpu, its train step (detector trained and frozen) and the grounding eval
CLI likewise; joint RL's beam search (the all-ties case too), its train
step (detector trained and frozen) and the joint train CLI on cuda
against cpu; ENet's forward and train step, the scan trainer and
``compute_multiview_features`` on cuda against cpu; the ScanRefer
submission writers and ``port_enet_weights --selftest`` on cuda against
cpu; data-parallel training: the detector step through a one-rank NCCL
group against the step with no group, and two gloo ranks on one card
against world size 1 (the detector step and the joint step).

This file imports no JAX, so it also runs on a machine that has only
PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest`` skips the JAX setup of tests/conftest.py). Without a
card every test skips.
"""

import os

import numpy as np
import pytest
import torch

from d3net_tpu_torch import device, params
from d3net_tpu_torch import probe as probe_cli
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.kernels import gather, probe
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.ops.sparse_conv import sparse_conv_t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(m=8, blocks=(1, 2, 3), cluster_blocks=(1, 2), clusters_per_pass=16,
           max_num_proposal=8, cluster_npoint_thre=30, test_npoint_thresh=30,
           test_score_thresh=0.0, cluster_ring=1, cluster_cell_size=0.03,
           cluster_prop_iters=4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these on the H100)")
    with device.parity_precision():
        yield


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_gather_kernel_matches_plain(card, dtype):
    g = torch.Generator(device="cuda").manual_seed(0)
    for c in (1, 3, 16, 134):
        src = torch.randint(-100, 100, (500, c), generator=g,
                            device="cuda").to(dtype)
        # 500 is the pad sentinel; -3..-1 and 501..502 are out of range
        idx = torch.randint(-3, 503, (4000,), generator=g, device="cuda",
                            dtype=torch.int32)
        before = gather.gather_rows.launches
        got = gather.gather_rows(src, idx)
        assert gather.gather_rows.launches == before + 1
        assert torch.equal(got, gather.gather_rows_plain(src, idx))


@pytest.mark.cuda
def test_detector_cuda_matches_cpu(card):
    scenes = [make_scene(seed=i, num_instances=3, density=3000.0,
                         size_range=(0.25, 0.5), floor_points=1000, room=4.0)
              for i in range(2)]
    batch = build_batch(scenes, BatchSpec(
        max_points=3072, voxel_caps=[3072, 1536, 768], max_instances=8,
        use_multiview=False, use_normal=True))
    variables = params.init_flax_variables(
        PointGroup(batch["point_feats"].shape[-1] + 3, **CFG), seed=0)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = params.load_detector(variables, CFG, device=dev)
        with torch.no_grad():
            outs[dev] = {k: v.cpu() for k, v in
                         model(batch_to_torch(batch, dev)).items()}
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        if want.is_floating_point():
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        else:
            assert torch.equal(got, want), k


@pytest.mark.cuda
def test_probe_scale2_matches_plain(card):
    g = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn(100003, generator=g, device="cuda") * 1e3).bfloat16()
    for t in (x[:-1], x[1:], x[:5]):   # aligned, 2-byte offset, short tail
        before = probe.probe_scale2.launches
        got = probe.probe_scale2(t)
        assert probe.probe_scale2.launches == before + 1
        assert torch.equal(got, probe.probe_scale2_plain(t))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", probe.DTYPES)
@pytest.mark.parametrize("c", [64, 128, 256])
def test_window3_gather_matches_plain(card, dtype, c):
    g = torch.Generator(device="cuda").manual_seed(c)
    for ch, nchunk in ((512, 4), (128, 1)):
        n = ch * nchunk
        src = torch.randn(n, c, generator=g, device="cuda").to(dtype)
        idx = torch.randint(-ch - 3, n + ch + 3, (n,), generator=g,
                            device="cuda", dtype=torch.int32)
        before = probe.window3_gather.launches
        got = probe.window3_gather(src, idx, ch)
        assert probe.window3_gather.launches == before + 1
        assert torch.equal(got, probe.window3_gather_plain(src, idx, ch))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", probe.DTYPES)
@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("ch", [128, 512])
def test_window3_gather_run_edges(card, dtype, c, ch):
    """nchunk in {1, 2, 3, L-1, L, L+1, 2L+1}, L the plan's run length at
    the probe's size, with the card's plan and with every plan that a card
    of fewer SMs gets (longer runs, so other run edges)."""
    g = torch.Generator(device="cuda").manual_seed(c + ch)
    row = c * torch.empty((), dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    run = probe.window3_ring_plan(262144, ch, row, sms).run_chunks
    for nchunk in sorted({1, 2, 3, max(run - 1, 1), run, run + 1,
                          2 * run + 1}):
        n = ch * nchunk
        src = torch.randn(n, c, generator=g, device="cuda").to(dtype)
        idx = torch.randint(-ch - 3, n + ch + 3, (n,), generator=g,
                            device="cuda", dtype=torch.int32)
        want = probe.window3_gather_plain(src, idx, ch)
        assert torch.equal(probe.window3_gather(src, idx, ch), want), nchunk
        plans = {p.run_chunks: p for p in (
            probe.window3_ring_plan(n, ch, row, s) for s in range(1, sms))}
        for plan in plans.values():
            assert torch.equal(probe.window3_gather(src, idx, ch, plan),
                               want), (nchunk, plan)


@pytest.mark.cuda
def test_launch_honours_the_current_stream(card):
    """Inputs written on a side stream behind a long sleep: each kernel,
    launched under ``torch.cuda.stream(side)``, reads the written values,
    which it would not if it ran on another stream."""
    g = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn(4096, 64, generator=g, device="cuda")
    idx = torch.randint(-600, 4096 + 600, (4096,), generator=g,
                        device="cuda", dtype=torch.int32)
    rel = torch.randint(-20, 6 * 128 + 20, (4096,), generator=g,
                        device="cuda", dtype=torch.int32)
    bases = torch.tensor([0, 3, 7, 26, 20, 27, 1, 4], device="cuda",
                         dtype=torch.int32)
    kw = dict(chunk=512, wblk=128, nwin=6)
    x = torch.zeros_like(y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)        # ~0.1 s of device cycles
        x.copy_(y)
        got = (gather.gather_rows(x, idx), probe.window3_gather(x, idx, 512),
               probe.probe_scale2(x.bfloat16()),
               probe.prefetch_window_gather(x, rel, bases, **kw))
    torch.cuda.synchronize()
    assert torch.equal(got[0], gather.gather_rows_plain(y, idx))
    assert torch.equal(got[1], probe.window3_gather_plain(y, idx, 512))
    assert torch.equal(got[2], probe.probe_scale2_plain(y.bfloat16()))
    assert torch.equal(got[3], probe.prefetch_window_gather_plain(
        y, rel, bases, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", probe.DTYPES)
@pytest.mark.parametrize("c", [64, 128, 256])
def test_prefetch_window_gather_matches_plain(card, dtype, c):
    g = torch.Generator(device="cuda").manual_seed(c + 1)
    n_src, chunk, wblk, nwin = 4096, 512, 128, 6
    n = 5 * chunk + 37
    src = torch.randn(n_src, c, generator=g, device="cuda").to(dtype)
    bases = torch.randint(0, n_src // wblk - nwin + 3, (6,), generator=g,
                          device="cuda", dtype=torch.int32)
    rel = torch.randint(-20, nwin * wblk + 20, (n,), generator=g,
                        device="cuda", dtype=torch.int32)
    kw = dict(chunk=chunk, wblk=wblk, nwin=nwin)
    before = probe.prefetch_window_gather.launches
    got = probe.prefetch_window_gather(src, rel, bases, **kw)
    assert probe.prefetch_window_gather.launches == before + 1
    assert torch.equal(got, probe.prefetch_window_gather_plain(src, rel,
                                                               bases, **kw))


def _prefetch_every_plan(g, src, bases, n, chunk, wblk, nwin, what):
    """``prefetch_window_gather`` on random rel (a margin outside the
    window too) with the card's plan and every plan that a card of fewer
    SMs gets (longer runs, so other run edges), each bit-exact."""
    rel = torch.randint(-20, nwin * wblk + 20, (n,), generator=g,
                        device="cuda", dtype=torch.int32)
    bases = torch.from_numpy(bases).cuda()
    kw = dict(chunk=chunk, wblk=wblk, nwin=nwin)
    want = probe.prefetch_window_gather_plain(src, rel, bases, **kw)
    assert torch.equal(probe.prefetch_window_gather(src, rel, bases, **kw),
                       want), what
    row = src.shape[1] * src.element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {p.run_chunks: p for p in (
        probe.prefetch_ring_plan(n, chunk, wblk, nwin, row, s)
        for s in range(1, sms))}
    for plan in plans.values():
        assert torch.equal(probe.prefetch_window_gather(
            src, rel, bases, plan=plan, **kw), want), (what, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", probe.DTYPES)
@pytest.mark.parametrize("c", [64, 128, 256])
def test_prefetch_window_gather_run_edges(card, dtype, c):
    """nchunk in {1, 2, 3, L-1, L, L+1, 2L+1}, L the plan's run length at
    the probe's size, whole and with a ragged last chunk, banded bases."""
    g = torch.Generator(device="cuda").manual_seed(c + 7)
    chunk, wblk, nwin = 512, 128, 6
    row = c * torch.empty((), dtype=dtype).element_size()
    run = probe.prefetch_ring_plan(262144, chunk, wblk, nwin, row).run_chunks
    for nchunk in sorted({1, 2, 3, max(run - 1, 1), run, run + 1,
                          2 * run + 1}):
        n_src = nchunk * chunk + 3 * wblk - 37
        src = torch.randn(n_src, c, generator=g, device="cuda").to(dtype)
        bases = probe_cli.prefetch_patterns(nchunk, chunk, wblk, nwin,
                                            n_src)["banded"]
        for n in (nchunk * chunk, nchunk * chunk - 37):
            _prefetch_every_plan(g, src, bases, n, chunk, wblk, nwin,
                                 (nchunk, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", probe.DTYPES)
@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("chunk,wblk,nwin", [(512, 128, 6), (200, 100, 3),
                                             (300, 384, 2)])
def test_prefetch_window_gather_bases_patterns(card, dtype, c, chunk, wblk,
                                               nwin):
    """Every bases pattern of ``probe.prefetch_patterns`` (banded, constant,
    the largest advance without a deferred copy and one more, backward,
    negative, past the source end, random jumps), a ragged last chunk, a
    source whose last block is partial; 100-row blocks take the division
    path and boxes of 104 rows, 384-row blocks two boxes of 192 rows."""
    g = torch.Generator(device="cuda").manual_seed(c + chunk)
    nchunk = 13
    n = nchunk * chunk - 37
    step = -(-chunk // wblk)
    n_src = ((nchunk - 1) * (step + 1) + nwin + 1) * wblk - 37
    src = torch.randn(n_src, c, generator=g, device="cuda").to(dtype)
    for name, bases in probe_cli.prefetch_patterns(nchunk, chunk, wblk, nwin,
                                                   n_src).items():
        _prefetch_every_plan(g, src, bases, n, chunk, wblk, nwin, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_conv_backward_cuda_matches_cpu(card, dtype):
    """dx through the mirrored table and dW (f32) on the card against the
    CPU, relative to each output's largest entry (dW sums 3000 rows; cuBLAS
    and ATen's CPU GEMM order them differently): f32 1e-5; bf16, the working
    type's rounding, 2e-2."""
    rng = np.random.default_rng(0)
    m, k, cin, cout = 3000, 27, 16, 32
    nbr = rng.integers(0, m + 1, (m, k)).astype(np.int32)
    feats = rng.standard_normal((m, cin)).astype(np.float32)
    w = rng.standard_normal((k, cin, cout)).astype(np.float32) * 0.1
    gout = rng.standard_normal((m, cout)).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        x = torch.from_numpy(feats).to(dev, dtype).requires_grad_()
        wt = torch.from_numpy(w).to(dev).requires_grad_()
        nb = torch.from_numpy(nbr).to(dev)
        out = sparse_conv_t(x, nb, nb, wt, True)
        out.backward(torch.from_numpy(gout).to(dev, dtype))
        res[dev] = (x.grad.float().cpu(), wt.grad.cpu())
        assert wt.grad.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in zip(res["cuda"], res["cpu"]):
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol * scale)


def _tiny_run_cfg(root):
    from d3net_tpu_torch import config

    cfg = config.load(os.path.join(ROOT, "conf", "debug",
                                   "tiny_pointgroup.yaml"))
    cfg.general.output_root = str(root)
    cfg.cluster.prepare_epochs = 10        # no clustering: no random draw
    cfg.train.optim.classname = "SGD"      # see tests/test_torch_loop.py
    return cfg


@pytest.mark.cuda
def test_run_loop_cuda_matches_cpu(card, tmp_path):
    """Two steps and a validation of the run loop on cuda against the same
    on cpu: train and val losses within the step tolerance (rtol 1e-4),
    and every step launches ``gather_rows`` on cuda."""
    import json

    from d3net_tpu_torch.train.loop import run_detector_training

    recs, launches = {}, []
    for dev in ("cpu", "cuda"):
        run = str(tmp_path / dev)
        before = gather.gather_rows.launches
        run_detector_training(
            _tiny_run_cfg(tmp_path), run, max_steps=2, device=dev,
            on_step=lambda r: launches.append(gather.gather_rows.launches))
        if dev == "cpu":
            assert gather.gather_rows.launches == before
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs[dev] = [json.loads(line) for line in f if line.strip()]
    assert len(launches) == 4 and launches[2] > 0 and launches[3] > launches[2]
    for c, g in zip(recs["cpu"], recs["cuda"]):
        assert set(c) == set(g) and c["step"] == g["step"]
        for k, v in c.items():
            if k.endswith(("_loss", "grad_norm")):
                np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_cuda_is_bit_exact(card, tmp_path):
    """A cuda train state saved by ``Checkpointer`` and restored into a
    fresh cuda state equals it bit for bit, on the card."""
    from d3net_tpu_torch.train.loop import (
        Checkpointer, detector_from_cfg, init_detector,
        run_detector_training,
    )
    from d3net_tpu_torch.train.trainer import create_train_state

    cfg = _tiny_run_cfg(tmp_path)
    cfg.train.optim.classname = "AdamW"    # moments and step counts
    state = run_detector_training(cfg, str(tmp_path / "r"), max_steps=2)
    fresh = create_train_state(init_detector(detector_from_cfg(cfg), 1).cuda(),
                               optim="AdamW")
    assert Checkpointer(str(tmp_path / "r"), "total_loss").restore_last(
        fresh) is fresh and fresh.step == state.step == 2
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert a.is_cuda and b.is_cuda and torch.equal(a, b), k
    want, got = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want["state"] and want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            g = got["state"][i][k]
            assert g.device == v.device and torch.equal(v, g), (i, k)


@pytest.mark.cuda
def test_profile_step_trace_holds_spans_beside_kernels(card, tmp_path):
    """``log.profile_step: 3`` on the card: ``profile/trace.json`` holds the
    kernels, the main thread's ``d3net.train.step`` spans of the traced
    steps and the collate workers' ``d3net.data.collate`` spans, each
    worker on a row of its own, on one timeline."""
    import json

    from d3net_tpu_torch.train.loop import run_detector_training

    cfg = _tiny_run_cfg(tmp_path)
    cfg.data.num_workers = 2
    cfg.log = {"profile_step": 3}
    run = str(tmp_path / "run")
    run_detector_training(cfg, run, max_steps=6, device="cuda")
    with open(os.path.join(run, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    host = [e for e in events if e.get("cat") == "user_annotation"]
    steps = [e for e in host if e["name"] == "d3net.train.step"]
    collates = [e for e in host if e["name"] == "d3net.data.collate"]
    assert kernels and len(steps) == 3 and collates
    workers = {e["tid"] for e in collates}
    assert not workers & {e["tid"] for e in steps}
    assert workers == {e["tid"] for e in events if e.get("ph") == "M" and
                       "d3net spans" in e.get("args", {}).get("name", "")}
    # the workers' spans lie inside the main thread's traced window
    main = [e for e in events if e.get("ph") == "X"
            and e.get("tid") in {s["tid"] for s in steps}]
    t0 = min(e["ts"] for e in main)
    t1 = max(e["ts"] + e["dur"] for e in main)
    assert all(t0 <= e["ts"] <= t1 for e in collates)
    assert sum(t0 <= k["ts"] <= t1 for k in kernels) > 100


# the host syncs of one flagship-layout scan step, by file:line (PERF.md,
# section 3): A19's capture of a dispatch needs each of them gone
FLAGSHIP_STEP_SYNCS = {
    "d3net_tpu_torch/ops/cluster.py:48": 1,    # the curve offsets' upload
    "d3net_tpu_torch/utils/bbox.py:25": 1,     # the box corner signs'
}


@pytest.mark.cuda
def test_flagship_step_host_syncs_are_the_listed_ones(card):
    """One scan-trainer step in conf/flagship_converge.yaml's layout,
    traced: the ``host_syncs`` counted inside its ``train.step`` span are
    the syncs listed by ``file:line``, no more (``checks.
    flagship_step_syncs``)."""
    from d3net_tpu_torch import checks

    res = checks.flagship_step_syncs(torch.device("cuda"))
    assert res["sites"] == FLAGSHIP_STEP_SYNCS
    assert res["host_syncs"] == [sum(FLAGSHIP_STEP_SYNCS.values())]


def _tiny_caption_cfg(root=None):
    from d3net_tpu_torch import config

    cfg = config.load(os.path.join(ROOT, "conf", "debug",
                                   "tiny_captioning.yaml"))
    cfg.model.use_orientation = True
    if root is not None:
        cfg.general.output_root = str(root)
    return cfg


@pytest.mark.cuda
def test_speaker_cuda_matches_cpu(card):
    """The speaker at the tiny captioning widths on seeded proposals: the
    graph's integers equal, its floats within rtol 1e-4, the greedy ids
    equal and each device's logits, teacher-forced on the cpu's ids,
    within rtol 1e-4; the cuda decode makes no host sync
    (``checks.speaker_cuda_vs_cpu``, which chip_smoke.py also runs)."""
    from d3net_tpu_torch.checks import speaker_cuda_vs_cpu
    from d3net_tpu_torch.train import pipeline
    from d3net_tpu_torch.utils.bbox import box_corners

    cfg = _tiny_caption_cfg()
    vocab, emb = pipeline.build_vocab(cfg)
    variables = params.init_flax_variables(
        pipeline.pipeline_from_cfg(cfg, vocab), seed=1)
    rng = np.random.default_rng(0)
    b, p = 3, cfg.model.max_num_proposal
    mask = (rng.random((b, p)) < 0.8).astype(np.float32)
    corners = box_corners(rng.uniform(0, 4, (b, p, 3)).astype(np.float32),
                          rng.uniform(0.2, 1, (b, p, 3)).astype(np.float32))
    data = {"proposal_feats_batched": rng.normal(size=(b, p, 8)).astype(
                np.float32) * mask[..., None],
            "proposal_batch_mask": mask,
            "proposal_bbox_batched": corners * mask[..., None, None],
            "glove_embeddings": emb}
    report = speaker_cuda_vs_cpu(variables, cfg, vocab, data, rtol=1e-4,
                                 atol=1e-5)
    assert all(report["integers_equal"].values()), report
    assert report["ids_equal"], report
    assert report["outside_tolerance"] == [], report
    assert report["ok"]


@pytest.mark.cuda
def test_caption_eval_cli_cuda_matches_cpu(card, tmp_path):
    """``--task captioning`` on one run dir (a tiny pipeline checkpoint) on
    cuda and on cpu: the same metrics, and ``gather_rows`` launched on
    cuda only."""
    import json

    from d3net_tpu_torch import config
    from d3net_tpu_torch.scripts import eval as eval_cli
    from d3net_tpu_torch.train import pipeline
    from d3net_tpu_torch.train.loop import Checkpointer
    from d3net_tpu_torch.train.trainer import create_train_state

    cfg = _tiny_caption_cfg(tmp_path)
    cfg.eval.min_iou_threshold = 0.2
    run = str(tmp_path / "run")
    os.makedirs(run)
    config.save(cfg, os.path.join(run, "config.yaml"))
    vocab, _ = pipeline.build_vocab(cfg)
    model = params.load_pipeline(params.init_flax_variables(
        pipeline.pipeline_from_cfg(cfg, vocab), seed=2), cfg, vocab,
        device="cpu")
    Checkpointer(run, "cider", "max").save(3, create_train_state(model),
                                           {"cider": 0.1})
    res = {}
    for dev in ("cpu", "cuda"):
        before = gather.gather_rows.launches
        eval_cli.main(["--folder", run, "--task", "captioning"]
                      + (["--cpu"] if dev == "cpu" else []))
        launched = gather.gather_rows.launches - before
        assert (launched > 0) == (dev == "cuda")
        with open(os.path.join(run, "eval_captioning.json")) as f:
            res[dev] = json.load(f)
    assert res["cuda"]["checkpoint"] == {"kind": "best", "step": 3}
    assert set(res["cuda"]) == set(res["cpu"])
    for k, v in res["cpu"].items():
        if k != "checkpoint":
            np.testing.assert_allclose(res["cuda"][k], v, rtol=1e-4, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True],
                         ids=["trained_detector", "frozen_detector"])
def test_speaker_train_step_cuda_matches_cpu(card, freeze):
    """One mode-1 train step at the tiny captioning widths (orientation on,
    seeded object rotations, ``min_iou_threshold`` 0) on cuda against cpu:
    losses rtol 1e-4, every gradient 1e-3 / 1e-6, new BN statistics 1e-4 /
    1e-5, target ids and good-box masks equal; ``gather_rows`` launched on
    cuda only: forward, dW and dx gathers, or with the detector frozen the
    forward's alone (``checks.speaker_step_cuda_vs_cpu``, which
    chip_smoke.py also runs)."""
    from d3net_tpu_torch.checks import (
        speaker_step_case, speaker_step_cuda_vs_cpu,
    )
    from d3net_tpu_torch.models.blocks import SubmConv
    from d3net_tpu_torch.train import pipeline

    cfg = _tiny_caption_cfg()
    cfg.data.min_iou_threshold = 0.0
    vocab, emb = pipeline.build_vocab(cfg)
    case = speaker_step_case(cfg, vocab, seed=1)
    report = speaker_step_cuda_vs_cpu(cfg, vocab, emb, case, freeze)
    assert report["ok"], report
    assert report["losses_cpu"]["orientation_loss"] > 0
    n_conv = sum(isinstance(m, SubmConv) for m in pipeline.pipeline_from_cfg(
        cfg, vocab).detector.modules())
    forward = n_conv + 4
    assert report["gather_launches_cpu"] == 0
    assert report["gather_launches_cuda"] == (
        forward if freeze else forward + n_conv + n_conv - 1)


def _tiny_grounding_cfg():
    from d3net_tpu_torch import config

    return config.load(os.path.join(ROOT, "conf", "debug",
                                    "tiny_grounding.yaml"))


@pytest.mark.cuda
def test_listener_cuda_matches_cpu(card):
    """The listener at the tiny grounding widths on seeded proposals and
    descriptions (lengths 0 and T among them), eval and train forward with
    the same draws: every output and the BN statistics within rtol 1e-4 /
    atol 1e-5 (``checks.listener_cuda_vs_cpu``, which chip_smoke.py also
    runs)."""
    from d3net_tpu_torch.checks import listener_cuda_vs_cpu, randomize
    from d3net_tpu_torch.train import pipeline

    cfg = _tiny_grounding_cfg()
    vocab, emb = pipeline.build_vocab(cfg)
    variables = randomize(params.init_flax_variables(
        pipeline.pipeline_from_cfg(cfg, vocab), seed=1),
        np.random.default_rng(2))
    rng = np.random.default_rng(0)
    b, p, t = 3, cfg.model.max_num_proposal, cfg.data.max_spk_len + 2
    rows = b * int(cfg.data.num_des_per_scene)
    mask = (rng.random((b, p)) < 0.8).astype(np.float32)
    lens = rng.integers(1, t + 1, rows)
    lens[0], lens[1] = 0, t
    data = {"proposal_feats_batched": rng.normal(size=(b, p, 8)).astype(
                np.float32) * mask[..., None],
            "proposal_batch_mask": mask,
            "proposal_center_batched": rng.uniform(0, 4, (b, p, 3)).astype(
                np.float32) * mask[..., None],
            "word_embs": emb[rng.integers(0, len(vocab), (rows, t))],
            "lang_len": lens.astype(np.int64)}
    report = listener_cuda_vs_cpu(variables, cfg, vocab, data, rtol=1e-4,
                                  atol=1e-5)
    assert report["outside_tolerance"] == [], report
    assert len(report["dropout_masks"]) == 7 and report["ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True],
                         ids=["trained_detector", "frozen_detector"])
def test_listener_train_step_cuda_matches_cpu(card, freeze):
    """One mode-2 train step at the tiny grounding widths (dropout and
    copy-paste on, the same draws) on cuda against cpu: the ten metrics
    rtol 1e-4, every gradient 1e-3 / 1e-6 (or within 4x its own one-ulp
    movement, for under 1% of a tensor), new BN statistics 1e-4 / 1e-5;
    ``gather_rows`` launched on cuda only (``checks.
    listener_step_cuda_vs_cpu``, which chip_smoke.py also runs)."""
    from d3net_tpu_torch.checks import (
        listener_step_case, listener_step_cuda_vs_cpu,
    )
    from d3net_tpu_torch.models.blocks import SubmConv
    from d3net_tpu_torch.train import pipeline

    cfg = _tiny_grounding_cfg()
    vocab, emb = pipeline.build_vocab(cfg)
    case = listener_step_case(cfg, vocab, emb, seed=1)
    report = listener_step_cuda_vs_cpu(cfg, vocab, emb, case, freeze)
    assert report["ok"], report
    assert report["losses_cpu"]["grounding_loss"] > 0
    n_conv = sum(isinstance(m, SubmConv) for m in pipeline.pipeline_from_cfg(
        cfg, vocab).detector.modules())
    forward = n_conv + 4
    assert report["gather_launches_cpu"] == 0
    assert report["gather_launches_cuda"] == (
        forward if freeze else forward + n_conv + n_conv - 1)


@pytest.mark.cuda
def test_grounding_eval_cli_cuda_matches_cpu(card, tmp_path):
    """``--task grounding`` on one run dir (a tiny listener pipeline
    checkpoint) on cuda and on cpu: the same metrics, and ``gather_rows``
    launched on cuda only."""
    import json

    from d3net_tpu_torch import config
    from d3net_tpu_torch.scripts import eval as eval_cli
    from d3net_tpu_torch.train import pipeline
    from d3net_tpu_torch.train.loop import Checkpointer
    from d3net_tpu_torch.train.trainer import create_train_state

    cfg = _tiny_grounding_cfg()
    cfg.general.output_root = str(tmp_path)
    run = str(tmp_path / "run")
    os.makedirs(run)
    config.save(cfg, os.path.join(run, "config.yaml"))
    vocab, _ = pipeline.build_vocab(cfg)
    model = params.load_pipeline(params.init_flax_variables(
        pipeline.pipeline_from_cfg(cfg, vocab), seed=2), cfg, vocab,
        device="cpu")
    Checkpointer(run, "ref_iou_rate_0.5", "max").save(
        3, create_train_state(model), {"ref_iou_rate_0.5": 0.1})
    res = {}
    for dev in ("cpu", "cuda"):
        before = gather.gather_rows.launches
        eval_cli.main(["--folder", run, "--task", "grounding"]
                      + (["--cpu"] if dev == "cpu" else []))
        launched = gather.gather_rows.launches - before
        assert (launched > 0) == (dev == "cuda")
        with open(os.path.join(run, "eval_grounding.json")) as f:
            res[dev] = json.load(f)
    assert res["cuda"]["checkpoint"] == {"kind": "best", "step": 3}
    assert set(res["cuda"]) == set(res["cpu"])
    for k, v in res["cpu"].items():
        if k != "checkpoint":
            np.testing.assert_allclose(res["cuda"][k], v, rtol=1e-4, err_msg=k)


def _beam_case(zero_output: bool):
    """A seeded caption decoder (output layer zeroed: every logit equal)
    and decoder inputs for 6 rows."""
    from d3net_tpu_torch.models.caption import CaptionModule

    torch.manual_seed(0)
    cap = CaptionModule(num_vocabs=40, sos_id=2, eos_id=3, feat_size=32,
                        hidden_size=64, num_locals=4, max_len=12)
    with torch.no_grad():
        for p in cap.parameters():
            p.add_(0.05 * torch.randn_like(p))
        if zero_output:
            cap.cls_fc2.weight.zero_()
            cap.cls_fc2.bias.zero_()
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(40, 300, generator=g) * 0.3,
         torch.randn(6, 32, generator=g), torch.randn(6, 16, 32, generator=g),
         (torch.rand(6, 16, generator=g) < 0.6).float())
    return cap, x


@pytest.mark.cuda
@pytest.mark.parametrize("zero_output", [False, True],
                         ids=["random", "all_ties"])
@pytest.mark.parametrize("bm,groups", [(3, 1), (3, 3), (6, 3)])
def test_beam_decode_cuda_matches_cpu(card, zero_output, bm, groups):
    """``beam_decode`` on cuda against cpu: sequences equal (with every
    logit equal, the tie rule alone picks), log-probs and scores rtol 1e-4
    / atol 1e-5; the cuda search makes no host sync."""
    cap, x = _beam_case(zero_output)
    out = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            c = cap.to(dev)
            args = [a.to(dev) for a in x]
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                res = c.beam_decode(*args, bm, group_size=groups,
                                    diversity_lambda=0.5)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out[dev] = [r.cpu() for r in res]
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    for g, c in zip(out["cuda"][1:], out["cpu"][1:]):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _tiny_joint_cfg():
    from d3net_tpu_torch import config
    from d3net_tpu_torch.checks import joint_parity_config

    return joint_parity_config(config.load(os.path.join(
        ROOT, "conf", "debug", "tiny_joint.yaml")))


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True],
                         ids=["trained_detector", "frozen_detector"])
def test_joint_step_cuda_matches_cpu(card, freeze):
    """One mode-3 train step at the tiny joint widths (the published beam,
    the XE anchor, the same draws) on cuda against cpu: the rollout ids
    equal (its search without a host sync), then on the cpu's rollout the
    metrics rtol 1e-4, every gradient 1e-3 / 1e-6 (or within 4x its own
    one-ulp movement, for under 1% of a tensor), new BN statistics 1e-4 /
    1e-5, the host scores equal; ``gather_rows`` launched on cuda only
    (``checks.joint_step_cuda_vs_cpu``, which chip_smoke.py also runs)."""
    from d3net_tpu_torch.checks import joint_step_case, joint_step_cuda_vs_cpu
    from d3net_tpu_torch.models.blocks import SubmConv
    from d3net_tpu_torch.train import pipeline

    cfg = _tiny_joint_cfg()
    vocab, emb = pipeline.build_vocab(cfg)
    case = joint_step_case(cfg, vocab, emb, seed=1)
    report = joint_step_cuda_vs_cpu(cfg, vocab, emb, case, freeze)
    assert report["ok"], {k: report[k] for k in (
        "outside_tolerance", "grad_detail", "rollout_ids_equal",
        "first_difference", "relu_kink_crossings", "grad_max_abs_err")}
    n_conv = sum(isinstance(m, SubmConv) for m in pipeline.pipeline_from_cfg(
        cfg, vocab).detector.modules())
    forward = n_conv + 4
    assert report["gather_launches_cpu"] == 0
    assert report["gather_launches_cuda"] == 2 * (
        forward if freeze else forward + n_conv + n_conv - 1)


@pytest.mark.cuda
def test_joint_train_cli_cuda_matches_cpu(card, tmp_path, monkeypatch):
    """``python -m d3net_tpu_torch.scripts.train`` on a tiny joint config
    (SGD, 2 steps and a validation) on cuda and on cpu with the same draws
    at every step (a case's, as tensors: the devices' generators differ):
    the train records' losses and rewards rtol 1e-4, the same val keys with
    ``combined``, and ``gather_rows`` launched on cuda only."""
    import json

    from d3net_tpu_torch import config
    from d3net_tpu_torch.checks import joint_step_case, joint_step_kwargs
    from d3net_tpu_torch.scripts import train as train_cli
    from d3net_tpu_torch.train import pipeline

    cfg = _tiny_joint_cfg()
    cfg.general.output_root = str(tmp_path)
    cfg.general.monitor = "val_score/combined"
    cfg.train.optim.classname = "SGD"
    path = str(tmp_path / "joint.yaml")
    config.save(cfg, path)
    vocab, emb = pipeline.build_vocab(cfg)
    case = joint_step_case(cfg, vocab, emb, seed=2)
    real = pipeline.joint_rl_train_step

    def step(state, *args, **kw):
        dev = args[0]["point_xyz"].device
        return real(state, *args[:5], **joint_step_kwargs(case, dev), **kw)

    monkeypatch.setattr(pipeline, "joint_rl_train_step", step)
    recs = {}
    for dev in ("cpu", "cuda"):
        before = gather.gather_rows.launches
        train_cli.main(["--config", path, "--max_steps", "2", "--folder",
                        dev] + (["--cpu"] if dev == "cpu" else []))
        assert (gather.gather_rows.launches > before) == (dev == "cuda")
        with open(os.path.join(str(tmp_path), dev, "metrics.jsonl")) as f:
            recs[dev] = [json.loads(line) for line in f if line.strip()]
    assert [r["step"] for r in recs["cuda"]] == [1, 2, 2]
    for c, g in zip(recs["cpu"], recs["cuda"]):
        assert set(c) == set(g) and c["step"] == g["step"]
        for k, v in c.items():
            if k.startswith("train/") and k.endswith(("_loss", "rwd")):
                np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=k)
    assert "val/combined" in recs["cuda"][-1]


@pytest.mark.cuda
def test_enet_cuda_matches_cpu(card):
    """ENet's eval forward (both layouts) and one ``train_enet`` step on
    cuda against cpu (``checks.enet_cuda_vs_cpu``, which ``chip_smoke.py``'s
    ``enet_parity`` also runs)."""
    from d3net_tpu_torch.checks import enet_cuda_vs_cpu

    res = enet_cuda_vs_cpu()
    assert res["ok"], res


@pytest.mark.cuda
def test_scan_trainer_cuda_matches_cpu(card, tmp_path, monkeypatch):
    """Two dispatches of 2 steps of the scan trainer on cuda against the
    same on cpu, the same fixed cluster jitter and proposal shuffle in
    every step (the two devices' generators draw different streams):
    train and val records within rtol 1e-4, ``gather_rows`` launched on
    cuda in every dispatch."""
    import json

    from d3net_tpu_torch.train import loop

    cfg = _tiny_run_cfg(tmp_path)
    cfg.tpu.steps_per_dispatch = 2
    cfg.tpu.augment_variants = 2
    rng = np.random.default_rng(11)
    jitter = rng.random((cfg.data.batch_size, 2 * cfg.tpu.clusters_per_pass,
                         3)).astype(np.float32)
    perm = rng.permutation(cfg.model.max_num_proposal)
    real = loop.detector_train_step

    def step(state, batch, generator=None, **kw):
        dev = batch["point_mask"].device
        b = batch["point_mask"].shape[0]
        return real(state, batch, jitter_u=torch.from_numpy(jitter).to(dev),
                    proposal_perm=torch.from_numpy(perm).long()[None].expand(
                        b, -1).to(dev), **kw)

    monkeypatch.setattr(loop, "detector_train_step", step)
    recs, launches = {}, []
    for dev in ("cpu", "cuda"):
        run = str(tmp_path / dev)
        loop.run_detector_training_scan(
            cfg, run, max_steps=4, device=dev,
            on_dispatch=lambda r: launches.append(gather.gather_rows.launches))
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs[dev] = [json.loads(line) for line in f if line.strip()]
    assert launches[0] == launches[1] < launches[2] < launches[3]
    assert [r["step"] for r in recs["cuda"]] == [2, 2, 4, 4]
    for c, g in zip(recs["cpu"], recs["cuda"]):
        assert set(c) == set(g) and c["step"] == g["step"]
        for k, v in c.items():
            if k.endswith(("_loss", "gt_iou_mean")):
                np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_compute_multiview_features_cuda_matches_cpu(card, tmp_path):
    """``compute_multiview_features`` on two small synthetic scenes with the
    committed ENet weights, ENet on cuda against ENet on cpu: the same
    scenes and seen masks, features within rtol 1e-4 / atol 1e-5."""
    from d3net_tpu_torch.data.multiview import read_multiview_store
    from d3net_tpu_torch.scripts import compute_multiview_features as cmf

    args = ["--synthetic", "2", "--width", "80", "--height", "64",
            "--weights", os.path.join(ROOT, "outputs", "enet",
                                      "enet_weights.pkl")]
    cpu = cmf.main(args + ["--cpu", "--output", str(tmp_path / "cpu.hdf5")])
    gpu = cmf.main(args + ["--output", str(tmp_path / "cuda.hdf5")])
    assert sorted(cpu) == sorted(gpu) and len(cpu) == 2
    for scene_id in cpu:
        want = read_multiview_store(str(tmp_path / "cpu.mvstore"), scene_id)
        got = read_multiview_store(str(tmp_path / "cuda.mvstore"), scene_id)
        np.testing.assert_array_equal(np.any(got != 0, 1),
                                      np.any(want != 0, 1))
        assert gpu[scene_id]["seen"] == cpu[scene_id]["seen"] > 0.2
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_tools_cuda_matches_cpu(card, tmp_path):
    """``benchmark_captioning`` and ``benchmark_grounding`` on one tiny
    joint run dir (seeded weights), and ``port_enet_weights``' selftest,
    on cuda against cpu: captions, classes and ids equal, boxes, scores
    and the selftest forward within rtol 1e-4 / atol 1e-5, ``gather_rows``
    launched on cuda only (``checks.tools_cuda_vs_cpu``, which
    ``chip_smoke.py``'s ``tools_parity`` also runs)."""
    from d3net_tpu_torch.checks import tools_cuda_vs_cpu

    res = tools_cuda_vs_cpu(os.path.join(ROOT, "conf", "debug",
                                         "tiny_joint.yaml"), str(tmp_path))
    assert res["ok"], res
    assert res["caption_entries"] > 0 and res["grounding_entries"] > 0


@pytest.mark.cuda
def test_world1_nccl_step_matches_the_step_without_a_group(card):
    """``chip_smoke.py`` phase ``dist`` (a) at tests/test_parallel.py's
    widths: the detector step through a one-rank NCCL group against the
    step with no group (``checks.world1_group_step``), every gather
    exact."""
    from d3net_tpu_torch import checks

    case = checks.detector_dp_case(2)
    res = checks.world1_group_step(case["variables"], case["cfg"],
                                   batch_to_torch(case["batch"], "cuda"))
    assert res["ok"], res["compare"]
    assert res["launches"] == res["checked"] > 0
    assert res["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_world1(card):
    """``chip_smoke.py`` phase ``dist`` (b): two gloo ranks on cuda:0
    against world size 1 on the card at conf/debug/ widths: the detector
    step with and without clustering, the mode-3 joint step and
    ``MaskedBatchNorm`` in bf16 (``checks.dist_ranks_on_one_card``)."""
    from d3net_tpu_torch import checks
    from d3net_tpu_torch.scripts.train import load_task_config
    from d3net_tpu_torch.train import loop, pipeline

    cfg = load_task_config(os.path.join(ROOT, "conf", "debug",
                                        "tiny_pointgroup.yaml"))
    train_it, _ = loop.make_dataloaders(cfg, loop.spec_from_cfg(cfg))
    det = checks.detector_case(loop.detector_cfg_dict(cfg),
                               next(iter(train_it)))
    jcfg = checks.joint_parity_config(load_task_config(os.path.join(
        ROOT, "conf", "debug", "tiny_joint.yaml")))
    vocab, emb = pipeline.build_vocab(jcfg)
    res = checks.dist_ranks_on_one_card(
        det, jcfg, checks.joint_step_case(jcfg, vocab, emb))
    assert res["ok"], res["outside_tolerance"]
