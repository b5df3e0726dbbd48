"""The probe kernels' plain versions (``d3net_tpu_torch/kernels/probe.py``)
against the Pallas TPU kernels they port, run in interpret mode on the CPU:
``probe_smoke`` and ``_band_gather_pallas`` of ``scripts/pallas_probe.py``
and ``_band_gather_impl`` of ``d3net_tpu/ops/pallas_gather.py`` (the body
of ``probe_prefetch.f``). A gather does no arithmetic: all exact. Also the
ring kernel's plan (``window3_ring_plan``, which the card's launch takes
as it is) and the probe entry point: it runs with ``--device cpu`` and
refuses to run without a card otherwise, and its device times raise
without a card."""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.ops import pallas_gather as pg
from d3net_tpu_torch import probe as probe_cli
from d3net_tpu_torch.kernels import launch, probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tpu_probe():
    spec = importlib.util.spec_from_file_location(
        "pallas_probe", os.path.join(ROOT, "scripts", "pallas_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale2_matches_probe_smoke(tpu_probe):
    assert tpu_probe.probe_smoke(True)          # o = 2 * ones, interpret
    x = torch.ones((256, 128), dtype=torch.bfloat16)
    assert bool((probe.probe_scale2(x) == 2.0).all())
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(1000) * 1e3).astype(np.float32)
    xb = torch.from_numpy(v).bfloat16()
    want = (np.asarray(jnp.asarray(xb.float().numpy(), jnp.bfloat16)) * 2)
    np.testing.assert_array_equal(probe.probe_scale2(xb).float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("nchunk", [1, 2, 3, 5])
def test_window3_matches_band_gather_pallas(tpu_probe, dtype, nchunk):
    """Out-of-band indices read zero rows; below 0 in the first chunk and
    past the end in the last one read the repeated edge block, as the TPU
    kernel's clamped window does."""
    ch, c = 128, 32
    n = ch * nchunk
    rng = np.random.default_rng(nchunk)
    src = rng.standard_normal((n, c)).astype(np.float32)
    idx = rng.integers(-ch - 3, n + ch + 3, n).astype(np.int32)
    idx[:4] = [-1, -ch, 0, n - 1]                # first chunk's edges
    idx[-4:] = [n, n + ch - 1, -5, 2 * n]        # last chunk's edges
    jsrc = jnp.asarray(src, dtype)
    want = np.asarray(tpu_probe._band_gather_pallas(
        jsrc, jnp.asarray(idx), ch, interpret=True)).astype(np.float32)
    tsrc = torch.from_numpy(np.asarray(jsrc).astype(np.float32))
    if dtype is jnp.bfloat16:
        tsrc = tsrc.bfloat16()
    got = probe.window3_gather(tsrc, torch.from_numpy(idx), ch)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the comparison covers zero rows and edge aliases, not only the band
    j = np.arange(n) // ch
    rel = idx - (j - 1) * ch
    assert ((rel < 0) | (rel >= 3 * ch)).any()
    assert (want[(rel < 0) | (rel >= 3 * ch)] == 0).all()


@pytest.mark.parametrize("n,ch,row_bytes", [
    (262144, 512, 256),        # the probe's size
    (512 * 7, 512, 1024), (128, 128, 128), (128 * 300, 128, 512),
    (300 * 7, 300, 256), (257 * 3, 257, 48), (5, 1, 16), (3000 * 2, 3000, 16),
])
@pytest.mark.parametrize("sms", [132, 3])
def test_window3_ring_plan(n, ch, row_bytes, sms):
    """Four slots of a chunk in one block's shared memory, S a 16-byte
    multiple (a power of two) that divides the row, every chunk in exactly
    one run, the blocks in one wave of ``sms`` SMs."""
    plan = probe.window3_ring_plan(n, ch, row_bytes, sms)
    s, run, nchunk = plan.slice_bytes, plan.run_chunks, n // ch
    assert probe.RING_SLOTS == 4
    assert s in (16, 32, 64, 128, 256) and row_bytes % s == 0
    assert plan.slices == row_bytes // s
    assert plan.box_rows % 8 == 0 and plan.box_rows <= 256
    assert plan.nbox * plan.box_rows >= ch
    slot = plan.nbox * plan.box_rows * s
    assert plan.smem_bytes == 4 * slot + 8 * ch + 32 <= probe.SMEM_MAX
    chunks = [c for r in range(plan.runs)
              for c in range(r * run, min((r + 1) * run, nchunk))]
    assert chunks == list(range(nchunk))          # each chunk once, in order
    assert (plan.runs - 1) * run < nchunk         # no empty run
    assert plan.blocks == plan.slices * plan.runs
    assert plan.blocks <= max(sms * plan.blocks_per_sm, plan.slices)
    # each run reads its chunks and one neighbour on each side, at most
    out = n * row_bytes
    assert out * 2 <= plan.moved_bytes - plan.slices * 4 * n
    assert plan.moved_bytes - plan.slices * 4 * n <= out + (
        nchunk + 2 * plan.runs) * plan.nbox * plan.box_rows * row_bytes


def test_window3_ring_plan_at_the_probes_size():
    """n=262144 bf16 rows of 128 channels, ch=512: 64-byte slices, runs of
    16 chunks, 4 x 32 = 128 blocks in one wave of the 132 SMs, one block
    per SM. Runs 1-30 read 18 chunks, the two edge runs 17: with 4 reads of
    the index and the output, the blocks move 146,538,496 bytes."""
    plan = probe.window3_ring_plan(262144, 512, 256)
    assert (plan.slice_bytes, plan.run_chunks, plan.blocks,
            plan.blocks_per_sm) == (64, 16, 128, 1)
    assert plan.smem_bytes == 4 * 512 * 64 + 2 * 512 * 4 + 32
    assert plan.moved_bytes == 146538496 == (30 * 18 + 2 * 17) * 512 * 256 \
        + 4 * 4 * 262144 + 262144 * 256


def test_window3_ring_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared"):
        probe.window3_ring_plan(4000 * 2, 4000, 16)
    with pytest.raises(ValueError):
        probe.window3_ring_plan(1000, 512, 256)   # n % ch != 0


@pytest.mark.parametrize("dtype,case", [
    (np.float32, "hand"), (jnp.bfloat16, "hand"),
    (np.float32, "banded"), (jnp.bfloat16, "banded")],
    ids=["float32", "bfloat16", "banded-float32", "banded-bfloat16"])
def test_prefetch_matches_band_gather_impl(dtype, case):
    """Hand-made bases and rel, with rel outside the window (zero rows);
    and the probe's banded data (``prefetch_case``) at a small size."""
    if case == "hand":
        n_src, chunk, wblk, nwin, c = 2048, 256, 128, 4, 16
        n = 4 * chunk
        rng = np.random.default_rng(3)
        src = rng.standard_normal((n_src, c)).astype(np.float32)
        bases = np.array([0, 3, 7, n_src // wblk - nwin], np.int32)
        rel = rng.integers(-10, nwin * wblk + 10, n).astype(np.int32)
        rel[:3] = [-1, nwin * wblk, nwin * wblk - 1]
    else:
        chunk, wblk, nwin, c = 512, 128, 6, 16
        src, _, bases, rel = probe_cli.prefetch_case(4096, c, chunk, wblk,
                                                     nwin)
    jsrc = jnp.asarray(src, dtype)
    want = np.asarray(pg._band_gather_impl(
        jsrc, jnp.asarray(bases), jnp.asarray(rel[None]), chunk=chunk,
        wblk=wblk, nwin=nwin, interpret=True)).astype(np.float32)
    tsrc = torch.from_numpy(np.asarray(jsrc).astype(np.float32))
    if dtype is jnp.bfloat16:
        tsrc = tsrc.bfloat16()
    got = probe.prefetch_window_gather(
        tsrc, torch.from_numpy(rel), torch.from_numpy(bases),
        chunk=chunk, wblk=wblk, nwin=nwin)
    np.testing.assert_array_equal(got.float().numpy(), want)
    out_of_window = (rel < 0) | (rel >= nwin * wblk)
    if case == "hand":
        assert out_of_window.sum() >= 3 and (want[out_of_window] == 0).all()
    else:                               # every row in its window, none zero
        assert not out_of_window.any() and (want != 0).any(1).all()


@pytest.mark.parametrize("n,chunk,wblk,nwin,row_bytes", [
    (262144, 512, 128, 6, 256),         # the probe's size
    (512 * 9, 512, 128, 8, 1024), (512 * 9, 512, 256, 2, 1024),
    (4096, 512, 64, 4, 128), (1000, 300, 64, 3, 128),
    (4096 - 37, 512, 256, 5, 16), (200 * 13 - 37, 200, 100, 3, 48),
    (300 * 13, 300, 384, 2, 512), (1, 1, 128, 7, 16),
])
@pytest.mark.parametrize("sms", [132, 3])
def test_prefetch_ring_plan(n, chunk, wblk, nwin, row_bytes, sms):
    """R = nwin + ceil(chunk / wblk) slots of whole TMA boxes, their state,
    two maps and two rel buffers in one block's shared memory; S a power
    of two that divides the row; every chunk in exactly one run, no run
    empty; the blocks in one wave of ``sms`` SMs."""
    plan = probe.prefetch_ring_plan(n, chunk, wblk, nwin, row_bytes, sms)
    s, run, nchunk = plan.slice_bytes, plan.run_chunks, -(-n // chunk)
    assert s in (16, 32, 64, 128, 256) and row_bytes % s == 0
    assert plan.slices == row_bytes // s
    assert plan.slots == nwin + -(-chunk // wblk)
    assert plan.box_rows % 8 == 0 and plan.box_rows <= 256
    assert wblk <= plan.nbox * plan.box_rows < wblk + 8 * plan.nbox
    slot = plan.nbox * plan.box_rows * s
    assert plan.smem_bytes == plan.slots * (slot + 8 + 8 + 4 + 4) \
        + 2 * 4 * nwin + 2 * 4 * chunk <= probe.SMEM_MAX
    if s < 256 and row_bytes % (2 * s) == 0:    # the widest slice that fits
        assert plan.slots * 2 * slot + plan.smem_bytes - plan.slots * slot \
            > probe.SMEM_MAX
    chunks = [c for r in range(plan.runs)
              for c in range(r * run, min((r + 1) * run, nchunk))]
    assert chunks == list(range(nchunk))          # each chunk once, in order
    assert (plan.runs - 1) * run < nchunk         # no empty run
    assert plan.blocks == plan.slices * plan.runs
    assert plan.blocks <= max(sms * plan.blocks_per_sm, plan.slices)


def test_prefetch_ring_plan_at_the_probes_size():
    """n=262144 bf16 rows of 128 channels, chunk 512, wblk 128, nwin 6:
    128-byte slices (ten 256-byte slots would take 320 KB), R = 10, runs of
    8 chunks, 2 x 64 = 128 blocks, one per SM. On the probe's bases the
    slots take 2174 copies of a 128-row block (34 a middle run, no
    deferred one): with the output and rel and bases read once per slice
    the blocks move 140,447,744 bytes."""
    plan = probe.prefetch_ring_plan(262144, 512, 128, 6, 256)
    assert (plan.slice_bytes, plan.slots, plan.run_chunks, plan.blocks,
            plan.blocks_per_sm, plan.box_rows, plan.nbox) \
        == (128, 10, 8, 128, 1, 128, 1)
    assert plan.smem_bytes == 10 * 128 * 128 + 10 * 24 + 48 + 4096 == 168224
    _, _, bases, _ = probe_cli.prefetch_case(262144, 1, 512, 128, 6)
    loads = probe.prefetch_ring_loads(bases, plan, 262144, 128, 6)
    whens = [w for window in loads for *_, w in window]
    assert whens.count("now") == 2174 and "deferred" not in whens
    assert [sum(w == "now" for *_, w in window) for window in loads[8:16]] \
        == [6, 4, 4, 4, 4, 4, 4, 4]               # a middle run: 34
    assert probe.prefetch_ring_moved_bytes(
        bases, plan, 262144, 262144, 128, 6, 256) == 140447744 \
        == (2174 * 128 + 262144) * 256 + 2 * 4 * (262144 + 512)


@pytest.mark.parametrize("chunk,wblk,nwin", [(512, 128, 6), (200, 100, 3),
                                             (300, 384, 2)])
def test_prefetch_ring_schedule(chunk, wblk, nwin):
    """The ring's slot schedule (the kernel's, replayed on the host) on
    every bases pattern, with runs of 1 to 13 chunks: block b sits in slot
    b mod R; one chunk's blocks sit in distinct slots; a slot copied while
    chunk t-1 is gathered is not one chunk t-1 reads, and one whose copy
    waits for chunk t-1 to end is; a block held is in its slot, from the
    copy that chunk's map names; blocks outside the source take no slot.
    An advance of R - nwin blocks a chunk defers no copy, one more does."""
    nchunk, step = 13, -(-chunk // wblk)
    n_src = ((nchunk - 1) * (step + 1) + nwin + 1) * wblk - 37
    pats = probe_cli.prefetch_patterns(nchunk, chunk, wblk, nwin, n_src)
    for sms in (132, 12, 4, 1):
        plan = probe.prefetch_ring_plan(nchunk * chunk, chunk, wblk, nwin,
                                        256, sms)
        r = plan.slots
        for name, bases in pats.items():
            loads = probe.prefetch_ring_loads(bases, plan, n_src, wblk, nwin)
            assert len(loads) == nchunk
            held = {}                            # slot -> (block, fill)
            for j, window in enumerate(loads):
                if j % plan.run_chunks == 0:
                    held, before = {}, set()     # a new run: empty slots
                assert [b for b, *_ in window] == list(
                    range(bases[j], bases[j] + nwin))
                slots = [s for _, s, _, w in window if w != "zeros"]
                assert len(set(slots)) == len(slots)
                for b, s, fill, when in window:
                    outside = b * wblk + wblk <= 0 or b * wblk >= n_src
                    assert (when == "zeros") == outside, (name, j, b)
                    if outside:
                        continue
                    assert s == b % r
                    if when == "held":
                        assert held[s] == (b, fill), (name, j, b)
                    else:
                        assert (s in before) == (when == "deferred")
                        assert fill == held.get(s, (None, -1))[1] + 1
                        held[s] = (b, fill)
                before = set(slots)
            whens = {w for window in loads for *_, w in window}
            if name in ("banded", "advance_max", "constant"):
                assert "deferred" not in whens, name
            if name == "advance_over" and plan.run_chunks > 1:
                assert "deferred" in whens


def test_prefetch_refuses_what_the_ring_cannot_take():
    """The plan's refusal (nine 4096-row slots of 16 bytes pass 227 KB),
    on the CPU too, and TMA's int32 row coordinates."""
    with pytest.raises(ValueError, match="shared"):
        probe.prefetch_ring_plan(4096, 512, 4096, 8, 16)
    with pytest.raises(ValueError):
        probe.prefetch_ring_plan(4096, 0, 128, 6, 256)
    src = torch.zeros(4096, 4)
    rel = torch.zeros(1024, dtype=torch.int32)
    bases = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared"):
        probe.prefetch_window_gather(src, rel, bases, chunk=512, wblk=4096,
                                     nwin=8)
    with pytest.raises(ValueError, match="positive"):
        probe.prefetch_window_gather(src, rel, bases, chunk=512, wblk=0,
                                     nwin=8)
    big = torch.empty((2**31, 4), device="meta")
    with pytest.raises(ValueError, match="source rows"):
        probe.prefetch_window_gather(big, rel, bases, chunk=512, wblk=128,
                                     nwin=6)


def test_probe_data_matches_the_tpu_probe(tpu_probe):
    """The probe's cases are the TPU probe's own construction."""
    np.testing.assert_array_equal(probe_cli.make_banded_indices(4096),
                                  tpu_probe.make_banded_indices(4096, 512))
    src, idx = probe_cli.band_case(4096, 8, 512)
    j = np.arange(4096) // 512
    rel = idx - (j - 1) * 512
    assert ((rel >= 0) & (rel < 3 * 512)).all() and src.shape == (4096, 8)
    src, idx, bases, rel = probe_cli.prefetch_case(4096, 8, 512, 128, 6)
    np.testing.assert_array_equal(
        np.repeat(bases, 512) * 128 + rel, idx)


def test_device_ms_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a machine without")
    with pytest.raises(RuntimeError, match="CUDA card"):
        probe_cli.device_ms(lambda: None)


def test_launch_passes_the_stream_last_and_raises_on_an_error(monkeypatch):
    """The one launch path: the current stream of the tensors' device goes
    last, and a non-zero return of the C side raises."""
    monkeypatch.setattr(launch, "_current_device", lambda: 0)
    monkeypatch.setattr(launch, "current_stream", lambda index: 1000 + index)
    calls = []
    launch.launch("k", lambda *a: calls.append(a) or 0, 0, 7, 8)
    assert calls == [(7, 8, 1000)]
    with pytest.raises(RuntimeError, match="k kernel launch failed: CUDA "
                                           "error 700"):
        launch.launch("k", lambda *a: 700, 0, 7)


def test_probe_band_and_prefetch_on_cpu():
    dev = torch.device("cpu")
    for res in probe_cli.run(["band", "prefetch", "gather", "launch"], dev,
                             n=4096, c=16, ch=512):
        assert res.get("max_abs_err", 0.0) == 0.0 and "ms" not in res


def _run(args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "d3net_tpu_torch.probe",
                           *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=120)


def test_probe_cli_runs_on_cpu_when_asked():
    out = _run(["--device", "cpu", "--what", "smoke"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert '"device": "cpu"' in lines[0]
    assert '"probe": "smoke", "ok": true' in lines[1]


def test_probe_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a machine without")
    out = _run(["--what", "smoke"])
    assert out.returncode != 0
    assert "CUDA" in out.stderr and '"probe"' not in out.stdout
