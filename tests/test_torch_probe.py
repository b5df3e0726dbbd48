"""The probe kernels' plain versions (``d3net_tpu_torch/kernels/probe.py``)
against the Pallas TPU kernels they port, run in interpret mode on the CPU:
``probe_smoke`` and ``_band_gather_pallas`` of ``scripts/pallas_probe.py``
and ``_band_gather_impl`` of ``d3net_tpu/ops/pallas_gather.py`` (the body
of ``probe_prefetch.f``). A gather does no arithmetic: all exact. Also the
probe entry point: it runs with ``--device cpu`` and refuses to run
without a card otherwise."""

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
from d3net_tpu_torch.kernels import probe

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
@pytest.mark.parametrize("nchunk", [1, 5])
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


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_prefetch_matches_band_gather_impl(dtype):
    """Hand-made bases and rel, with rel outside the window (zero rows)."""
    n_src, chunk, wblk, nwin, c = 2048, 256, 128, 4, 16
    n = 4 * chunk
    rng = np.random.default_rng(3)
    src = rng.standard_normal((n_src, c)).astype(np.float32)
    bases = np.array([0, 3, 7, n_src // wblk - nwin], np.int32)
    rel = rng.integers(-10, nwin * wblk + 10, n).astype(np.int32)
    rel[:3] = [-1, nwin * wblk, nwin * wblk - 1]
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
    assert out_of_window.sum() >= 3 and (want[out_of_window] == 0).all()


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


def test_probe_band_and_prefetch_on_cpu():
    dev = torch.device("cpu")
    for res in probe_cli.run(["band", "prefetch", "gather"], dev, n=4096,
                             c=16, ch=512):
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
