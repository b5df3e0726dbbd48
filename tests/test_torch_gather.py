"""gather_rows / band_gather: the plain path against the JAX Pallas
band_gather (interpret mode) and segment.gather_padded, and CPU dispatch.
The kernel itself is checked on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.ops import pallas_gather as pg
from d3net_tpu.ops import segment as jseg
from d3net_tpu_torch.kernels import gather
from d3net_tpu_torch.ops import segment


def _banded_idx(rng, n, spread):
    base = np.arange(n)
    idx = base + rng.integers(-spread, spread + 1, size=n)
    return np.clip(idx, 0, n - 1).astype(np.int32)


@pytest.fixture
def launches():
    gather.gather_rows.launches = 0
    yield
    assert gather.gather_rows.launches == 0   # CPU tensors never launch


@pytest.mark.parametrize("c", [128, 256])
def test_band_gather_matches_pallas(c, launches):
    rng = np.random.default_rng(0)
    n = 4096
    idx = _banded_idx(rng, n, spread=150)
    plan = pg.plan_band_windows(idx, n, chunk=512, wblk=128, nwin=8)
    tplan = gather.plan_band_windows(idx, n, chunk=512, wblk=128, nwin=8)
    assert tplan is not None
    for a, b in zip(tplan, plan):
        assert np.array_equal(a, b)
    src = rng.standard_normal((n, c)).astype(np.float32)
    want = np.asarray(pg.band_gather(jnp.asarray(src, jnp.bfloat16), plan,
                                     interpret=True).astype(jnp.float32))
    got = gather.band_gather(torch.from_numpy(src).to(torch.bfloat16), tplan)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


def test_band_gather_repeated_and_clamped_rows(launches):
    rng = np.random.default_rng(1)
    n = 2048
    idx = _banded_idx(rng, n, spread=40)
    idx[:64] = 0
    idx[100:110] = idx[99]
    plan = pg.plan_band_windows(idx, n, chunk=256, wblk=128, nwin=4)
    tplan = gather.plan_band_windows(idx, n, chunk=256, wblk=128, nwin=4)
    src = rng.standard_normal((n, 128)).astype(np.float32)
    want = np.asarray(pg.band_gather(jnp.asarray(src), plan, interpret=True))
    got = gather.band_gather(torch.from_numpy(src), tplan).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, src[idx])


def test_plan_rejections_match():
    rng = np.random.default_rng(2)
    n = 4096
    idx = _banded_idx(rng, n, spread=100)
    idx[7] = n - 1
    assert gather.plan_band_windows(idx, n, chunk=512, wblk=128, nwin=6) is None
    assert gather.plan_band_windows(np.zeros(1000, np.int32), 4096) is None
    assert gather.plan_band_windows(np.zeros(512, np.int32), 500) is None


@pytest.mark.parametrize("dtype,c", [
    (torch.float32, 3), (torch.float32, 134), (torch.bfloat16, 16),
    (torch.bfloat16, 112), (torch.int32, 2),
])
def test_gather_rows_equals_gather_padded(dtype, c, launches):
    rng = np.random.default_rng(c)
    m, n = 300, 1000
    src = rng.integers(-50, 50, size=(m, c)).astype(np.float32)
    idx = rng.integers(0, m + 1, size=n).astype(np.int32)
    idx[::7] = m                           # INVALID sentinel reads zeros
    want = np.asarray(jseg.gather_padded(jnp.asarray(src), jnp.asarray(idx)))
    tsrc = torch.from_numpy(src).to(dtype)
    got = segment.gather_padded(tsrc, torch.from_numpy(idx))
    assert got.dtype == dtype and got.shape == (n, c)
    assert np.array_equal(got.float().numpy(), want)
    assert (got[torch.from_numpy(idx) == m] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_gather_rows_out_of_range_reads_zero_rows(dtype, launches):
    # one contract with the kernel: every index outside [0, n_src) reads a
    # zero row, the sentinel n_src among them; no wrap, no IndexError
    src = torch.arange(1, 13, dtype=torch.float32).reshape(4, 3).to(dtype)
    idx = torch.tensor([0, -1, 3, 4, 5, -4, 1000, 2], dtype=torch.int32)
    got = gather.gather_rows(src, idx)
    want = torch.zeros(8, 3, dtype=dtype)
    for r, j in enumerate(idx.tolist()):
        if 0 <= j < 4:
            want[r] = src[j]
    assert torch.equal(got, want)


def test_gather_padded_batched_folds_scenes(launches):
    rng = np.random.default_rng(5)
    b, m, n, c = 3, 40, 70, 5
    feats = rng.standard_normal((b, m, c)).astype(np.float32)
    idx = rng.integers(0, m + 1, size=(b, n)).astype(np.int32)
    want = np.stack([np.asarray(jseg.gather_padded(jnp.asarray(feats[i]),
                                                   jnp.asarray(idx[i])))
                     for i in range(b)])
    got = segment.gather_padded_batched(torch.from_numpy(feats),
                                        torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), want)


def test_gather_rows_rejects_bad_inputs():
    src = torch.zeros(4, 3)
    with pytest.raises(TypeError):
        gather.gather_rows(src, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        gather.gather_rows(src.double(), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros(4, 3, 2),
                           torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros(3, 4).t(),
                           torch.zeros(2, dtype=torch.int32))


def test_kernel_module_imports_without_nvcc_or_cuda():
    code = (
        "import sys, torch\n"
        "from d3net_tpu_torch.kernels import gather, build\n"
        "assert 'triton' not in sys.modules\n"
        "assert gather._lib is None\n"
        "print(torch.cuda.is_available())\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
