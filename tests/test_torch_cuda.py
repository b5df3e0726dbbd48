"""Card-only checks of the port (marker ``cuda``): each kernel against its
plain version, the detector on cuda against the detector on cpu, and the
sparse conv's backward on cuda against the same on cpu.

This file imports no JAX, so it also runs on a machine that has only
PyTorch: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest`` skips the JAX setup of tests/conftest.py). Without a
card every test skips.
"""

import numpy as np
import pytest
import torch

from d3net_tpu_torch import device, params
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.kernels import gather, probe
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.ops.sparse_conv import sparse_conv_t

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
