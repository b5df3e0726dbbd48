"""Card-only checks of the port (marker ``cuda``): each kernel against its
plain version, and the detector on cuda against the detector on cpu.

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
from d3net_tpu_torch.kernels import gather
from d3net_tpu_torch.models.pointgroup import PointGroup

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
