"""The whole detector forward (train=False) against d3net_tpu's PointGroup
on the CPU at the tests/test_detector.py config, weights through the
converter. Integers must be equal; floats within rtol 1e-4 / atol 1e-5 (f32
on both sides; XLA and ATen sum in different orders through ~40 layers).
test_torch_pointgroup_stages.py pins each stage on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.data.collate import BatchSpec as JaxBatchSpec
from d3net_tpu.data.collate import build_batch as jax_build_batch
from d3net_tpu.models.pointgroup import PointGroup as JaxPointGroup
from d3net_tpu_torch import params
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.kernels import gather
from d3net_tpu_torch.models.pointgroup import PointGroup

CFG = dict(m=8, blocks=(1, 2, 3), cluster_blocks=(1, 2), clusters_per_pass=16,
           max_num_proposal=8, cluster_npoint_thre=30, test_npoint_thresh=30,
           test_score_thresh=0.0, cluster_ring=1, cluster_cell_size=0.03,
           cluster_prop_iters=4)
SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
             floor_points=1000, room=4.0)
SPEC = dict(max_points=3072, voxel_caps=[3072, 1536, 768], max_instances=8,
            use_multiview=False, use_normal=True)
RTOL, ATOL = 1e-4, 1e-5

INT_KEYS = ["member_pt", "cluster_mask_all", "proposal_slot",
            "proposal_sem_cls_batched", "object_assignment"]
FLOAT_KEYS = ["semantic_scores", "pt_offsets", "pt_feats",
              "proposal_scores_all", "cluster_npoint", "cluster_center",
              "cluster_size", "proposal_batch_mask", "proposal_feats_batched",
              "proposal_center_batched", "proposal_size_batched",
              "proposal_bbox_batched", "proposal_scores_batched"]


def _randomize(tree, rng):
    for k, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif k in ("bias", "mean"):
            tree[k] = rng.normal(0.0, 0.1, val.shape).astype(np.float32)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)


def _setup(cfg):
    scenes = [make_scene(seed=i, **SCENE) for i in range(2)]
    batch_np = build_batch(scenes, BatchSpec(**SPEC))
    jbatch = jax.tree.map(jnp.asarray,
                          jax_build_batch(scenes, JaxBatchSpec(**SPEC)))
    in_ch = batch_np["point_feats"].shape[-1] + 3
    variables = params.init_flax_variables(PointGroup(in_ch, **cfg), seed=0)
    _randomize(variables, np.random.default_rng(0))
    jvars = jax.tree.map(jnp.asarray, variables)
    jmodel = JaxPointGroup(**cfg)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(jvars, jbatch)
    model = params.load_detector(variables, cfg, device="cpu")
    gather.gather_rows.launches = 0
    with torch.no_grad():
        got = model(batch_to_torch(batch_np, "cpu"))
    assert gather.gather_rows.launches == 0       # CPU: plain path only
    return dict(jmodel=jmodel, jvars=jvars, jbatch=jbatch, model=model,
                batch=batch_to_torch(batch_np, "cpu"),
                want=jax.tree.map(np.asarray, want),
                got={k: v.numpy() for k, v in got.items()})


@pytest.fixture(scope="module")
def run():
    return _setup(CFG)


def test_same_outputs(run):
    assert set(run["got"]) == set(run["want"])
    for k, w in run["want"].items():
        assert run["got"][k].shape == w.shape, k
        assert run["got"][k].dtype == w.dtype, k
    # the comparison is not vacuous: both passes found clusters
    assert run["want"]["cluster_mask_all"].sum() >= 4
    assert run["want"]["proposal_batch_mask"].sum() >= 4


@pytest.mark.parametrize("key", INT_KEYS)
def test_integer_outputs_equal(run, key):
    np.testing.assert_array_equal(run["got"][key], run["want"][key])


@pytest.mark.parametrize("key", FLOAT_KEYS)
def test_float_outputs_close(run, key):
    np.testing.assert_allclose(run["got"][key], run["want"][key], rtol=RTOL,
                               atol=ATOL)


def test_requires_gt_mask_branch():
    cfg = dict(CFG, requires_gt_mask=True)
    r = _setup(cfg)
    for k in INT_KEYS:
        np.testing.assert_array_equal(r["got"][k], r["want"][k], err_msg=k)
    for k in ("proposal_scores_all", "proposal_feats_batched",
              "proposal_center_batched"):
        np.testing.assert_allclose(r["got"][k], r["want"][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_bf16_compute_dtype_casts_like_jax(run):
    """bf16 backbone/ScoreNet, f32 heads and geometry (CPU, dtypes only:
    bf16 rounds at different places in XLA and ATen)."""
    model = run["model"]
    model.compute_dtype = "bfloat16"
    try:
        with torch.no_grad():
            out = model(run["batch"])
    finally:
        model.compute_dtype = None
    assert out["pt_feats"].dtype == torch.bfloat16
    for k in ("semantic_scores", "pt_offsets", "proposal_scores_all",
              "proposal_feats_batched", "cluster_center"):
        assert out[k].dtype == torch.float32, k
        assert torch.isfinite(out[k]).all(), k
