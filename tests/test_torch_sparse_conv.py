"""Sparse conv, MaskedBatchNorm and a 3-level UBlock (gather mode) against
d3net_tpu, f32 on the CPU. Tolerance: rtol 1e-5 per op; the U-Net stacks
~30 convs and BNs, so rtol 1e-4 / atol 1e-5 through the whole block
(summation order differs between XLA and ATen)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.data.collate import BatchSpec, build_batch
from d3net_tpu.data.synthetic import make_scene
from d3net_tpu.models import blocks as jblocks
from d3net_tpu.ops.sparse_conv import sparse_conv as jax_sparse_conv
from d3net_tpu_torch import params
from d3net_tpu_torch.models import blocks
from d3net_tpu_torch.ops.sparse_conv import sparse_conv


@pytest.fixture(scope="module")
def batch():
    scenes = [make_scene(seed=i, num_instances=3, density=3000.0,
                         size_range=(0.25, 0.5), floor_points=1000, room=4.0)
              for i in range(2)]
    spec = BatchSpec(max_points=3072, voxel_caps=[3072, 1536, 768],
                     max_instances=8, use_multiview=False, use_normal=True)
    return build_batch(scenes, spec)


def _torch_tables(b):
    return [{k: torch.from_numpy(v) for k, v in t.items()} for t in b["tables"]]


@pytest.mark.parametrize("table,k", [("nbr", 27), ("down", 8), ("up", 8)])
def test_sparse_conv_matches_jax(batch, table, k):
    rng = np.random.default_rng(k)
    t0, t1 = batch["tables"][0], batch["tables"][1]
    nbr = t0[table][0]
    m_in = (t1 if table == "up" else t0)["mask"].shape[1]
    feats = rng.standard_normal((m_in, 5)).astype(np.float32)
    w = rng.standard_normal((k, 5, 7)).astype(np.float32)
    want = np.asarray(jax_sparse_conv(jnp.asarray(feats), jnp.asarray(nbr),
                                      jnp.asarray(w)))
    got = sparse_conv(torch.from_numpy(feats), torch.from_numpy(nbr),
                      torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_folded_batch_conv_matches_vmapped(batch):
    """fold_tables: one flat gather over the batch == the per-scene vmap."""
    rng = np.random.default_rng(1)
    t = batch["tables"]
    b, m = t[0]["mask"].shape
    feats = rng.standard_normal((b, m, 4)).astype(np.float32)
    w = rng.standard_normal((27, 4, 6)).astype(np.float32)
    want = np.asarray(jblocks._batched_conv(
        jnp.asarray(feats), jnp.asarray(t[0]["nbr"]), jnp.asarray(t[0]["nbr"]),
        jnp.asarray(w), True))
    folded = blocks.fold_tables(_torch_tables(batch))
    conv = blocks.SubmConv(4, 6)
    conv.kernel.data = torch.from_numpy(w)
    got = conv(torch.from_numpy(feats), folded[0]["nbr"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    # sentinel bookkeeping: INVALID of every level/table -> its global B*M
    for li, ft in enumerate(folded):
        m_l = t[li]["mask"].shape[1]
        assert int(ft["nbr"].max()) == b * m_l
        if "down" in ft:
            assert int(ft["up"].max()) == b * t[li + 1]["mask"].shape[1]


@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm_matches_jax(train):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 50, 6)).astype(np.float32) * 3 + 1
    mask = (rng.random((2, 50)) < 0.7).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                    "bias": rng.normal(0, 0.1, 6).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    jv = jax.tree.map(jnp.asarray, v)
    jbn = jblocks.MaskedBatchNorm()
    want, state = jbn.apply(jv, jnp.asarray(x), jnp.asarray(mask), train,
                            mutable=["batch_stats"])
    bn = blocks.MaskedBatchNorm(6)
    bn.load_state_dict(params.flax_to_state_dict(v, bn))
    got = bn(torch.from_numpy(x), torch.from_numpy(mask), train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(state["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(state["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-5)


def _randomize(tree, rng):
    for k, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif k in ("bias", "mean"):
            tree[k] = rng.normal(0.0, 0.1, val.shape).astype(np.float32)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)


@pytest.mark.parametrize("residual", [True, False])
def test_ublock_three_levels_matches_jax(batch, residual):
    planes = (8, 16, 24)
    rng = np.random.default_rng(3)
    t = batch["tables"]
    b, m = t[0]["mask"].shape
    x = rng.standard_normal((b, m, 8)).astype(np.float32) \
        * t[0]["mask"][..., None]
    port = blocks.UBlock(planes, 2, residual)
    variables = params.init_flax_variables(port, seed=4)
    _randomize(variables, rng)
    port.load_state_dict(params.flax_to_state_dict(variables, port))
    jtables = [jax.tree.map(jnp.asarray, tt) for tt in t]
    jmod = jblocks.UBlock(planes, 2, residual)
    want = jax.jit(lambda v, x: jmod.apply(v, x, jtables, False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), blocks.fold_tables(_torch_tables(batch)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
