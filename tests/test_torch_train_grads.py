"""Gradients of the port's differentiable pieces against JAX's VJPs on the
CPU, f32: ``sparse_conv_t`` (dx through the transpose table, dW
re-gathering the inputs), ``gather_rows``'s backward (a scatter-add that
drops the sentinel) and ``MaskedBatchNorm(train=True)``.

Tolerances: ``sparse_conv_t`` rtol 1e-5 / atol 1e-6 (one gather-matmul
summed in another order); the gather's backward exact (the same adds in
the same order); BN rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.data.collate import BatchSpec, build_batch
from d3net_tpu.data.synthetic import make_scene
from d3net_tpu.models import blocks as jblocks
from d3net_tpu.ops import segment as jseg
from d3net_tpu.ops.sparse_conv import sparse_conv_t as jax_sparse_conv_t
from d3net_tpu_torch import params
from d3net_tpu_torch.kernels import gather
from d3net_tpu_torch.models import blocks
from d3net_tpu_torch.ops.sparse_conv import sparse_conv_t


@pytest.fixture(scope="module")
def tables():
    scenes = [make_scene(seed=i, num_instances=3, density=3000.0,
                         size_range=(0.25, 0.5), floor_points=1000, room=4.0)
              for i in range(1)]
    spec = BatchSpec(max_points=3072, voxel_caps=[3072, 1536, 768],
                     max_instances=8, use_multiview=False, use_normal=True)
    t = build_batch(scenes, spec)["tables"]
    return [{k: v[0] for k, v in lvl.items()} for lvl in t]


# (table, transpose table, flip, input level): the submanifold table is its
# own transpose under the mirror; down and up are each other's transpose
CONVS = {
    "subm": ("nbr", "nbr", True, 0),
    "proj1x1": ("nbr13", "nbr13", True, 0),
    "down": ("down", "up", False, 0),
    "up": ("up", "down", False, 1),
}


@pytest.mark.parametrize("conv", list(CONVS))
def test_sparse_conv_t_vjp_matches_jax(tables, conv):
    name, name_t, flip, lvl = CONVS[conv]
    t0 = dict(tables[0], nbr13=tables[0]["nbr"][:, 13:14])
    nbr, nbr_t = t0[name], t0[name_t]
    m_in = tables[lvl]["mask"].shape[0]
    rng = np.random.default_rng(len(conv))
    k, cin, cout = nbr.shape[1], 5, 7
    # a step's scales: unit activations, He-init weights, small output
    # gradients, so dW (a sum over every row) is O(1) like the outputs
    feats = rng.standard_normal((m_in, cin)).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout))
         * np.sqrt(2.0 / (k * cin))).astype(np.float32)
    g = (rng.standard_normal((nbr.shape[0], cout)) * 0.01).astype(np.float32)

    out, vjp = jax.vjp(
        lambda f, ww: jax_sparse_conv_t(f, jnp.asarray(nbr), jnp.asarray(nbr_t),
                                        ww, flip),
        jnp.asarray(feats), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    x = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = sparse_conv_t(x, torch.from_numpy(nbr), torch.from_numpy(nbr_t), wt,
                        flip)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-6)
    assert wt.grad.dtype == torch.float32


def test_sparse_conv_t_skips_dx_without_input_grad(tables):
    """The input conv's feats are data: no dx gather is launched for them
    (JAX's stop_gradient), only dW's re-gather."""
    nbr = torch.from_numpy(tables[0]["nbr"])
    m = nbr.shape[0]
    x = torch.randn(m, 4)
    w = torch.randn(27, 4, 3, requires_grad=True)
    calls = []
    real = gather.gather_rows

    def counting(src, idx):
        calls.append(src.shape[1])
        return real(src, idx)

    mp = pytest.MonkeyPatch()
    mp.setattr(gather, "gather_rows", counting)
    try:
        sparse_conv_t(x, nbr, nbr, w, True).sum().backward()
    finally:
        mp.undo()
    assert calls == [4, 4]            # forward + dW re-gather, no dx
    assert x.grad is None and w.grad.shape == w.shape


def test_gather_rows_backward_matches_jax():
    """Duplicates accumulate; the sentinel and out-of-range rows drop."""
    rng = np.random.default_rng(7)
    n_src, c = 50, 6
    feats = rng.standard_normal((n_src, c)).astype(np.float32)
    idx = rng.integers(0, n_src, 400).astype(np.int32)
    idx[:40] = 3                       # heavy duplicates
    idx[40:60] = n_src                 # the INVALID sentinel
    g = rng.standard_normal((idx.shape[0], c)).astype(np.float32)

    _, vjp = jax.vjp(lambda f: jseg.gather_padded(f, jnp.asarray(idx)),
                     jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(feats).requires_grad_()
    gather.gather_rows(x, torch.from_numpy(idx)).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    # out of range on both sides also drops (the gather read zeros there)
    idx2 = np.concatenate([idx, [-1, n_src + 5]]).astype(np.int32)
    x2 = torch.from_numpy(feats).requires_grad_()
    g2 = np.concatenate([g, np.ones((2, c), np.float32)])
    gather.gather_rows(x2, torch.from_numpy(idx2)).backward(
        torch.from_numpy(g2))
    np.testing.assert_array_equal(x2.grad.numpy(), np.asarray(want))


def test_masked_batchnorm_train_grads_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 50, 6)) * 3 + 1).astype(np.float32)
    mask = (rng.random((2, 50)) < 0.7).astype(np.float32)
    g = rng.standard_normal((2, 50, 6)).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                    "bias": rng.normal(0, 0.1, 6).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    jbn = jblocks.MaskedBatchNorm()

    def f(p, xx):
        return jbn.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                         jnp.asarray(mask), True, mutable=["batch_stats"])

    jp = jax.tree.map(jnp.asarray, v["params"])
    want, vjp, state = jax.vjp(f, jp, jnp.asarray(x), has_aux=True)
    dparams, dx = vjp(jnp.asarray(g))

    bn = blocks.MaskedBatchNorm(6)
    bn.load_state_dict(params.flax_to_state_dict(v, bn))
    xt = torch.from_numpy(x).requires_grad_()
    out = bn(xt, torch.from_numpy(mask), True)
    out.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **tol)
    np.testing.assert_allclose(bn.scale.grad.numpy(),
                               np.asarray(dparams["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(dparams["bias"]), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(state["batch_stats"][k]), **tol)
