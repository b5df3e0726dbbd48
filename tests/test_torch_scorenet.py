"""Dense ScoreNet against d3net_tpu on even and odd grids and on empty
occupancy (f32, rtol 1e-4 / atol 1e-5 through the ~20-layer U-Net)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.models.scorenet import ScoreNet as JaxScoreNet
from d3net_tpu_torch import params
from d3net_tpu_torch.models.scorenet import ScoreNet


def _randomize(tree, rng):
    for k, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif k in ("bias", "mean"):
            tree[k] = rng.normal(0.0, 0.1, val.shape).astype(np.float32)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)


@pytest.mark.parametrize("g,density", [(6, 0.3), (7, 0.3), (6, 0.0)])
def test_scorenet_matches_jax(g, density):
    rng = np.random.default_rng(g)
    p, c, planes = 3, 5, (8, 16)
    occ = (rng.random((p, g, g, g)) < density).astype(np.float32)
    grids = rng.standard_normal((p, g, g, g, c)).astype(np.float32) * occ[..., None]
    port = ScoreNet(c, planes, block_reps=2)
    variables = params.init_flax_variables(port, seed=g)
    _randomize(variables, rng)
    port.load_state_dict(params.flax_to_state_dict(variables, port))
    jmod = JaxScoreNet(planes, 2)
    want_s, want_p = jax.jit(lambda v, x, o: jmod.apply(v, x, o, False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(grids),
        jnp.asarray(occ))
    with torch.no_grad():
        got_s, got_p = port(torch.from_numpy(grids), torch.from_numpy(occ))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-4,
                               atol=1e-5)
    if density == 0.0:
        assert (got_p.numpy() == 0).all()


@pytest.mark.parametrize("g", [6, 7])
def test_scorenet_train_grads_match_jax(g):
    """train=True: BN batch statistics over the occupied cells. Scores,
    input and parameter gradients, and the new running statistics against
    JAX under autograd (f32, rtol 1e-4 / atol 1e-5 as for the forward)."""
    rng = np.random.default_rng(10 + g)
    p, c, planes = 3, 5, (8, 16)
    occ = (rng.random((p, g, g, g)) < 0.3).astype(np.float32)
    grids = rng.standard_normal((p, g, g, g, c)).astype(np.float32) \
        * occ[..., None]
    port = ScoreNet(c, planes, block_reps=2)
    variables = params.init_flax_variables(port, seed=g)
    _randomize(variables, rng)
    port.load_state_dict(params.flax_to_state_dict(variables, port))
    jmod = JaxScoreNet(planes, 2)
    jv = jax.tree.map(jnp.asarray, variables)

    def loss(prm, x):
        (s, pooled), st = jmod.apply(
            {"params": prm, "batch_stats": jv["batch_stats"]}, x,
            jnp.asarray(occ), True, mutable=["batch_stats"])
        return (s * jnp.arange(1.0, p + 1)).sum() + pooled.sum(), (s, st)

    (_, (want_s, state)), (want_dp, want_dx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jv["params"], jnp.asarray(grids))

    x = torch.from_numpy(grids).requires_grad_()
    got_s, got_p = port(x, torch.from_numpy(occ), True)
    ((got_s * torch.arange(1.0, p + 1)).sum() + got_p.sum()).backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               **tol)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx), **tol)
    grads = params.state_dict_to_flax(
        port, {n: q.grad for n, q in port.named_parameters()})["params"]
    want_g = params.flatten(jax.tree.map(np.asarray, want_dp))
    got_g = params.flatten(grads)
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k], w, **tol, err_msg=k)
    got_bs = params.flatten(params.state_dict_to_flax(port)["batch_stats"])
    for k, w in params.flatten(
            jax.tree.map(np.asarray, state["batch_stats"])).items():
        np.testing.assert_allclose(got_bs[k], w, **tol, err_msg=k)
