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
