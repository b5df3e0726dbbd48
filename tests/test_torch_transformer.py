"""The port's attention primitives (``d3net_tpu_torch/models/
transformer.py``) against ``d3net_tpu.models.transformer`` and Flax's
``LayerNorm`` on the CPU: same numpy-seeded inputs, same weights converted
from the Flax tree (biases and LayerNorm scales drawn, so each is checked).

- ``MultiHeadAttention`` with multiplicative and additive attention
  weights and none, a key mask with one all-masked row, eval and train
  (the same dropout keep mask on both sides: ``jax.random.bernoulli``
  patched for the call). Outputs rtol 1e-4 / atol 1e-5; an all-masked
  row's attention is zero, so its output is the post-LN of the query
  plus ``fc_o``'s bias (times the keep mask); the gradients of a loss
  through it are finite on both sides and agree (rtol 1e-3 / atol 1e-6).
- ``LayerNorm``'s eps is Flax's 1e-6: on rows of small variance the port
  matches Flax (rtol 1e-4) and ``torch.nn.functional.layer_norm``, with
  torch's 1e-5, does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch.nn import functional as F

from d3net_tpu.models.transformer import MultiHeadAttention as JMHA
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import randomize
from d3net_tpu_torch.models.listener import ListenerDraws
from d3net_tpu_torch.models.transformer import LayerNorm, MultiHeadAttention

B, NQ, NK, D, H, DK = 3, 5, 6, 16, 4, 8
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6


def _inputs(rng):
    mask = (rng.random((B, NK)) < 0.7).astype(np.float32)
    mask[1] = 0.0                                    # an all-masked row
    mask[0, 0] = 1.0
    return {
        "q": rng.normal(size=(B, NQ, D)).astype(np.float32),
        "k": rng.normal(size=(B, NK, D)).astype(np.float32),
        "v": rng.normal(size=(B, NK, D)).astype(np.float32),
        "mask": mask,
        "w": rng.uniform(0.1, 1.0, (B, H, NQ, NK)).astype(np.float32),
        "keep": rng.random((B, NQ, D)) >= 0.1,
        "r": rng.normal(size=(B, NQ, D)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def mha():
    rng = np.random.default_rng(0)
    x = _inputs(rng)
    jm = JMHA(D, DK, DK, H)
    v = jm.init(jax.random.key(0), jnp.asarray(x["q"]), jnp.asarray(x["k"]),
                jnp.asarray(x["v"]))
    v = randomize(jax.tree.map(np.array, v), rng)
    tm = MultiHeadAttention(D, DK, DK, H)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    return jm, v, tm, x


CASES = [("none", "mul", False), ("mul", "mul", False), ("add", "add", False),
         ("add", "add", True)]


def _jax_out(jm, v, x, weights, way, train, mp):
    mp.setattr(jax.random, "bernoulli",
               lambda key, p=0.5, shape=None: jnp.asarray(x["keep"]))

    def f(v, q, k, val):
        out = jm.apply(v, q, k, val, key_mask=jnp.asarray(x["mask"]),
                       attention_weights=(jnp.asarray(x["w"])
                                          if weights != "none" else None),
                       way=way, deterministic=not train,
                       rngs={"dropout": jax.random.key(1)})
        return (out * jnp.asarray(x["r"])).sum(), out

    grads, out = jax.grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x["q"]),
        jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    return np.asarray(out), grads


def _port_out(tm, x, weights, way, train):
    t = {k: torch.from_numpy(np.asarray(x[k])) for k in ("q", "k", "v")}
    for a in t.values():
        a.requires_grad_()
    tm.zero_grad()
    draws = ListenerDraws(masks={"Dropout_0": torch.from_numpy(x["keep"])}) \
        if train else None
    out = tm(t["q"], t["k"], t["v"], key_mask=torch.from_numpy(x["mask"]),
             attention_weights=(torch.from_numpy(x["w"])
                                if weights != "none" else None),
             way=way, draws=draws)
    (out * torch.from_numpy(x["r"])).sum().backward()
    return out.detach().numpy(), t


@pytest.mark.parametrize("weights,way,train", CASES,
                         ids=["no_weights", "mul", "add", "add_train"])
def test_mha_matches_jax(mha, weights, way, train):
    jm, v, tm, x = mha
    with pytest.MonkeyPatch.context() as mp:
        want, jgrads = _jax_out(jm, v, x, weights, way, train, mp)
    got, t = _port_out(tm, x, weights, way, train)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    # the all-masked row: zero attention, so fc_o adds its bias alone
    p = {k: torch.from_numpy(np.asarray(a)) for k, a in
         params.flatten(v["params"]).items()}
    resid = p["fc_o.bias"].expand(NQ, D)
    if train:
        resid = torch.where(torch.from_numpy(x["keep"][1]), resid / 0.9, 0.0)
    row = torch.from_numpy(x["q"][1]) + resid
    mean = row.mean(-1, keepdim=True)
    var = (row * row).mean(-1, keepdim=True) - mean * mean
    ln = (row - mean) * torch.rsqrt(var + 1e-6) * p["LayerNorm_0.scale"] \
        + p["LayerNorm_0.bias"]
    np.testing.assert_allclose(got[1], ln.numpy(), rtol=RTOL, atol=ATOL)

    # gradients: finite on both sides and equal
    gv, gq, gk, gval = jgrads
    for name, jg, tg in (("queries", gq, t["q"].grad), ("keys", gk, t["k"].grad),
                         ("values", gval, t["v"].grad)):
        jg = np.asarray(jg)
        assert np.isfinite(jg).all() and torch.isfinite(tg).all(), name
        np.testing.assert_allclose(tg.numpy(), jg, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    # the masked scene's keys and values get no gradient
    assert not np.abs(np.asarray(gk)[1]).any()
    assert not t["k"].grad[1].abs().any()
    want_p = params.flatten(jax.tree.map(np.asarray, gv)["params"])
    got_p = params.flatten(params.state_dict_to_flax(tm, {
        n: q.grad for n, q in tm.named_parameters()})["params"])
    assert set(got_p) == set(want_p)
    for k, w in want_p.items():
        assert np.isfinite(got_p[k]).all(), k
        np.testing.assert_allclose(got_p[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_layer_norm_eps_is_flax():
    rng = np.random.default_rng(3)
    x = (3e-3 * rng.normal(size=(4, 7, D))).astype(np.float32)
    ln = fnn.LayerNorm()
    v = randomize(jax.tree.map(np.array, ln.init(jax.random.key(0),
                                                 jnp.asarray(x))), rng)
    want = np.asarray(ln.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x)))
    port = LayerNorm(D)
    port.load_state_dict(params.flax_to_state_dict(v, port))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        torch_eps = F.layer_norm(torch.from_numpy(x), (D,), port.scale,
                                 port.bias).numpy()
    assert port.eps == 1e-6
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not np.allclose(torch_eps, want, rtol=RTOL, atol=ATOL)
