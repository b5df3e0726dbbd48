"""The port's grounding match modules (``d3net_tpu_torch/models/match.py``)
against ``d3net_tpu.models.match`` on the CPU: same numpy-seeded proposals
and language hiddens, same weights converted from the Flax tree (biases,
BN scales and statistics, PReLU slopes drawn, so each is checked).

- ``TransformerMatchModule`` in eval and in train; in train with the
  copy-paste draw applied, not applied, and with a scene whose donor (the
  previous scene) has no valid proposal. The dropout keep masks are drawn
  on the port's side (``ListenerDraws.drawn``) and given to JAX by
  module path through ``flax.linen.intercept_methods``, which also hands
  ``_copy_paste`` the same Bernoulli and (B, P, P) Gumbel draws.
  ``cluster_ref`` rtol 1e-4 / atol 1e-5; the new BN statistics rtol 1e-4
  / atol 1e-5 (Flax's momentum 0.9 and biased variance, over all B·P rows,
  padded slots included); gradients of a loss through ``cluster_ref`` for
  the proposal features and every parameter rtol 1e-3 / atol 1e-6, but
  in train those of the four biases that only shift a BatchNorm's input,
  which the batch mean takes out: their gradient is 0, and both sides'
  float noise must stay under 1e-5 of the largest gradient.
- ``MatchModule`` (ScanRefer) in eval, masked confidences.
- Flax's ``BatchNorm`` against ``torch.nn.BatchNorm1d``: the port's
  running variance is the biased one, which ``BatchNorm1d``'s is not.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from d3net_tpu.models.match import MatchModule as JMatch
from d3net_tpu.models.match import TransformerMatchModule as JTMatch
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import BN_FED_BIASES, grad_mismatches, randomize
from d3net_tpu_torch.models.listener import ListenerDraws
from d3net_tpu_torch.models.match import (
    BatchNorm, MatchModule, TransformerMatchModule,
)

B, CHUNK, P, F, T, LH, HS = 3, 2, 8, 12, 5, 24, 16
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6


@contextlib.contextmanager
def jax_draws(masks, copy_paste=None, prefix=()):
    """Inside the block, each Flax ``Dropout`` applied at path ``prefix +
    p`` takes ``masks[".".join(p)]`` as its keep mask (where it has one)
    and ``_copy_paste`` takes ``copy_paste`` (apply, gumbel) as its
    Bernoulli and Gumbel."""
    real_b, real_g = jax.random.bernoulli, jax.random.gumbel

    def interceptor(next_fun, args, kwargs, context):
        mod, name = context.module, context.method_name
        key = ".".join(context.module.path[len(prefix):])
        if isinstance(mod, fnn.Dropout) and name == "__call__" \
                and key in masks:
            assert tuple(mod.path[:len(prefix)]) == tuple(prefix), mod.path
            mask = jnp.asarray(np.asarray(masks[key]))
            jax.random.bernoulli = lambda key, p=0.5, shape=None: mask
        elif name == "_copy_paste" and copy_paste is not None:
            apply, g = (jnp.asarray(np.asarray(a)) for a in copy_paste)
            jax.random.bernoulli = lambda key, p=0.5, shape=None: apply
            jax.random.gumbel = lambda key, shape=(), *a, **k: g
        try:
            return next_fun(*args, **kwargs)
        finally:
            jax.random.bernoulli, jax.random.gumbel = real_b, real_g

    with fnn.intercept_methods(interceptor):
        yield


def _data(rng, donorless=False):
    mask = (rng.random((B, P)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    if donorless:
        mask[0] = 0.0            # scene 1's donor (scene 0) has no proposal
    lang_len = rng.integers(1, T + 1, B * CHUNK)
    lang_len[1] = 0
    return {
        "proposal_feats_batched": (rng.normal(size=(B, P, F))
                                   * mask[..., None]).astype(np.float32),
        "proposal_batch_mask": mask,
        "proposal_center_batched": rng.uniform(0, 4, (B, P, 3)).astype(
            np.float32),
        "lang_hiddens": rng.normal(size=(B * CHUNK, T, LH)).astype(np.float32),
        "lang_masks": (np.arange(T)[None] < lang_len[:, None]).astype(
            np.float32),
        "lang_emb": rng.normal(size=(B * CHUNK, LH)).astype(np.float32),
    }


def _to_torch(d, grad=False):
    out = {k: torch.from_numpy(v) for k, v in d.items()}
    if grad:
        out["proposal_feats_batched"].requires_grad_()
    return out


@pytest.fixture(scope="module")
def transformer():
    rng = np.random.default_rng(0)
    data = _data(rng)
    jm = JTMatch(lang_size=LH, hidden_size=HS, num_proposals=P)
    v = jax.jit(lambda d: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, d,
        chunk_size=CHUNK, train=True, rng=jax.random.key(2)))(
            jax.tree.map(jnp.asarray, data))
    v = randomize(jax.tree.map(np.array, v), rng)
    return jm, v


def _port(v, cls=TransformerMatchModule, **kw):
    tm = cls(F, **kw)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    return tm


CASES = ["eval", "train_no_copy_paste", "train_copy_paste",
         "train_copy_paste_donorless"]


@pytest.mark.parametrize("case", CASES)
def test_transformer_match_matches_jax(transformer, case):
    jm, v = transformer
    rng = np.random.default_rng(CASES.index(case) + 10)
    data = _data(rng, donorless=case.endswith("donorless"))
    train = case != "eval"
    apply = np.asarray(case.startswith("train_copy_paste"))
    gumbel = rng.gumbel(size=(B, P, P)).astype(np.float32)
    r = rng.normal(size=(B * CHUNK, P)).astype(np.float32)

    tm = _port(v, lang_size=LH, hidden_size=HS)
    draws = None
    rec_masks = {}
    if train:      # the port draws the keep masks; JAX takes the same
        cp = (torch.from_numpy(apply), torch.from_numpy(gumbel))
        rec = ListenerDraws(torch.Generator().manual_seed(CASES.index(case)),
                            copy_paste=cp)
        with torch.no_grad():
            _port(v, lang_size=LH, hidden_size=HS)(
                _to_torch(data), CHUNK, train=True, draws=rec)
        rec_masks = rec.drawn
        assert set(rec_masks) == {
            "lang_dropout", "lang_self_attn.Dropout_0",
            "self_attn_0.Dropout_0", "cross_attn_0.Dropout_0",
            "self_attn_1.Dropout_0", "cross_attn_1.Dropout_0"}
        draws = ListenerDraws(masks=rec_masks, copy_paste=cp)

    td = _to_torch(data, grad=True)
    out = tm(td, CHUNK, train=train, draws=draws)
    (out["cluster_ref"] * torch.from_numpy(r)).sum().backward()

    def f(params_, feats):
        d = dict(jax.tree.map(jnp.asarray, data), proposal_feats_batched=feats)
        o, mut = jm.apply({"params": params_,
                           "batch_stats": jax.tree.map(jnp.asarray,
                                                       v["batch_stats"])},
                          d, chunk_size=CHUNK, train=train,
                          rng=jax.random.key(3) if train else None,
                          rngs={"dropout": jax.random.key(4)},
                          mutable=["batch_stats"])
        return (o["cluster_ref"] * r).sum(), (o["cluster_ref"], mut)

    ctx = jax_draws(rec_masks, (apply, gumbel)) if train else \
        contextlib.nullcontext()
    with ctx:
        (gp, gf), (want, mut) = jax.jit(jax.grad(f, argnums=(0, 1),
                                                 has_aux=True))(
            jax.tree.map(jnp.asarray, v["params"]),
            jnp.asarray(data["proposal_feats_batched"]))
    np.testing.assert_allclose(out["cluster_ref"].detach().numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)

    got_stats = params.flatten(params.state_dict_to_flax(tm)["batch_stats"])
    want_stats = params.flatten(jax.tree.map(np.asarray, mut["batch_stats"]))
    old = params.flatten(v["batch_stats"])
    assert set(got_stats) == set(want_stats) == {
        f"{bn}.{s}" for bn in ("feat_bn", "match_bn1", "match_bn2")
        for s in ("mean", "var")}
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        # statistics move in train only
        assert np.array_equal(w, old[k]) != train, k

    np.testing.assert_allclose(td["proposal_feats_batched"].grad.numpy(),
                               np.asarray(gf), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    want_p = params.flatten(jax.tree.map(np.asarray, gp))
    got_p = params.flatten(params.state_dict_to_flax(tm, {
        n: p.grad for n, p in tm.named_parameters()
        if p.grad is not None})["params"])
    # in train, the biases that only shift a BatchNorm's input have a zero
    # gradient: both sides' noise is held to the largest gradient
    assert grad_mismatches(got_p, want_p, zero_grads={
        k[len("listener.match."):] for k in BN_FED_BIASES} if train
        else ())[0] == []


def test_copy_paste_fills_padded_slots(transformer):
    """Applied, every padded slot of a scene with a donor takes a valid
    proposal of the previous scene; the donor-less scene keeps its own."""
    _, v = transformer
    rng = np.random.default_rng(3)
    data = _to_torch(_data(rng, donorless=True))
    tm = _port(v, lang_size=LH, hidden_size=HS)
    h = torch.randn(B, P, HS, generator=torch.Generator().manual_seed(0))
    masks = data["proposal_batch_mask"]
    g = torch.from_numpy(rng.gumbel(size=(B, P, P)).astype(np.float32))
    same = tm._copy_paste(h, masks, ListenerDraws(
        copy_paste=(torch.tensor(False), g)))
    assert torch.equal(same, h)
    out = tm._copy_paste(h, masks, ListenerDraws(
        copy_paste=(torch.tensor(True), g)))
    assert torch.equal(out[1], h[1])                 # no donor
    for s in (0, 2):
        donor = (s - 1) % B
        valid = h[donor][masks[donor] > 0]
        for j in range(P):
            if masks[s, j] > 0:
                assert torch.equal(out[s, j], h[s, j])
            else:
                assert any(torch.equal(out[s, j], x) for x in valid)
    assert (masks[0] == 0).all() and not torch.equal(out[0], h[0])


def test_scanrefer_match_matches_jax():
    rng = np.random.default_rng(5)
    data = _data(rng)
    feats = np.repeat(data["proposal_feats_batched"], CHUNK, 0)
    masks = np.repeat(data["proposal_batch_mask"], CHUNK, 0)
    jm = JMatch(hidden_size=HS, lang_size=LH)
    args = [jnp.asarray(a) for a in (feats, masks, data["lang_emb"])]
    v = randomize(jax.tree.map(np.array, jm.init(jax.random.key(0), *args)),
                  rng)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, v), *args))
    tm = MatchModule(F, hidden_size=HS, lang_size=LH)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (
            feats, masks, data["lang_emb"]))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[masks == 0].any()


def test_batch_norm_running_variance_is_biased():
    rng = np.random.default_rng(6)
    x = rng.normal(2.0, 3.0, (10, HS)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    want_y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(HS)
    y = port(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=RTOL, atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(mut["batch_stats"][k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    ref = torch.nn.BatchNorm1d(HS, momentum=0.1)
    ref.train()(torch.from_numpy(x))
    assert not np.allclose(ref.running_var.numpy(), port.var.numpy(),
                           rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        port.var.numpy(), 0.9 + 0.1 * x.var(0), rtol=RTOL, atol=ATOL)
