"""The port's GRU language encoder (``d3net_tpu_torch/models/lang.py``)
against ``d3net_tpu.models.lang.LangModule`` on the CPU: same numpy-seeded
word embeddings and lengths (0, 1, T and between), same weights converted
from the Flax tree (biases drawn).

- Forward and bidirectional: ``lang_hiddens``, ``lang_emb``,
  ``lang_masks`` and ``lang_scores`` rtol 1e-4 / atol 1e-5; a length-0
  row gives zero hiddens and a zero ``lang_emb``.
- Train: the scores' dropout (0.5) with the same keep mask on both sides
  (``jax.random.bernoulli`` patched for the call).
- Gradients of a loss through every output, for the inputs and every
  parameter, rtol 1e-3 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.models.lang import LangModule as JLang
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import randomize
from d3net_tpu_torch.models.lang import LangModule
from d3net_tpu_torch.models.listener import ListenerDraws

N, T, E, H, C = 6, 7, 300, 24, 18
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
KEYS = ("lang_hiddens", "lang_emb", "lang_masks", "lang_scores")


def _inputs(rng):
    return {"embs": (rng.normal(size=(N, T, E)) * 0.3).astype(np.float32),
            "len": np.array([0, T, 1, 3, 5, 0], np.int32),
            "keep": rng.random((N, C)) >= 0.5,
            "r": {k: rng.normal(size=s).astype(np.float32) for k, s in (
                ("lang_hiddens", (N, T, H)), ("lang_emb", (N, H)),
                ("lang_scores", (N, C)))}}


def _setup(bidir):
    rng = np.random.default_rng(int(bidir))
    x = _inputs(rng)
    jm = JLang(num_text_classes=C, hidden_size=H, use_bidir=bidir)
    v = jm.init(jax.random.key(0), jnp.asarray(x["embs"]),
                jnp.asarray(x["len"]))
    v = randomize(jax.tree.map(np.array, v), rng)
    tm = LangModule(num_text_classes=C, hidden_size=H, use_bidir=bidir)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    return jm, v, tm, x


def _loss(out, r, xp):
    return sum((out[k] * xp.asarray(r[k])).sum() for k in r)


def _jax(jm, v, x, train, mp):
    mp.setattr(jax.random, "bernoulli",
               lambda key, p=0.5, shape=None: jnp.asarray(x["keep"]))

    def f(v, embs):
        out = jm.apply(v, embs, jnp.asarray(x["len"]),
                       deterministic=not train,
                       rngs={"dropout": jax.random.key(1)})
        return _loss(out, x["r"], jnp), out

    (gv, ge), out = jax.grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x["embs"]))
    return {k: np.asarray(a) for k, a in out.items()}, gv, np.asarray(ge)


@pytest.mark.parametrize("bidir", [False, True], ids=["fwd", "bidir"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lang_module_matches_jax(bidir, train):
    jm, v, tm, x = _setup(bidir)
    with pytest.MonkeyPatch.context() as mp:
        want, gv, ge = _jax(jm, v, x, train, mp)
    embs = torch.from_numpy(x["embs"]).requires_grad_()
    draws = ListenerDraws(masks={"cls_dropout": torch.from_numpy(x["keep"])})
    out = tm(embs, torch.from_numpy(x["len"]), draws if train else None)
    _loss(out, x["r"], torch).backward()
    assert set(out) == set(KEYS) == set(want)
    for k in KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(), want[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    zero = x["len"] == 0
    assert not out["lang_hiddens"][zero].abs().any()
    assert not out["lang_emb"][zero].abs().any()
    if train:    # half the scores dropped, the rest doubled
        eval_scores = tm.lang_cls(out["lang_emb"]).detach().numpy()
        np.testing.assert_allclose(
            want["lang_scores"], np.where(x["keep"], eval_scores * 2, 0.0),
            rtol=RTOL, atol=ATOL)

    np.testing.assert_allclose(embs.grad.numpy(), ge, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    want_p = params.flatten(jax.tree.map(np.asarray, gv)["params"])
    got_p = params.flatten(params.state_dict_to_flax(tm, {
        n: p.grad for n, p in tm.named_parameters()})["params"])
    assert set(got_p) == set(want_p)
    assert {k.split(".")[0] for k in got_p} == (
        {"gru_fwd", "gru_bwd", "lang_cls"} if bidir else
        {"gru_fwd", "lang_cls"})
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
