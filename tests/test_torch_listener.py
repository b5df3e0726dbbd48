"""The port's listener (``d3net_tpu_torch/models/listener.py``) against
``d3net_tpu.models.listener.ListenerNet`` on the CPU, and the converter's
listener leaves.

- ``ListenerNet`` with both match types, in eval and in train, on the same numpy-seeded proposals, word embeddings and lengths
  (0 and T among them), same weights converted from the Flax tree (drawn
  biases, BN statistics and PReLU slopes): ``cluster_ref``,
  ``lang_scores``, ``lang_emb`` and ``lang_hiddens`` rtol 1e-4 / atol
  1e-5. In train the dropout masks and copy-paste draws are the port's,
  given to JAX by module path (``tests/test_torch_match.py``
  ``jax_draws``).
- The converter: Flax -> torch -> Flax gives the same tree, leaf for leaf
  and bit for bit, for the ListenerNet and for the whole grounding
  pipeline of conf/debug/tiny_grounding.yaml; the port's numpy init of
  that pipeline has the JAX ``PipelineNet.init`` tree's leaves and shapes
  (``jax.eval_shape``), its PReLU slopes 0.25.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.models.listener import ListenerNet as JListener
from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import randomize
from d3net_tpu_torch.models.listener import ListenerDraws, ListenerNet
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train import pipeline as tpl
from test_torch_match import jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_grounding.yaml")
B, CHUNK, P, F, T, E, LH, MH = 2, 3, 8, 12, 6, 300, 24, 16
RTOL, ATOL = 1e-4, 1e-5
KEYS = ("cluster_ref", "lang_scores", "lang_emb", "lang_hiddens")


def _inputs(rng):
    mask = (rng.random((B, P)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    lens = rng.integers(1, T + 1, B * CHUNK).astype(np.int32)
    lens[0], lens[1] = 0, T
    return {
        "data": {"proposal_feats_batched": (rng.normal(size=(B, P, F))
                                            * mask[..., None]).astype(
                                                np.float32),
                 "proposal_batch_mask": mask,
                 "proposal_center_batched": rng.uniform(0, 4, (B, P, 3)).astype(
                     np.float32)},
        "embs": (rng.normal(size=(B * CHUNK, T, E)) * 0.3).astype(np.float32),
        "lens": lens,
        "gumbel": rng.gumbel(size=(B, P, P)).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def _init(match_type):
    """The JAX ListenerNet and its initial variables (numpy), once per
    match type: the inputs matter only by their shapes."""
    x = _inputs(np.random.default_rng(99))
    jm = JListener(num_text_classes=18, lang_hidden=LH, match_hidden=MH,
                   match_type=match_type, num_proposals=P)
    v = jax.jit(lambda d, e, n: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, d, e, n,
        CHUNK, train=True, rng=jax.random.key(2)))(
            jax.tree.map(jnp.asarray, x["data"]), jnp.asarray(x["embs"]),
            jnp.asarray(x["lens"]))
    return jm, jax.tree.map(np.asarray, v)


def _models(match_type, rng):
    jm, v = _init(match_type)
    v = randomize(jax.tree.map(np.array, v), rng)
    tm = ListenerNet(F, lang_hidden=LH, match_hidden=MH,
                     match_type=match_type)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    return jm, v, tm


@pytest.mark.parametrize("match_type,train", [
    ("Transformer", False), ("Transformer", True), ("ScanRefer", False),
    ("ScanRefer", True)],
    ids=["transformer_eval", "transformer_train", "scanrefer_eval",
         "scanrefer_train"])
def test_listener_matches_jax(match_type, train):
    rng = np.random.default_rng(int(train))
    x = _inputs(rng)
    jm, v, tm = _models(match_type, rng)
    td = {k: torch.from_numpy(a) for k, a in x["data"].items()}
    apply = np.asarray(True)
    masks = {}
    if train:
        cp = (torch.from_numpy(apply), torch.from_numpy(x["gumbel"]))
        rec = ListenerDraws(torch.Generator().manual_seed(0), copy_paste=cp)
        with torch.no_grad():
            got = tm(td, torch.from_numpy(x["embs"]),
                     torch.from_numpy(x["lens"]), CHUNK, train=True,
                     draws=rec)
        masks = rec.drawn
        assert {k.split(".")[0] for k in masks} == (
            {"lang", "match"} if match_type == "Transformer" else {"lang"})
        assert "lang.cls_dropout" in masks
        # the same draws given again give the same outputs
        with torch.no_grad():
            again = tm(td, torch.from_numpy(x["embs"]),
                       torch.from_numpy(x["lens"]), CHUNK, train=True,
                       draws=ListenerDraws(masks=masks, copy_paste=cp))
        for k in KEYS:
            assert torch.equal(got[k], again[k]), k
    else:
        tm.eval()
        with torch.no_grad():
            got = tm(td, torch.from_numpy(x["embs"]),
                     torch.from_numpy(x["lens"]), CHUNK)

    def f(d, e, n):
        return jm.apply(jax.tree.map(jnp.asarray, v), d, e, n, CHUNK,
                        train=train, rng=jax.random.key(3) if train else None,
                        rngs={"dropout": jax.random.key(4)},
                        mutable=["batch_stats"])[0]

    with jax_draws(masks, (apply, x["gumbel"])):
        want = jax.jit(f)(jax.tree.map(jnp.asarray, x["data"]),
                          jnp.asarray(x["embs"]), jnp.asarray(x["lens"]))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert not got["lang_emb"][0].any()          # the length-0 row
    if match_type == "ScanRefer":
        rows = torch.from_numpy(x["data"]["proposal_batch_mask"]
                                ).repeat_interleave(CHUNK, 0)
        assert not got["cluster_ref"][rows == 0].any()


def _round_trip(variables, model):
    model.load_state_dict(params.flax_to_state_dict(variables, model))
    back = params.state_dict_to_flax(model)
    for coll in ("params", "batch_stats"):
        want = params.flatten(variables.get(coll, {}))
        got = params.flatten(back.get(coll, {}))
        assert set(got) == set(want), coll
        for k, w in want.items():
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.mark.parametrize("match_type", ["Transformer", "ScanRefer"])
def test_converter_round_trip_listener(match_type):
    _, v, tm = _models(match_type, np.random.default_rng(7))
    _round_trip(v, tm)
    names = dict(tm.named_parameters())
    if match_type == "Transformer":
        assert "match.self_attn_0.LayerNorm_0.scale" in names
        assert "match.feat_prelu.alpha" in names
        assert "match.feat_bn.mean" in tm.state_dict()
    assert "lang.gru_fwd.weight_ih" in names


def test_grounding_pipeline_tree_matches_jax():
    from d3net_tpu import config as jcfg
    from d3net_tpu.data.collate import build_batch
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train import pipeline_loop as jpl
    from d3net_tpu_torch.data.language import build_lang_batch

    cfg = tcfg.load(TINY)
    vocab, emb = tpl.build_vocab(cfg)
    spec = tloop.spec_from_cfg(cfg)
    train_it, _ = tloop.make_dataloaders(cfg, spec, return_scenes=True)
    _, scenes = next(iter(train_it))
    chunk = int(cfg.data.num_des_per_scene)
    lang_np = build_lang_batch(scenes, vocab, chunk, cfg.data.max_spk_len,
                               np.random.default_rng(0), spec.max_instances)
    jc = jcfg.load(TINY)
    jmodel = jpl.pipeline_from_cfg(jc, vocab)
    batch = jax.tree.map(jnp.asarray, build_batch(scenes,
                                                  jloop.spec_from_cfg(jc)))
    rngs = {k: jax.random.key(i) for i, k in enumerate(
        ("params", "cluster_jitter", "proposal_shuffle", "target_sampling",
         "copy_paste", "dropout"))}
    shapes = jax.eval_shape(
        lambda b, ln: jmodel.init(rngs, b, ln, train=True, chunk_size=chunk),
        batch, jpl.lang_rows(lang_np, emb))
    want = {c: {k: tuple(a.shape) for k, a in params.flatten(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes[c])
    ).items()} for c in ("params", "batch_stats")}

    model = tpl.pipeline_from_cfg(cfg, vocab)
    assert hasattr(model, "listener") and not hasattr(model, "speaker")
    variables = params.init_flax_variables(model, 0)
    for c in ("params", "batch_stats"):
        got = {k: a.shape for k, a in params.flatten(variables[c]).items()}
        assert got == want[c], c
    alphas = [a for k, a in params.flatten(variables["params"]).items()
              if k.endswith(".alpha")]
    assert len(alphas) == 3 and all((a == 0.25).all() for a in alphas)
    _round_trip(randomize(variables, np.random.default_rng(0)), model)
