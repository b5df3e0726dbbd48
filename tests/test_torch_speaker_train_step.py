"""One mode-1 train step of the port (``train/pipeline.py``
``speaker_train_step``) against ``d3net_tpu.train.pipeline_loop.
speaker_train_step`` on the CPU, on conf/debug/tiny_captioning.yaml with
the orientation head on and ``data.min_iou_threshold`` 0 (so that the
random detector's targets that meet their box count as good and the caption
loss reaches the detector). Both sides start from the same variables
(numpy-initialised, nonzero biases and BN statistics) and get the same
batch, description rows, cluster jitter, proposal permutation and Gumbel
draw: on the JAX side ``jax.random.uniform``, ``permutation`` and
``gumbel`` are patched for the call, as tests/test_torch_train_step.py
patches the first two.

The optimizer is the config's AdamW, wrapped on the JAX side by
``make_frozen_optimizer``; the JAX step returns no gradients, so they are
read from Adam's first moment (``(1 - b1) * grad``). With
``freeze_detector`` True the JAX optimizer masks the detector and the port
computes no gradient for it; the detector's parameters are unchanged on
both sides and its BN statistics move on both.

Tolerances: the seven metrics rtol 1e-4; gradients rtol 1e-3 / atol 1e-6;
new BN statistics rtol 1e-4 / atol 1e-5; target ids and good-box masks
equal.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import randomize
from d3net_tpu_torch.data.collate import batch_to_torch
from d3net_tpu_torch.data.language import build_lang_batch
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_captioning.yaml")
B1 = 0.9
METRICS = {"detect_loss", "captioning_loss", "orientation_loss", "cap_acc",
           "ori_acc", "pred_ious", "loss"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(load, batch_size=None):
    cfg = load(TINY)
    cfg.model.use_orientation = True
    cfg.data.min_iou_threshold = 0.0
    if batch_size is not None:
        cfg.data.batch_size = batch_size
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(tcfg.load)
    vocab, emb = tpl.build_vocab(cfg)
    spec = tloop.spec_from_cfg(cfg)
    train_it, _ = tloop.make_dataloaders(cfg, spec, return_scenes=True)
    batch_np, scenes = next(iter(train_it))
    chunk = int(cfg.data.num_des_per_scene)
    lang_np = build_lang_batch(scenes, vocab, chunk, cfg.data.max_spk_len,
                               np.random.default_rng(0), spec.max_instances,
                               apply_word_erase=True)
    variables = randomize(params.init_flax_variables(
        tpl.pipeline_from_cfg(cfg, vocab), seed=0), np.random.default_rng(1))
    rng = np.random.default_rng(5)
    b = cfg.data.batch_size
    k = cfg.model.max_num_proposal
    draws = dict(
        jitter=rng.random((b, 2 * cfg.tpu.clusters_per_pass, 3)).astype(
            np.float32),
        perm=rng.permutation(k).astype(np.int32),
        gumbel=rng.gumbel(size=(b * chunk, k)).astype(np.float32))
    return dict(cfg=cfg, vocab=vocab, emb=emb, scenes=scenes,
                batch_np=batch_np, lang_np=lang_np, variables=variables,
                chunk=chunk, **draws)


def _patch_draws(mp, s):
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(s["jitter"]))
    mp.setattr(jax.random, "permutation",
               lambda key, x, *a, **k: jnp.asarray(s["perm"], jnp.int32))
    mp.setattr(jax.random, "gumbel",
               lambda key, shape, *a, **k: jnp.asarray(s["gumbel"]))


def _adam_mu(state):
    """The first moment of the (masked) ``scale_by_adam`` inside an optax
    state."""
    if isinstance(state, optax.ScaleByAdamState):
        return state.mu
    children = state.values() if isinstance(state, dict) else (
        state if isinstance(state, tuple) else ())
    for c in children:
        mu = _adam_mu(c)
        if mu is not None:
            return mu
    return None


def _flat(tree, prefix=""):
    """Dotted leaves of a tree, without optax's masked (frozen) nodes."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        elif not isinstance(v, optax.MaskedNode):
            out[path] = np.asarray(v)
    return out


def _jax_side(s, mp, targets=True):
    """JAX's step with and without the frozen detector, and (with
    ``targets``) the target ids and good-box masks of the same draws. The
    batch is JAX's collate of the same scenes, with the port batch's object
    rotations when it has them."""
    from d3net_tpu import config as jcfg
    from d3net_tpu.data.collate import build_batch
    from d3net_tpu.models.pipeline import PipelineNet
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train import pipeline_loop as jpl
    from d3net_tpu.train.trainer import TrainState, make_optimizer

    cfg = _cfg(jcfg.load, s["cfg"].data.batch_size)
    model = jpl.pipeline_from_cfg(cfg, s["vocab"])
    jbatch = jax.tree.map(jnp.asarray, build_batch(
        s["scenes"], jloop.spec_from_cfg(cfg)))
    jbatch.update({k: jnp.asarray(v) for k, v in s["batch_np"].items()
                   if k.startswith("scene_object_rotation")})
    jlang = jpl.lang_rows(s["lang_np"], s["emb"])
    v = jax.tree.map(jnp.asarray, s["variables"])
    _patch_draws(mp, s)
    step = jax.jit(functools.partial(
        jpl.speaker_train_step, model, False, chunk_size=s["chunk"],
        det_weight=tuple(cfg.train.loss_weight[:4])))
    res = {}
    for freeze in (False, True):
        o = cfg.train.optim
        tx = jpl.make_frozen_optimizer(
            make_optimizer(lr=o.lr, optim=o.classname,
                           weight_decay=o.weight_decay),
            v["params"], {"detector": freeze, "speaker": False})
        state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"],
                           opt_state=tx.init(v["params"]), tx=tx)
        new, metrics = step(state, jbatch, jlang, jax.random.key(0))
        res[freeze] = dict(
            metrics={k: float(x) for k, x in metrics.items()},
            grads={k: a / (1 - B1) for k, a in _flat(
                _adam_mu(new.opt_state)).items()},
            params=_flat(jax.tree.map(np.asarray, new.params)),
            batch_stats=_flat(jax.tree.map(np.asarray, new.batch_stats)))
    if not targets:
        return res, None, None

    @jax.jit
    def targets(v, b, ln):
        rngs = {"cluster_jitter": jax.random.key(1),
                "proposal_shuffle": jax.random.key(2)}
        out, _ = model.apply(v, b, train=True, method=PipelineNet.run_detector,
                             rngs=rngs, mutable=["batch_stats"])
        data = {**out, **ln, **jpl.expand_rows(out, b, s["chunk"])}
        data = model.apply(v, data, mode="tf", rng=jax.random.key(3),
                           chunk_size=s["chunk"],
                           method=PipelineNet.run_speaker)
        return data["target_ids"], data["good_bbox_masks"]

    ids, good = targets(v, jbatch, jlang)
    return res, np.asarray(ids), np.asarray(good)


def _draw_kw(s):
    return dict(jitter_u=torch.from_numpy(s["jitter"]),
                proposal_perm=torch.from_numpy(s["perm"]).long()[None],
                gumbel=torch.from_numpy(s["gumbel"]))


def _port_side(s, freeze):
    cfg = s["cfg"]
    model = params.load_pipeline(s["variables"], cfg, s["vocab"], device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tpl.freeze_submodules(model, {"detector": freeze})
    o = cfg.train.optim
    state = create_train_state(model, lr=o.lr, optim=o.classname,
                               weight_decay=o.weight_decay)
    batch = batch_to_torch(s["batch_np"], "cpu")
    lang = tpl.lang_rows(s["lang_np"], s["emb"], "cpu")
    _, metrics = tpl.speaker_train_step(
        state, batch, lang, chunk_size=s["chunk"],
        loss_weight=tuple(cfg.train.loss_weight[:4]), **_draw_kw(s))
    return dict(model=model, before=before,
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def results(setup):
    with pytest.MonkeyPatch.context() as mp:
        jax_res, ids, good = _jax_side(setup, mp)
    return dict(jax=jax_res, ids=ids, good=good,
                port={f: _port_side(setup, f) for f in (False, True)})


CASES = pytest.mark.parametrize("freeze", [False, True],
                                ids=["trained_detector", "frozen_detector"])


@CASES
def test_metrics(results, freeze):
    want, got = results["jax"][freeze]["metrics"], results["port"][freeze][
        "metrics"]
    assert set(got) == set(want) == METRICS
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
    assert got["captioning_loss"] > 0 and got["detect_loss"] > 0
    assert got["orientation_loss"] == got["ori_acc"] == 0.0   # no rotations


@CASES
def test_gradients(results, freeze):
    want = results["jax"][freeze]["grads"]
    model = results["port"][freeze]["model"]
    got = params.flatten(params.state_dict_to_flax(model, {
        n: p.grad for n, p in model.named_parameters()
        if p.grad is not None})["params"])
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == (
        {"speaker"} if freeze else {"detector", "speaker"})
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    # not vacuous: only the orientation head, which no loss reaches without
    # rotation labels, has zero gradients
    zero = {k for k, w in want.items() if not np.abs(w).max() > 0}
    assert zero == {k for k in want if ".edge_layer." in k
                    or ".edge_predict." in k}


@CASES
def test_bn_statistics_and_frozen_parameters(setup, results, freeze):
    jres, port = results["jax"][freeze], results["port"][freeze]
    got = params.flatten(params.state_dict_to_flax(port["model"])[
        "batch_stats"])
    want = jres["batch_stats"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    # the detector's statistics move, frozen or not; its parameters stay
    # only when frozen, on both sides; the speaker's always move
    sd, before = port["model"].state_dict(), port["before"]
    stats = {k for k in sd if k.endswith((".mean", ".var"))}
    assert all(k.startswith("detector.") for k in stats)
    assert not any(torch.equal(sd[k], before[k]) for k in stats)
    det = [k for k in sd if k.startswith("detector.") and k not in stats]
    assert [k for k in det if torch.equal(sd[k], before[k])] == (
        det if freeze else [])
    assert not any(torch.equal(sd[k], before[k]) for k in sd
                   if k.startswith("speaker."))
    v0 = params.flatten(setup["variables"]["params"])
    jdet = [k for k in jres["params"] if k.startswith("detector.")]
    assert [k for k in jdet if np.array_equal(jres["params"][k], v0[k])] == (
        jdet if freeze else [])


def test_target_ids_equal(setup, results):
    model = params.load_pipeline(setup["variables"], setup["cfg"],
                                 setup["vocab"], device="cpu")
    with torch.no_grad():
        _, _, data = tpl.speaker_losses(
            model, batch_to_torch(setup["batch_np"], "cpu"),
            tpl.lang_rows(setup["lang_np"], setup["emb"], "cpu"),
            chunk_size=setup["chunk"], **_draw_kw(setup))
    np.testing.assert_array_equal(data["target_ids"].numpy(), results["ids"])
    np.testing.assert_array_equal(data["good_bbox_masks"].numpy(),
                                  results["good"])
    assert 0 < results["good"].sum() < len(results["good"])
