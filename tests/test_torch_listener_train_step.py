"""One mode-2 train step of the port (``train/pipeline.py``
``listener_train_step``) against ``d3net_tpu.train.pipeline_loop.
listener_train_step`` on the CPU, on conf/debug/tiny_grounding.yaml, with
the detector trained and frozen. Both sides start from the same variables
(numpy-initialised, nonzero biases, BN statistics and PReLU slopes) and get
the same batch, description rows, cluster jitter, proposal permutation,
dropout keep masks and copy-paste draws: on the JAX side
``jax.random.uniform`` and ``permutation`` are patched for the call, as
tests/test_torch_train_step.py does, and the listener's draws are handed
over by module path (``tests/test_torch_match.py`` ``jax_draws``); the
port records its own draws from a seeded generator first.

The optimizer is the config's AdamW, wrapped on the JAX side by
``make_frozen_optimizer``; the JAX step returns no gradients, so they are
read from Adam's first moment (``(1 - b1) * grad``). With
``freeze_detector`` the JAX optimizer masks the detector and the port
computes no gradient for it; the detector's parameters stay on both sides
and its BN statistics move on both.

Tolerances: the ten metrics rtol 1e-4; gradients rtol 1e-3 / atol 1e-6
(the biases that only shift a train-mode BatchNorm's input have a zero
gradient: both sides' noise under 1e-5 of the largest); new BN statistics
rtol 1e-4 / atol 1e-5.

The listener's backward into the detector is ill-conditioned in f32: the
port's own gradients move by up to a few times that gradient tolerance
when every weight moves by one ulp (relative 2^-24, random signs). So a
gradient element outside the tolerance passes only where the difference
from JAX is within ``ULP_FACTOR`` times that element's own one-ulp
movement, and such elements must stay under 1% of each tensor.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import (
    BN_FED_BIASES, grad_mismatches, listener_step_case, listener_step_kwargs,
    ulp_moved,
)
from d3net_tpu_torch.data.collate import batch_to_torch
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.trainer import create_train_state
from test_torch_match import jax_draws
from test_torch_speaker_train_step import _adam_mu, _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_grounding.yaml")
B1 = 0.9
ULP_FACTOR = 4.0
METRICS = {"detect_loss", "grounding_loss", "lobjcls_loss", "lang_acc",
           "loss", "ref_acc_mean", "ref_iou_mean", "best_ious_mean",
           "ref_iou_rate_0.25", "ref_iou_rate_0.5"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = tcfg.load(TINY)
    vocab, emb = tpl.build_vocab(cfg)
    case = listener_step_case(cfg, vocab, emb, seed=0)
    return dict(cfg=cfg, vocab=vocab, emb=emb, case=case)


def _jax_side(s, mp):
    from d3net_tpu import config as jcfg
    from d3net_tpu.data.collate import build_batch
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train import pipeline_loop as jpl
    from d3net_tpu.train.trainer import TrainState, make_optimizer

    case = s["case"]
    cfg = jcfg.load(TINY)
    model = jpl.pipeline_from_cfg(cfg, s["vocab"])
    jbatch = jax.tree.map(jnp.asarray, build_batch(
        case["scenes"], jloop.spec_from_cfg(cfg)))
    jlang = jpl.lang_rows(case["lang"], s["emb"])
    v = jax.tree.map(jnp.asarray, case["variables"])
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(case["jitter"]))
    mp.setattr(jax.random, "permutation",
               lambda key, x, *a, **k: jnp.asarray(case["perm"], jnp.int32))
    step = jax.jit(functools.partial(
        jpl.listener_train_step, model, chunk_size=case["chunk"],
        det_weight=tuple(cfg.train.loss_weight[:4])))
    res = {}
    for freeze in (False, True):
        o = cfg.train.optim
        tx = jpl.make_frozen_optimizer(
            make_optimizer(lr=o.lr, optim=o.classname,
                           weight_decay=o.weight_decay),
            v["params"], {"detector": freeze, "listener": False})
        state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"],
                           opt_state=tx.init(v["params"]), tx=tx)
        with jax_draws(case["masks"], case["copy_paste"],
                       prefix=("listener",)):
            new, metrics = step(state, jbatch, jlang, jax.random.key(0))
        res[freeze] = dict(
            metrics={k: float(x) for k, x in metrics.items()},
            grads={k: a / (1 - B1) for k, a in _flat(
                _adam_mu(new.opt_state)).items()},
            params=_flat(jax.tree.map(np.asarray, new.params)),
            batch_stats=_flat(jax.tree.map(np.asarray, new.batch_stats)))
    return res


def _port_side(s, freeze, variables=None):
    cfg, case = s["cfg"], s["case"]
    model = params.load_pipeline(variables or case["variables"], cfg,
                                 s["vocab"], device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tpl.freeze_submodules(model, {"detector": freeze})
    o = cfg.train.optim
    state = create_train_state(model, lr=o.lr, optim=o.classname,
                               weight_decay=o.weight_decay)
    _, metrics = tpl.listener_train_step(
        state, batch_to_torch(case["batch"], "cpu"),
        tpl.lang_rows(case["lang"], s["emb"], "cpu"),
        chunk_size=case["chunk"],
        loss_weight=tuple(cfg.train.loss_weight[:4]),
        **listener_step_kwargs(case, "cpu"))
    return dict(model=model, before=before,
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def results(setup):
    with pytest.MonkeyPatch.context() as mp:
        jax_res = _jax_side(setup, mp)
    moved = dict(setup["case"]["variables"])
    moved["params"] = ulp_moved(moved["params"], np.random.default_rng(0))
    return dict(jax=jax_res,
                port={f: _port_side(setup, f) for f in (False, True)},
                ulp={f: _port_side(setup, f, moved) for f in (False, True)})


def _grads(model):
    return params.flatten(params.state_dict_to_flax(model, {
        n: p.grad for n, p in model.named_parameters()
        if p.grad is not None})["params"])


CASES = pytest.mark.parametrize("freeze", [False, True],
                                ids=["trained_detector", "frozen_detector"])


@CASES
def test_metrics(results, freeze):
    want, got = results["jax"][freeze]["metrics"], results["port"][freeze][
        "metrics"]
    assert set(got) == set(want) == METRICS
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
    assert got["grounding_loss"] > 0 and got["lobjcls_loss"] > 0
    assert got["detect_loss"] > 0 and got["best_ious_mean"] > 0


@CASES
def test_gradients(results, freeze):
    want = results["jax"][freeze]["grads"]
    got = _grads(results["port"][freeze]["model"])
    moved = _grads(results["ulp"][freeze]["model"])
    assert {k.split(".")[0] for k in got} == (
        {"listener"} if freeze else {"detector", "listener"})
    # elements off by more than the tolerance must lie within the port's
    # own f32 noise (its gradient on weights moved by one ulp)
    bad, _ = grad_mismatches(got, want, {
        k: np.abs(g - moved[k]) for k, g in got.items()},
        ulp_factor=ULP_FACTOR, zero_grads=BN_FED_BIASES)
    assert bad == []
    # every listener parameter but the biases the BN takes out is reached
    zero = {k for k, w in want.items() if not np.abs(w).max() > 0}
    assert not {k for k in zero if k.startswith("listener.")
                and not k.endswith(".bias")}


@CASES
def test_bn_statistics_and_frozen_parameters(setup, results, freeze):
    jres, port = results["jax"][freeze], results["port"][freeze]
    got = params.flatten(params.state_dict_to_flax(port["model"])[
        "batch_stats"])
    want = jres["batch_stats"]
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == {"detector", "listener"}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    sd, before = port["model"].state_dict(), port["before"]
    stats = {k for k in sd if k.endswith((".mean", ".var"))}
    assert not any(torch.equal(sd[k], before[k]) for k in stats)
    det = [k for k in sd if k.startswith("detector.") and k not in stats]
    assert [k for k in det if torch.equal(sd[k], before[k])] == (
        det if freeze else [])
    v0 = params.flatten(setup["case"]["variables"]["params"])
    jdet = [k for k in jres["params"] if k.startswith("detector.")]
    assert [k for k in jdet if np.array_equal(jres["params"][k], v0[k])] == (
        jdet if freeze else [])
