"""One mode-3 train step of the port (``train/pipeline.py``
``joint_rl_train_step``) against the JAX package's two-phase step
(``d3net_tpu.train.pipeline_loop.sample_caption_ids``, the host reward,
then ``joint_rl_train_step(rollout=, caption_scores=)``) on the CPU, on
conf/debug/tiny_joint.yaml with the published beam (3 in 3 groups, lambda
0.5, top 3), 4 caption references, the XE anchor at 0.2 and
``data.min_iou_threshold`` 0 (``checks.joint_parity_config``), the
detector trained.

Both sides start from the same variables (numpy-initialised, nonzero
biases, BN statistics and PReLU slopes) and get the same two streams
(speaker and listener batches with their rows) and the same draws: on the
JAX side ``jax.random.uniform``, ``permutation`` and ``gumbel`` are patched
(both detectors take the jitter and permutation, the target selection the
Gumbel draw), and each train-mode listener's dropout keep masks are handed
over by module path and shape, with the shared copy-paste draw
(``jax_draws_by_shape``); the port draws the masks once from a seeded
generator (``checks.joint_step_case``). The optimizer is the config's
AdamW; the JAX gradients are read from Adam's first moment.

Tolerances: rollout ids, target ids and the host scores equal (the
scores rtol 1e-6: the same float64 host code); sampled log-probs rtol
1e-4 / atol 1e-5; the metrics rtol 1e-4; gradients rtol 1e-3 / atol 1e-6
under tests/test_torch_listener_train_step.py's rules (the BN-fed biases
have a zero gradient; an element outside the tolerance passes only within
4x its one-ulp movement, under 1% of a tensor), where an element's one-ulp
movement is the larger of the two sides' own: both steps run again on
weights moved by one ulp, on the same rollout and scores, and JAX's moves
4.7x more than the port's at an element of the listener's feature MLP;
new BN statistics rtol 1e-4 / atol 1e-5.

The detector frozen on GT proposals (``data.requires_gt_mask``) is the
same step with another detector path, held to JAX in a file of its own
(tests/test_torch_joint_gt_proposals.py), as a JAX compile of it would
double this file's time.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import (
    BN_FED_BIASES, grad_mismatches, joint_parity_config, joint_step_case,
    joint_step_inputs, joint_step_kw, joint_step_kwargs, ulp_moved,
)
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.trainer import create_train_state
from test_torch_speaker_train_step import _adam_mu, _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_joint.yaml")
B1 = 0.9
ULP_FACTOR = 4.0
METRICS = {"cap_rwd", "loc_rwd", "ttl_rwd", "cap_acc", "cap_xe_loss",
           "loss", "spk_detect_loss", "lis_detect_loss", "captioning_loss",
           "spk_ref_loss", "lis_ref_loss", "lang_acc", "lis_ref_acc_mean",
           "lis_ref_iou_mean", "lis_best_ious_mean", "lis_ref_iou_rate_0.25",
           "lis_ref_iou_rate_0.5"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_draws_by_shape(masks, copy_paste, prefix=("listener",)):
    """Inside the block, each Flax ``Dropout`` at path ``prefix + p`` takes
    the mask of ``masks[".".join(p)]`` (a list) whose shape is its input's,
    and ``_copy_paste`` takes ``copy_paste`` (apply, gumbel)."""
    real_b, real_g = jax.random.bernoulli, jax.random.gumbel

    def interceptor(next_fun, args, kwargs, context):
        mod, name = context.module, context.method_name
        key = ".".join(mod.path[len(prefix):])
        if isinstance(mod, fnn.Dropout) and name == "__call__" \
                and key in masks:
            assert tuple(mod.path[:len(prefix)]) == tuple(prefix), mod.path
            mask, = [m for m in masks[key] if m.shape == args[0].shape]
            jax.random.bernoulli = \
                lambda key, p=0.5, shape=None: jnp.asarray(mask)
        elif name == "_copy_paste":
            apply, g = (jnp.asarray(a) for a in copy_paste)
            jax.random.bernoulli = lambda key, p=0.5, shape=None: apply
            jax.random.gumbel = lambda key, shape=(), *a, **k: g
        try:
            return next_fun(*args, **kwargs)
        finally:
            jax.random.bernoulli, jax.random.gumbel = real_b, real_g

    with fnn.intercept_methods(interceptor):
        yield


def masks_by_path(case):
    """The case's two listeners' keep masks by path, one of each shape."""
    out = {}
    for s in ("spk_masks", "lis_masks"):
        for p, m in case[s].items():
            if not any(x.shape == m.shape for x in out.setdefault(p, [])):
                out[p].append(m)
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = joint_parity_config(tcfg.load(TINY))
    vocab, emb = tpl.build_vocab(cfg)
    return dict(cfg=cfg, vocab=vocab, emb=emb,
                case=joint_step_case(cfg, vocab, emb, seed=0))


def jax_joint_step(cfg, vocab, emb, case, mp, variables, moved=None,
                   freeze=False):
    """The JAX package's two-phase step on ``case``: (rollout, host scores,
    new state, metrics, and with ``moved`` the gradients of the same step,
    on the same rollout and scores, from the variables ``moved``); with
    ``freeze`` the optimizer masks the detector."""
    from d3net_tpu.data.collate import build_batch
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train import pipeline_loop as jpl
    from d3net_tpu.train.trainer import TrainState, make_optimizer

    model = jpl.pipeline_from_cfg(cfg, vocab)
    spec = jloop.spec_from_cfg(cfg)
    streams = [(jax.tree.map(jnp.asarray, build_batch(case[s][1], spec)),
                jpl.lang_rows(case[s][2], emb)) for s in ("spk", "lis")]
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(case["jitter"]))
    mp.setattr(jax.random, "permutation",
               lambda key, x, *a, **k: jnp.asarray(case["perm"], jnp.int32))
    mp.setattr(jax.random, "gumbel",
               lambda key, shape, *a, **k: jnp.asarray(case["gumbel"]))
    o, t = cfg.train.optim, cfg.train

    def state_of(variables):
        v = jax.tree.map(jnp.asarray, variables)
        tx = jpl.make_frozen_optimizer(
            make_optimizer(lr=o.lr, optim=o.classname,
                           weight_decay=o.weight_decay),
            v["params"], {"detector": freeze})
        return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), tx=tx)

    state = state_of(variables)
    kw = dict(chunk_size=case["chunk"], beam_size=int(t.beam_size),
              sample_topn=int(t.sample_topn))
    rollout = jax.jit(functools.partial(jpl.sample_caption_ids, model, **kw))(
        state, *streams[0], jax.random.key(0))
    reward_fn = jpl.make_caption_reward_fn(vocab, t.caption_reward_weight,
                                           0.0)
    topn, lang = kw["sample_topn"], streams[0][1]
    n = lang["lang_ids"].shape[0]
    gt = np.repeat(np.asarray(lang["gt_refs"]), topn, axis=0)
    ann = np.repeat(np.asarray(lang["annotated"]), topn, axis=0)
    scores = (reward_fn(np.asarray(rollout["sampled_cap"]).reshape(
        n * topn, -1), gt, ann), reward_fn(np.repeat(np.asarray(
            rollout["baseline_cap"]), topn, axis=0), gt, ann))
    step = jax.jit(functools.partial(
        jpl.joint_rl_train_step, model, reward_fn,
        det_weight=tuple(t.loss_weight[:4]),
        ref_reward_weight=t.ref_reward_weight,
        lang_reward_weight=t.lang_reward_weight,
        listener_reward_weight=t.listener_reward_weight,
        caption_reward_weight=t.caption_reward_weight,
        xe_weight=float(t.rl_xe_weight), **kw))
    with jax_draws_by_shape(masks_by_path(case), case["copy_paste"]):
        def run(state):
            return step(state, *streams[0], *streams[1], jax.random.key(0),
                        caption_scores=tuple(jnp.asarray(x) for x in scores),
                        rollout={k: rollout[k] for k in tpl.ROLLOUT_KEYS})
        new, metrics = run(state)
        grads_moved = None if moved is None else jax_grads(
            run(state_of(moved))[0])
    return (jax.tree.map(np.asarray, rollout), scores, new,
            {k: float(x) for k, x in metrics.items()}, grads_moved)


def jax_grads(state):
    """The gradients of a first AdamW step, from its first moment."""
    return {k: a / (1 - B1) for k, a in _flat(_adam_mu(state.opt_state)
                                               ).items()}


def port_joint_step(cfg, vocab, emb, case, variables, rollout=None,
                    freeze=False):
    model = params.load_pipeline(variables, cfg, vocab, device="cpu")
    tpl.freeze_submodules(model, {"detector": freeze})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    o = cfg.train.optim
    state = create_train_state(model, lr=o.lr, optim=o.classname,
                               weight_decay=o.weight_decay)
    _, metrics, rollout = tpl.joint_rl_train_step(
        state, *joint_step_inputs(case, emb, "cpu"),
        tpl.make_caption_reward_fn(vocab),
        rollout=rollout, **joint_step_kwargs(case, "cpu"),
        **joint_step_kw(cfg))
    return dict(model=model, before=before, rollout=rollout,
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def results(setup):
    from d3net_tpu import config as jcfg

    s = setup
    moved = dict(s["case"]["variables"])
    moved["params"] = ulp_moved(moved["params"], np.random.default_rng(0))
    with pytest.MonkeyPatch.context() as mp:
        jres = jax_joint_step(joint_parity_config(jcfg.load(TINY)),
                              s["vocab"], s["emb"], s["case"], mp,
                              s["case"]["variables"], moved)
    args = (s["cfg"], s["vocab"], s["emb"], s["case"])
    port = port_joint_step(*args, s["case"]["variables"])
    return dict(jax=jres, port=port, ulp=port_joint_step(
        *args, moved, {k: port["rollout"][k] for k in tpl.ROLLOUT_KEYS}))


def _grads(model):
    return params.flatten(params.state_dict_to_flax(model, {
        n: p.grad for n, p in model.named_parameters()
        if p.grad is not None})["params"])


def test_rollout_and_scores(results):
    rollout, scores = results["jax"][:2]
    got = results["port"]["rollout"]
    for k in ("sampled_cap", "baseline_cap", "target_ids"):
        np.testing.assert_array_equal(got[k].numpy(), rollout[k], err_msg=k)
    np.testing.assert_allclose(got["target_ious"].numpy(),
                               rollout["target_ious"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["sampled_logps"].numpy(),
                               rollout["sampled_logps"], rtol=1e-4,
                               atol=1e-5)
    for g, w in zip((got["sampled_scores"], got["baseline_scores"]), scores):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    n, topn, t = got["sampled_cap"].shape
    assert (n, topn, t) == (8, 3, 11) and got["baseline_cap"].shape == (8, 12)
    # the three groups' samples differ, and some captions score
    assert (got["sampled_cap"][:, 0] != got["sampled_cap"][:, 1]).any()
    assert float(got["sampled_scores"].max()) > 0


def test_metrics(results):
    want, got = results["jax"][3], results["port"]["metrics"]
    assert set(got) == set(want) == METRICS
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
    # the RL loss and both streams' losses are live
    assert got["captioning_loss"] != 0 and got["ttl_rwd"] != 0
    assert got["spk_detect_loss"] > 0 and got["lis_detect_loss"] > 0
    assert got["spk_ref_loss"] > 0 and got["lis_ref_loss"] > 0


def test_gradients(results):
    want, jax_moved = jax_grads(results["jax"][2]), results["jax"][4]
    got = _grads(results["port"]["model"])
    moved = _grads(results["ulp"]["model"])
    assert {k.split(".")[0] for k in got} == {"detector", "speaker",
                                              "listener"}
    # each element's f32 noise: the larger of the two sides' movements
    # when every weight moves by one ulp, on the same rollout (JAX's is
    # 4.7x the port's at an element of the listener's feature MLP)
    bad, _ = grad_mismatches(got, want, {
        k: np.maximum(np.abs(g - moved[k]), np.abs(want[k] - jax_moved[k]))
        for k, g in got.items()},
        ulp_factor=ULP_FACTOR, zero_grads=BN_FED_BIASES)
    assert bad == []
    # the RL loss reaches the decoder and the graph, the listener's losses
    # its language encoder
    reached = {k for k, w in want.items() if np.abs(w).max() > 0}
    for prefix in ("speaker.caption.", "speaker.graph.", "listener.lang."):
        assert any(k.startswith(prefix) for k in reached), prefix


def test_bn_statistics(results):
    new = results["jax"][2]
    port = results["port"]
    got = params.flatten(params.state_dict_to_flax(port["model"])[
        "batch_stats"])
    want = _flat(jax.tree.map(np.asarray, new.batch_stats))
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == {"detector", "listener"}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    sd, before = port["model"].state_dict(), port["before"]
    stats = [k for k in sd if k.endswith((".mean", ".var"))]
    assert not any(torch.equal(sd[k], before[k]) for k in stats)
