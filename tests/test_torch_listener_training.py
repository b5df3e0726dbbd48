"""The listener's stage as users run it (``train/pipeline.py``
``run_pipeline_training`` and ``run_pipeline_validation`` in mode 2, the
eval CLI's ``--task grounding``) against ``d3net_tpu.train.pipeline_loop``
on the CPU, on conf/debug/tiny_grounding.yaml.

- Both loops run 3 steps from the same weights, a detector pickle and a
  listener pickle written from numpy-initialised variables (drawn biases,
  BN statistics and PReLU slopes), which each side loads through its own
  ``apply_pretrained``. The draws are fixed on both sides:
  ``jax.random.uniform`` and ``permutation`` patched, the listener's
  dropout masks and copy-paste draws handed to JAX by module path
  (``tests/test_torch_match.py`` ``jax_draws``) and given to the port's
  step as tensors (``checks.listener_step_case``). The optimizer is SGD
  (AdamW's first steps move a noise-sized gradient by ±lr). The train and
  val records of ``metrics.jsonl`` hold the same keys and agree within
  rtol 1e-4; the run dir has the JAX layout, with ``ckpt_best/best.json``
  by ``ref_iou_rate_0.5``; a fresh state restored from it equals the
  run's final state bit for bit.
- ``run_pipeline_validation(mode=2)`` on JAX's final weights: the picked
  proposal of every description row equal, accuracies equal, IoU means
  rtol 1e-4.
- The eval CLI (``--task grounding --cpu``) on a run dir holding those
  weights as a port checkpoint writes the same numbers, averaged over
  ``eval.repeat`` runs, into ``eval_grounding.json`` with its checkpoint.
"""

import json
import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import (
    listener_step_case, listener_step_kwargs, randomize,
)
from d3net_tpu_torch.scripts import eval as eval_cli
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.trainer import create_train_state
from test_torch_match import jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_grounding.yaml")
LOSS_RTOL = 1e-4
IOU_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _loop_cfg(load, root, pickles):
    cfg = load(TINY)
    cfg.general.output_root = str(root)
    cfg.train.optim.classname = "SGD"
    cfg.model.pretrained_detector = pickles["detector"]
    cfg.model.pretrained_listener = pickles["listener"]
    return cfg


class _Recording:
    """Wraps an evaluator class: keeps each ``add``'s masked argmax picks."""

    def __init__(self, module):
        self.picks, real = [], module.GroundingEvaluator
        picks = self.picks

        class Evaluator(real):
            def add(self, cluster_ref, pred_corners, pred_mask, *a, **k):
                picks.append(np.where(pred_mask > 0, cluster_ref,
                                      -1e30).argmax(-1))
                return super().add(cluster_ref, pred_corners, pred_mask,
                                   *a, **k)
        self.cls = Evaluator


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both loops' run dirs, the port's final state, JAX's final variables
    and validation functions."""
    import jax
    import jax.numpy as jnp
    from d3net_tpu import config as jcfg
    from d3net_tpu.train import pipeline_loop as jpl

    root = tmp_path_factory.mktemp("loops")
    cfg0 = tcfg.load(TINY)
    vocab, emb = tpl.build_vocab(cfg0)
    variables = randomize(params.init_flax_variables(
        tpl.pipeline_from_cfg(cfg0, vocab), 0), np.random.default_rng(1))
    pickles = {}
    for sub in ("detector", "listener"):
        pickles[sub] = str(root / f"init_{sub}.pkl")
        with open(pickles[sub], "wb") as f:
            pickle.dump({"params": variables["params"][sub],
                         "batch_stats": variables["batch_stats"][sub]}, f)
    cfg_t = _loop_cfg(tcfg.load, root, pickles)
    case = listener_step_case(cfg_t, vocab, emb, seed=2)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(case["jitter"]))
    mp.setattr(jax.random, "permutation",
               lambda key, x, *a, **k: jnp.asarray(case["perm"], jnp.int32))
    mp.setitem(sys.modules, "tensorflow", None)   # no TB writer
    real_step = tpl.listener_train_step

    def step(state, batch, lang, generator=None, **kw):
        return real_step(state, batch, lang, generator,
                         **listener_step_kwargs(case, "cpu"), **kw)

    mp.setattr(tpl, "listener_train_step", step)
    val_fns = []
    real_fns = jpl._ValFns

    def keep_fns(*a, **k):
        val_fns.append(real_fns(*a, **k))
        return val_fns[-1]

    mp.setattr(jpl, "_ValFns", keep_fns)
    jrun, trun = str(root / "jax"), str(root / "torch")
    try:
        with jax_draws(case["masks"], case["copy_paste"],
                       prefix=("listener",)):
            jstate = jpl.run_pipeline_training(
                _loop_cfg(jcfg.load, root, pickles), jrun, max_steps=3)
        state = tpl.run_pipeline_training(cfg_t, trun, max_steps=3,
                                          device="cpu")
    finally:
        mp.undo()
    jvars = {"params": jax.tree.map(np.array, jstate.params),
             "batch_stats": jax.tree.map(np.array, jstate.batch_stats)}
    return SimpleNamespace(cfg=cfg_t, vocab=vocab, emb=emb, jrun=jrun,
                           trun=trun, state=state, jvars=jvars,
                           val_fns=val_fns[0], root=root)


def test_run_matches_jax_run_pipeline_training(runs):
    want, got = _records(runs.jrun), _records(runs.trun)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k, v in w.items():
            if not k.endswith("iter_time"):
                np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL,
                                           err_msg=f"step {w['step']} {k}")
    assert all(r["train/grounding_loss"] > 0 for r in got[:3])
    assert {"val/ref_iou_rate_0.25", "val/ref_iou_rate_0.5", "val/iou_mean",
            "val/unique_acc@0.5"} <= set(got[-1])
    trun = runs.trun
    for name in ("config.yaml", "run_meta.json", "ckpt/3/state.pt",
                 "ckpt_best/3/state.pt"):
        assert os.path.exists(os.path.join(trun, name)), name
    best = json.load(open(os.path.join(trun, "ckpt_best", "best.json")))
    assert best == {"step": 3, "value": got[-1]["val/ref_iou_rate_0.5"],
                    "monitor": "ref_iou_rate_0.5", "mode": "max"}

    # resume: a fresh state restored from the run dir is the final state
    cfg = runs.cfg
    model = tpl.pipeline_from_cfg(cfg, runs.vocab)
    o = cfg.train.optim
    fresh = create_train_state(model, lr=o.lr, optim=o.classname,
                               weight_decay=o.weight_decay,
                               momentum=o.momentum,
                               step_epoch=cfg.train.step_epoch,
                               multiplier=cfg.train.multiplier)
    assert tloop.Checkpointer(trun, "ref_iou_rate_0.5", "max").restore_last(
        fresh) is fresh and fresh.step == runs.state.step == 3
    for (k, a), (k2, b) in zip(runs.state.model.state_dict().items(),
                               fresh.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_validation_matches_jax(runs, monkeypatch):
    import jax
    from d3net_tpu import config as jcfg
    from d3net_tpu.parallel.mesh import make_mesh
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train import pipeline_loop as jpl
    from d3net_tpu_torch.eval import grounding_eval

    jc = jcfg.load(TINY)
    _, jval = jloop.make_dataloaders(jc, jloop.spec_from_cfg(jc, infer=True),
                                     return_scenes=True)
    jrec = _Recording(jpl)
    monkeypatch.setattr(jpl, "GroundingEvaluator", jrec.cls)
    want = jpl.run_pipeline_validation(
        jc, jpl.pipeline_from_cfg(jc, runs.vocab),
        SimpleNamespace(**runs.jvars), jval, runs.vocab, runs.emb,
        int(jc.data.num_des_per_scene), make_mesh(jax.devices()[:1]), 2,
        val_fns=runs.val_fns)

    cfg = tcfg.load(TINY)
    model = params.load_pipeline(runs.jvars, cfg, runs.vocab, device="cpu")
    trec = _Recording(grounding_eval)
    monkeypatch.setattr(tpl, "GroundingEvaluator", trec.cls)
    got = tpl.run_pipeline_validation(
        cfg, model, tloop.make_val_loader(cfg, tloop.spec_from_cfg(cfg),
                                          return_scenes=True),
        runs.vocab, runs.emb, mode=2)
    assert len(trec.picks) == len(jrec.picks) == 1     # 2 val scenes, B=2
    for g, w in zip(trec.picks, jrec.picks):
        np.testing.assert_array_equal(g, w)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=IOU_RTOL if "iou" in k
                                   else 1e-12, err_msg=k)
    assert 0 < got["iou_mean"]


def test_eval_cli_grounding(runs, tmp_path):
    cfg = tcfg.load(TINY)
    cfg.eval.repeat = 2
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    tcfg.save(cfg, os.path.join(run_dir, "config.yaml"))
    model = params.load_pipeline(runs.jvars, cfg, runs.vocab, device="cpu")
    want = tpl.run_pipeline_validation(
        cfg, model, tloop.make_val_loader(cfg, tloop.spec_from_cfg(cfg),
                                          return_scenes=True),
        runs.vocab, runs.emb, mode=2)
    tloop.Checkpointer(run_dir, "ref_iou_rate_0.5", "max").save(
        7, create_train_state(model), {"ref_iou_rate_0.5": 0.5})
    eval_cli.main(["--folder", run_dir, "--task", "grounding", "--cpu"])
    with open(os.path.join(run_dir, "eval_grounding.json")) as f:
        res = json.load(f)
    assert res.pop("checkpoint") == {"kind": "best", "step": 7}
    assert set(res) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(res[k], v, rtol=1e-6, err_msg=k)
