"""Joint speaker-listener RL as users train it (``train/pipeline.py``
``run_pipeline_training`` and ``run_pipeline_validation`` in mode 3)
against ``d3net_tpu.train.pipeline_loop`` on the CPU, on
conf/debug/tiny_joint.yaml set up by ``checks.joint_parity_config`` (the
published beam, 4 caption references, the XE anchor at 0.2) and monitored
by ``combined``.

- Both loops run 3 steps from the same weights, detector, speaker and
  listener pickles written from numpy-initialised variables, which each
  side loads through its own ``apply_pretrained``. JAX runs its two-phase
  path (``D3NET_RL_TWO_PHASE=1``: rollout, host reward, then the step),
  the one users on an accelerator get. The draws are fixed on both sides
  and the same at every step: ``jax.random.uniform``, ``permutation`` and
  ``gumbel`` patched, the two listeners' dropout masks and the shared
  copy-paste draw handed to JAX by module path and shape
  (tests/test_torch_joint_train_step.py ``jax_draws_by_shape``) and given
  to the port's step as tensors (``checks.joint_step_case``). The
  optimizer is SGD. The train and val records of ``metrics.jsonl`` hold
  the same keys and agree within rtol 1e-4 (``combined`` included); the
  run dir has the JAX layout, with ``ckpt_best/best.json`` by
  ``combined``; a fresh state restored from it equals the run's final
  state bit for bit. The listener stream takes the previous step's batch
  (the current one at step 1).
- ``run_pipeline_validation(mode=3)`` on JAX's final weights: every
  proposal's caption ids and every row's grounding pick equal, caption
  metrics equal, IoUs rtol 1e-4, ``combined`` = ``cider`` +
  ``ref_iou_rate_0.5``.
- The detector frozen on GT proposals (``data.requires_gt_mask``,
  ``model.freeze_detector``), port only (a JAX compile of that step
  would add a third compile-bound file): the proposals are the GT
  instances, the detector's parameters do not move and get no gradient,
  the speaker's and the listener's do, its BN statistics move.
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
    joint_parity_config, joint_step_case, joint_step_inputs, joint_step_kw,
    joint_step_kwargs, randomize,
)
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.trainer import create_train_state
from test_torch_joint_train_step import jax_draws_by_shape, masks_by_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_joint.yaml")
SUBS = ("detector", "speaker", "listener")
LOSS_RTOL = 1e-4


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
    cfg = joint_parity_config(load(TINY))
    cfg.general.output_root = str(root)
    cfg.general.monitor = "val_score/combined"
    cfg.train.optim.classname = "SGD"
    for sub in SUBS:
        setattr(cfg.model, f"pretrained_{sub}", pickles[sub])
    return cfg


class _Recording:
    """Wraps a module's evaluator classes: keeps each scene's captions and
    each grounding ``add``'s masked argmax picks."""

    def __init__(self, module):
        self.captions, self.picks = [], []
        captions, picks = self.captions, self.picks

        class Captions(module.CaptionEvaluator):
            def add_scene(self, scene_id, caps, *a, **k):
                captions.append((scene_id, list(caps)))
                return super().add_scene(scene_id, caps, *a, **k)

        class Grounding(module.GroundingEvaluator):
            def add(self, cluster_ref, pred_corners, pred_mask, *a, **k):
                picks.append(np.where(pred_mask > 0, cluster_ref,
                                      -1e30).argmax(-1))
                return super().add(cluster_ref, pred_corners, pred_mask,
                                   *a, **k)

        self.classes = {"CaptionEvaluator": Captions,
                        "GroundingEvaluator": Grounding}


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
    for sub in SUBS:
        pickles[sub] = str(root / f"init_{sub}.pkl")
        with open(pickles[sub], "wb") as f:
            pickle.dump({"params": variables["params"][sub],
                         "batch_stats": variables["batch_stats"].get(sub, {})},
                        f)
    cfg_t = _loop_cfg(tcfg.load, root, pickles)
    case = joint_step_case(cfg_t, vocab, emb, seed=2)

    mp = pytest.MonkeyPatch()
    mp.setenv("D3NET_RL_TWO_PHASE", "1")
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.asarray(case["jitter"]))
    mp.setattr(jax.random, "permutation",
               lambda key, x, *a, **k: jnp.asarray(case["perm"], jnp.int32))
    mp.setattr(jax.random, "gumbel",
               lambda key, shape, *a, **k: jnp.asarray(case["gumbel"]))
    mp.setitem(sys.modules, "tensorflow", None)   # no TB writer
    real_step = tpl.joint_rl_train_step
    lis_inputs = []

    def step(state, spk_b, spk_l, lis_b, lis_l, reward_fn, generator=None,
             **kw):
        lis_inputs.append((spk_b["point_xyz"], lis_b["point_xyz"]))
        return real_step(state, spk_b, spk_l, lis_b, lis_l, reward_fn,
                         generator, **joint_step_kwargs(case, "cpu"), **kw)

    mp.setattr(tpl, "joint_rl_train_step", step)
    val_fns = []
    real_fns = jpl._ValFns

    def keep_fns(*a, **k):
        val_fns.append(real_fns(*a, **k))
        return val_fns[-1]

    mp.setattr(jpl, "_ValFns", keep_fns)
    jrun, trun = str(root / "jax"), str(root / "torch")
    try:
        assert jpl.use_two_phase_rl()
        with jax_draws_by_shape(masks_by_path(case), case["copy_paste"]):
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
                           val_fns=val_fns[0], lis_inputs=lis_inputs)


def test_run_matches_jax_run_pipeline_training(runs):
    want, got = _records(runs.jrun), _records(runs.trun)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k, v in w.items():
            if not k.endswith("iter_time"):
                np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL,
                                           err_msg=f"step {w['step']} {k}")
    assert all(r["train/captioning_loss"] != 0 for r in got[:3])
    val = got[-1]
    assert {"val/cider", "val/ref_iou_rate_0.5", "val/combined",
            "val/bleu4", "val/iou_mean"} <= set(val)
    assert val["val/combined"] == val["val/cider"] + val[
        "val/ref_iou_rate_0.5"]
    # the listener stream: the current batch at step 1, then the previous
    (s1, l1), (s2, l2), (s3, l3) = runs.lis_inputs
    assert l1 is s1 and l2 is s1 and l3 is s2
    trun = runs.trun
    for name in ("config.yaml", "run_meta.json", "caption_diag.json",
                 "ckpt/3/state.pt", "ckpt_best/3/state.pt"):
        assert os.path.exists(os.path.join(trun, name)), name
    best = json.load(open(os.path.join(trun, "ckpt_best", "best.json")))
    assert best == {"step": 3, "value": val["val/combined"],
                    "monitor": "combined", "mode": "max"}

    # resume: a fresh state restored from the run dir is the final state
    cfg = runs.cfg
    model = tpl.pipeline_from_cfg(cfg, runs.vocab)
    o = cfg.train.optim
    fresh = create_train_state(model, lr=o.lr, optim=o.classname,
                               weight_decay=o.weight_decay,
                               momentum=o.momentum,
                               step_epoch=cfg.train.step_epoch,
                               multiplier=cfg.train.multiplier)
    assert tloop.Checkpointer(trun, "combined", "max").restore_last(
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

    jc = joint_parity_config(jcfg.load(TINY))
    _, jval = jloop.make_dataloaders(jc, jloop.spec_from_cfg(jc, infer=True),
                                     return_scenes=True)
    jrec = _Recording(jpl)
    for name, cls in jrec.classes.items():
        monkeypatch.setattr(jpl, name, cls)
    want = jpl.run_pipeline_validation(
        jc, jpl.pipeline_from_cfg(jc, runs.vocab),
        SimpleNamespace(**runs.jvars), jval, runs.vocab, runs.emb,
        int(jc.data.num_des_per_scene), make_mesh(jax.devices()[:1]), 3,
        val_fns=runs.val_fns)

    cfg = joint_parity_config(tcfg.load(TINY))
    model = params.load_pipeline(runs.jvars, cfg, runs.vocab, device="cpu")
    trec = _Recording(tpl)
    for name, cls in trec.classes.items():
        monkeypatch.setattr(tpl, name, cls)
    got = tpl.run_pipeline_validation(
        cfg, model, tloop.make_val_loader(cfg, tloop.spec_from_cfg(cfg),
                                          return_scenes=True),
        runs.vocab, runs.emb, mode=3)
    assert trec.captions == jrec.captions and len(trec.captions) == 2
    assert len(trec.picks) == len(jrec.picks) == 1     # 2 val scenes, B=2
    for g, w in zip(trec.picks, jrec.picks):
        np.testing.assert_array_equal(g, w)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4 if "iou" in k
                                   or k == "combined" else 1e-12, err_msg=k)
    assert got["combined"] == got["cider"] + got["ref_iou_rate_0.5"]


def test_frozen_detector_on_gt_proposals():
    cfg = joint_parity_config(tcfg.load(TINY))
    cfg.data.requires_gt_mask = True
    cfg.model.freeze_detector = True
    vocab, emb = tpl.build_vocab(cfg)
    case = joint_step_case(cfg, vocab, emb, seed=3)
    model = params.load_pipeline(case["variables"], cfg, vocab, device="cpu")
    tpl.freeze_submodules(model, {"detector": True})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, lr=cfg.train.optim.lr,
                               optim=cfg.train.optim.classname,
                               weight_decay=cfg.train.optim.weight_decay)
    inputs = joint_step_inputs(case, emb, "cpu")
    with torch.no_grad():
        props = params.load_pipeline(case["variables"], cfg, vocab,
                                     device="cpu").run_detector(
            inputs[0], train=True,
            **{k: v for k, v in joint_step_kwargs(case, "cpu").items()
               if k in ("jitter_u", "proposal_perm")})
    _, metrics, rollout = tpl.joint_rl_train_step(
        state, *inputs, tpl.make_caption_reward_fn(vocab),
        **joint_step_kwargs(case, "cpu"), **joint_step_kw(cfg))
    # the proposals are the scenes' GT instances
    n_props = props["proposal_batch_mask"].sum(1).numpy()
    np.testing.assert_array_equal(n_props,
                                  case["spk"][0]["gt_box_mask"].sum(1))
    assert (n_props > 0).all()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["captioning_loss"]) != 0
    sd = model.state_dict()
    stats = {k for k in sd if k.endswith((".mean", ".var"))}
    det = [k for k in sd if k.startswith("detector.") and k not in stats]
    assert det and all(torch.equal(sd[k], before[k]) for k in det)
    assert all(p.grad is None for p in model.detector.parameters())
    for sub in ("speaker", "listener"):
        assert any(p.grad is not None and bool(p.grad.abs().max() > 0)
                   for p in getattr(model, sub).parameters()), sub
    assert any(not torch.equal(sd[k], before[k]) for k in stats
               if k.startswith("detector."))
    assert rollout["sampled_cap"].shape[1] == cfg.train.sample_topn
