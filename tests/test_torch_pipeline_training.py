"""The speaker's training as users run it (``train/pipeline.py``
``run_pipeline_training`` mode 1, ``apply_pretrained``,
``scripts/prepare_weights.py``) against ``d3net_tpu.train.pipeline_loop``
on the CPU, on conf/debug/tiny_captioning.yaml.

- Both loops run 3 steps from the same weights: a detector and a speaker
  pickle written from numpy-initialised variables, which each side loads
  through its own ``apply_pretrained``. The draws are fixed on both sides
  (``jax.random.uniform``, ``permutation`` and ``gumbel`` patched; the
  port's step given the same tensors), the optimizer is SGD (AdamW's first
  steps move a noise-sized gradient by ±lr: ROADMAP.md §C), and
  ``data.min_iou_threshold`` is 0 so the caption loss is not 0. The train
  and val records of ``metrics.jsonl`` hold the same keys and agree within
  rtol 1e-4; the run dir has the JAX layout, with ``ckpt_best/best.json``
  by cider; a fresh state restored from it equals the run's final state
  bit for bit.
- The pretrained handoff is exact both ways: the port's ``prepare_weights``
  output passes JAX's ``apply_pretrained`` (a pipeline run and a
  detector-only run), and a JAX-layout pickle with legacy U-Net block names
  passes the port's. A missing pretrained file raises.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.scripts import prepare_weights
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_captioning.yaml")
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


def _variables(cfg, seed=0):
    vocab, _ = tpl.build_vocab(cfg)
    return params.init_flax_variables(tpl.pipeline_from_cfg(cfg, vocab), seed)


def _write_pickles(variables, root, tag="init"):
    """JAX-layout pickles of each submodule of ``variables``."""
    os.makedirs(root, exist_ok=True)
    paths = {}
    for sub in variables["params"]:
        paths[sub] = os.path.join(root, f"{tag}_{sub}.pkl")
        with open(paths[sub], "wb") as f:
            pickle.dump({"params": variables["params"][sub],
                         "batch_stats": variables["batch_stats"].get(sub, {})},
                        f)
    return paths


def _loop_cfg(load, root, pickles):
    cfg = load(TINY)
    cfg.general.output_root = str(root)
    cfg.train.optim.classname = "SGD"
    cfg.data.min_iou_threshold = 0.0
    cfg.eval.min_iou_threshold = 0.2
    cfg.model.pretrained_detector = pickles["detector"]
    cfg.model.pretrained_speaker = pickles["speaker"]
    return cfg


def _draws(cfg):
    rng = np.random.default_rng(7)
    b, k = cfg.data.batch_size, cfg.model.max_num_proposal
    return dict(jitter=rng.random((b, 2 * cfg.tpu.clusters_per_pass, 3)).astype(
                    np.float32),
                perm=rng.permutation(k).astype(np.int32),
                gumbel=rng.gumbel(size=(b * cfg.data.num_des_per_scene, k)
                                  ).astype(np.float32))


def _fixed_port_draws(monkeypatch, d):
    real = tpl.speaker_train_step

    def step(state, batch, lang, generator=None, **kw):
        return real(state, batch, lang, generator,
                    jitter_u=torch.from_numpy(d["jitter"]),
                    proposal_perm=torch.from_numpy(d["perm"]).long()[None],
                    gumbel=torch.from_numpy(d["gumbel"]), **kw)

    monkeypatch.setattr(tpl, "speaker_train_step", step)


def _fresh_state(cfg):
    vocab, _ = tpl.build_vocab(cfg)
    model = tpl.pipeline_from_cfg(cfg, vocab)
    o = cfg.train.optim
    return create_train_state(model, lr=o.lr, optim=o.classname,
                              weight_decay=o.weight_decay,
                              momentum=o.momentum, step_epoch=cfg.train.step_epoch,
                              multiplier=cfg.train.multiplier)


def test_run_matches_jax_run_pipeline_training(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from d3net_tpu import config as jcfg
    from d3net_tpu.train import pipeline_loop as jpl

    pickles = _write_pickles(_variables(tcfg.load(TINY)), tmp_path / "pre")
    cfg_t = _loop_cfg(tcfg.load, tmp_path, pickles)
    d = _draws(cfg_t)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(d["jitter"]))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(d["perm"]))
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, *a, **k: jnp.asarray(d["gumbel"]))
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # no TB writer
    _fixed_port_draws(monkeypatch, d)

    jrun, trun = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpl.run_pipeline_training(_loop_cfg(jcfg.load, tmp_path, pickles), jrun,
                              max_steps=3)
    state = tpl.run_pipeline_training(cfg_t, trun, max_steps=3, device="cpu")

    want, got = _records(jrun), _records(trun)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k, v in w.items():
            if not k.endswith("iter_time"):
                np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL,
                                           err_msg=f"step {w['step']} {k}")
    assert all(r["train/captioning_loss"] > 0 for r in got[:3])
    assert {"val/cider", "val/bleu4", "val/rouge"} <= set(got[-1])
    for name in ("config.yaml", "run_meta.json", "caption_diag.json",
                 "ckpt/3/state.pt", "ckpt_best/3/state.pt"):
        assert os.path.exists(os.path.join(trun, name)), name
    best = json.load(open(os.path.join(trun, "ckpt_best", "best.json")))
    assert best == {"step": 3, "value": got[-1]["val/cider"],
                    "monitor": "cider", "mode": "max"}
    assert tcfg.load(os.path.join(trun, "config.yaml")).to_dict() \
        == cfg_t.to_dict()

    # resume: a fresh state restored from the run dir is the final state
    fresh = _fresh_state(cfg_t)
    assert tloop.Checkpointer(trun, "cider", "max").restore_last(fresh) \
        is fresh and fresh.step == state.step == 3
    for (k, a), (k2, b) in zip(state.model.state_dict().items(),
                               fresh.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    want_o, got_o = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want_o["param_groups"] == got_o["param_groups"]
    assert want_o["state"] and want_o["state"].keys() == got_o["state"].keys()
    for i, st in want_o["state"].items():
        for k, v in st.items():
            assert torch.equal(v, got_o["state"][i][k]), (i, k)
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()


def _port_run_dir(root, cfg, model, monitor="cider"):
    os.makedirs(root, exist_ok=True)
    tcfg.save(cfg, os.path.join(root, "config.yaml"))
    tloop.Checkpointer(root, monitor, "max").save(
        4, create_train_state(model), {monitor: 0.5})
    return root


@pytest.mark.parametrize("run", ["pipeline", "detector_only"])
def test_prepare_weights_output_passes_jax_apply_pretrained(run, tmp_path):
    from d3net_tpu import config as jcfg
    from d3net_tpu.train import pipeline_loop as jpl

    cfg = tcfg.load(TINY)
    vocab, _ = tpl.build_vocab(cfg)
    variables = _variables(cfg, seed=3)
    model = params.load_pipeline(variables, cfg, vocab, device="cpu")
    if run == "pipeline":
        subs = ("detector", "speaker")
        _port_run_dir(str(tmp_path / "run"), cfg, model)
    else:
        subs = ("detector",)
        _port_run_dir(str(tmp_path / "run"), cfg, model.detector)
    out = str(tmp_path / "pretrained")
    prepare_weights.main(["--folder", str(tmp_path / "run"), "--name", "t",
                          "--out", out])
    assert sorted(os.listdir(out)) == [f"t_{s}.pkl" for s in subs]

    jc = jcfg.load(TINY)
    for s in subs:
        with open(os.path.join(out, f"t_{s}.pkl"), "rb") as f:
            payload = pickle.load(f)
        leaves = params.flatten(payload)
        assert all(type(a) is np.ndarray for a in leaves.values())
        jc.model[f"pretrained_{s}"] = os.path.join(out, f"t_{s}.pkl")
    zeros = {c: {s: {} for s in subs} for c in ("params", "batch_stats")}
    got_p, got_bs = jpl.apply_pretrained(zeros["params"], zeros["batch_stats"],
                                         jc)
    for s in subs:
        for coll, got in (("params", got_p), ("batch_stats", got_bs)):
            want = params.flatten(variables[coll].get(s, {}))
            have = params.flatten(got.get(s, {}))
            assert set(have) == set(want), (s, coll)
            for k, v in want.items():
                assert have[k].dtype == v.dtype and np.array_equal(have[k], v)


def _legacy_names(tree):
    """The U-Net's top scope under the Flax auto names of older JAX
    artifacts: blk0, blk1, tail0, tail1 -> ResidualBlock_0..3."""
    unet = dict(tree["unet"])
    for i, name in enumerate(("blk0", "blk1", "tail0", "tail1")):
        unet[f"ResidualBlock_{i}"] = unet.pop(name)
    return {**tree, "unet": unet}


def test_jax_layout_pickle_passes_port_apply_pretrained(tmp_path):
    cfg = tcfg.load(TINY)
    variables = _variables(cfg, seed=4)
    det = {"params": _legacy_names(variables["params"]["detector"]),
           "batch_stats": _legacy_names(variables["batch_stats"]["detector"])}
    assert "ResidualBlock_2" in det["params"]["unet"]
    path = str(tmp_path / "legacy_detector.pkl")
    with open(path, "wb") as f:
        pickle.dump(det, f)
    cfg.model.pretrained_detector = path
    vocab, _ = tpl.build_vocab(cfg)
    model = tpl.pipeline_from_cfg(cfg, vocab)
    speaker_before = {k: v.clone() for k, v in
                      model.speaker.state_dict().items()}
    tpl.apply_pretrained(model, cfg)
    got = params.state_dict_to_flax(model.detector)
    for coll in ("params", "batch_stats"):
        want = params.flatten(variables[coll]["detector"])
        have = params.flatten(got[coll])
        assert set(have) == set(want)
        for k, v in want.items():
            assert np.array_equal(have[k], v), k
    for k, v in model.speaker.state_dict().items():
        assert torch.equal(v, speaker_before[k]), k

    # a payload without BN statistics keeps the model's
    with open(path, "wb") as f:
        pickle.dump({"params": det["params"], "batch_stats": {}}, f)
    tpl.apply_pretrained(model, cfg)
    cfg.model.pretrained_detector = str(tmp_path / "missing.pkl")
    with pytest.raises(FileNotFoundError):
        tpl.apply_pretrained(model, cfg)
    cfg.model.pretrained_detector = None
    cfg.model.pretrained_listener = path
    with pytest.raises(ValueError, match="listener"):
        tpl.apply_pretrained(model, cfg)
