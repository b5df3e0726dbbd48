"""A pipeline run of the JAX package with a frozen submodule, carried onto
the port on the CPU.

A JAX ``TrainState`` of conf/debug/tiny_joint.yaml with
``model.freeze_detector``: the variables from the port's
``params.init_flax_variables`` (no JAX model compile), JAX's
``make_frozen_optimizer`` over ``make_optimizer`` (an optax
multi_transform whose ``freeze`` label covers the detector's leaves), one
``tx.update``/``apply_updates`` of seeded gradients, saved by JAX's
``Checkpointer``; then ``scripts/export_jax_run.py`` (its template from
the pipeline loop's builders) and ``import_jax_run``:

- the trainable moments equal optax's exactly, and the frozen parameters
  (the detector's) have no optimizer state;
- a port step (``run_pipeline_training`` resumed for one step) moves the
  speaker and the listener and leaves every detector parameter as it was,
  bit for bit;
- an archive of another model (its config's pipeline has no listener)
  raises, as do labels that freeze another submodule than the config and
  an optax state whose frozen leaves are not the model's frozen ones;
- a run of a TPU conv tiling (``tpu.conv_impl: colres``) imports as the
  gather layout, which ``run_meta.json`` records beside the one asked for;
- the import CLI without ``--cpu`` raises where there is no GPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import jax_run, params
from d3net_tpu_torch.scripts import import_jax_run
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train import pipeline as tpipe
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_JOINT = os.path.join(ROOT, "conf", "debug", "tiny_joint.yaml")
TINY_CAPTIONING = os.path.join(ROOT, "conf", "debug", "tiny_captioning.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frozen_run(tmp_path_factory):
    """(JAX run dir, its archive, the JAX state saved) of a frozen-detector
    joint run after one update."""
    import jax
    import jax.numpy as jnp
    from d3net_tpu import config as jcfg
    from d3net_tpu.train.loop import Checkpointer
    from d3net_tpu.train.pipeline_loop import make_frozen_optimizer
    from d3net_tpu.train.trainer import TrainState, make_optimizer
    from scripts import export_jax_run

    tmp = tmp_path_factory.mktemp("frozen")
    cfg = jcfg.load(TINY_JOINT)
    cfg.model.freeze_detector = True
    cfg.general.output_root = str(tmp)
    run = str(tmp / "jax")
    os.makedirs(run)
    jcfg.save(cfg, os.path.join(run, "config.yaml"))
    tcfg_ = tcfg.load(os.path.join(run, "config.yaml"))
    model = tpipe.pipeline_from_cfg(tcfg_, tpipe.build_vocab(tcfg_)[0])
    v = jax.tree.map(jnp.asarray, params.init_flax_variables(model, 3))
    o = cfg.train.optim
    tx = make_frozen_optimizer(
        make_optimizer(lr=o.lr, optim=o.classname,
                       weight_decay=o.weight_decay,
                       step_epoch=cfg.train.step_epoch,
                       multiplier=cfg.train.multiplier, steps_per_epoch=4),
        v["params"], {"detector": True})
    st = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    batch_stats=v["batch_stats"],
                    opt_state=tx.init(v["params"]), tx=tx)
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), st.params)
    st = jax.jit(lambda st, g: st.apply_gradients(g, st.batch_stats))(st, g)
    Checkpointer(run, "ref_iou_rate_0.5", "max").save(
        1, st, {"ref_iou_rate_0.5": 0.5})
    npz, _ = export_jax_run.export_run(run, str(tmp / "frozen.npz"))
    return run, npz, st


def test_frozen_submodule_imports_and_stays_frozen(frozen_run, tmp_path,
                                                   monkeypatch):
    _, npz, want = frozen_run
    arc = jax_run.read_archive(npz)
    assert arc.meta["labels"] == {"detector": "freeze", "speaker": "train",
                                  "listener": "train"}
    prun = str(tmp_path / "port")
    res = import_jax_run.import_run(npz, prun, "cpu")
    assert res["loop"] == "pipeline" and res["steps"]["last"] == 1

    cfg = tcfg.load(os.path.join(prun, "config.yaml"))
    model = import_jax_run.model_of(cfg, "pipeline")
    state = create_train_state(model, **tloop.optimizer_kw(cfg))
    assert tloop.Checkpointer(prun, "none").restore_last(state) is not None
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {n for n, _ in model.named_parameters()
                      if n.startswith("detector.")}
    assert {id(p) for p in state.optimizer.state} == {
        id(p) for p in model.parameters() if p.requires_grad}
    adam = want.opt_state.inner_states["train"].inner_state[0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = params.flatten(params.state_dict_to_flax(model, {
            n: state.optimizer.state[p][key]
            for n, p in model.named_parameters() if p.requires_grad}
        )["params"])
        trained = params.flatten(params._unmasked(tree))
        assert sorted(got) == sorted(trained)
        assert not any(k.startswith("detector.") for k in got)
        for k, w in trained.items():
            np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {1.0}

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    monkeypatch.setenv("D3NET_VAL_SCENES", "2")
    resumed = tpipe.run_pipeline_training(cfg, prun, max_steps=2,
                                          device="cpu")
    assert resumed.step == 2
    after = dict(resumed.model.named_parameters())
    for n, p in before.items():
        moved = not torch.equal(after[n].detach(), p)
        assert moved != n.startswith("detector."), n
    meta = json.load(open(os.path.join(prun, "run_meta.json")))
    assert meta["imported_from"]["step"] == 1


def _rewritten(arc, path, **changes):
    """The archive ``arc`` written again at ``path`` with ``changes`` to its
    JSON fields (the port's numpy writer)."""
    meta = {**arc.meta, **changes}
    steps = {k: {"step": s.step, "params": s.params,
                 "batch_stats": s.batch_stats, "opt_state": s.opt_state}
             for k, s in arc.steps.items()}
    return jax_run.write_archive(
        path, config_yaml=meta["config_yaml"], loop=meta["loop"],
        schedule=meta["schedule"], steps=steps, labels=meta["labels"],
        folder=meta["folder"], best_json=meta["best_json"],
        metrics_jsonl=meta["metrics_jsonl"], run_meta=meta["run_meta"])[0]


def test_mismatched_archives_raise(frozen_run, tmp_path):
    _, npz, _ = frozen_run
    arc = jax_run.read_archive(npz)
    with open(TINY_CAPTIONING) as f:
        other = f.read()
    cases = [
        ({"config_yaml": other, "labels": {"detector": "train",
                                           "speaker": "train"}},
         "unused Flax params leaves"),
        ({"labels": {"detector": "train", "speaker": "freeze",
                     "listener": "train"}}, "labels"),
        ({"schedule": {**arc.meta["schedule"], "transition_steps": 7}},
         "schedule"),
    ]
    for i, (changes, match) in enumerate(cases):
        bad = _rewritten(arc, str(tmp_path / f"bad{i}"), **changes)
        with pytest.raises(ValueError, match=match):
            import_jax_run.import_run(bad, str(tmp_path / f"out{i}"), "cpu")


def test_frozen_leaves_must_be_the_models(frozen_run):
    _, npz, _ = frozen_run
    arc = jax_run.read_archive(npz)
    cfg = tcfg.load(TINY_JOINT)              # its detector is trainable
    model = tpipe.pipeline_from_cfg(cfg, tpipe.build_vocab(cfg)[0])
    state = create_train_state(model, lr=0.002)
    with pytest.raises(ValueError, match="no leaves"):
        params.optax_state_to_torch(arc.steps["last"].opt_state, model,
                                    state.optimizer)
    tpipe.freeze_submodules(model, {"detector": True, "speaker": True})
    state = create_train_state(model, lr=0.002)
    with pytest.raises(ValueError, match="unused leaves"):
        params.optax_state_to_torch(arc.steps["last"].opt_state, model,
                                    state.optimizer)


def test_tpu_conv_layout_imports_as_gather(frozen_run, tmp_path):
    """A run the JAX package trained on a TPU tiling of the sparse conv
    (``tpu.conv_impl: colres``) imports: the weights interchange, the port
    runs the gather layout and records the one asked for."""
    _, npz, _ = frozen_run
    arc = jax_run.read_archive(npz)
    cfg = tcfg.Config(tcfg.parse_yaml(arc.meta["config_yaml"]))
    cfg.tpu["conv_impl"] = "colres"
    colres = _rewritten(arc, str(tmp_path / "colres"),
                        config_yaml=tcfg.dump_yaml(cfg.to_dict()))
    out = str(tmp_path / "port")
    import_jax_run.import_run(colres, out, "cpu")
    meta = json.load(open(os.path.join(out, "run_meta.json")))
    assert (meta["conv_impl"], meta["conv_impl_requested"]) == ("gather",
                                                                "colres")


def test_import_without_cpu_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        import_jax_run.main(["--archive", str(tmp_path / "none.npz"),
                             "--out", str(tmp_path / "out")])
