"""A run of the JAX package carried onto the port on the CPU:
``scripts/export_jax_run.py`` writes the run archive, ``d3net_tpu_torch.
scripts.import_jax_run`` writes the port's run dir from it.

- The detector loop: JAX's ``run_detector_training`` on
  conf/debug/tiny_pointgroup.yaml for 2 steps, SGD and ``prepare_epochs``
  covering every step (no random draw in a step, as in
  tests/test_torch_loop.py), exported and imported. The port's restored
  parameters, BN statistics and momentum buffers equal JAX's restored state
  exactly (compared in the Flax layout), its StepLR stands at the step.
  Then the port's ``scripts.train`` resumes the imported dir to step 3
  beside JAX resuming its own (a copy) to step 3: the step-3 train and val
  records of ``metrics.jsonl`` agree within rtol 1e-4 (the losses and
  ``grad_norm``), the cap counters exactly.
- AdamW at a ``step_epoch`` boundary: a JAX ``TrainState`` of the tiny
  detector after 3 and after 4 optax updates of seeded gradients (a decay
  every 4 updates), saved by JAX's ``Checkpointer`` as the best and the
  last checkpoint. ``exp_avg``, ``exp_avg_sq`` and ``step`` equal optax's
  ``mu``, ``nu`` and ``count`` exactly, the lr equals optax's schedule at
  the count exactly, and one more update with the same gradient on both
  sides agrees within rtol 1e-5 / atol 1e-7 (float order: a few f32 ulps
  of the weights, where a wrong lr moves them by about 1e-3).
- A scan-trainer run dir (``tpu.steps_per_dispatch``) imports, its StepLR
  counting the stack's batches, and the port's scan trainer resumes it.
- The port's numpy writer (``jax_run.optax_state``) builds the structure
  optax's own states have, for each optimizer, with and without frozen
  submodules, and an archive reads back as written.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import jax_run, params
from d3net_tpu_torch.scripts import import_jax_run
from d3net_tpu_torch.scripts import train as train_cli
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_pointgroup.yaml")
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


def _port_state(run_dir, kind="last"):
    """A fresh port train state of the run dir's config, restored from its
    ``kind`` checkpoint (the loop's optimizer)."""
    cfg = tcfg.load(os.path.join(run_dir, "config.yaml"))
    loop = train_cli.loop_of(cfg)
    model = import_jax_run.model_of(cfg, loop)
    state = create_train_state(model, **tloop.optimizer_kw(cfg,
                                                           loop == "scan"))
    ckpt = tloop.Checkpointer(run_dir, "none")
    restore = ckpt.restore_last if kind == "last" else ckpt.restore_best
    assert restore(state) is not None
    return cfg, state


def _opt_flax(state, key):
    """The optimizer's ``key`` state of every parameter in the Flax
    layout."""
    model = state.model
    return params.state_dict_to_flax(model, {
        n: state.optimizer.state[p][key] for n, p in model.named_parameters()
        if p.requires_grad})["params"]


def _assert_trees_equal(got, want, where=""):
    got, want = params.flatten(got), params.flatten(want)
    assert sorted(got) == sorted(want), where
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=f"{where} {k}")


def _tiny_cfg(load, run_root):
    cfg = load(TINY)
    cfg.general.output_root = str(run_root)
    cfg.cluster.prepare_epochs = 10        # no clustering: no random draw
    cfg.train.optim.classname = "SGD"
    return cfg


def _export(folder, out):
    from scripts import export_jax_run

    return export_jax_run.export_run(str(folder), str(out))


def test_detector_run_imports_and_resumes(tmp_path, monkeypatch):
    from d3net_tpu import config as jcfg
    from d3net_tpu.data.collate import CAP_STATS as jax_cap_stats
    from d3net_tpu.train import loop as jloop
    from scripts import export_jax_run

    from d3net_tpu_torch.data.collate import CAP_STATS

    monkeypatch.setitem(sys.modules, "tensorflow", None)   # no TB writer
    jrun, jrun2 = str(tmp_path / "jax"), str(tmp_path / "jax_resumed")
    prun = str(tmp_path / "port")
    jloop.run_detector_training(_tiny_cfg(jcfg.load, tmp_path), jrun,
                                max_steps=2)
    shutil.copytree(jrun, jrun2)
    _, jstates, facts = export_jax_run.restored_states(jrun)
    npz, _ = export_jax_run.write_archive(jrun, str(tmp_path / "run.npz"),
                                          jstates, facts)
    res = import_jax_run.main(["--archive", npz, "--out", prun, "--cpu"])
    assert res["loop"] == "detector" and res["steps"] == {"last": 2,
                                                          "best": 2}

    # the imported state equals JAX's restored state exactly
    want = jstates["last"]
    _, state = _port_state(prun)
    assert state.step == 2
    got = params.state_dict_to_flax(state.model)
    _assert_trees_equal(got["params"], want.params, "params")
    _assert_trees_equal(got["batch_stats"], want.batch_stats, "batch_stats")
    trace = [s for s in want.opt_state if hasattr(s, "trace")][0].trace
    _assert_trees_equal(_opt_flax(state, "momentum_buffer"), trace,
                        "momentum")
    assert state.scheduler.last_epoch == 2
    assert state.optimizer.param_groups[0]["lr"] == 0.002
    meta = json.load(open(os.path.join(prun, "run_meta.json")))
    assert meta["imported_from"]["step"] == 2
    assert meta["imported_from"]["folder"] == os.path.abspath(jrun)
    assert _records(prun) == _records(jrun)

    # both resume to step 3 on the same batches
    monkeypatch.chdir(tmp_path)
    jax_cap_stats.reset()
    CAP_STATS.reset()
    jloop.run_detector_training(
        jcfg.load(os.path.join(jrun2, "config.yaml")), jrun2, max_steps=3)
    train_cli.main(["--config", os.path.join(prun, "config.yaml"),
                    "--folder", prun, "--max_steps", "3", "--cpu"])
    want = [r for r in _records(jrun2) if r["step"] == 3]
    got = [r for r in _records(prun) if r["step"] == 3]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert len(got) == 2 and "train/grad_norm" in got[0]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k.endswith("iter_time"):
                continue
            if "/cap_" in k or k == "step":
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL,
                                           err_msg=f"step 3 {k}")
    meta = json.load(open(os.path.join(prun, "run_meta.json")))
    assert meta["imported_from"]["step"] == 2      # kept through the resume
    assert tloop.StepDir(os.path.join(prun, "ckpt"), 3).all_steps() == [2, 3]


def test_adamw_state_and_lr_at_a_step_epoch_boundary(tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    from d3net_tpu import config as jcfg
    from d3net_tpu.train.loop import Checkpointer
    from d3net_tpu.train.trainer import TrainState, make_optimizer

    cfg = jcfg.load(TINY)
    cfg.train.step_epoch = 1               # a decay every 4 updates
    run = str(tmp_path / "jax")
    os.makedirs(run)
    jcfg.save(cfg, os.path.join(run, "config.yaml"))
    spe = 8 // 2                           # tiny: 8 scenes, batches of 2
    tx = make_optimizer(lr=0.002, optim="AdamW", weight_decay=1e-4,
                        step_epoch=1, multiplier=0.5, steps_per_epoch=spe)
    variables = params.init_flax_variables(
        tloop.detector_from_cfg(tcfg.load(TINY)), 5)
    v = jax.tree.map(jnp.asarray, variables)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    batch_stats=v["batch_stats"],
                    opt_state=tx.init(v["params"]), tx=tx)
    rng = np.random.default_rng(0)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 0.1),
            st.params)

    update = jax.jit(lambda st, g: st.apply_gradients(g, st.batch_stats))
    ckpt = Checkpointer(run, "total_loss", "min")
    states = {}
    for step in range(1, 5):
        st = update(st, grads())
        if step >= 3:
            ckpt.save(step, st, {"total_loss": float(step)})
            states[step] = st
    npz, _ = _export(run, tmp_path / "run.npz")
    import_jax_run.import_run(npz, str(tmp_path / "port"), "cpu")

    sched = optax.exponential_decay(0.002, spe, 0.5, staircase=True)
    for kind, count in (("best", 3), ("last", 4)):
        want = states[count]
        _, state = _port_state(str(tmp_path / "port"), kind)
        adam = want.opt_state[0]
        _assert_trees_equal(_opt_flax(state, "exp_avg"), adam.mu, "mu")
        _assert_trees_equal(_opt_flax(state, "exp_avg_sq"), adam.nu, "nu")
        assert {float(s["step"]) for s in state.optimizer.state.values()} \
            == {float(count)}
        lr = state.optimizer.param_groups[0]["lr"]
        assert np.float32(lr) == np.asarray(sched(count)), kind
        assert lr == (0.002 if count < spe else 0.001)
        # one more update with the same gradient on both sides
        g = grads()
        nxt = update(want, g)
        model = state.model
        tg = params._params_to_tensors(g, model)
        for n, p in model.named_parameters():
            p.grad = tg[n]
        state.optimizer.step()
        state.scheduler.step()
        got = params.flatten(params.state_dict_to_flax(model)["params"])
        for k, w in params.flatten(nxt.params).items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{kind} {k}")
        assert np.float32(state.optimizer.param_groups[0]["lr"]) \
            == np.asarray(sched(count + 1))


def test_scan_trainer_run_dir_imports(tmp_path, monkeypatch):
    import jax
    from d3net_tpu import config as jcfg
    from d3net_tpu.train.loop import Checkpointer
    from scripts import export_jax_run

    cfg = jcfg.load(TINY)
    cfg.general.output_root = str(tmp_path)
    cfg.tpu.steps_per_dispatch = 2
    cfg.tpu.augment_variants = 2
    run = str(tmp_path / "jax")
    os.makedirs(run)
    jcfg.save(cfg, os.path.join(run, "config.yaml"))
    abstract, facts = export_jax_run.template(cfg)
    assert facts["loop"] == "scan"
    assert facts["schedule"]["transition_steps"] == 480 * 2 * 4
    variables = params.init_flax_variables(
        tloop.detector_from_cfg(tcfg.load(TINY)), 7)
    rng = np.random.default_rng(1)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind == "i":
            return np.full(x.shape, 5, x.dtype)
        return (np.abs(rng.standard_normal(x.shape)) * 1e-3).astype(x.dtype)

    st = abstract.replace(
        step=np.int32(5), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=jax.tree.map(fill, abstract.tx.init(variables["params"])))
    Checkpointer(run, "total_loss").save(5, st, {"total_loss": 1.0})
    npz, _ = _export(run, tmp_path / "scan")
    prun = str(tmp_path / "port")
    assert import_jax_run.import_run(npz, prun, "cpu")["loop"] == "scan"
    _, state = _port_state(prun)
    assert state.step == 5 and state.scheduler.last_epoch == 5
    assert state.scheduler.step_size == 480 * 2 * 4
    _assert_trees_equal(params.state_dict_to_flax(state.model)["params"],
                        variables["params"], "params")

    monkeypatch.chdir(tmp_path)
    train_cli.main(["--config", os.path.join(prun, "config.yaml"),
                    "--folder", prun, "--max_steps", "7", "--cpu"])
    recs = _records(prun)
    assert [r["step"] for r in recs] == [7, 7]
    assert all(np.isfinite(v) for r in recs for v in r.values())


def _tiny_tree():
    rng = np.random.default_rng(0)
    return {sub: {"Dense_0": {"kernel": rng.standard_normal((3, 2)).astype(
        np.float32), "bias": np.zeros(2, np.float32)}}
        for sub in ("detector", "speaker")}


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("optim", ["AdamW", "Adam", "SGD"])
def test_numpy_optax_state_has_optax_structure(optim, frozen):
    import jax
    import jax.numpy as jnp
    from d3net_tpu.train.pipeline_loop import make_frozen_optimizer
    from d3net_tpu.train.trainer import make_optimizer

    tree = _tiny_tree()
    tx = make_optimizer(optim=optim, steps_per_epoch=2)
    labels = None
    if frozen:
        labels = {"detector": "freeze", "speaker": "train"}
        tx = make_frozen_optimizer(tx, tree, {"detector": True})
    real = tx.init(jax.tree.map(jnp.asarray, tree))
    moments = [tree, tree] if optim != "SGD" else [tree]
    mine = jax_run.optax_state(optim, 0, moments, labels)
    want_arrays, got_arrays = {}, {}
    want = jax_run.describe(real, want_arrays)
    got = jax_run.describe(mine, got_arrays)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert {k: v.shape for k, v in got_arrays.items()} == {
        k: np.shape(v) for k, v in want_arrays.items()}


def test_archive_reads_back_as_written(tmp_path):
    tree = _tiny_tree()
    labels = {"detector": "freeze", "speaker": "train"}
    opt = jax_run.optax_state("AdamW", 4, [tree, tree], labels)
    st = {"step": 4, "params": tree, "batch_stats": {}, "opt_state": opt}
    npz, js = jax_run.write_archive(
        str(tmp_path / "a"), config_yaml="x: 1\n", loop="pipeline",
        schedule={"optim": "AdamW", "lr": 0.1, "multiplier": 0.5,
                  "transition_steps": 8},
        steps={"last": st, "best": st}, labels=labels,
        best_json={"step": 4, "value": 1.0}, metrics_jsonl="{}\n")
    assert json.load(open(js))["steps"]["best"] == {"step": 4,
                                                    "same_as": "last"}
    arc = jax_run.read_archive(npz)
    assert arc.steps["best"] is arc.steps["last"]
    got = arc.steps["last"]
    assert got.step == 4 and got.batch_stats == {}
    _assert_trees_equal(got.params, tree)
    adam = got.opt_state.inner_states["train"].inner_state[0]
    assert type(adam.mu["detector"]["Dense_0"]["kernel"]).__name__ \
        == "MaskedNode"
    _assert_trees_equal(adam.nu["speaker"], tree["speaker"])
    assert int(adam.count) == 4 and arc.meta["labels"] == labels
    assert arc.sha256 == jax_run.read_archive(js).sha256
    with pytest.raises(ValueError, match="not a d3net run archive"):
        json.dump({"format": "other"}, open(js, "w"))
        jax_run.read_archive(npz)
