"""The port's run loop (``d3net_tpu_torch/train/loop.py``) on the CPU.

- ``MetricLogger`` rotates a stale history away on resume, as the JAX one.
- ``Checkpointer``: the cases of tests/test_checkpoint.py (the best step
  survives rotation and a restart, mode max), every restore stamping
  ``restored_from``, and a round-trip that is bit-exact in every
  parameter, BN statistic, optimizer and scheduler entry and the step.
- ``run_detector_training`` against ``d3net_tpu.train.loop.
  run_detector_training`` on conf/debug/tiny_pointgroup.yaml for 3 steps,
  both sides started from the same variables (the JAX side's
  ``create_train_state`` patched to take the port's initial weights) and
  ``prepare_epochs`` covering every step, so no random draw enters a step,
  and SGD in place of AdamW (AdamW's first steps move each parameter by
  about ``lr`` whatever its gradient's size, so a gradient that is float
  noise, such as a bias's before a BN, moves 2·lr apart when its sign
  differs; tests/test_torch_optimizer.py holds AdamW's update itself):
  the same batches (the loaders are byte-identical, tests/
  test_torch_dataset.py) give train and val losses and ``grad_norm``
  within the step tolerance of PERF.md §2 (rtol 1e-4) in ``metrics.jsonl``,
  the same record keys and the same cap counters.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.models.blocks import MaskedBatchNorm
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_pointgroup.yaml")
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pools, oversubscribed, slow these steps up to tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_metric_logger_rotates_a_stale_history(tmp_path):
    run = str(tmp_path)
    log = tloop.MetricLogger(run)
    for step in (1, 2, 10):
        log.log(step, {"total_loss": 1.0 / step})
    log.begin(10)                         # nothing past the restored step
    assert os.listdir(run) == ["metrics.jsonl"]
    log.begin(5)                          # steps 6-10 are a stale history
    assert sorted(os.listdir(run)) == ["metrics.jsonl.upto10"]
    log.log(6, {"total_loss": 0.5}, "val")
    assert _records(run) == [{"step": 6, "val/total_loss": 0.5}]
    log.log(11, {"total_loss": 0.5})
    log.begin(5)
    assert sorted(os.listdir(run)) == ["metrics.jsonl.upto10",
                                       "metrics.jsonl.upto11"]


def test_metric_logger_writes_tensorboard_when_asked(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # its stub: fast
    log = tloop.MetricLogger(str(tmp_path), tensorboard=True)
    log.log(3, {"total_loss": 0.25})
    events = os.listdir(tmp_path / "tb")
    assert len(events) == 1 and events[0].startswith("events.out.tfevents")
    assert _records(str(tmp_path)) == [{"step": 3, "train/total_loss": 0.25}]
    (tmp_path / "off").mkdir()
    tloop.MetricLogger(str(tmp_path / "off")).log(1, {"x": 1.0})
    assert os.listdir(tmp_path / "off") == ["metrics.jsonl"]


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 4)
        self.bn = MaskedBatchNorm(4)

    def forward(self, x):
        return self.bn(self.fc(x), torch.ones(x.shape[:-1]), True)


def _state(value: float, optim="SGD"):
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(value)
    state = create_train_state(model, optim=optim, lr=1e-3)
    state.step = int(value * 10)
    return state


def _w(state):
    return float(state.model.fc.weight[0, 0].detach())


def test_best_survives_rotation(tmp_path):
    run = str(tmp_path / "run")
    ck = tloop.Checkpointer(run, monitor="total_loss", mode="min")
    ck.save(10, _state(1.0), {"total_loss": 1.0})
    for i, loss in enumerate([3.0, 2.5, 2.4, 2.2, 2.1]):
        ck.save(20 + i * 10, _state(loss), {"total_loss": loss})
    assert ck.best_step == 10 and ck.best == 1.0
    assert ck.mgr.latest_step() == 60
    assert ck.mgr.all_steps() == [40, 50, 60]
    assert ck.best_mgr.all_steps() == [10]
    assert sorted(os.listdir(os.path.join(run, "ckpt_best"))) == [
        "10", "best.json"]

    restored = ck.restore_best(_state(0.0))
    assert _w(restored) == 1.0 and restored.step == 10
    assert ck.restored_from == {"kind": "best", "step": 10}
    last = ck.restore_last(_state(0.0))
    assert _w(last) == pytest.approx(2.1) and last.step == 21
    assert ck.restored_from == {"kind": "last", "step": 60}

    ck2 = tloop.Checkpointer(run, monitor="total_loss", mode="min")
    assert ck2.best == 1.0 and ck2.best_step == 10
    ck2.save(70, _state(1.5), {"total_loss": 1.5})
    assert ck2.best_mgr.latest_step() == 10
    # weights only (any optimizer): best first, then last
    w = ck2.restore_weights(_state(0.0, optim="AdamW"))
    assert _w(w) == 1.0 and ck2.restored_from == {"kind": "best", "step": 10}
    w = ck2.restore_weights(_state(0.0), prefer_best=False)
    assert _w(w) == 1.5 and ck2.restored_from == {"kind": "last", "step": 70}


def test_best_mode_max(tmp_path):
    ck = tloop.Checkpointer(str(tmp_path / "r"), monitor="cider", mode="max")
    ck.save(1, _state(0.2), {"cider": 0.2})
    ck.save(2, _state(0.5), {"cider": 0.5})
    ck.save(3, _state(0.3), {"cider": 0.3})
    assert ck.best_step == 2 and ck.best == 0.5
    assert ck.best_mgr.latest_step() == 2
    assert tloop.Checkpointer(str(tmp_path / "r"), "x").restore_last(
        _state(0.0)).step == 3
    assert tloop.Checkpointer(str(tmp_path / "empty"), "x").restore_last(
        _state(0.0)) is None


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    torch.manual_seed(0)
    state = create_train_state(_Tiny(), lr=0.01, step_epoch=1,
                               steps_per_epoch=2)
    for _ in range(3):                 # moments, BN statistics, an LR decay
        state.optimizer.zero_grad()
        state.model(torch.randn(7, 3)).square().sum().backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
    ck = tloop.Checkpointer(str(tmp_path), "total_loss")
    ck.save(state.step, state, {"total_loss": 1.0})

    fresh = create_train_state(_Tiny(), lr=0.01, step_epoch=1,
                               steps_per_epoch=2)
    assert ck.restore_last(fresh) is fresh and fresh.step == 3
    for (k, a), (k2, b) in zip(state.model.state_dict().items(),
                               fresh.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    assert fresh.optimizer.param_groups[0]["lr"] == pytest.approx(0.005)
    want, got = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    assert want["state"]
    for i, s in want["state"].items():
        for k, v in s.items():
            g = got["state"][i][k]
            assert g.device == v.device and torch.equal(v, g), (i, k)


def test_cached_variants_cycle_and_prepare_epochs(tmp_path, monkeypatch):
    """``tpu.cache_batches`` with augmentation: the first
    ``augment_variants`` epochs come from the loader and stay on the
    device, later epochs cycle them and the val batches are built once;
    ``prepare_epochs`` runs its epochs without clustering (no score loss)."""
    cfg = tcfg.load(TINY)
    cfg.tpu.cache_batches = True
    cfg.tpu.augment_variants = 2
    cfg.train.epochs = 3
    cfg.cluster.prepare_epochs = 1
    loads = []
    real_iter = tloop.BatchIterator.__iter__

    def counted(it):
        loads.append(it.shuffle)
        yield from real_iter(it)

    monkeypatch.setattr(tloop.BatchIterator, "__iter__", counted)
    state = tloop.run_detector_training(cfg, str(tmp_path), device="cpu")
    assert state.step == 12
    assert loads == [True, False, True]     # train, val, train; then cached
    recs = _records(str(tmp_path))
    train = [r for r in recs if "train/total_loss" in r]
    assert [r["step"] for r in recs if "val/total_loss" in r] == [4, 8, 12]
    assert len(train) == 12 and all(np.isfinite(r["train/total_loss"])
                                    for r in train)
    assert ["train/score_loss" in r for r in train] == [False] * 4 + [True] * 8
    assert tloop.StepDir(str(tmp_path / "ckpt"), 3).all_steps() == [4, 8, 12]


def test_profile_step_writes_a_trace(tmp_path, capsys):
    """``log.profile_step: 1`` traces the three steps after the first, as
    the JAX loop does, into ``run_dir/profile``."""
    cfg = tcfg.load(TINY)
    cfg.cluster.prepare_epochs = 10
    cfg.log = {"profile_step": 1}
    tloop.run_detector_training(cfg, str(tmp_path), max_steps=4, device="cpu")
    out = capsys.readouterr().out
    assert f"profile written to {tmp_path}/profile" in out
    # written once step 4 is done, before its log line (as in JAX)
    assert out.index("step 3 ") < out.index("profile written") \
        < out.index("step 4 ")
    trace = tmp_path / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("detector_loss" in e.get("name", "")
               or "aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("sync_steps", [True, False])
def test_on_step_timings(tmp_path, sync_steps):
    """``on_step`` gets each train step's host-clock timings, with or
    without the loop waiting for the device around each part."""
    cfg = tcfg.load(TINY)
    cfg.cluster.prepare_epochs = 10
    recs = []
    tloop.run_detector_training(cfg, str(tmp_path), max_steps=2, device="cpu",
                                on_step=recs.append, sync_steps=sync_steps)
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["t_start"] + recs[0]["wall_s"] <= recs[1]["t_start"]
    for r in recs:
        assert r["h2d_bytes"] > 0 and min(
            r["data_wait_s"], r["h2d_s"], r["step_s"]) >= 0
        assert r["wall_s"] == pytest.approx(
            r["data_wait_s"] + r["h2d_s"] + r["step_s"])


# ---------------------------------------------------------------------------
def _tiny_cfg(load, run_root):
    cfg = load(TINY)
    cfg.general.output_root = str(run_root)
    cfg.cluster.prepare_epochs = 10        # no clustering: no random draw
    cfg.train.optim.classname = "SGD"
    return cfg


def test_run_matches_jax_run_detector_training(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from d3net_tpu import config as jcfg
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train.trainer import TrainState

    cfg_t = _tiny_cfg(tcfg.load, tmp_path)
    variables = params.init_flax_variables(tloop.detector_from_cfg(cfg_t),
                                           cfg_t.general.manual_seed)

    def create_from_variables(model, batch, rng, tx):
        v = jax.tree.map(jnp.asarray, variables)
        return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), tx=tx)

    monkeypatch.setattr(jloop, "create_train_state", create_from_variables)
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # no TB writer
    # the cap counters are per process: drop what earlier tests counted
    from d3net_tpu.data.collate import CAP_STATS as jax_cap_stats
    from d3net_tpu_torch.data.collate import CAP_STATS

    jax_cap_stats.reset()
    CAP_STATS.reset()
    jrun, trun = str(tmp_path / "jax"), str(tmp_path / "torch")
    jloop.run_detector_training(_tiny_cfg(jcfg.load, tmp_path), jrun,
                                max_steps=3)
    tloop.run_detector_training(cfg_t, trun, max_steps=3, device="cpu")

    want, got = _records(jrun), _records(trun)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k, v in w.items():
            if k.endswith("iter_time"):
                continue
            if "/cap_" in k or k == "step":
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL,
                                           err_msg=f"step {w['step']} {k}")
    assert {k for k in want[-1]} >= {"val/total_loss", "val/semantic_loss"}
    for name in ("config.yaml", "run_meta.json", "ckpt_best/best.json"):
        assert os.path.exists(os.path.join(trun, name)), name
    assert tloop.StepDir(os.path.join(trun, "ckpt"), 3).all_steps() == [3]
    meta = json.load(open(os.path.join(trun, "run_meta.json")))
    assert meta["conv_impl"] == "gather" and "git_sha" in meta
    assert tcfg.load(os.path.join(trun, "config.yaml")).to_dict() \
        == cfg_t.to_dict()
