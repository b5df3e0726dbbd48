"""The port's scan trainer (``d3net_tpu_torch/train/loop.py``
``run_detector_training_scan``) against ``d3net_tpu.train.loop.
run_detector_training_scan`` on conf/debug/tiny_pointgroup.yaml
(``steps_per_dispatch`` 2, ``augment_variants`` 2, ``max_steps`` 4, SGD).

Both sides start from the same variables (the JAX side's
``create_train_state`` patched to take the port's initial weights) and
take the same fixed cluster jitter and proposal shuffle in every step
(JAX's ``jax.random.uniform``/``permutation`` patched to them, the port's
step handed them as tensors), so no random draw enters a step while the
clustering and ScoreNet still train:

- the resident stack (both augmented epochs) equals the batches JAX
  stacks, byte for byte; under ``activation_dtype: bfloat16`` its
  ``point_feats`` are JAX's bf16 cast bit for bit;
- ``metrics.jsonl``: the same record keys at the same steps (2 and 4,
  ``train`` with ``steps_per_sec`` then ``val``), the values within rtol
  1e-4;
- a second call with ``max_steps`` 6 resumes at step 4, and its step-6
  records equal an uninterrupted 6-step run's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.train import loop as tloop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_pointgroup.yaml")
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _scan_cfg(load, run_root):
    cfg = load(TINY)
    cfg.general.output_root = str(run_root)
    cfg.tpu.steps_per_dispatch = 2
    cfg.tpu.augment_variants = 2
    cfg.train.optim.classname = "SGD"
    return cfg


def _draws(cfg):
    rng = np.random.default_rng(11)
    b, p = cfg.data.batch_size, 2 * cfg.tpu.clusters_per_pass
    jitter = rng.random((b, p, 3)).astype(np.float32)
    perm = rng.permutation(cfg.model.max_num_proposal).astype(np.int32)
    return jitter, perm


def _fixed_draws_step(monkeypatch, jitter, perm):
    real = tloop.detector_train_step

    def step(state, batch, generator=None, **kw):
        b = batch["point_mask"].shape[0]
        return real(state, batch, jitter_u=torch.from_numpy(jitter),
                    proposal_perm=torch.from_numpy(perm).long()[None].expand(
                        b, -1), **kw)

    monkeypatch.setattr(tloop, "detector_train_step", step)


def _same(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        g = got.cpu().numpy()
        assert g.dtype == want.dtype and g.shape == want.shape, where
        np.testing.assert_array_equal(g, want, err_msg=where)


def test_scan_run_matches_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from d3net_tpu import config as jcfg
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train.trainer import TrainState

    cfg_t = _scan_cfg(tcfg.load, tmp_path)
    variables = params.init_flax_variables(tloop.detector_from_cfg(cfg_t),
                                           cfg_t.general.manual_seed)
    jitter, perm = _draws(cfg_t)

    def create_from_variables(model, batch, rng, tx):
        v = jax.tree.map(jnp.asarray, variables)
        return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]), tx=tx)

    shipped = []
    real_shard = jloop.shard_batch

    def shard(batch, mesh):
        shipped.append(batch)
        return real_shard(batch, mesh)

    monkeypatch.setattr(jloop, "create_train_state", create_from_variables)
    monkeypatch.setattr(jloop, "shard_batch", shard)
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # no TB writer
    jrun, trun = str(tmp_path / "jax"), str(tmp_path / "torch")
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, *a, **k: jnp.asarray(jitter))
        mp.setattr(jax.random, "permutation",
                   lambda key, x, *a, **k: jnp.asarray(perm))
        jloop.run_detector_training_scan(_scan_cfg(jcfg.load, tmp_path),
                                         jrun, max_steps=4)

    stacks = []
    real_stack = tloop.build_scan_stack
    monkeypatch.setattr(tloop, "build_scan_stack", lambda *a: stacks.append(
        real_stack(*a)) or stacks[-1])
    _fixed_draws_step(monkeypatch, jitter, perm)
    state = tloop.run_detector_training_scan(cfg_t, trun, max_steps=4,
                                             device="cpu")
    assert state.step == 4

    stack, nb = stacks[0]
    assert nb == 8 and shipped[0]["point_feats"].shape[0] == nb
    _same(stack, shipped[0], "stack")

    want, got = _records(jrun), _records(trun)
    assert [r["step"] for r in got] == [r["step"] for r in want] \
        == [2, 2, 4, 4]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k, v in w.items():
            if k == "step" or k.endswith("steps_per_sec"):
                assert g[k] > 0
                continue
            np.testing.assert_allclose(g[k], v, rtol=LOSS_RTOL,
                                       err_msg=f"step {w['step']} {k}")
    assert {"train/steps_per_sec", "train/score_loss",
            "train/gt_iou_mean"} <= set(got[0])
    assert "val/total_loss" in got[1]
    assert tloop.StepDir(os.path.join(trun, "ckpt"), 3).all_steps() == [2, 4]

    # a resume at step 4 equals the uninterrupted run
    tloop.run_detector_training_scan(cfg_t, trun, max_steps=6, device="cpu")
    once = str(tmp_path / "once")
    tloop.run_detector_training_scan(cfg_t, once, max_steps=6, device="cpu")
    resumed, straight = _records(trun), _records(once)
    assert [r["step"] for r in resumed] == [2, 2, 4, 4, 6, 6]
    for r, s in zip(resumed[-2:], straight[-2:]):
        assert {k: v for k, v in r.items() if "steps_per_sec" not in k} == \
            {k: v for k, v in s.items() if "steps_per_sec" not in k}


def test_stack_casts_point_feats_to_bf16_as_jax():
    import ml_dtypes
    from d3net_tpu import config as jcfg
    from d3net_tpu.train import loop as jloop

    cfg = _scan_cfg(tcfg.load, "/unused")
    cfg.tpu.activation_dtype = "bfloat16"
    train_it, _ = tloop.make_dataloaders(cfg, tloop.spec_from_cfg(cfg))
    stack, nb = tloop.build_scan_stack(cfg, train_it, torch.device("cpu"))

    jc = _scan_cfg(jcfg.load, "/unused")
    jit, _ = jloop.make_dataloaders(jc, jloop.spec_from_cfg(jc))
    batches = []
    for e in range(2):
        jit.epoch = e
        batches.extend(list(jit))
    assert nb == len(batches) == 8
    feats = np.stack([b["point_feats"] for b in batches]).astype(
        ml_dtypes.bfloat16)
    got = stack["point_feats"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == feats.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  feats.view(np.int16))
    np.testing.assert_array_equal(
        stack["point_xyz"].numpy(), np.stack([b["point_xyz"]
                                              for b in batches]))
