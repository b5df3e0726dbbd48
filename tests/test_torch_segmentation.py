"""The port's ScanNet-benchmark evaluation against the JAX package's on
the CPU:

- ``eval/segmentation.py``: ``semantic_confusion``/``semantic_iou`` and
  ``InstanceEvaluator`` give JAX's numbers on seeded predictions (classes
  with no GT, unannotated points, small GT regions, duplicate masks);
- ``eval --task scannet --cpu`` on a tiny detector run dir (conf/debug/
  tiny_captioning.yaml with the speaker off: a detector run whose config
  has the pipeline's keys, which both packages' pipeline models read; one
  detector-only checkpoint) against ``d3net_tpu.eval.cli.
  eval_scannet_cli`` with the same weights (its ``_setup`` patched to
  build the pipeline around them): every txt file of ``split_pred/val``
  byte-equal, and ``eval_scannet.json`` equal.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from d3net_tpu.eval import segmentation as jseg
from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.eval import segmentation as tseg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_captioning.yaml")


def test_semantic_iou_equals_jax():
    rng = np.random.default_rng(0)
    gt = rng.integers(-1, 12, 5000)              # classes 12..19 absent
    pred = np.where(rng.random(5000) < 0.6, gt, rng.integers(0, 20, 5000))
    pred = np.clip(pred, 0, 19)
    got = tseg.semantic_confusion(pred, gt, 20)
    want = jseg.semantic_confusion(pred, gt, 20)
    np.testing.assert_array_equal(got, want)
    g, w = tseg.semantic_iou(got), jseg.semantic_iou(want)
    assert g.keys() == w.keys() and g["mIoU"] == w["mIoU"]
    assert g["accuracy"] == w["accuracy"]
    np.testing.assert_array_equal(g["per_class_iou"], w["per_class_iou"])
    assert 0 < g["mIoU"] < 1


def _scenes(rng, n_scenes=4, n=1500):
    for _ in range(n_scenes):
        ids = rng.integers(-1, 6, n)
        ids[:40] = 7                              # a region under min size
        sem = np.where(ids >= 0, ids % 3 + 1, -1)
        sem[rng.random(n) < 0.05] = -1
        preds = []
        for g in range(8):
            mask = (ids == g) ^ (rng.random(n) < 0.05)
            cls = g % 3 + 1 if rng.random() < 0.7 else int(rng.integers(1, 4))
            preds.append((mask, cls, float(rng.random())))
        preds.append(preds[0])                    # a duplicate
        yield preds, ids, sem


@pytest.mark.parametrize("min_region", [100, 20])
def test_instance_evaluator_equals_jax(min_region):
    got = tseg.InstanceEvaluator(min_region_size=min_region)
    want = jseg.InstanceEvaluator(min_region_size=min_region)
    for preds, ids, sem in _scenes(np.random.default_rng(1)):
        got.add_scene(preds, ids, sem)
        want.add_scene(preds, ids, sem)
    g, w = got.compute(), want.compute()
    assert g == w and set(g) == {"AP", "AP@50", "AP@25"}
    assert 0 < g["AP@25"] <= 1
    assert tseg.InstanceEvaluator().compute() == \
        jseg.InstanceEvaluator().compute()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_eval_scannet_cli_matches_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from d3net_tpu.eval import cli as jcli
    from d3net_tpu.parallel.mesh import make_mesh
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train.pipeline_loop import build_vocab, pipeline_from_cfg
    from d3net_tpu_torch.scripts import eval as eval_cli
    from d3net_tpu_torch.train import loop as tloop
    from d3net_tpu_torch.train.trainer import create_train_state

    torch.set_num_threads(1)
    cfg = tcfg.load(TINY)
    cfg.model.no_captioning = True
    cfg.general.monitor = "val_loss/total_loss"
    cfg.general.monitor_mode = "min"
    trun, jrun = str(tmp_path / "torch"), str(tmp_path / "jax")
    for run in (trun, jrun):
        os.makedirs(run)
        tcfg.save(cfg, os.path.join(run, "config.yaml"))
    model = tloop.init_detector(tloop.detector_from_cfg(cfg), 7)
    tloop.Checkpointer(trun, "total_loss").save(
        3, create_train_state(model), {"total_loss": 1.0})
    v = params.state_dict_to_flax(model)

    def setup(jc, run_dir):
        vocab, emb = build_vocab(jc)
        _, val_it = jloop.make_dataloaders(
            jc, jloop.spec_from_cfg(jc, infer=True), return_scenes=True)
        state = type("State", (), dict(
            params={"detector": jax.tree.map(jnp.asarray, v["params"])},
            batch_stats={"detector": jax.tree.map(jnp.asarray,
                                                  v["batch_stats"])}))
        return (pipeline_from_cfg(jc, vocab), state, val_it, vocab, emb,
                int(jc.data.num_des_per_scene),
                make_mesh(batch_size=int(jc.data.batch_size)),
                {"kind": "best", "step": 3})

    monkeypatch.setattr(jcli, "_setup", setup)
    from d3net_tpu import config as jcfg

    want = jcli.eval_scannet_cli(jcfg.load(os.path.join(jrun, "config.yaml")),
                                 jrun)
    monkeypatch.setattr(sys, "argv", ["eval"])
    eval_cli.main(["--folder", trun, "--task", "scannet", "--cpu"])

    got_tree = _tree(os.path.join(trun, "split_pred"))
    want_tree = _tree(os.path.join(jrun, "split_pred"))
    assert sorted(got_tree) == sorted(want_tree)
    for name, data in want_tree.items():
        assert got_tree[name] == data, name
    masks = [n for n in got_tree if "predicted_masks" in n]
    assert len(masks) > 0 and len(got_tree) > len(masks) + 2
    got = json.load(open(os.path.join(trun, "eval_scannet.json")))
    assert got == json.load(open(os.path.join(jrun, "eval_scannet.json")))
    assert got["checkpoint"] == {"kind": "best", "step": 3}
    assert {k: got[k] for k in want} == want
    assert set(want) == {"mIoU", "accuracy", "AP", "AP@50", "AP@25"}
