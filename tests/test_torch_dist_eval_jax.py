"""The port's captioning eval over 2 gloo ranks against the JAX package's
over a 2-device dp mesh, on the CPU: ``d3net_tpu.eval.cli.
eval_captioning_cli`` (its ``_setup`` patched from outside to hand it the
same seeded weights, as ``test_torch_segmentation.py`` does) against
``scripts.eval.eval_captioning(world_size=2)``, at conf/debug/
tiny_captioning.yaml's widths (B=2, one scene a rank or device) on 4 val
scenes, with ``eval.min_iou_threshold`` 0.0 so that every caption is
scored (seed 13: CIDEr above 0). CIDEr's document frequencies are the
whole corpus's, so the ranks' records are merged on rank 0 before
``compute()``. BLEU-4, CIDEr, ROUGE-L, METEOR and the replaced fraction
equal, the assignment IoU means within the detector's rtol 1e-4; the
json files the same way, with the same checkpoint stamp.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import torch
from threadpoolctl import threadpool_limits

from d3net_tpu_torch import checks
from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch.scripts import eval as eval_cli

TINY = "conf/debug/tiny_captioning.yaml"
IOU_RTOL = 1e-4


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=IOU_RTOL if "iou" in k
                                   else 1e-12, err_msg=k)


def test_two_ranks_equal_jax_two_devices(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from d3net_tpu import config as jcfg
    from d3net_tpu.eval import cli as jcli
    from d3net_tpu.parallel.mesh import make_mesh
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train.pipeline_loop import build_vocab, pipeline_from_cfg

    monkeypatch.setenv("D3NET_VAL_SCENES", "4")
    trun, jrun = str(tmp_path / "torch"), str(tmp_path / "jax")
    variables = checks.seeded_run_dir(TINY, trun, seed=13, min_iou=0.0)
    os.makedirs(jrun)
    shutil.copy(os.path.join(trun, "config.yaml"), jrun)
    devices = []

    def setup(jc, run_dir):
        vocab, emb = build_vocab(jc)
        _, val_it = jloop.make_dataloaders(
            jc, jloop.spec_from_cfg(jc, infer=True), return_scenes=True)
        state = SimpleNamespace(**{
            k: jax.tree.map(jnp.asarray, variables[k])
            for k in ("params", "batch_stats")})
        mesh = make_mesh(batch_size=int(jc.data.batch_size))
        devices.append(mesh.devices.size)
        return (pipeline_from_cfg(jc, vocab), state, val_it, vocab, emb,
                int(jc.data.num_des_per_scene), mesh,
                {"kind": "best", "step": 3})

    monkeypatch.setattr(jcli, "_setup", setup)
    want = jcli.eval_captioning_cli(
        jcfg.load(os.path.join(jrun, "config.yaml")), jrun)
    assert devices == [2]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            got = eval_cli.eval_captioning(
                tcfg.load(os.path.join(trun, "config.yaml")), trun, "cpu",
                world_size=2, threads=1)
    finally:
        torch.set_num_threads(n)
    _assert_metrics_equal(got, want)
    assert want["cider"] > 0 and want["cap_frac_replaced"] == 0.0
    files = []
    for run in (trun, jrun):
        with open(os.path.join(run, "eval_captioning.json")) as f:
            files.append(json.load(f))
    assert files[0].pop("checkpoint") == files[1].pop("checkpoint")
    _assert_metrics_equal(*files)
