"""The slice as a whole: dense captioning as users evaluate it, on
conf/debug/tiny_captioning.yaml, on the CPU.

One JAX-initialised ``PipelineNet`` (module fixture) is converted to the
port. JAX's ``run_pipeline_validation(mode=1)`` and the port's give equal
``lang_cap`` ids for every val scene's proposals, equal BLEU-4, CIDEr,
ROUGE-L and METEOR, and equal diagnostics (the assignment IoUs within the
detector's rtol 1e-4). The eval CLI (``--task captioning --cpu``) on a run
dir holding the converted pipeline as a port checkpoint writes those
numbers, stamped with the checkpoint; a detector-only checkpoint fails to
load. The Flax -> torch -> Flax round trip of the whole tree is exact.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.scripts import eval as eval_cli
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_captioning.yaml")
IOU_RTOL = 1e-4
# below the config's 0.5, so that some proposals of the random detector
# keep their captions and the protocol metrics score real candidates
MIN_IOU = 0.2


def _load(load):
    cfg = load(TINY)
    cfg.eval.min_iou_threshold = MIN_IOU
    return cfg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(module, calls):
    """``module.decode_captions`` that keeps each scene's ids."""
    real = module.decode_captions

    def record(ids, vocab):
        calls.append(np.asarray(ids).copy())
        return real(ids, vocab)
    return record


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX side: initialised variables (numpy), and its mode-1
    validation's metrics, per-scene ids and diagnostics."""
    import jax
    import jax.numpy as jnp
    from d3net_tpu import config as jcfg
    from d3net_tpu.data.collate import build_batch
    from d3net_tpu.data.language import build_lang_batch
    from d3net_tpu.parallel.mesh import make_mesh
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train import pipeline_loop as jpl

    cfg = _load(jcfg.load)
    vocab, emb = jpl.build_vocab(cfg)
    model = jpl.pipeline_from_cfg(cfg, vocab)
    spec = jloop.spec_from_cfg(cfg, infer=True)
    _, val_it = jloop.make_dataloaders(cfg, spec, return_scenes=True)
    chunk = int(cfg.data.num_des_per_scene)
    scenes = [val_it.scenes[i] for i in range(cfg.data.batch_size)]
    first = jax.tree.map(jnp.asarray, build_batch(scenes, spec))
    lang = jpl.lang_rows(build_lang_batch(
        scenes, vocab, chunk, cfg.data.max_spk_len, np.random.default_rng(0),
        spec.max_instances), emb)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("params",) + jpl._RNGS)}
    variables = jax.jit(lambda b, ln: model.init(
        rngs, b, ln, train=True, chunk_size=chunk))(first, lang)
    variables = jax.tree.map(np.asarray, dict(variables))

    ids = []
    diag_path = str(tmp_path_factory.mktemp("jax") / "caption_diag.json")
    mp = pytest.MonkeyPatch()
    mp.setattr(jpl, "decode_captions", _recording(jpl, ids))
    try:
        metrics = jpl.run_pipeline_validation(
            cfg, model, SimpleNamespace(params=variables["params"],
                                        batch_stats=variables["batch_stats"]),
            val_it, vocab, emb, chunk, make_mesh(jax.devices()[:1]), 1,
            diag_path=diag_path)
    finally:
        mp.undo()
    with open(diag_path) as f:
        diag = json.load(f)
    return SimpleNamespace(variables=variables, metrics=metrics, ids=ids,
                           diag=diag)


def _port(jax_run):
    cfg = _load(tcfg.load)
    vocab, emb = tpl.build_vocab(cfg)
    model = params.load_pipeline(jax_run.variables, cfg, vocab, device="cpu")
    return cfg, vocab, emb, model


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = IOU_RTOL if "iou" in k else 1e-12
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


def test_validation_matches_jax(jax_run, tmp_path, monkeypatch):
    cfg, vocab, emb, model = _port(jax_run)
    val_it = tloop.make_val_loader(cfg, tloop.spec_from_cfg(cfg),
                                   return_scenes=True)
    ids = []
    monkeypatch.setattr(tpl, "decode_captions", _recording(tpl, ids))
    diag_path = str(tmp_path / "caption_diag.json")
    metrics = tpl.run_pipeline_validation(cfg, model, val_it, vocab, emb,
                                          mode=1, diag_path=diag_path)
    assert len(ids) == len(jax_run.ids) == 2          # the 2 val scenes
    for g, w in zip(ids, jax_run.ids):
        assert g.shape == w.shape == (16, cfg.data.max_spk_len + 1)
        np.testing.assert_array_equal(g, w)
    _assert_metrics_equal(metrics, jax_run.metrics)
    assert {"bleu4", "cider", "rouge", "meteor", "cap_frac_replaced",
            "cap_assign_iou_mean", "cider_raw"} <= set(metrics)
    assert 0 < metrics["cap_frac_replaced"] < 1
    with open(diag_path) as f:
        diag = json.load(f)
    want = jax_run.diag
    assert [e["key"] for e in diag["examples"]] == \
        [e["key"] for e in want["examples"]]
    for g, w in zip(diag["examples"], want["examples"]):
        assert g["iou"] == pytest.approx(w["iou"], abs=1e-3)
        assert {k: g[k] for k in g if k != "iou"} == \
            {k: w[k] for k in w if k != "iou"}
    _assert_metrics_equal({k: v for k, v in diag.items() if k != "examples"},
                          {k: v for k, v in want.items() if k != "examples"})
    with pytest.raises(ValueError, match="needs the listener"):
        tpl.run_pipeline_validation(cfg, model, val_it, vocab, emb, mode=2)


def _run_dir(root, cfg, model, step=5):
    os.makedirs(root, exist_ok=True)
    tcfg.save(cfg, os.path.join(root, "config.yaml"))
    tloop.Checkpointer(root, "cider", "max").save(
        step, create_train_state(model), {"cider": 0.5})
    return root


def test_eval_cli_writes_the_same_numbers(jax_run, tmp_path):
    cfg, _, _, model = _port(jax_run)
    run = _run_dir(str(tmp_path / "run"), cfg, model)
    eval_cli.main(["--folder", run, "--task", "captioning", "--cpu"])
    with open(os.path.join(run, "eval_captioning.json")) as f:
        res = json.load(f)
    assert res.pop("checkpoint") == {"kind": "best", "step": 5}
    _assert_metrics_equal(res, jax_run.metrics)

    # a checkpoint of the detector alone does not load into the pipeline
    det = str(tmp_path / "det")
    os.makedirs(det)
    tcfg.save(cfg, os.path.join(det, "config.yaml"))
    tloop.Checkpointer(det, "total_loss").save(
        1, create_train_state(model.detector), {"total_loss": 1.0})
    with pytest.raises(RuntimeError, match="Missing key"):
        eval_cli.main(["--folder", det, "--task", "captioning", "--cpu"])


def test_eval_cli_without_checkpoint_warns(jax_run, tmp_path, capsys):
    cfg = _load(tcfg.load)
    run = str(tmp_path / "empty")
    os.makedirs(run)
    tcfg.save(cfg, os.path.join(run, "config.yaml"))
    metrics = eval_cli.eval_captioning(cfg, run, device="cpu")
    assert "no checkpoint found, evaluating random weights" in \
        capsys.readouterr().out
    with open(os.path.join(run, "eval_captioning.json")) as f:
        res = json.load(f)
    assert res.pop("checkpoint") == {"kind": "none", "step": -1}
    assert res == metrics and all(np.isfinite(v) for v in res.values())


def test_flax_round_trip_is_exact(jax_run):
    _, _, _, model = _port(jax_run)
    back = params.state_dict_to_flax(model)
    for coll in ("params", "batch_stats"):
        got = params.flatten(back[coll])
        want = params.flatten(jax_run.variables[coll])
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert set(params.flatten(back["params"]["speaker"])) >= {
        "caption.cell_td.hr.kernel", "caption.cell_lang.hn.bias",
        "graph.gc_1.Dense_1.kernel"}
    n_flax = sum(v.size for c in ("params", "batch_stats")
                 for v in params.flatten(jax_run.variables[c]).values())
    assert sum(t.numel() for t in model.state_dict().values()) == n_flax
    # a leaf too many or an entry left unset fails
    extra = {c: dict(jax_run.variables[c]) for c in jax_run.variables}
    extra["params"]["speaker"] = {**extra["params"]["speaker"],
                                  "extra": {"kernel": np.zeros((2, 2))}}
    with pytest.raises(ValueError, match="unused"):
        params.flax_to_state_dict(extra, model)
    short = {c: dict(jax_run.variables[c]) for c in jax_run.variables}
    short["params"] = {k: v for k, v in short["params"].items()
                       if k != "speaker"}
    with pytest.raises(ValueError, match="speaker"):
        params.flax_to_state_dict(short, model)


def test_load_pipeline_without_device_raises_without_gpu(jax_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.load(TINY)
    vocab, _ = tpl.build_vocab(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params.load_pipeline(jax_run.variables, cfg, vocab)
