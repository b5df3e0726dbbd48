"""The ScanRefer submission writers as users run them, on the CPU: the
port's ``scripts/benchmark_captioning.py`` and ``benchmark_grounding.py``
against the JAX package's ``benchmark/benchmark_captioning.py`` and
``benchmark_grounding.py``, on conf/debug/tiny_captioning.yaml and
tiny_grounding.yaml.

One set of seeded weights (numpy, nonzero biases and BN statistics) goes
to both sides: the port's run dir holds it as a checkpoint, which the CLI
restores; the JAX scripts get it through a patched
``d3net_tpu.eval.cli._setup``. That patch returns the 7 values the JAX
scripts unpack: the real ``_setup`` returns 8 (a checkpoint stamp too),
so the scripts cannot run as they stand. Each JAX script is loaded by
file path and its ``main()`` called under a patched ``sys.argv``.

Captions, ``sem_cls``, scene and object ids and the picked proposals are
equal; boxes and ``obj_prob`` within the detector's rtol 1e-4 / atol 1e-5.
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import randomize
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.train.loop import Checkpointer
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CAPTION = os.path.join(ROOT, "conf", "debug", "tiny_captioning.yaml")
TINY_GROUNDING = os.path.join(ROOT, "conf", "debug", "tiny_grounding.yaml")
RTOL, ATOL = 1e-4, 1e-5
SEED = 2          # weights whose random detector keeps several proposals


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_jax_script(relpath: str):
    """A JAX-package script of the repo, loaded by file path."""
    name = "jax_" + os.path.splitext(os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_runs(root, config: str, seed: int = SEED):
    """A port run dir (``config.yaml`` and a checkpoint of seeded weights)
    and a JAX run dir (``config.yaml``) of ``config``, and the weights as
    numpy Flax trees."""
    cfg = tcfg.load(config)
    cfg.general.output_root = str(root)
    vocab, _ = tpl.build_vocab(cfg)
    variables = randomize(params.init_flax_variables(
        tpl.pipeline_from_cfg(cfg, vocab), seed),
        np.random.default_rng(seed))
    runs = SimpleNamespace(port=os.path.join(str(root), "port"),
                           jax=os.path.join(str(root), "jax"),
                           variables=variables)
    for run in (runs.port, runs.jax):
        os.makedirs(run)
        tcfg.save(cfg, os.path.join(run, "config.yaml"))
    model = params.load_pipeline(variables, cfg, vocab, device="cpu")
    Checkpointer(runs.port, "cider", "max").save(
        3, create_train_state(model), {"cider": 0.0})
    return runs


def patch_jax_setup(monkeypatch, variables):
    """``d3net_tpu.eval.cli._setup`` returning the 7 values the JAX
    scripts unpack, with ``variables`` as the state's weights."""
    import jax
    import jax.numpy as jnp
    from d3net_tpu.eval import cli as jcli
    from d3net_tpu.parallel.mesh import make_mesh
    from d3net_tpu.train import loop as jloop
    from d3net_tpu.train.pipeline_loop import build_vocab, pipeline_from_cfg

    def setup(jc, run_dir):
        vocab, emb = build_vocab(jc)
        _, val_it = jloop.make_dataloaders(
            jc, jloop.spec_from_cfg(jc, infer=True), return_scenes=True)
        state = SimpleNamespace(**{
            c: jax.tree.map(jnp.asarray, variables[c])
            for c in ("params", "batch_stats")})
        return (pipeline_from_cfg(jc, vocab), state, val_it, vocab, emb,
                int(jc.data.num_des_per_scene),
                make_mesh(jax.devices()[:1]))

    monkeypatch.setattr(jcli, "_setup", setup)


def run_jax_script(monkeypatch, relpath: str, *args: str):
    monkeypatch.setattr(sys, "argv", [relpath, *args])
    load_jax_script(relpath).main()


@pytest.fixture(scope="module")
def captioning(tmp_path_factory):
    from d3net_tpu_torch.scripts import benchmark_captioning

    root = tmp_path_factory.mktemp("captioning")
    runs = make_runs(root, TINY_CAPTION)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_setup(mp, runs.variables)
        run_jax_script(mp, "benchmark/benchmark_captioning.py",
                       "--folder", runs.jax, "--cpu")
    with open(os.path.join(runs.jax, "benchmark_captioning.json")) as f:
        want = json.load(f)
    out = str(root / "port.json")
    got = benchmark_captioning.main(["--folder", runs.port, "--cpu",
                                     "--out", out])
    with open(out) as f:
        assert json.load(f) == got
    return got, want


@pytest.fixture(scope="module")
def grounding(tmp_path_factory):
    from d3net_tpu_torch.scripts import benchmark_grounding

    root = tmp_path_factory.mktemp("grounding")
    runs = make_runs(root, TINY_GROUNDING)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_setup(mp, runs.variables)
        run_jax_script(mp, "benchmark/benchmark_grounding.py",
                       "--folder", runs.jax, "--cpu")
    with open(os.path.join(runs.jax, "benchmark_grounding.json")) as f:
        want = json.load(f)
    got = benchmark_grounding.main(["--folder", runs.port, "--cpu"])
    with open(os.path.join(runs.port, "benchmark_grounding.json")) as f:
        assert json.load(f) == got
    return got, want


def test_captioning_submission_matches_jax(captioning):
    got, want = captioning
    assert list(got) == list(want) == ["synthetic_10000", "synthetic_10001"]
    for scene, entries in want.items():
        assert len(got[scene]) == len(entries) > 1, scene
        for g, w in zip(got[scene], entries):
            assert set(g) == set(w) == {"caption", "box", "sem_cls",
                                        "obj_prob"}
            assert (g["caption"], g["sem_cls"]) == (w["caption"],
                                                    w["sem_cls"])
            np.testing.assert_allclose(g["box"], w["box"], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(g["obj_prob"], w["obj_prob"],
                                       rtol=RTOL, atol=ATOL)
            assert np.shape(g["box"]) == (8, 3)


def test_captioning_entries_are_well_formed(captioning):
    """Every caption is a decoded sentence and every score a probability."""
    got, _ = captioning
    for entries in got.values():
        for e in entries:
            words = e["caption"].split()
            assert words[0] == "sos" and words[-1] == "eos", e["caption"]
            assert 0.0 <= e["obj_prob"] <= 1.0


def test_grounding_submission_matches_jax(grounding):
    got, want = grounding
    assert len(got) == len(want) > 0
    picked = set()
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"scene_id", "object_id", "bbox"}
        assert (g["scene_id"], g["object_id"]) == (w["scene_id"],
                                                   w["object_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=RTOL,
                                   atol=ATOL)
        picked.add(json.dumps(np.round(g["bbox"], 3).tolist()))
    assert {g["scene_id"] for g in got} == {"synthetic_10000",
                                            "synthetic_10001"}
    # the listener picks more than one proposal over the run
    assert len(picked) > 1


def test_grounding_object_id_is_the_instance_slot(grounding, tmp_path):
    """``object_id`` is the argmax of the row's ``ref_box_label``: the
    target's instance slot in the scene, as JAX writes it."""
    from d3net_tpu_torch.data.language import build_lang_batch
    from d3net_tpu_torch.train.loop import make_val_loader, spec_from_cfg

    got, _ = grounding
    cfg = tcfg.load(TINY_GROUNDING)
    vocab, _ = tpl.build_vocab(cfg)
    val_it = make_val_loader(cfg, spec_from_cfg(cfg), return_scenes=True)
    rng = np.random.default_rng(0)
    want = []
    for _, scenes in val_it:
        lang = build_lang_batch(scenes, vocab, int(cfg.data.num_des_per_scene),
                                cfg.data.max_spk_len, rng,
                                val_it.spec.max_instances)
        for i, scene in enumerate(scenes):
            for c in np.flatnonzero(lang["annotated"][i] > 0):
                want.append((scene.scene_id,
                             int(lang["ref_box_label"][i, c].argmax())))
    assert [(g["scene_id"], g["object_id"]) for g in got] == want
