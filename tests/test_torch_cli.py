"""The port's train and eval CLIs on the CPU (conf/debug/tiny_pointgroup.yaml).

``python -m d3net_tpu_torch.scripts.train --cpu --max_steps 2`` leaves the
JAX run-dir layout, a second call resumes from the saved step and goes on,
and ``python -m d3net_tpu_torch.scripts.eval --task detection --cpu``
writes ``eval_detection.json`` stamped with its checkpoint. The speaker's
stage runs as users run it: ``prepare_weights`` turns a detector run into
a pretrained pickle and ``train`` on conf/debug/tiny_captioning.yaml
(mode (1, 1, 0)) loads it and leaves the same layout, validated by cider;
the listener's stage likewise on conf/debug/tiny_grounding.yaml (mode
(1, 0, 1)), validated by ``ref_iou_rate_0.5``, resumed, and evaluated by
``--task grounding``; joint RL's stage (mode (1, 1, 1)) on
conf/debug/tiny_joint.yaml from the speaker's and the listener's pickles,
validated by ``combined``, resumed, and evaluated by both tasks. The scan
trainer (``tpu.steps_per_dispatch``) trains through the train CLI, resumes,
and ``--task scannet`` scores its run dir. Without ``--cpu`` and without a
GPU every call exits non-zero, ``train_enet``,
``compute_multiview_features``, the submission writers
(``benchmark_captioning``, ``benchmark_grounding``), the visualize
scripts and ``port_enet_weights --selftest`` included (``--task
captioning`` is held in tests/test_torch_pipeline.py).
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch.scripts import eval as eval_cli
from d3net_tpu_torch.scripts import train as train_cli
from d3net_tpu_torch.train import loop as tloop
from d3net_tpu_torch.train.trainer import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "conf/debug/tiny_pointgroup.yaml"
TINY_CAPTION = "conf/debug/tiny_captioning.yaml"
TINY_GROUNDING = "conf/debug/tiny_grounding.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for in-process runs: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(*args, gpu_hidden=False):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"     # the test workers share the cores
    if gpu_hidden:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)


def _steps(run):
    """(step, "train" or "val") of each ``metrics.jsonl`` record."""
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["step"], next(k for k in r if k != "step").split("/")[0])
            for r in recs]


def test_train_resume_and_eval_cli(tmp_path):
    run = str(tmp_path / "run")
    out = _run("d3net_tpu_torch.scripts.train", "--config", TINY, "--cpu",
               "--max_steps", "2", "--folder", run)
    assert out.returncode == 0, out.stderr[-3000:]
    for name in ("config.yaml", "run_meta.json", "metrics.jsonl",
                 "ckpt/2/state.pt", "ckpt_best/best.json",
                 "ckpt_best/2/state.pt"):
        assert os.path.exists(os.path.join(run, name)), name
    assert _steps(run) == [(1, "train"), (2, "train"), (2, "val")]

    out = _run("d3net_tpu_torch.scripts.train", "--config", TINY, "--cpu",
               "--max_steps", "3", "--folder", run)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resumed from step 2" in out.stdout
    assert _steps(run)[3:] == [(3, "train"), (3, "val")]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["2", "3"]

    # bf16 activations, as conf/pointgroup.yaml runs them (the outputs the
    # eval reads stay f32)
    out = _run("d3net_tpu_torch.scripts.eval", "--folder", run, "--task",
               "detection", "--cpu", "--set", "test.TEST_SCORE_THRESH=0.0",
               "--set", "tpu.activation_dtype=bfloat16")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "config override: test.TEST_SCORE_THRESH = 0.0" in out.stdout
    assert "tpu.activation_dtype = 'bfloat16' (was None)" in out.stdout
    res = json.load(open(os.path.join(run, "eval_detection.json")))
    best = json.load(open(os.path.join(run, "ckpt_best", "best.json")))
    assert res["checkpoint"] == {"kind": "best", "step": best["step"]}
    for key in ("mAP@0.25", "mAP@0.5", "AR@0.25", "AR@0.5"):
        assert math.isfinite(res[key]) and 0.0 <= res[key] <= 1.0, key
    assert set(res) >= {"per_class@0.25", "per_class@0.5"}


# the submission and inspection tools: their arguments without --cpu
TOOLS = {"benchmark_captioning": ("--folder", ROOT),
         "benchmark_grounding": ("--folder", ROOT),
         "visualize_captioning": ("--folder", ROOT),
         "visualize_grounding": ("--folder", ROOT),
         "port_enet_weights": ("--selftest",)}


@pytest.mark.parametrize("cli", ["train", "eval", "train_captioning",
                                 "train_grounding", "eval_grounding",
                                 "eval_scannet", "train_enet",
                                 "compute_multiview_features", *TOOLS])
def test_cli_without_cpu_fails_without_gpu(cli, tmp_path):
    run = str(tmp_path / "r")
    config = {"train_captioning": TINY_CAPTION,
              "train_grounding": TINY_GROUNDING}.get(cli, TINY)
    module = {"train_enet": "train_enet",
              "compute_multiview_features": "compute_multiview_features"
              }.get(cli, cli if cli in TOOLS else cli.split("_")[0])
    if module in TOOLS:
        args = TOOLS[module]
    elif module == "eval":
        task = cli.split("_")[1] if "_" in cli else "detection"
        args = ("--folder", ROOT, "--task", task)
    elif module == "train":
        args = ("--config", config, "--max_steps", "1", "--folder", run)
    else:
        args = ("--synthetic", "1", "--output", run) \
            if module == "compute_multiview_features" else (
                "--scenes", "1", "--frames", "1", "--steps", "1",
                "--output", os.path.join(run, "enet.pkl"))
    out = _run(f"d3net_tpu_torch.scripts.{module}", *args, gpu_hidden=True)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not os.path.exists(run)


def test_captioning_train_cli_with_prepared_detector(tmp_path):
    """The curriculum's steps 2-3: a detector run's checkpoint through
    ``prepare_weights``, then the speaker's stage loading it."""
    cfg = tcfg.load(os.path.join(ROOT, TINY_CAPTION))
    det = str(tmp_path / "det")
    os.makedirs(det)
    tcfg.save(cfg, os.path.join(det, "config.yaml"))
    tloop.Checkpointer(det, "total_loss").save(1, create_train_state(
        tloop.init_detector(tloop.detector_from_cfg(cfg), 5)),
        {"total_loss": 1.0})
    out = _run("d3net_tpu_torch.scripts.prepare_weights", "--folder", det,
               "--name", "tiny", "--out", str(tmp_path / "pretrained"))
    assert out.returncode == 0, out.stderr[-3000:]
    pkl = str(tmp_path / "pretrained" / "tiny_detector.pkl")
    assert os.listdir(tmp_path / "pretrained") == ["tiny_detector.pkl"]

    cfg.model.pretrained_detector = pkl
    config = str(tmp_path / "captioning.yaml")
    tcfg.save(cfg, config)
    run = str(tmp_path / "run")
    out = _run("d3net_tpu_torch.scripts.train", "--config", config, "--cpu",
               "--max_steps", "2", "--folder", run)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"loaded pretrained detector from {pkl}" in out.stdout
    for name in ("config.yaml", "run_meta.json", "metrics.jsonl",
                 "caption_diag.json", "ckpt/2/state.pt",
                 "ckpt_best/best.json", "ckpt_best/2/state.pt"):
        assert os.path.exists(os.path.join(run, name)), name
    assert _steps(run) == [(1, "train"), (2, "train"), (2, "val")]
    best = json.load(open(os.path.join(run, "ckpt_best", "best.json")))
    assert best["monitor"] == "cider" and best["mode"] == "max"


def test_modes_not_ported_raise(tmp_path):
    """Once the two guards of the unported modes: now the scan trainer
    (``tpu.steps_per_dispatch``) trains a tiny detector config through the
    train CLI, a second call resumes it, and ``eval --task scannet`` on its
    run dir writes the ScanNet txt tree and ``eval_scannet.json``.
    (conf/debug/tiny_captioning.yaml with the speaker off: a detector run
    whose config has the keys the eval's pipeline model reads.)"""
    cfg = tcfg.load(os.path.join(ROOT, TINY_CAPTION))
    cfg.model.no_captioning = True
    cfg.general.monitor = "val_loss/total_loss"
    cfg.general.monitor_mode = "min"
    cfg.tpu.steps_per_dispatch = 2
    cfg.tpu.augment_variants = 1
    cfg_path = str(tmp_path / "scan.yaml")
    tcfg.save(cfg, cfg_path)
    run = str(tmp_path / "run")
    train_cli.main(["--config", cfg_path, "--cpu", "--max_steps", "2",
                    "--folder", run])
    train_cli.main(["--config", cfg_path, "--cpu", "--max_steps", "4",
                    "--folder", run])
    assert _steps(run) == [(2, "train"), (2, "val"), (4, "train"),
                           (4, "val")]
    assert tloop.StepDir(os.path.join(run, "ckpt"), 3).all_steps() == [2, 4]
    eval_cli.main(["--folder", run, "--task", "scannet", "--cpu"])
    res = json.load(open(os.path.join(run, "eval_scannet.json")))
    best = json.load(open(os.path.join(run, "ckpt_best", "best.json")))
    assert res["checkpoint"] == {"kind": "best", "step": best["step"]}
    for key in ("mIoU", "accuracy", "AP", "AP@50", "AP@25"):
        assert math.isfinite(res[key]) and 0.0 <= res[key] <= 1.0, key
    sem = os.listdir(os.path.join(run, "split_pred", "val", "semantic"))
    assert len(sem) == tloop.num_val_scenes(cfg)


def test_grounding_train_resume_and_eval_cli(tmp_path, capsys):
    """The curriculum's stage 3 in-process: a prepared detector, the
    listener's stage for 2 steps, a resume to 3, then ``eval --task
    grounding``."""
    from d3net_tpu_torch.scripts import prepare_weights

    cfg = tcfg.load(os.path.join(ROOT, TINY_GROUNDING))
    det = str(tmp_path / "det")
    os.makedirs(det)
    tcfg.save(cfg, os.path.join(det, "config.yaml"))
    tloop.Checkpointer(det, "total_loss").save(1, create_train_state(
        tloop.init_detector(tloop.detector_from_cfg(cfg), 5)),
        {"total_loss": 1.0})
    prepare_weights.main(["--folder", det, "--name", "tiny", "--out",
                          str(tmp_path / "pretrained")])
    pkl = str(tmp_path / "pretrained" / "tiny_detector.pkl")
    cfg.model.pretrained_detector = pkl
    config = str(tmp_path / "grounding.yaml")
    tcfg.save(cfg, config)
    run = str(tmp_path / "run")
    capsys.readouterr()
    train_cli.main(["--config", config, "--cpu", "--max_steps", "2",
                    "--folder", run])
    assert f"loaded pretrained detector from {pkl}" in capsys.readouterr().out
    assert _steps(run) == [(1, "train"), (2, "train"), (2, "val")]
    best = json.load(open(os.path.join(run, "ckpt_best", "best.json")))
    assert best["monitor"] == "ref_iou_rate_0.5" and best["mode"] == "max"
    train_cli.main(["--config", config, "--cpu", "--max_steps", "3",
                    "--folder", run])
    assert "resumed from step 2" in capsys.readouterr().out
    assert _steps(run)[3:] == [(3, "train"), (3, "val")]

    eval_cli.main(["--folder", run, "--task", "grounding", "--cpu"])
    res = json.load(open(os.path.join(run, "eval_grounding.json")))
    best = json.load(open(os.path.join(run, "ckpt_best", "best.json")))
    assert res["checkpoint"] == {"kind": "best", "step": best["step"]}
    for key in ("ref_iou_rate_0.25", "ref_iou_rate_0.5", "iou_mean"):
        assert math.isfinite(res[key]) and 0.0 <= res[key] <= 1.0, key


def test_joint_train_resume_and_eval_cli(tmp_path, capsys):
    """The curriculum's stage 4 in-process: ``prepare_weights`` on a
    speaker run and a listener run (checkpoints of seeded pipelines at
    conf/debug/tiny_joint.yaml's widths), joint RL for 2 steps validated by
    ``combined``, a resume to 3, then ``eval --task captioning`` and
    ``--task grounding`` on the joint run dir."""
    from d3net_tpu_torch.params import flax_to_state_dict, init_flax_variables
    from d3net_tpu_torch.scripts import prepare_weights
    from d3net_tpu_torch.train import pipeline as tpl

    joint = tcfg.load(os.path.join(ROOT, "conf", "debug", "tiny_joint.yaml"))
    pre = str(tmp_path / "pretrained")
    for stage, off, seed in (("speaker", "no_grounding", 5),
                             ("listener", "no_captioning", 6)):
        cfg = tcfg.load(os.path.join(ROOT, "conf", "debug",
                                     "tiny_joint.yaml"))
        setattr(cfg.model, off, True)
        run = str(tmp_path / stage)
        os.makedirs(run)
        tcfg.save(cfg, os.path.join(run, "config.yaml"))
        model = tpl.pipeline_from_cfg(cfg, tpl.build_vocab(cfg)[0])
        model.load_state_dict(flax_to_state_dict(
            init_flax_variables(model, seed), model))
        tloop.Checkpointer(run, "cider").save(1, create_train_state(model),
                                              {"cider": 0.0})
        prepare_weights.main(["--folder", run, "--name", stage, "--out",
                              pre])
    joint.model.pretrained_detector = os.path.join(pre,
                                                   "speaker_detector.pkl")
    joint.model.pretrained_speaker = os.path.join(pre, "speaker_speaker.pkl")
    joint.model.pretrained_listener = os.path.join(pre,
                                                   "listener_listener.pkl")
    joint.general.monitor = "val_score/combined"
    config = str(tmp_path / "joint.yaml")
    tcfg.save(joint, config)
    run = str(tmp_path / "run")
    capsys.readouterr()
    train_cli.main(["--config", config, "--cpu", "--max_steps", "2",
                    "--folder", run])
    out = capsys.readouterr().out
    for sub in ("detector", "speaker", "listener"):
        assert f"loaded pretrained {sub} from" in out, sub
    assert _steps(run) == [(1, "train"), (2, "train"), (2, "val")]
    best = json.load(open(os.path.join(run, "ckpt_best", "best.json")))
    assert best["monitor"] == "combined" and best["mode"] == "max"
    train_cli.main(["--config", config, "--cpu", "--max_steps", "3",
                    "--folder", run])
    assert "resumed from step 2" in capsys.readouterr().out
    assert _steps(run)[3:] == [(3, "train"), (3, "val")]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert all(math.isfinite(v) for r in recs for v in r.values())
    assert {"train/ttl_rwd", "train/cap_rwd", "train/lis_ref_loss"} <= set(
        recs[0])

    best = json.load(open(os.path.join(run, "ckpt_best", "best.json")))
    for task, keys in (("captioning", ("cider", "bleu4", "rouge")),
                       ("grounding", ("ref_iou_rate_0.25",
                                      "ref_iou_rate_0.5"))):
        eval_cli.main(["--folder", run, "--task", task, "--cpu"])
        res = json.load(open(os.path.join(run, f"eval_{task}.json")))
        assert res["checkpoint"] == {"kind": "best", "step": best["step"]}
        for key in keys:
            assert math.isfinite(res[key]), (task, key)
