"""The port's train and eval CLIs on the CPU (conf/debug/tiny_pointgroup.yaml).

``python -m d3net_tpu_torch.scripts.train --cpu --max_steps 2`` leaves the
JAX run-dir layout, a second call resumes from the saved step and goes on,
and ``python -m d3net_tpu_torch.scripts.eval --task detection --cpu``
writes ``eval_detection.json`` stamped with its checkpoint. Without
``--cpu`` and without a GPU both exit non-zero; the tasks and trainers
that are not ported raise ``NotImplementedError`` naming their ROADMAP item
(``--task captioning`` is held in tests/test_torch_pipeline.py).
"""

import json
import math
import os
import subprocess
import sys

import pytest

from d3net_tpu_torch.scripts import eval as eval_cli
from d3net_tpu_torch.scripts import train as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "conf/debug/tiny_pointgroup.yaml"


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


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_cli_without_cpu_fails_without_gpu(cli, tmp_path):
    run = str(tmp_path / "r")
    args = (("--config", TINY, "--max_steps", "1", "--folder", run)
            if cli == "train" else ("--folder", ROOT, "--task", "detection"))
    out = _run(f"d3net_tpu_torch.scripts.{cli}", *args, gpu_hidden=True)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not os.path.exists(run)


def test_modes_not_ported_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="queue A items 13-15"):
        train_cli.main(["--config", os.path.join(
                            ROOT, "conf", "debug", "tiny_captioning.yaml"),
                        "--cpu", "--folder", str(tmp_path / "c")])
    cfg_path = tmp_path / "scan.yaml"
    cfg_path.write_text(open(os.path.join(ROOT, TINY)).read()
                        + "  steps_per_dispatch: 4\n")
    with pytest.raises(NotImplementedError, match="scan trainer"):
        train_cli.main(["--config", str(cfg_path), "--cpu"])
    (tmp_path / "config.yaml").write_text(open(os.path.join(ROOT, TINY)).read())
    for task in ("grounding", "scannet"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            eval_cli.main(["--folder", str(tmp_path), "--task", task,
                           "--cpu"])
