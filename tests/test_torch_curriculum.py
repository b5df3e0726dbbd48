"""The port's round-5 curriculum script
(``d3net_tpu_torch/scripts/run_r5_curriculum.sh``) against the JAX
package's ``scripts/run_r5_curriculum.sh``: the same commands in the same
order once ``python scripts/X.py`` reads ``python -m
d3net_tpu_torch.scripts.X``, the same env knobs and defaults, valid bash
that changes to the repo root; each of the four ``*_converge`` configs
builds its model through the port at its published widths; and each
stage's ``prepare_weights`` pickles are the pretrained paths the next
configs read."""

import os
import re
import shlex
import subprocess

import pytest

from d3net_tpu_torch.scripts.import_jax_run import model_of
from d3net_tpu_torch.scripts.train import load_task_config, loop_of
from d3net_tpu_torch.train.pipeline import SUBMODULES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "d3net_tpu_torch", "scripts", "run_r5_curriculum.sh")
JAX = os.path.join(ROOT, "scripts", "run_r5_curriculum.sh")
CONFIGS = ("det_converge", "spk_converge", "lis_converge", "joint_converge")


def _lines(path):
    """The script's logical lines: continuations joined, comments and blank
    lines dropped."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    return [" ".join(line.split()) for line in text.splitlines()
            if line.strip() and not line.lstrip().startswith("#")]


def _commands(path):
    return [line for line in _lines(path) if line.startswith("python ")]


def _knobs(path):
    return dict(re.findall(r"^(\w+)=\$\{\1:-(\w+)\}$", "\n".join(
        _lines(path)), re.M))


def _to_port(line):
    return re.sub(r"^python scripts/(\w+)\.py",
                  r"python -m d3net_tpu_torch.scripts.\1", line)


def test_commands_match_the_jax_script():
    jax = _commands(JAX)
    assert len(jax) == 11
    assert _commands(PORT) == [_to_port(c) for c in jax]
    assert _lines(PORT)[-1] == _lines(JAX)[-1] == "echo CURRICULUM DONE"
    assert _lines(PORT)[0] == _lines(JAX)[0] == "set -x"
    # the trains and prepare_weights stop the script on failure, as in JAX
    assert [c.endswith("|| exit 1") for c in _commands(PORT)] == [
        c.endswith("|| exit 1") for c in jax]


def test_env_knobs_match_the_jax_script():
    knobs = _knobs(PORT)
    assert knobs == _knobs(JAX) == {"DET_STEPS": "576", "SPK_STEPS": "128",
                                    "LIS_STEPS": "128", "JOINT_STEPS": "48"}
    for name in knobs:
        assert any(f'"${name}"' in c for c in _commands(PORT))


def test_script_is_valid_bash_and_changes_to_the_repo_root():
    out = subprocess.run(["bash", "-n", PORT], capture_output=True,
                         text=True, timeout=30)
    assert out.returncode == 0, out.stderr
    cd = [line for line in _lines(PORT) if line.startswith("cd ")]
    assert cd == ['cd "$(dirname "$0")/../.."']
    out = subprocess.run(["bash", "-c", cd[0] + " && pwd", PORT],
                         capture_output=True, text=True, timeout=30)
    assert os.path.realpath(out.stdout.strip()) == os.path.realpath(ROOT)
    assert os.access(PORT, os.X_OK)


@pytest.mark.parametrize("name", CONFIGS)
def test_converge_config_builds_its_model(name):
    """Published widths, no forward pass: the detector of 5 levels at m=16
    and 65,536 points, and each stage's submodules, frozen as its loop
    freezes them."""
    cfg = load_task_config(os.path.join(ROOT, "conf", f"{name}.yaml"))
    loop = loop_of(cfg)
    assert loop == ("scan" if name == "det_converge" else "pipeline")
    model = model_of(cfg, loop)
    det = model if loop == "scan" else model.detector
    assert cfg.model.m == 16 and len(cfg.model.blocks) == 5
    assert cfg.data.max_num_point == 65536
    assert sum(p.numel() for p in det.parameters()) > 1_000_000
    subs = {s for s in SUBMODULES if hasattr(model, s)} if loop != "scan" \
        else {"detector"}
    want = {"det_converge": {"detector"},
            "spk_converge": {"detector", "speaker"},
            "lis_converge": {"detector", "listener"},
            "joint_converge": {"detector", "speaker", "listener"}}[name]
    assert subs == want
    if loop == "pipeline":
        assert cfg.model.freeze_detector
        assert not any(p.requires_grad for p in model.detector.parameters())
        for sub in subs - {"detector"}:
            assert all(p.requires_grad
                       for p in getattr(model, sub).parameters())


def _args(command):
    words = shlex.split(command.replace("|| exit 1", ""))
    module = words[2].rsplit(".", 1)[1]
    return module, dict(zip(words[3::2], words[4::2]))


def test_each_stage_hands_its_weights_to_the_next():
    written = {}          # pickle path -> the train run it came from
    trained = {}          # run folder -> its config's name
    for command in _commands(PORT):
        module, args = _args(command)
        if module == "train":
            cfg_name = os.path.basename(args["--config"])[:-len(".yaml")]
            cfg = load_task_config(os.path.join(ROOT, args["--config"]))
            for sub in SUBMODULES:
                path = cfg.model.get(f"pretrained_{sub}")
                if path:
                    assert path in written, (cfg_name, sub, path)
            folder = os.path.join(cfg.general.output_root.rstrip("/"),
                                  args["--folder"])
            trained[folder] = cfg
        elif module == "prepare_weights":
            cfg = trained[args["--folder"]]
            loop = loop_of(cfg)
            model = model_of(cfg, loop)
            subs = ["detector"] if loop == "scan" else [
                s for s in SUBMODULES if hasattr(model, s)]
            for sub in subs:
                written[os.path.join("pretrained",
                                     f"{args['--name']}_{sub}.pkl")] = cfg
            assert args["--which"] == "best"
        else:
            assert module == "eval"
            assert args["--folder"] in trained
            assert args["--task"] in ("captioning", "grounding")
    assert set(written) >= {"pretrained/det_converge_detector.pkl",
                            "pretrained/spk_converge_speaker.pkl",
                            "pretrained/lis_converge_listener.pkl"}
    assert len(trained) == 4
