"""The port stands alone: no module of d3net_tpu_torch, nor chip_smoke.py,
imports JAX, Flax, optax, the JAX package or the repo's scripts (the probe
keeps its own copy of what it needs from scripts/pallas_probe.py), nor
PyYAML, orbax, TensorFlow, h5py or PIL, which the card's machine lacks; entry
points refuse to fall back to the CPU quietly."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import d3net_tpu_torch
names = [m.name for m in pkgutil.walk_packages(d3net_tpu_torch.__path__,
                                               "d3net_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "d3net_tpu", "scripts", "pallas_probe",
                                    "yaml", "orbax", "tensorflow", "h5py",
                                    "PIL"))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def _run(args, cwd=ROOT, timeout=120):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(args, capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=timeout)


def test_port_imports_no_jax_flax_or_reference():
    import json

    out = _run([sys.executable, "-c", _IMPORT_ALL.format(root=ROOT)])
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("d3net_tpu_torch.models.pointgroup",
                "d3net_tpu_torch.kernels.gather", "d3net_tpu_torch.params",
                "d3net_tpu_torch.kernels.probe", "d3net_tpu_torch.probe",
                "d3net_tpu_torch.train.losses",
                "d3net_tpu_torch.train.trainer", "d3net_tpu_torch.train.loop",
                "d3net_tpu_torch.config", "d3net_tpu_torch.ops.native",
                "d3net_tpu_torch.data.dataset",
                "d3net_tpu_torch.eval.detection",
                "d3net_tpu_torch.scripts.train",
                "d3net_tpu_torch.scripts.eval",
                "d3net_tpu_torch.data.vocab", "d3net_tpu_torch.data.language",
                "d3net_tpu_torch.models.graph",
                "d3net_tpu_torch.models.caption",
                "d3net_tpu_torch.models.speaker",
                "d3net_tpu_torch.models.pipeline",
                "d3net_tpu_torch.eval.capeval",
                "d3net_tpu_torch.eval.caption_eval",
                "d3net_tpu_torch.train.pipeline", "d3net_tpu_torch.checks",
                "d3net_tpu_torch.models.enet", "d3net_tpu_torch.data.frames",
                "d3net_tpu_torch.data.multiview",
                "d3net_tpu_torch.eval.segmentation",
                "d3net_tpu_torch.eval.scannet_eval",
                "d3net_tpu_torch.scripts.train_enet",
                "d3net_tpu_torch.scripts.compute_multiview_features",
                "d3net_tpu_torch.scripts.convert_multiview_hdf5",
                "d3net_tpu_torch.utils.ply", "d3net_tpu_torch.data.scanrefer",
                "d3net_tpu_torch.scripts.benchmark_captioning",
                "d3net_tpu_torch.scripts.benchmark_grounding",
                "d3net_tpu_torch.scripts.visualize_captioning",
                "d3net_tpu_torch.scripts.visualize_grounding",
                "d3net_tpu_torch.scripts.visualize_scannet",
                "d3net_tpu_torch.scripts.port_enet_weights",
                "d3net_tpu_torch.parallel.mesh",
                "d3net_tpu_torch.parallel.dryrun",
                "d3net_tpu_torch.jax_run",
                "d3net_tpu_torch.scripts.import_jax_run",
                "d3net_tpu_torch.scripts.prepare_scannet",
                "d3net_tpu_torch.scripts.scan2cad_to_scannet",
                "d3net_tpu_torch.scripts.profile_ops",
                "d3net_tpu_torch.data.raw_scans"):
        assert mod in res["modules"]
    assert os.path.exists(os.path.join(ROOT, "d3net_tpu_torch", "train",
                                       "__init__.py"))


def test_curriculum_script_runs_only_port_modules():
    """Every command of ``run_r5_curriculum.sh`` is ``python -m`` of a port
    module that the import test above holds to the port alone: none names
    the JAX package or the repo's ``scripts/``."""
    import importlib.util
    import re

    path = os.path.join(ROOT, "d3net_tpu_torch", "scripts",
                        "run_r5_curriculum.sh")
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    commands = [line.split() for line in text.splitlines()
                if line.strip().startswith("python")]
    assert len(commands) == 11
    for words in commands:
        assert not any("d3net_tpu." in w or "scripts/" in w for w in words)
        assert words[:2] == ["python", "-m"]
        assert re.fullmatch(r"d3net_tpu_torch\.scripts\.\w+", words[2])
        assert importlib.util.find_spec(words[2]) is not None


def test_jax_run_exporter_imports_no_port():
    """``scripts/export_jax_run.py`` runs where the JAX run lives: every
    import it makes, those inside its functions included, is of the JAX
    package, JAX, orbax or numpy, never of the port."""
    import ast

    with open(os.path.join(ROOT, "scripts", "export_jax_run.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert not any(m.split(".")[0] == "d3net_tpu_torch" for m in mods)
    assert {"d3net_tpu.train.loop", "jax", "numpy"} <= mods


def test_load_detector_without_device_raises_without_gpu(monkeypatch):
    from d3net_tpu_torch import params
    from d3net_tpu_torch.models.pointgroup import PointGroup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    variables = params.init_flax_variables(
        PointGroup(9, m=4, blocks=(1, 2)), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params.load_detector(variables, dict(m=4, blocks=(1, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        params.load_detector(variables, dict(m=4, blocks=(1, 2)),
                             device="cuda")


def _smoke(path, cuda: bool, cwd):
    """Run chip_smoke.py as __main__ with torch.cuda.is_available forced."""
    code = ("import sys, runpy, torch\n"
            f"torch.cuda.is_available = lambda: {cuda}\n"
            f"sys.argv = [{path!r}]\n"
            f"runpy.run_path({path!r}, run_name='__main__')\n")
    return _run([sys.executable, "-c", code], cwd=cwd)


def test_chip_smoke_fails_without_cuda():
    out = _smoke(os.path.join(ROOT, "chip_smoke.py"), False, ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    it fails even where a card is present."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _smoke(str(tmp_path / "chip_smoke.py"), True, tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "No module named 'd3net_tpu_torch'" in out.stderr
