"""``scripts/process_start.py``: each step in a fresh interpreter, timed,
with a shared bytecode cache written by the first process; without a GPU
it needs ``--cpu``."""

import os

import pytest
import torch

from d3net_tpu_torch.scripts import process_start


def test_steps_timed_in_fresh_processes_with_a_shared_cache(tmp_path,
                                                            capsys):
    cache = tmp_path / "pycache"
    res = process_start.main(["--reps", "1", "--cpu", "--cache",
                              str(cache)])
    assert list(res) == ["bare", "import_torch", "import_checks",
                         "train_help"]
    assert all(len(v) == 1 and v[0] > 0 for v in res.values())
    assert '"cache": true' in capsys.readouterr().out
    # the processes wrote the port's bytecode into the shared cache
    written = [f for _, _, files in os.walk(cache) for f in files
               if f.startswith("checks.") and f.endswith(".pyc")]
    assert written


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_without_a_gpu_needs_cpu():
    with pytest.raises(RuntimeError, match="--cpu"):
        process_start.main(["--reps", "1"])
