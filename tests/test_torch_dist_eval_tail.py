"""``test_torch_dist_eval.py``'s four evals on 3 val scenes: the short
last batch (one scene) does not split over 2 ranks, so rank 0 runs it
alone under ``mesh.local()`` while rank 1 runs none of it, and world 2
still equals world 1 (metrics, ``eval_<task>.json``, the ``split_pred``
tree byte-equal). Then the programmatic entry spawning its own ranks, and
the rule that picks the ranks of an eval.
"""

import json
import os

import pytest
import torch

from d3net_tpu_torch import checks
from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.scripts import eval as eval_cli

from test_torch_dist_eval import (  # noqa: F401 (one_thread: a fixture)
    CONFIGS, SEEDS, TASKS, one_thread, world_report,
)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    return world_report(tmp_path_factory.mktemp("dist_eval_tail"), 3)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_two_ranks_equal_one_with_a_short_last_batch(report, task):
    rec = next(r for r in report["evals"] if r["task"] == task)
    assert rec["mismatches"] == []
    # rank 0 runs both batches; rank 1 has no rows of the last
    assert rec["val_batches_per_rank"] == [2, 1]


def _json(run_dir):
    with open(os.path.join(run_dir, "eval_detection.json")) as f:
        return json.load(f)


def test_eval_entry_spawns_its_ranks(tmp_path, monkeypatch):
    """``eval_detection(world_size=2)`` starts its own 2 ranks and returns
    world 1's numbers; rank 0 writes the file, stamped as world 1's."""
    monkeypatch.setenv("D3NET_VAL_SCENES", "3")
    run = str(tmp_path / "det")
    checks.seeded_run_dir(CONFIGS["det"], run, seed=SEEDS["det"])
    cfg = tcfg.load(os.path.join(run, "config.yaml"))
    one = eval_cli.eval_detection(cfg, run, "cpu")
    one_file = _json(run)
    two = eval_cli.eval_detection(cfg, run, "cpu", world_size=2, threads=1)
    two_file = _json(run)
    assert one["mAP@0.25"] > 0
    assert two_file["checkpoint"] == {"kind": "best", "step": 3}
    assert checks.values_differ(two, one, "metrics", checks.EVAL_RTOL) == []
    assert checks.values_differ(two_file, one_file, "json",
                                 checks.EVAL_RTOL) == []


def test_eval_world_rule():
    """One rank on the CPU unless asked, and inside a process group; a
    count that does not divide the batch raises."""
    cpu = torch.device("cpu")
    assert mesh.run_world(2, cpu) == 1
    assert mesh.run_world(2, cpu, 2) == 2
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        mesh.run_world(2, cpu, 3)
