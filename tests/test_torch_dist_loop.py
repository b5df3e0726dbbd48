"""The port's run loops over a process group (``parallel/mesh.py``) at
conf/debug/ tiny widths, B=2, on 2 gloo ranks (one scene each) against
world size 1: the detector loop (``run_detector_training``: 2 steps, then
a resume to 3), the scan trainer (``run_detector_training_scan``, one
dispatch of 2 steps, through the programmatic entry
``scripts.train.train(world_size=2)``) and the mode-3 joint loop
(``run_pipeline_training``, 2 steps).

One run dir a run, written by rank 0 alone: ``config.yaml``,
``run_meta.json`` (with ``world_size``), ``metrics.jsonl``, ``ckpt/`` and
``ckpt_best/``. The logged records equal world 1's within the loop
tolerance (rtol 1e-4 / atol 1e-6, under SGD as ``tests/test_torch_loop.py``
holds loop steps: AdamW's first steps move parameters by ±lr whatever
their gradient's size). A fresh state restored from the 2-rank run dir on
each rank equals that rank's final state bit for bit, and the ranks' final
parameters are bit-identical. The logged cap counters are the global
batch's, and a run's first log line counts its own builds alone.
"""

import json
import os

import numpy as np
import pytest
import torch

from d3net_tpu_torch import checks
from d3net_tpu_torch.data.collate import CAP_STATS
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.scripts import train as train_cli

TINY = "conf/debug/tiny_pointgroup.yaml"


def _cfg(scan=False):
    cfg = train_cli.load_task_config(TINY)
    cfg.train.optim.classname = "SGD"
    if scan:
        cfg.tpu.steps_per_dispatch = 2
    return cfg


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_loop")
    d = {k: str(root / k) for k in ("loop1", "loop2", "scan1", "scan2",
                                    "joint2")}
    joint = train_cli.load_task_config("conf/debug/tiny_joint.yaml")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # a count left by an earlier build in this process: the run's first
        # log line must not carry it (the ranks start with none)
        CAP_STATS.add(cap_points_truncated=12345)
        one = checks.train_rank(_cfg(), d["loop1"], [2, 3])
        train_cli.train(_cfg(scan=True), d["scan1"], 2, device="cpu")
    finally:
        torch.set_num_threads(n)
    ranks = mesh.spawn(checks.rank_calls, 2, [
        (checks.train_rank, (_cfg(), d["loop2"], [2, 3]), {}),
        (checks.train_rank, (joint, d["joint2"], [2]), {}),
        (checks.cap_counters_rank, (), {})], threads=1)
    train_cli.train(_cfg(scan=True), d["scan2"], 2, device="cpu",
                    world_size=2, threads=1)
    return {"dirs": d, "one": one, "ranks": ranks}


@pytest.mark.parametrize("name", ["loop", "scan"])
def test_metrics_match_world1(runs, name):
    want = _records(runs["dirs"][f"{name}1"])
    got = _records(runs["dirs"][f"{name}2"])
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert any(k.startswith("val/") for r in got for k in r)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k, v in b.items():
            if k.endswith(("iter_time", "steps_per_sec")) or k == "step":
                continue
            np.testing.assert_allclose(a[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {b['step']} {k}")


@pytest.mark.parametrize("name", ["loop2", "scan2", "joint2"])
def test_rank0_writes_one_run_dir(runs, name):
    run_dir = runs["dirs"][name]
    for f in ("config.yaml", "run_meta.json", "metrics.jsonl", "ckpt",
              "ckpt_best"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    with open(os.path.join(run_dir, "run_meta.json")) as f:
        assert json.load(f)["world_size"] == 2
    steps = [r["step"] for r in _records(run_dir)]
    assert steps == sorted(steps)       # one writer: no record twice


def test_resume_restores_bit_exact_and_ranks_agree(runs):
    loop = [r[0] for r in runs["ranks"]]
    assert runs["one"]["restored_equal"]
    assert all(r["restored_equal"] for r in loop)
    assert loop[0]["step"] == loop[1]["step"] == 3
    for k, v in loop[0]["state"].items():
        np.testing.assert_array_equal(loop[1]["state"][k], v, err_msg=k)
        np.testing.assert_allclose(v, runs["one"]["state"][k], rtol=1e-5,
                                   atol=2e-6, err_msg=k)


def test_joint_loop_ends_with_finite_combined(runs):
    val = [r for r in _records(runs["dirs"]["joint2"])
           if "val/combined" in r]
    assert val and val[-1]["step"] == 2
    assert np.isfinite(val[-1]["val/combined"])
    j0, j1 = (r[1] for r in runs["ranks"])
    for k, v in j0["state"].items():
        np.testing.assert_array_equal(j1["state"][k], v, err_msg=k)


def test_cap_counters_sum_over_ranks(runs):
    """A rank counts the truncations of the rows it collates; the logged
    cap counters are the global batch's: 1 + 2 on 2 ranks, on each."""
    for r in runs["ranks"]:
        assert r[2]["cap_points_truncated"] == 3
        assert r[2]["cap_voxel_overflow"] == 0
