"""The harness driven on the CPU at tiny sizes past its look for a chip:
a sound run comes out correct, and each fault the cell can have, planted
under the timed path, comes out not correct."""

import time

import pytest

from perfbench.harness import bench
from perfbench.harness.names import load_cell
from perfbench.tests import cells, faults


def _cell(name="flagship_det_train", chips=1):
    # the cell's own limits on its tiny copy, in float32: the sound
    # program then agrees with the reference exactly
    c = cells.tiny_det_cell(load_cell(name).limits(), chips)
    c.config["config"]["tpu"]["activation_dtype"] = None
    return c


def _run(cell):
    return bench.run_rank(0, 1, cells.args(seed=7), 0, time.perf_counter(),
                          cell, "cpu")


def test_sound_run_is_correct():
    out = _run(_cell())
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_scenes_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_fault_is_not_correct(monkeypatch, fault):
    faults.plant(monkeypatch.setattr, fault)
    out = _run(_cell())
    assert not out["correct"], out["checks"]


def _caption_cell():
    return cells.tiny_caption_cell(load_cell("caption_eval").limits())


def test_sound_eval_is_correct():
    out = bench.run_rank(0, 1, cells.args(seed=8, seconds=0.2), 0,
                         time.perf_counter(), _caption_cell(), "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["eval_batch_ms_p50"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered_token", "wrong_offsets",
                                   "wrong_objectness", "wrong_graph"])
def test_eval_fault_is_not_correct(monkeypatch, fault):
    # a detector head or graph at fault moves which points and proposals
    # are captioned and what the decoder reads; the reference follows
    # those decisions and inputs, so its own stage outputs have to catch
    # the fault
    faults.plant(monkeypatch.setattr, fault)
    out = bench.run_rank(0, 1, cells.args(seed=8, seconds=0.2), 0,
                         time.perf_counter(), _caption_cell(), "cpu")
    assert not out["correct"], out["checks"]
