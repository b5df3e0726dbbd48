"""The frozen reference against the port's CPU path at tiny sizes: in
float32 the program's first steps and the reference's agree exactly, and
the clustering stage rerun on the program's inputs gives its clusters."""

import torch

from perfbench.drivers import det_train
from perfbench.harness import bench
from perfbench.tests import cells


def _driver(seed, f32=True):
    cell = cells.tiny_det_cell({})
    if f32:
        cell.config["config"]["tpu"]["activation_dtype"] = None
    drv = det_train.Driver(bench.Run(cell, seed, 0.0, False,
                                     torch.device("cpu")))
    drv.release()
    return drv


def test_frozen_reference_equals_the_port_in_float32():
    nums = _driver(3).check()
    assert set(nums.values()) == {0.0}


def test_bfloat16_program_follows_its_clusters():
    nums = _driver(4, f32=False).check()
    assert nums["clusters"] == 0.0
    assert 0.0 < nums["loss"] < 0.05


def test_bfloat16_gap_is_the_type_alone():
    # the frozen model in the program's own bfloat16 gives the program's
    # numbers exactly (the step draws line up), so the gap to the float32
    # reference is the type's
    wit = _driver(4, f32=False).witness()
    assert set(wit["witness.program"].values()) == {0.0}
    assert wit["witness.dtype"]["grad.diff"] > 0.01


def test_control_and_half_batch_read_off_the_reference():
    drv = _driver(5)
    ctl = drv.check(control="float8_e4m3fn")
    half = drv.check(fault="half_batch")
    assert ctl["loss"] > 0 and ctl["grad"] > 0
    assert half["loss"] > 0.01 and half["grad"] > 0.1
