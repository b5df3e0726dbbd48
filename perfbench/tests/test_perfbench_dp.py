"""The data-parallel cell's path on the CPU: two gloo ranks through the
harness, one scene each; a sound run comes out correct and one whose
ranks never exchange their gradients does not."""

import pytest

from perfbench.tests import cells, faults
from perfbench.tests.test_perfbench_faults import _cell


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_two_ranks(fault):
    out = faults.run_world(_cell(), 2, cells.args(seed=9), fault)
    assert out["device"]["count"] == 2
    assert out["correct"] == (fault is None), out["checks"]
