"""The readers of the program's spans and counters, driven through the
harness on both tiny cells: with ``--trace 1`` each reads a number from
the traced unit's window; with ``--trace 0`` none runs and the program's
tracer records nothing."""

import time

import pytest

from d3net_tpu_torch import trace
from perfbench.harness import bench
from perfbench.harness.names import load_cell
from perfbench.tests import cells

SPAN_METRICS = {
    "caption_eval": ["data_wait.eval", "collate_ms.eval", "h2d_gbps.eval",
                     "detector_ms.eval", "speaker_ms.eval",
                     "host_syncs.eval"],
    "flagship_det_train": ["host_syncs.train"],
}


def _cell(name):
    """The cell's tiny copy with the per-layer metrics BENCHMARK.json gives
    the cell."""
    want = load_cell(name)
    c = (cells.tiny_caption_cell(want.limits()) if name == "caption_eval"
         else cells.tiny_det_cell(want.limits()))
    c.config["config"]["tpu"]["activation_dtype"] = None
    c.per_layer = want.per_layer
    return c


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_readers_read_the_traced_unit(name):
    out = bench.run_rank(0, 1, cells.args(seed=9, seconds=0.1, trace=1), 0,
                         time.perf_counter(), _cell(name), "cpu")
    for m in SPAN_METRICS[name]:
        v = out["metrics"][m]["value"]
        assert isinstance(v, float) and v >= 0, (m, v)
    if name == "caption_eval":
        got = out["metrics"]
        assert 0 < got["data_wait.eval"]["value"] < 100
        assert got["h2d_gbps.eval"]["value"] > 0


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_untraced_runs_read_no_spans(name):
    before = trace.last_window()
    out = bench.run_rank(0, 1, cells.args(seed=9, seconds=0.1, trace=0), 0,
                         time.perf_counter(), _cell(name), "cpu")
    assert not set(SPAN_METRICS[name]) & set(out["metrics"])
    assert trace.last_window().start_ns == before.start_ns
