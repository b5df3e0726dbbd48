"""``d3net_tpu_torch/trace.py``: spans and counters that record only while
a ``torch.profiler`` session records, nest with their parents and ids,
lie in the exported Chrome trace at their in-memory stamps, follow the
session on the loaders' worker threads, charge counters to the innermost
span from any thread, start a new record with each session, and record
the collectives of two gloo ranks."""

import json
import sys
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d3net_tpu_torch import checks, trace
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch
from d3net_tpu_torch.data.dataset import BatchIterator
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.params import load_detector
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.train.trainer import (
    create_train_state, detector_train_step,
)

STEP_SPANS = {"train.step": None, "train.forward": "train.step",
              "det.backbone": "train.forward", "det.cluster": "train.forward",
              "det.scorenet": "train.forward", "train.loss": "train.step",
              "train.backward": "train.step", "train.optim": "train.step"}


@pytest.fixture(scope="module")
def step():
    """One tiny detector train step on the CPU (checks.DP_CFG's model on
    two scenes, the case's fixed draws)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    case = checks.detector_dp_case(2)
    state = create_train_state(load_detector(case["variables"], case["cfg"],
                                             device="cpu"), lr=1e-3)
    batch = batch_to_torch(case["batch"], "cpu")
    kw = dict(jitter_u=torch.from_numpy(case["jitter"]),
              proposal_perm=torch.from_numpy(case["perm"])[None])
    yield lambda: detector_train_step(state, batch, **kw)
    torch.set_num_threads(n)


def _session(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_off_records_nothing_and_enters_no_record_function(step,
                                                           monkeypatch):
    _session(lambda: None)             # an empty window to compare with
    before = trace.last_window()

    def refuse(*a, **kw):
        raise AssertionError("record_function called while off")

    # the tracer's own route to record_function (torch's optimizer takes
    # its own)
    monkeypatch.setattr(trace, "_profiler",
                        types.SimpleNamespace(record_function=refuse))
    assert not trace.enabled()
    step()
    after = trace.last_window()
    assert after.spans == before.spans == []
    assert after.counts == {} and after.start_ns == before.start_ns


def test_spans_nest_and_lie_in_the_chrome_trace(step, tmp_path):
    prof = _session(step)
    w = trace.last_window()
    got = {s.name: s for s in w.spans}
    assert set(STEP_SPANS) <= set(got)
    top = got["train.step"]
    for name, parent in STEP_SPANS.items():
        s = got[name]
        assert (s.parent.name if s.parent else None) == parent, name
        assert s.id == top.id and s.traced and s.t0 <= s.t1
        assert top.t0 <= s.t0 and s.t1 <= top.t1
    path = str(tmp_path / "trace.json")
    trace.export_chrome_trace(prof, path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    for name in STEP_SPANS:
        ev = [e for e in doc["traceEvents"]
              if e.get("name") == "d3net." + name
              and e.get("cat") == "user_annotation"]
        assert len(ev) == 1, name
        # within 0.5 ms of the trace's own event on the shared clock
        assert abs(ev[0]["ts"] * 1e3 + base - got[name].t0) < 5e5, name


@pytest.mark.parametrize("workers", [1, 2])
def test_worker_collates_carry_their_batch_id(tmp_path, workers):
    scenes = [make_scene(seed=i, **checks.DP_SCENE) for i in range(6)]
    it = BatchIterator(scenes, BatchSpec(**checks.DP_SPEC), 2,
                       shuffle=False, augment=False, workers=workers)
    it.epoch = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        items = iter(it)
        while True:
            with trace.span("eval.batch") as s:
                with trace.span("data.wait"):
                    item = next(items, None)
                if item is None:
                    s.drop()
                    break
    w = trace.last_window()
    collates = w.named("data.collate")
    main = threading.main_thread().native_id
    assert sorted(s.id for s in collates) == [(3, b) for b in range(3)]
    assert all(s.tid != main and not s.traced for s in collates)
    batches = w.named("eval.batch")
    assert [s.id for s in batches] == [(3, b) for b in range(3)]
    waits = w.named("data.wait")
    assert len(waits) == 4 and waits[-1].parent is None
    assert [s.id for s in waits[:3]] == [(3, b) for b in range(3)]
    path = str(tmp_path / "trace.json")
    trace.export_chrome_trace(prof, path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows = {e["tid"] for e in events if e.get("name") == "d3net.data.collate"}
    scene_rows = {e["tid"] for e in events
                  if e.get("name") == "d3net.data.collate.scene"}
    named = {e["tid"] for e in events if e.get("ph") == "M"
             and "d3net spans" in e["args"].get("name", "")}
    assert rows and scene_rows and rows | scene_rows == named
    assert main not in named
    # a batch whose rows several threads collate is an async slice
    phases = sorted(e["ph"] for e in events
                    if e.get("name") == "d3net.data.collate")
    assert phases == (["X"] * 3 if workers == 1 else ["b"] * 3 + ["e"] * 3)
    assert sum(e.get("name") == "d3net.eval.batch" for e in events) >= 3


def test_counters_charge_the_innermost_span_from_every_thread():
    threads_n, per = 8, 2000

    def work(i):
        with trace.span(f"t{i}"):
            for _ in range(per):
                trace.count("n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("outer"):
                with trace.span("inner"):
                    trace.count("n", 3)
                trace.count("n", 2)
                pool = [threading.Thread(target=work, args=(i,))
                        for i in range(threads_n)]
                for t in pool:
                    t.start()
                for t in pool:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    w = trace.last_window()
    got = {s.name: s.counts.get("n", 0) for s in w.spans}
    assert got["inner"] == 3 and got["outer"] == 2
    assert all(got[f"t{i}"] == per for i in range(threads_n))
    assert w.counts["n"] == 5 + threads_n * per
    assert w.under("outer", "n") == [5]


def test_a_new_session_clears_the_window():
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span(name):
                trace.count("k")
    w = trace.last_window()
    assert [s.name for s in w.spans] == ["second"] and w.counts == {"k": 1}


def test_two_gloo_ranks_record_collectives():
    every = mesh.spawn(checks.trace_rank, 2, threads=1)
    for r in every:
        assert r["total"] == [3.0] * 4
        names = [n for n, _ in r["spans"]]
        assert names == ["dist.all_reduce", "dist.all_reduce",
                         "dist.all_gather", "dist.broadcast_object_list"]
        assert all(c["collectives"] == 1 for _, c in r["spans"])
        # 4 + 1 float32s reduced, 2 x 3 int32s gathered, no tensor sent
        assert r["counts"] == {"collectives": 4, "collective_bytes": 44}
