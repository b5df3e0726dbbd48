"""The scan trainer's ``log.profile_step`` window (``train/loop.py``
``run_detector_training_scan``) on conf/debug/tiny_pointgroup.yaml on the
CPU: ``profile_step: 1`` traces the first of two 2-step dispatches, its
val batch and checkpoint into ``profile/trace.json``, with the val
loader's collate on its worker thread merged in on the trace's clock."""

import json
import os

import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch.train import loop as tloop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_pointgroup.yaml")


def test_scan_trainer_traces_the_dispatch_of_profile_step(tmp_path):
    cfg = tcfg.load(TINY)
    cfg.tpu.steps_per_dispatch = 2
    cfg.tpu.augment_variants = 1
    cfg.log = {"profile_step": 1}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tloop.run_detector_training_scan(cfg, str(tmp_path), max_steps=4,
                                         device="cpu")
    finally:
        torch.set_num_threads(n)
    with open(tmp_path / "profile" / "trace.json") as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("d3net.")]
    count = {}
    for e in spans:
        count[e["name"]] = count.get(e["name"], 0) + 1
    assert count["d3net.train.dispatch"] == 1
    assert count["d3net.train.step"] == 2
    assert count["d3net.val.batch"] == count["d3net.ckpt.save"] == 1
    assert count["d3net.data.h2d"] == 1        # the val batch's copy
    main = {e["tid"] for e in spans if e["name"] == "d3net.train.step"}
    workers = {e["tid"] for e in spans if e["name"] == "d3net.data.collate"}
    assert workers and not workers & main
    rows = {e["tid"] for e in doc["traceEvents"] if e.get("ph") == "M"
            and "d3net spans" in e.get("args", {}).get("name", "")}
    assert rows == workers
    # one timeline: the worker's collate ends before the val batch starts
    val = next(e for e in spans if e["name"] == "d3net.val.batch")
    collate = next(e for e in spans if e["name"] == "d3net.data.collate")
    dispatch = next(e for e in spans if e["name"] == "d3net.train.dispatch")
    assert dispatch["ts"] + dispatch["dur"] <= collate["ts"] + 1
    assert collate["ts"] + collate["dur"] <= val["ts"] + 1
