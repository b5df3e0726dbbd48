"""BENCHMARK.json against the contract's shape, and every cell, traffic,
configuration, driver and metric found by its name."""

import json
import os
import re

import pytest

from perfbench.harness import names

ROOT = names.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.exists(os.path.join(ROOT, bench["command"][1]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys(bench):
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in bench[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"]


def test_at_most_a_quarter_on_four_chips(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])


def test_every_cell_loads_by_name(bench):
    for w in bench["workloads"]:
        cell = names.load_cell(w["name"])
        assert cell.config["config"]
        assert max(cell.traffic.get("num_scenes", 0),
                   cell.traffic.get("num_val_scenes", 0)) > 0
        assert names.driver_module(cell.driver).Driver
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.limits()), w["name"]
        moved = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in moved for m in cell.per_layer)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(names.metric_reader(m["name"]))


def test_config_files_hold_the_reduced_keys(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert c["source"] == cfg["source"]
        assert cfg["peak_flops"] > 0 and cfg["control_dtype"]
