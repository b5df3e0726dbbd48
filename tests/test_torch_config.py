"""The port's config system (``d3net_tpu_torch/config.py``) on the CPU.

Its YAML reader equals ``yaml.safe_load`` on every ``conf/**/*.yaml`` and
on the constructs those files use; its writer's output reads back equal
through both readers; ``path.yaml`` merge and ``${a.b}`` interpolation
equal ``d3net_tpu.config``; constructs outside the subset raise.
"""

import glob
import os

import pytest
import yaml

from d3net_tpu import config as jcfg
from d3net_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "conf", "**", "*.yaml"), recursive=True))


def test_every_conf_is_covered():
    assert len(CONFS) >= 20 and "conf/pointgroup.yaml" in CONFS


@pytest.mark.parametrize("path", CONFS)
def test_reader_and_writer_match_pyyaml(path, tmp_path):
    text = open(os.path.join(ROOT, path)).read()
    want = yaml.safe_load(text)
    assert tcfg.parse_yaml(text) == want
    out = str(tmp_path / "c.yaml")
    tcfg.save(tcfg.Config(want), out)
    assert yaml.safe_load(open(out)) == want
    assert tcfg.load(out).to_dict() == want


SUBSET = """\
# a comment line
plain: text with spaces   # trailing comment
url: http://a.b/c#frag
quoted: 'it''s #1'
dquoted: "tab\\there: ok"
ints: [0, -3, +4, 1_000, 0o17]
floats: [1.5, -2., .5, 5.0e-5, 1e-5, 0.25]
bools: [true, False, TRUE, y, n, .git]
nulls: [~, null, Null]
empty:
flow: {a: 1, b: [2, {c: d}], 'e f': "g, h", k: }
nested:
  list:
  - 1
  - [a, b]
  - {x: 1}
  - key: v
    other: w
  -
    - deep
  level:
    - z
date_like: 2024-01-01
colon_in: a:b
dash-key: -x
"""


def test_reader_covers_the_subset():
    want = yaml.safe_load(SUBSET)
    got = tcfg.parse_yaml(SUBSET)
    assert got.pop("date_like") == "2024-01-01"     # PyYAML: a date
    del want["date_like"]
    assert got == want
    assert got["floats"][3] == 5e-5 and got["floats"][4] == "1e-5"


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n",
    "a: !!str 1\n",
    "a: |\n  block\n",
    "a: >\n  folded\n",
    "a: [1,\n  2]\n",
    "a: b\n  c: d\n",
    "a: yes\n",
    "a: [Off]\n",
    "a: 0x1F\n",
    "a: 017\n",
    "a: -.inf\n",
    "on: 1\n",
])
def test_constructs_outside_the_subset_raise(text):
    with pytest.raises(ValueError):
        tcfg.parse_yaml(text)


def test_path_merge_and_interpolation_match_jax():
    paths = [os.path.join(ROOT, "conf", "path.yaml"),
             os.path.join(ROOT, "conf", "pointgroup.yaml")]
    got, want = tcfg.load(*paths), jcfg.load(*paths)
    assert got.to_dict() == want.to_dict()
    for key in ("scannet_root", "scannet_data", "multiview_hdf5",
                "scanrefer_val", "output_root"):
        assert got[key] == want[key], key
    assert got.general.output_root == want.general.output_root
    assert got.model.blocks == want.model.blocks
    merged = tcfg.merge(got, {"model": {"m": 32}, "extra": "${data_root}/x"})
    jmerged = jcfg.merge(want, {"model": {"m": 32}, "extra": "${data_root}/x"})
    assert merged.to_dict() == jmerged.to_dict()
    assert merged.extra == jmerged.extra == "data/x"
    assert merged.model.m == 32 and merged.model.blocks == want.model.blocks


@pytest.mark.parametrize("value", ["yes", "off", "017", ".nan", "0x1F"])
def test_writer_quotes_forms_outside_the_subset(value, tmp_path):
    out = str(tmp_path / "c.yaml")
    tcfg.save(tcfg.Config({"a": value, "b": [value]}), out)
    assert yaml.safe_load(open(out)) == tcfg.load(out).to_dict() == {
        "a": value, "b": [value]}


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
def test_writer_refuses_non_finite_floats(value, tmp_path):
    with pytest.raises(ValueError):
        tcfg.save(tcfg.Config({"a": value}), str(tmp_path / "c.yaml"))


def test_config_access_matches_jax():
    data = {"a": {"b": 2, "c": [1, {"d": "${a.b}"}]}, "s": "v${a.b}w",
            "full": "${a}"}
    got, want = tcfg.Config(data), jcfg.Config(yaml.safe_load(
        yaml.safe_dump(data)))
    assert got.a.b == want.a.b == 2
    assert got.a.c[1].d == want.a.c[1].d == 2
    assert got.s == want.s == "v2w"
    assert got.full.to_dict() == want.full.to_dict()
    assert got.get("missing", 7) == 7 and "a" in got
    with pytest.raises(AttributeError):
        got.missing
    got.a.b = 5
    assert got.s == "v5w"
