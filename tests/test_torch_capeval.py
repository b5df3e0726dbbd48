"""``eval/capeval.py``'s METEOR jar path against the JAX package's, on the
CPU: ``MeteorJar`` (meteor-1.5.jar's ``-stdio`` protocol) and the jar
dispatch of ``meteor()``. No java and no jar here: a mock scorer (the one
of tests/test_capeval.py) stands in, reached through ``D3NET_METEOR_CMD``
or through a ``java`` on ``PATH`` given ``D3NET_METEOR_JAR``. It logs every
line it reads and its command line, so both sides are held to the same
bytes on the wire, the same command and the same scores; the caption
evaluator scores METEOR only where nltk imports, on both sides.
"""

import stat
import sys

import numpy as np
import pytest

from d3net_tpu_torch.eval import capeval as tcap
from d3net_tpu_torch.eval import caption_eval as tce

MOCK = """\
import os, sys
log = open(os.environ["METEOR_LOG"], "a")
log.write("ARGS " + " ".join(sys.argv[1:]) + " CWD " + os.getcwd() + "\\n")
for line in sys.stdin:
    log.write(line); log.flush()
    parts = [p.strip() for p in line.split('|||')]
    if parts[0] == 'SCORE':
        # stat = n_refs * 100 + len(cand words)
        s = (len(parts) - 2) * 100 + len(parts[-1].split())
        print(s); sys.stdout.flush()
    elif parts[0] == 'EVAL':
        vals = [float(p) for p in parts[1:]]
        for v in vals: print(v / 1000.0)
        print(sum(vals) / len(vals) / 1000.0)
        sys.stdout.flush()
"""
GTS = {"a": ["the red chair", "a chair ||| that is red"],
       "b": ["a wooden\ntable"], "c": ["x", "y", "z w"]}
CANDS = {"a": ["the red chair"], "b": ["a table|||"], "c": ["sos eos"]}
# a: 2 refs + 3 words; b: 1 ref + 2 words; c: 3 refs + 2 words
SCORES = [0.203, 0.102, 0.302]


@pytest.fixture
def mock(tmp_path, monkeypatch):
    path = tmp_path / "mock_meteor.py"
    path.write_text(MOCK)
    log = tmp_path / "wire.log"
    monkeypatch.setenv("METEOR_LOG", str(log))
    monkeypatch.delenv("D3NET_METEOR_CMD", raising=False)
    monkeypatch.delenv("D3NET_METEOR_JAR", raising=False)
    return path, log


def _jax():
    from d3net_tpu.eval import capeval as jcap

    return jcap


def _scored_lines(log):
    """The wire log taken by the last scorer run, and cleared."""
    text = log.read_text()
    log.write_text("")
    return text


def test_meteor_through_cmd_matches_jax(mock, monkeypatch):
    path, log = mock
    monkeypatch.setenv("D3NET_METEOR_CMD", f"{sys.executable} {path}")
    want = _jax().meteor(GTS, CANDS)
    want_wire = _scored_lines(log)
    got = tcap.meteor(GTS, CANDS)
    assert got == want
    assert _scored_lines(log) == want_wire
    assert got[1] == SCORES
    assert got[0] == pytest.approx(np.mean([203, 102, 302]) / 1000.0,
                                   abs=1e-12)
    # "|||" and newlines are stripped from references and candidates
    assert want_wire.count("\n") == 1 + len(GTS) + 1
    assert "SCORE ||| the red chair ||| a chair  that is red ||| the red " \
        "chair" in want_wire


def test_meteor_jar_direct_matches_jax(mock, monkeypatch):
    path, log = mock
    cmd = [sys.executable, str(path)]
    for gts, cands in ((GTS, CANDS), ({"k": ["one two"]}, {"k": ["two"]})):
        jar = _jax().MeteorJar(cmd)
        try:
            want = jar.compute_score(gts, cands)
        finally:
            jar.close()
        want_wire = _scored_lines(log)
        jar = tcap.MeteorJar(cmd)
        got = jar.compute_score(gts, cands)
        jar.close()
        assert jar.proc.poll() is not None      # closed and reaped
        assert got == want and _scored_lines(log) == want_wire


def test_meteor_jar_lookup_matches_jax(mock, tmp_path, monkeypatch):
    """``D3NET_METEOR_JAR`` with a ``java`` on ``PATH``: both sides start
    ``java -jar -Xmx2G <jar> - - -stdio -l en -norm`` in the jar's
    directory; without java, or without the jar, neither finds a scorer
    and ``meteor()`` takes the Python path."""
    path, log = mock
    jar_dir = tmp_path / "jars"
    jar_dir.mkdir()
    jar = jar_dir / "meteor-1.5.jar"
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    java = bin_dir / "java"
    java.write_text(f"#!/bin/sh\nexec {sys.executable} {path} \"$@\"\n")
    java.chmod(java.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setenv("D3NET_METEOR_JAR", str(jar))
    jcap = _jax()
    # no jar file yet
    assert tcap.MeteorJar.maybe() is None and jcap.MeteorJar.maybe() is None
    jar.write_bytes(b"")
    want = jcap.meteor(GTS, CANDS)
    want_wire = _scored_lines(log)
    got = tcap.meteor(GTS, CANDS)
    assert got == want and got[1] == SCORES
    assert _scored_lines(log) == want_wire
    assert want_wire.splitlines()[0] == (
        f"ARGS -jar -Xmx2G {jar} - - -stdio -l en -norm CWD {jar_dir}")
    # a jar but no java
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    assert tcap.MeteorJar.maybe() is None and jcap.MeteorJar.maybe() is None


@pytest.mark.parametrize("nltk", [True, False], ids=["nltk", "no_nltk"])
def test_caption_evaluator_gate_matches_jax(mock, monkeypatch, nltk):
    """The evaluator scores METEOR (here through the scorer) only where
    ``meteor_available()``; else it reports 0.0, on both sides."""
    from d3net_tpu.eval import caption_eval as jce

    path, _ = mock
    monkeypatch.setenv("D3NET_METEOR_CMD", f"{sys.executable} {path}")
    monkeypatch.setattr(tcap, "meteor_available", lambda: nltk)
    monkeypatch.setattr(_jax(), "meteor_available", lambda: nltk)
    got = tce.CaptionEvaluator._metrics(GTS, CANDS)
    want = jce.CaptionEvaluator._metrics(GTS, CANDS)
    assert got == want
    assert got["meteor"] == (pytest.approx(np.mean(SCORES)) if nltk else 0.0)
