"""The port's caption metrics and dense-captioning evaluator
(``d3net_tpu_torch/eval/capeval.py``, ``caption_eval.py``) against
``d3net_tpu.eval`` on fixed candidate sets: BLEU, CIDEr, ROUGE-L and
METEOR, the Hungarian GIoU assignment, ``CaptionEvaluator.compute`` and
``diagnostics`` give equal numbers; without nltk METEOR reads 0.0 on both
sides."""

import numpy as np
import pytest

from d3net_tpu.eval import capeval as jcap
from d3net_tpu.eval import caption_eval as jce
from d3net_tpu.utils import bbox as jbbox
from d3net_tpu_torch.eval import capeval as tcap
from d3net_tpu_torch.eval import caption_eval as tce
from d3net_tpu_torch.utils import bbox as tbbox

GTS = {
    "a|0": ["sos the tall chair near the table eos",
            "sos the tall chair left of the table eos"],
    "a|1": ["sos the large bed in the corner eos"],
    "b|0": ["sos the small sink far from the door eos",
            "sos the small sink near the toilet eos",
            "sos the wide sink right of the door eos"],
    "b|3": ["sos the low desk next to the chair eos"],
}
CANDS = {
    "a|0": ["sos the tall chair near the chair eos"],
    "a|1": ["sos the large beds in the corners eos"],
    "b|0": ["sos eos"],
    "b|3": ["sos the the the the the the the the eos"],
}


def test_scorers_equal(monkeypatch):
    monkeypatch.delenv("D3NET_METEOR_CMD", raising=False)
    monkeypatch.delenv("D3NET_METEOR_JAR", raising=False)
    assert tcap.bleu(GTS, CANDS, 4) == jcap.bleu(GTS, CANDS, 4)
    assert tcap.Cider().compute_score(GTS, CANDS) == \
        jcap.Cider().compute_score(GTS, CANDS)
    assert tcap.rouge_l(GTS, CANDS) == jcap.rouge_l(GTS, CANDS)
    assert tcap.meteor_available() == jcap.meteor_available()
    if tcap.meteor_available():
        got = tcap.meteor(GTS, CANDS)
        assert got == jcap.meteor(GTS, CANDS) and got[0] > 0


def _scene_boxes(rng, n):
    c = rng.uniform(0, 5, (n, 3)).astype(np.float32)
    s = rng.uniform(0.3, 1.2, (n, 3)).astype(np.float32)
    return tbbox.box_corners(c, s)


def test_giou_and_assignment_equal():
    rng = np.random.default_rng(0)
    gt = _scene_boxes(rng, 5)
    pred = np.concatenate([gt[:3] + rng.normal(0, 0.05, (3, 1, 3)).astype(
        np.float32), _scene_boxes(rng, 6)])
    pmask = np.ones(9, np.float32)
    pmask[4] = 0
    gmin, gmax = tbbox.corners_to_minmax(gt)
    pmin, pmax = tbbox.corners_to_minmax(pred)
    np.testing.assert_array_equal(
        tbbox.pairwise_giou_matrix(gmin, gmax, pmin, pmax),
        jbbox.pairwise_giou_matrix(gmin, gmax, pmin, pmax))
    gmask = np.array([1, 1, 0, 1, 1], np.float32)
    for pm in (pmask, np.zeros(9, np.float32)):
        assert tce.assign_dense_caption(pred, pm, gt, gmask) == \
            jce.assign_dense_caption(pred, pm, gt, gmask)


def _fill(evaluator, rng):
    words = ["sos the tall chair near the table eos",
             "sos the large bed eos", "sos eos",
             "sos the small sink near the door eos"]
    for s in range(3):
        gt = _scene_boxes(rng, 4)
        pred = np.concatenate([gt + rng.normal(0, 0.15, (4, 1, 3)).astype(
            np.float32), _scene_boxes(rng, 4)])
        caps = [words[(s + i) % 4] for i in range(8)]
        refs = {j: [words[(j + 1) % 4][4:-4], words[j][4:-4]]
                for j in range(4) if j != 2}
        evaluator.add_scene(f"s{s}", caps, pred, np.ones(8), gt, np.ones(4),
                            refs)
    return evaluator


@pytest.mark.parametrize("nltk", [True, False])
def test_caption_evaluator_equal(monkeypatch, nltk):
    if not nltk:
        monkeypatch.setattr(tcap, "meteor_available", lambda: False)
        monkeypatch.setattr(jcap, "meteor_available", lambda: False)
    want = _fill(jce.CaptionEvaluator(0.5), np.random.default_rng(1))
    got = _fill(tce.CaptionEvaluator(0.5), np.random.default_rng(1))
    assert got.compute() == want.compute()
    assert got.diagnostics() == want.diagnostics()
    assert 0 < got.diagnostics()["frac_replaced"] < 1
    if not nltk:
        assert got.compute()["meteor"] == 0.0
    assert tce.CaptionEvaluator().compute() == jce.CaptionEvaluator().compute()
    assert tce.CaptionEvaluator().diagnostics() == {}


def test_decode_captions_equal():
    from d3net_tpu.data.language import base_corpus
    from d3net_tpu.data.vocab import Vocabulary

    vocab = Vocabulary.build(base_corpus())
    ids = np.random.default_rng(2).integers(0, len(vocab), (7, 9))
    assert tce.decode_captions(ids, vocab) == jce.decode_captions(ids, vocab)
