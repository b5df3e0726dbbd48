"""The port's ``GroundingEvaluator`` (``d3net_tpu_torch/eval/
grounding_eval.py``) against ``d3net_tpu.eval.grounding_eval`` on the same
numpy batches made from a seed: masked proposals, unannotated rows,
unique/multiple rows and "others" (category 17) rows. Every metric equal,
with and without the breakdown, and for an evaluator that saw no
annotated row."""

import numpy as np
import pytest

from d3net_tpu.eval.grounding_eval import GroundingEvaluator as JEval
from d3net_tpu_torch.eval.grounding_eval import GroundingEvaluator
from d3net_tpu_torch.utils.bbox import box_corners

N, P = 12, 9


def _batch(rng):
    centers = rng.uniform(0, 3, (N, P, 3)).astype(np.float32)
    sizes = rng.uniform(0.4, 1.2, (N, P, 3)).astype(np.float32)
    mask = (rng.random((N, P)) < 0.7).astype(np.float32)
    ref_c = centers[:, 0] + rng.normal(0, 0.15, (N, 3)).astype(np.float32)
    conf = rng.normal(size=(N, P)).astype(np.float32)
    conf[:, 0] += rng.uniform(-1, 2, N).astype(np.float32)
    return (conf, box_corners(centers, sizes), mask,
            box_corners(ref_c, sizes[:, 0]),
            (rng.random(N) < 0.8).astype(np.float32),
            (rng.random(N) < 0.5).astype(np.float32),
            np.where(rng.random(N) < 0.3, 17, rng.integers(0, 17, N)))


@pytest.mark.parametrize("breakdown", [True, False])
def test_grounding_evaluator_matches_jax(breakdown):
    rng = np.random.default_rng(0)
    got, want = GroundingEvaluator(), JEval()
    for _ in range(3):
        args = _batch(rng)
        got.add(*args[:5], unique_multiple=args[5], object_cat=args[6])
        want.add(*args[:5], unique_multiple=args[5], object_cat=args[6])
    g, w = got.compute(breakdown), want.compute(breakdown)
    assert g == w
    assert len(got.ious) == len(want.ious) > 20
    if breakdown:
        assert {"unique_acc@0.5", "multiple_acc@0.25", "others_iou_mean",
                "not_others_acc@0.5"} <= set(g)
    assert 0 < g["acc@0.25"] < 1


def test_grounding_evaluator_edge_cases():
    rng = np.random.default_rng(1)
    args = list(_batch(rng))
    got, want = GroundingEvaluator(), JEval()
    args[4] = np.zeros(N, np.float32)            # no annotated row
    got.add(*args[:5])
    want.add(*args[:5])
    assert got.compute() == want.compute() == {
        "acc@0.25": 0.0, "acc@0.5": 0.0, "iou_mean": 0.0}
    args[4] = np.ones(N, np.float32)             # no breakdown labels
    got.add(*args[:5])
    want.add(*args[:5])
    assert got.compute() == want.compute()
    assert "multiple_acc@0.5" not in got.compute()
