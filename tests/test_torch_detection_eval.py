"""The port's detection eval (``eval/detection.py``, ``utils/nms.py`` and
the numpy box helpers of ``utils/bbox.py``) against d3net_tpu's on the CPU:
the same random inputs give exactly the same kept indices, parsed boxes,
APs, recalls, mAP and AR.
"""

import numpy as np
import pytest

from d3net_tpu.eval import detection as jdet
from d3net_tpu.utils import bbox as jbbox
from d3net_tpu.utils import nms as jnms
from d3net_tpu_torch.eval import detection as tdet
from d3net_tpu_torch.utils import bbox as tbbox
from d3net_tpu_torch.utils import nms as tnms


def _boxes(rng, n):
    """(n, 6) min/max boxes clustered so that many overlap."""
    c = rng.uniform(0, 3, (n, 3))
    s = rng.uniform(0.2, 1.0, (n, 3))
    return np.concatenate([c - s / 2, c + s / 2], 1)


@pytest.mark.parametrize("seed", range(4))
def test_nms_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    boxes = _boxes(rng, n)
    scores = rng.random(n)
    classes = rng.integers(0, 4, n)
    for thr in (0.1, 0.25, 0.5):
        for old in (False, True):
            got = tnms.nms_3d_same_class(boxes, scores, classes, thr, old)
            want = jnms.nms_3d_same_class(boxes, scores, classes, thr, old)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        ious = tbbox.aabb_iou_minmax(boxes[:, None, :3], boxes[:, None, 3:],
                                     boxes[None, :, :3], boxes[None, :, 3:])
        np.testing.assert_array_equal(
            ious, jbbox.aabb_iou_minmax(boxes[:, None, :3], boxes[:, None, 3:],
                                        boxes[None, :, :3], boxes[None, :, 3:]))
        np.testing.assert_array_equal(tnms.nms_matrix(ious, scores, thr),
                                      jnms.nms_matrix(ious, scores, thr))
    assert len(tnms.nms_3d_same_class(boxes[:0], scores[:0], classes[:0],
                                      0.25)) == 0


def _case(seed, b=3, k=12, i=6):
    rng = np.random.default_rng(seed)
    center = rng.uniform(0, 4, (b, i, 3)).astype(np.float32)
    size = rng.uniform(0.3, 1.2, (b, i, 3)).astype(np.float32)
    sem = rng.integers(0, 20, (b, i)).astype(np.int32)
    gmask = rng.random((b, i)) < 0.8
    # predictions: jittered copies of GT boxes plus random ones
    src = rng.integers(0, i, (b, k))
    pc = np.take_along_axis(center, src[..., None], 1) + rng.normal(
        0, 0.15, (b, k, 3))
    ps = np.take_along_axis(size, src[..., None], 1) * rng.uniform(
        0.7, 1.3, (b, k, 3))
    pc[:, -3:] = rng.uniform(0, 4, (b, 3, 3))
    corners = tbbox.box_corners(pc.astype(np.float32), ps.astype(np.float32))
    psem = np.where(rng.random((b, k)) < 0.8,
                    np.take_along_axis(sem, src, 1),
                    rng.integers(0, 20, (b, k))).astype(np.int32)
    prob = rng.random((b, k)).astype(np.float32)
    pmask = (rng.random((b, k)) < 0.9).astype(np.float32)
    return (corners, psem, prob, pmask), (center, size, sem, gmask)


def _same_entries(got, want):
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert len(g) == len(w) and g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])
            if len(w) == 3:
                assert g[2] == w[2]


@pytest.mark.parametrize("seed", range(3))
def test_parse_and_eval_match_jax(seed):
    preds_in, gts_in = _case(seed)
    np.testing.assert_array_equal(
        tbbox.box_corners(gts_in[0], gts_in[1]),
        jbbox.box_corners(gts_in[0], gts_in[1]))
    np.testing.assert_array_equal(tdet.sem_to_box_class(gts_in[2]),
                                  jdet.sem_to_box_class(gts_in[2]))
    calcs = {}
    for thr in (0.25, 0.5):
        calcs[thr] = (tdet.APCalculator(thr), jdet.APCalculator(thr))
    for conf in (0.0, 0.3):
        tp = tdet.parse_predictions(*preds_in, nms_iou=0.25, conf_thresh=conf)
        jp = jdet.parse_predictions(*preds_in, nms_iou=0.25, conf_thresh=conf)
        _same_entries(tp, jp)
    tg, jg = tdet.parse_groundtruths(*gts_in), jdet.parse_groundtruths(*gts_in)
    _same_entries(tg, jg)
    for t, j in calcs.values():
        t.step(tp, tg)
        t.step(tp[::-1], tg)               # a second batch, mismatched scenes
        j.step(jp, jg)
        j.step(jp[::-1], jg)
    for thr, (t, j) in calcs.items():
        got, want = t.compute_metrics(), j.compute_metrics()
        assert got == want
        assert 0.0 <= want["mAP"] <= 1.0 and 0.0 <= want["AR"] <= 1.0
        aps, recs = tdet.eval_det(t.pred, t.gt, thr)
        assert (aps, recs) == jdet.eval_det(j.pred, j.gt, thr)
    assert calcs[0.25][1].compute_metrics()["mAP"] > 0.0
    t, _ = calcs[0.25]
    t.reset()
    assert t.compute_metrics() == {"mAP": 0.0, "AR": 0.0}


def test_voc_ap_matches_jax():
    rng = np.random.default_rng(0)
    for n in (1, 5, 50):
        rec = np.sort(rng.random(n))
        prec = rng.random(n)
        assert tdet.voc_ap(rec, prec) == jdet.voc_ap(rec, prec)
