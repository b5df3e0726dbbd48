"""The port's speaker losses (``d3net_tpu_torch/train/losses_slt.py``)
against ``d3net_tpu.train.losses_slt`` on the CPU, on the same numpy inputs
made from a seed.

- ``caption_loss``: loss and accuracy (rtol 1e-5) over good rows with pad
  words, both exactly 0 when no row is good, and its gradient.
- ``radian_to_label``: equal bins on seeded angles, the bin edges included.
- ``orientation_loss``: loss and accuracy (rtol 1e-5) on seeded rotations
  about z, with masked objects and masked edges, and its gradient.
- ``grounding_loss`` with both loss types, with ``annotated`` (0 rows
  among them, and all 0) and without, reduced and per row: loss, the five
  ``ref_*`` metrics and the gradient (rtol 1e-5); the labels equal, a row
  whose IoUs are all 0 labelled 0 and a row of tied confidences picking
  proposal 0, as ``jnp.argmax``.
- ``softmax_ranking_loss``, ``contrastive_loss`` per row, and
  ``lang_cls_loss`` with and without ``annotated``, tied scores included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.train import losses_slt as jl
from d3net_tpu_torch.checks import rot_z
from d3net_tpu_torch.train import losses_slt as tl
from d3net_tpu_torch.utils.bbox import box_corners

N, T, V = 6, 9, 13


def _caption_inputs(seed, good):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, T - 1, V)).astype(np.float32)
    ids = rng.integers(1, V, (N, T)).astype(np.int32)
    ids[:, 0] = 2
    for i in range(N):                     # pad tails of different lengths
        ids[i, T - i:] = 0
    # a few predictions right, so the accuracy is not 0
    logits[0, 1, ids[0, 2]] += 10.0
    logits[3, 0, ids[3, 1]] += 10.0
    return logits, ids, np.asarray(good)


@pytest.mark.parametrize("good", [
    [True, False, True, True, False, True],
    [False] * N,
], ids=["some_good", "no_good_row"])
def test_caption_loss_matches_jax(good):
    logits, ids, good = _caption_inputs(0, good)
    want_l, want_a = jl.caption_loss(jnp.asarray(logits), jnp.asarray(ids),
                                     jnp.asarray(good))
    want_g = jax.grad(lambda x: jl.caption_loss(
        x, jnp.asarray(ids), jnp.asarray(good))[0])(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got_l, got_a = tl.caption_loss(x, torch.from_numpy(ids),
                                   torch.from_numpy(good))
    got_l.backward()
    got_l = got_l.detach()
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-8)
    if good.any():
        assert float(got_l) > 0 and float(got_a) > 0
    else:
        assert float(got_l) == 0.0 and float(got_a) == 0.0
        assert not x.grad.any()


def test_radian_to_label_matches_jax():
    rng = np.random.default_rng(1)
    width = np.float32(np.pi / 6)
    edges = np.arange(7, dtype=np.float32) * width
    ang = np.concatenate([rng.uniform(0, np.pi, 200), edges,
                          np.nextafter(edges, np.float32(-1)),
                          [-0.1, np.pi, 4.0]]).astype(np.float32)
    want = np.asarray(jl.radian_to_label(jnp.asarray(ang)))
    got = tl.radian_to_label(torch.from_numpy(ang))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want) == set(range(6))


def test_orientation_loss_matches_jax():
    rng = np.random.default_rng(2)
    b, p, l, i, bins = 2, 7, 3, 5, 6
    edge = rng.normal(size=(b, p, l, bins)).astype(np.float32)
    lids = rng.integers(0, p, (b, p, l)).astype(np.int32)
    lmask = (rng.random((b, p, l)) < 0.8).astype(np.float32)
    assign = rng.integers(0, i, (b, p)).astype(np.int32)
    rots = rot_z(rng.uniform(-np.pi, np.pi, (b, i)))
    rmask = (rng.random((b, i)) < 0.8).astype(np.float32)
    args = (edge, lids, lmask, assign, rots, rmask)
    want_l, want_a = jl.orientation_loss(*map(jnp.asarray, args))
    want_g = jax.grad(lambda e: jl.orientation_loss(
        e, *map(jnp.asarray, args[1:]))[0])(jnp.asarray(edge))
    x = torch.from_numpy(edge).requires_grad_()
    got_l, got_a = tl.orientation_loss(x, *map(torch.from_numpy, args[1:]))
    got_l.backward()
    got_l = got_l.detach()
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-8)
    assert float(got_l) > 0 and 0 < float(got_a) < 1


P = 7


def _grounding_inputs(seed):
    """Proposals, reference boxes (row 0 equal to proposal 3, row 1 far from
    every proposal, the rest overlapping) and confidences (row 2 tied)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 3, (N, P, 3)).astype(np.float32)
    sizes = rng.uniform(0.5, 1.5, (N, P, 3)).astype(np.float32)
    pred = box_corners(centers, sizes)
    ref_c = centers[:, 0] + rng.normal(0, 0.2, (N, 3)).astype(np.float32)
    ref_s = rng.uniform(0.5, 1.5, (N, 3)).astype(np.float32)
    ref_c[0], ref_s[0] = centers[0, 3], sizes[0, 3]
    ref_c[1] = 50.0
    conf = rng.normal(size=(N, P)).astype(np.float32)
    conf[2] = 0.5
    return pred, box_corners(ref_c, ref_s), conf


@pytest.mark.parametrize("loss_type", ["cross_entropy", "contrastive"])
@pytest.mark.parametrize("annotated", [
    None, [1, 1, 0, 1, 0, 1], [0] * N], ids=["all", "some_rows", "no_row"])
@pytest.mark.parametrize("reduce", [True, False], ids=["reduced", "rows"])
def test_grounding_loss_matches_jax(loss_type, annotated, reduce):
    pred, ref, conf = _grounding_inputs(1)
    ann = None if annotated is None else np.asarray(annotated, np.float32)
    j_ann = None if ann is None else jnp.asarray(ann)

    def jf(c):
        loss, m = jl.grounding_loss(c, jnp.asarray(pred), jnp.asarray(ref),
                                    j_ann, reduce=reduce, loss_type=loss_type)
        return loss.sum(), (loss, m)

    want_g, (want_l, want_m) = jax.grad(jf, has_aux=True)(jnp.asarray(conf))
    x = torch.from_numpy(conf).requires_grad_()
    got_l, got_m = tl.grounding_loss(
        x, torch.from_numpy(pred), torch.from_numpy(ref),
        None if ann is None else torch.from_numpy(ann), reduce=reduce,
        loss_type=loss_type)
    got_l.sum().backward()
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(want_l),
                               rtol=1e-5, atol=1e-7)
    assert set(got_m) == set(want_m) == {
        "ref_acc_mean", "ref_iou_mean", "best_ious_mean",
        "ref_iou_rate_0.25", "ref_iou_rate_0.5"}
    for k, w in want_m.items():
        np.testing.assert_allclose(float(got_m[k]), float(w), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)
    if annotated == [0] * N:
        assert all(float(v) == 0.0 for v in got_m.values())


def test_grounding_labels_and_ties():
    pred, ref, conf = _grounding_inputs(2)
    want_lab, want_iou = jl.grounding_labels(jnp.asarray(pred),
                                             jnp.asarray(ref))
    got_lab, got_iou = tl.grounding_labels(torch.from_numpy(pred),
                                           torch.from_numpy(ref))
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou),
                               rtol=1e-5, atol=1e-7)
    assert got_lab[0, 3] == 1 and float(got_iou[0, 3]) == pytest.approx(1.0)
    assert not got_iou[1].any() and got_lab[1, 0] == 1   # all 0 -> first
    assert int(torch.from_numpy(conf).argmax(-1)[2]) == 0   # tied -> first


@pytest.mark.parametrize("annotated", [None, [1, 0, 1, 1, 0, 1], [0] * N],
                         ids=["all", "some_rows", "no_row"])
def test_lang_cls_loss_matches_jax(annotated):
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(N, 18)).astype(np.float32)
    scores[4] = 0.25                                  # tied: argmax 0
    labels = rng.integers(0, 18, N).astype(np.int32)
    labels[4] = 0
    labels[0] = int(scores[0].argmax())
    ann = None if annotated is None else np.asarray(annotated, np.float32)

    def jf(s):
        loss, acc = jl.lang_cls_loss(s, jnp.asarray(labels),
                                     None if ann is None else jnp.asarray(ann))
        return loss, acc

    (want_l, want_a), want_g = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(scores))
    x = torch.from_numpy(scores).requires_grad_()
    got_l, got_a = tl.lang_cls_loss(x, torch.from_numpy(labels),
                                    None if ann is None else torch.from_numpy(
                                        ann))
    got_l.backward()
    np.testing.assert_allclose(float(got_l.detach()), float(want_l),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-8)
    if annotated is None:
        assert float(got_a) == pytest.approx(2 / N)    # rows 0 and 4
    got_rows, _ = tl.lang_cls_loss(torch.from_numpy(scores),
                                   torch.from_numpy(labels), reduce=False)
    want_rows = jl.lang_cls_loss(jnp.asarray(scores), jnp.asarray(labels),
                                 reduce=False)[0]
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(want_rows),
                               rtol=1e-5)


def test_ranking_losses_match_jax():
    rng = np.random.default_rng(4)
    preds = rng.normal(size=(N, P)).astype(np.float32)
    targets = np.eye(P, dtype=np.float32)[rng.integers(0, P, N)]
    for name in ("softmax_ranking_loss", "contrastive_loss"):
        for reduce in (True, False):
            want = getattr(jl, name)(jnp.asarray(preds), jnp.asarray(targets),
                                     reduce=reduce)
            got = getattr(tl, name)(torch.from_numpy(preds),
                                    torch.from_numpy(targets), reduce=reduce)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
