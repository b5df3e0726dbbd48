"""The port's detector losses against ``d3net_tpu/train/losses.py`` on the
same numpy inputs, f32 on the CPU: each loss, ``get_segmented_scores`` at
and around its thresholds, and ``detector_loss``'s gradient with respect to
``semantic_scores``, ``pt_offsets`` and ``proposal_scores_all``.
Tolerance rtol 1e-5 (atol 1e-7 for gradients of entries the loss barely
touches): the same arithmetic summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.train import losses as jl
from d3net_tpu_torch.train import losses as tl

B, N, CLS, I, P = 2, 96, 20, 4, 6
TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    point_mask = rng.random((B, N)) < 0.85
    inst = rng.integers(-1, I, (B, N)).astype(np.int32)
    inst[~point_mask] = -1
    sem = rng.integers(-1, CLS, (B, N)).astype(np.int32)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    inst_mean = np.where(inst[..., None] >= 0,
                         rng.standard_normal((B, N, 3)), 0).astype(np.float32)
    inst_mean[~point_mask] = 0
    xyz[~point_mask] = 0
    offsets = rng.standard_normal((B, N, 3)).astype(np.float32)
    offsets[~point_mask] = 0          # padded points: exactly-zero vectors
    member = rng.integers(-1, P, (B, 2, N)).astype(np.int32)
    member[:, :, ~point_mask[0]] = -1
    cmask = rng.random((B, P)) < 0.7
    npt = np.stack([np.bincount(np.clip(i, 0, None)[i >= 0], minlength=I)
                    for i in inst]).astype(np.float32)
    out = {"semantic_scores": rng.standard_normal((B, N, CLS)).astype(
               np.float32) * 2,
           "pt_offsets": offsets,
           "proposal_scores_all": rng.standard_normal((B, P)).astype(
               np.float32),
           "member_pt": member, "cluster_mask_all": cmask}
    batch = {"sem_labels": sem, "point_mask": point_mask, "point_xyz": xyz,
             "instance_mean_xyz": inst_mean, "instance_ids": inst,
             "instance_num_point": npt}
    return out, batch


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_cross_entropy_ignore(data):
    out, batch = data
    want = jl.cross_entropy_ignore(jnp.asarray(out["semantic_scores"]),
                                   jnp.asarray(batch["sem_labels"]), -1,
                                   mask=jnp.asarray(batch["point_mask"]))
    got = tl.cross_entropy_ignore(torch.from_numpy(out["semantic_scores"]),
                                  torch.from_numpy(batch["sem_labels"]), -1,
                                  mask=torch.from_numpy(batch["point_mask"]))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_offset_losses(data):
    out, batch = data
    keys = ("point_xyz", "instance_mean_xyz", "instance_ids", "point_mask")
    want = jl.offset_losses(jnp.asarray(out["pt_offsets"]),
                            *(jnp.asarray(batch[k]) for k in keys))
    got = tl.offset_losses(torch.from_numpy(out["pt_offsets"]),
                           *(torch.from_numpy(batch[k]) for k in keys))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **TOL)


def test_get_segmented_scores_at_thresholds():
    s = np.array([0.0, 0.1, 0.25, 0.2500001, 0.3, 0.5, 0.7499999, 0.75,
                  0.7500001, 0.9, 1.0], np.float32)
    want = np.asarray(jl.get_segmented_scores(jnp.asarray(s)))
    got = tl.get_segmented_scores(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got[2] == want[2] and got[7] == want[7]
    assert got[0] == 0.0 and got[-1] == 1.0


def test_point_set_iou_and_score_loss(data):
    out, batch = data
    want_iou = jax.vmap(lambda m, i, pm, n: jl.point_set_iou(m, i, pm, P, I, n))(
        jnp.asarray(out["member_pt"]), jnp.asarray(batch["instance_ids"]),
        jnp.asarray(batch["point_mask"]),
        jnp.asarray(batch["instance_num_point"]))
    got_iou = tl.point_set_iou(
        torch.from_numpy(out["member_pt"]),
        torch.from_numpy(batch["instance_ids"]),
        torch.from_numpy(batch["point_mask"]), P, I,
        torch.from_numpy(batch["instance_num_point"]))
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou), **TOL)
    assert float(np.asarray(want_iou).max()) > 0     # not vacuous
    args = [out["proposal_scores_all"], out["member_pt"],
            batch["instance_ids"], batch["point_mask"],
            out["cluster_mask_all"], batch["instance_num_point"]]
    want = jl.score_loss(*map(jnp.asarray, args))
    got = tl.score_loss(*(torch.from_numpy(np.asarray(a)) for a in args))
    np.testing.assert_allclose(float(got[0]), float(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("with_score", [True, False])
def test_detector_loss_and_gradients(data, with_score):
    out, batch = data
    diff = ("semantic_scores", "pt_offsets", "proposal_scores_all")
    weights = (1.0, 0.7, 1.3, 0.5)

    def jloss(d):
        o = dict(_j(out), **d)
        return jl.detector_loss(o, _j(batch), loss_weight=weights,
                                with_score=with_score)

    jd = {k: jnp.asarray(out[k]) for k in diff}
    want = jloss(jd)
    want_grad = jax.grad(lambda d: jloss(d)["total_loss"])(jd)

    td = {k: torch.from_numpy(out[k]).requires_grad_() for k in diff}
    got = tl.detector_loss(dict(_t(out), **td), _t(batch), loss_weight=weights,
                           with_score=with_score)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), **TOL,
                                   err_msg=k)
    got["total_loss"].backward()
    for k in diff:
        if not with_score and k == "proposal_scores_all":
            assert td[k].grad is None
            continue
        np.testing.assert_allclose(td[k].grad.numpy(),
                                   np.asarray(want_grad[k]), **TOL, err_msg=k)
        assert np.isfinite(td[k].grad.numpy()).all()
