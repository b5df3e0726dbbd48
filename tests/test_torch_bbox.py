"""The ``pred_bbox`` head and ``bbox_loss`` against d3net_tpu on the CPU.

- ``bbox_loss`` on random inputs (``tests/test_bbox_loss.py``'s shapes,
  with and without ``mean_size_arr``, and its empty-GT scene): every term
  and its gradient with respect to every head output, rtol 1e-5 (the same
  arithmetic summed in another order).
- The head inside ``PointGroup(pred_bbox=True)`` at the
  tests/test_detector.py config, weights through the converter: its eval
  outputs (rtol 1e-4 / atol 1e-5), then one train step on both sides with
  the same cluster jitter and proposal permutation (patched on the JAX
  side as in test_torch_train_step.py): every loss, ``bbox_loss``'s terms
  among them, rtol 1e-4, and every gradient rtol 1e-3 / atol 1e-6, read
  from optax's first Adam moment.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.data.collate import BatchSpec as JaxBatchSpec
from d3net_tpu.data.collate import build_batch as jax_build_batch
from d3net_tpu.models.pointgroup import PointGroup as JaxPointGroup
from d3net_tpu.train import losses as jl
from d3net_tpu.train import trainer as jtrainer
from d3net_tpu_torch import params
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.train import losses as tl
from d3net_tpu_torch.train import trainer

B, P, I, NS = 2, 5, 4, 6
OUT_KEYS = ("pred_center", "heading_scores", "heading_residuals_normalized",
            "size_scores", "size_residuals_normalized", "sem_cls_scores")
LOSS_KEYS = ("center_loss", "heading_cls_loss", "heading_reg_loss",
             "size_cls_loss", "size_reg_loss", "bbox_sem_cls_loss",
             "bbox_loss")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    torch's thread pools, oversubscribed, slow these steps up to tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(m=8, blocks=(1, 2, 3), cluster_blocks=(1, 2), clusters_per_pass=16,
           max_num_proposal=8, cluster_npoint_thre=30, test_npoint_thresh=30,
           test_score_thresh=0.0, cluster_ring=1, cluster_cell_size=0.03,
           cluster_prop_iters=4, pred_bbox=True,
           # a size cluster and a box class for each of the 20 semantic
           # classes the synthetic scenes label their instances with
           num_size_cluster=20, num_bbox_class=20)
SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
             floor_points=1000, room=4.0)
SPEC = dict(max_points=3072, voxel_caps=[3072, 1536, 768], max_instances=8,
            use_multiview=False, use_normal=True)
HEAD_OUT = ("pred_center", "heading_scores", "heading_residuals_normalized",
            "heading_residuals", "size_scores", "size_residuals_normalized",
            "sem_cls_scores")


def _random_case(seed, b, empty_gt=False):
    rng = np.random.default_rng(seed)
    out = {
        "pred_center": rng.normal(size=(b, P, 3)),
        "heading_scores": rng.normal(size=(b, P, 1)),
        "heading_residuals_normalized": rng.normal(size=(b, P, 1)),
        "size_scores": rng.normal(size=(b, P, NS)),
        "size_residuals_normalized": rng.normal(size=(b, P, NS, 3)),
        "sem_cls_scores": rng.normal(size=(b, P, NS)),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], np.float32)[:b]
    out["cluster_mask_all"] = np.ones((b, P), np.float32) if empty_gt else mask
    batch = {
        "center_label": rng.normal(size=(b, I, 3)).astype(np.float32),
        "size_label": rng.uniform(0.3, 1.5, (b, I, 3)).astype(np.float32),
        "sem_cls_label": rng.integers(0, NS, (b, I)).astype(np.int32),
        "gt_box_mask": np.array([[1, 1, 0, 0], [1, 1, 1, 1]],
                                np.float32)[:b],
    }
    if empty_gt:
        batch = {k: np.zeros_like(v) for k, v in batch.items()}
    return out, batch


def _jax_loss(out, batch, mean_size):
    def f(head):
        o = dict({k: jnp.asarray(v) for k, v in out.items()}, **head)
        ls = jl.bbox_loss(o, {k: jnp.asarray(v) for k, v in batch.items()},
                          mean_size_arr=mean_size)
        return ls["bbox_loss"], ls

    head = {k: jnp.asarray(out[k]) for k in OUT_KEYS}
    (_, losses), grads = jax.value_and_grad(f, has_aux=True)(head)
    return ({k: float(v) for k, v in losses.items()},
            {k: np.asarray(v) for k, v in grads.items()})


def _port_loss(out, batch, mean_size):
    o = {k: torch.from_numpy(v) for k, v in out.items()}
    for k in OUT_KEYS:
        o[k].requires_grad_(True)
    losses = tl.bbox_loss(o, {k: torch.from_numpy(v) for k, v in batch.items()},
                          mean_size_arr=mean_size)
    losses["bbox_loss"].backward()
    # bbox_sem_cls_loss is reported beside bbox_loss, not in it: its
    # scores get no gradient (JAX's is zeros)
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: (np.zeros_like(out[k]) if o[k].grad is None
                 else o[k].grad.numpy()) for k in OUT_KEYS})


@pytest.mark.parametrize("with_mean_size", [False, True])
def test_bbox_loss_and_gradients_match_jax(with_mean_size):
    out, batch = _random_case(0, B)
    mean_size = (np.random.default_rng(1).uniform(0.5, 1.2, (NS, 3))
                 .astype(np.float32) if with_mean_size else None)
    want, want_g = _jax_loss(out, batch, mean_size)
    got, got_g = _port_loss(out, batch, mean_size)
    assert set(got) == set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in OUT_KEYS:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert got["bbox_loss"] > 0


def test_bbox_loss_empty_gt_scene_is_finite_and_zero():
    """tests/test_bbox_loss.py:101's scene: no GT box, every slot occupied."""
    out, batch = _random_case(1, 1, empty_gt=True)
    want, want_g = _jax_loss(out, batch, None)
    got, got_g = _port_loss(out, batch, None)
    for k in LOSS_KEYS:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["bbox_loss"], 0.0, atol=1e-6)
    for k in OUT_KEYS:
        np.testing.assert_array_equal(got_g[k], want_g[k])
        assert not got_g[k].any(), k


def test_detector_loss_weights_the_bbox_term():
    """``loss_weight[4]`` scales ``bbox_loss`` in ``total_loss``, 1 without
    a fifth weight, as in the JAX ``detector_loss``."""
    out, batch = _random_case(2, B)
    rng = np.random.default_rng(3)
    n = 16
    out.update(semantic_scores=rng.normal(size=(B, n, 20)).astype(np.float32),
               pt_offsets=rng.normal(size=(B, n, 3)).astype(np.float32))
    batch.update(sem_labels=rng.integers(-1, 20, (B, n)).astype(np.int32),
                 point_mask=np.ones((B, n), bool),
                 point_xyz=rng.normal(size=(B, n, 3)).astype(np.float32),
                 instance_mean_xyz=rng.normal(size=(B, n, 3)).astype(
                     np.float32),
                 instance_ids=rng.integers(-1, I, (B, n)).astype(np.int32))
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    jj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}        # noqa: E731
    for lw in ((1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0, 0.25)):
        got = tl.detector_loss(tt(out), tt(batch), loss_weight=lw,
                               with_score=False)
        want = jl.detector_loss(jj(out), jj(batch), loss_weight=lw,
                                with_score=False)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=f"{lw} {k}")


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def detector():
    scenes = [make_scene(seed=i, **SCENE) for i in range(2)]
    batch_np = build_batch(scenes, BatchSpec(**SPEC))
    jbatch = jax.tree.map(jnp.asarray,
                          jax_build_batch(scenes, JaxBatchSpec(**SPEC)))
    in_ch = batch_np["point_feats"].shape[-1] + 3
    variables = params.init_flax_variables(PointGroup(in_ch, **CFG), seed=0)
    rng = np.random.default_rng(5)
    for name in ("bbox_bn1", "bbox_bn2"):       # nonzero BN statistics
        bs = variables["batch_stats"][name]
        bs["mean"] = rng.normal(0, 0.1, bs["mean"].shape).astype(np.float32)
        bs["var"] = rng.uniform(0.5, 1.5, bs["var"].shape).astype(np.float32)
    b = batch_np["point_mask"].shape[0]
    jitter = rng.random((b, 2 * CFG["clusters_per_pass"], 3)).astype(
        np.float32)
    perm = rng.permutation(CFG["max_num_proposal"]).astype(np.int32)
    return dict(batch_np=batch_np, jbatch=jbatch, variables=variables,
                jitter=jitter, perm=perm)


def test_head_converts_both_ways(detector):
    model = PointGroup(9, **CFG)
    names = {k for k in model.state_dict() if k.startswith("bbox_")}
    assert names == {"bbox_fc1.weight", "bbox_bn1.scale", "bbox_bn1.bias",
                     "bbox_bn1.mean", "bbox_bn1.var", "bbox_fc2.weight",
                     "bbox_bn2.scale", "bbox_bn2.bias", "bbox_bn2.mean",
                     "bbox_bn2.var", "bbox_out.weight", "bbox_out.bias"}
    model = params.load_detector(detector["variables"], CFG, device="cpu")
    back = params.flatten(params.state_dict_to_flax(model))
    for k, v in params.flatten(detector["variables"]).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert back["params.bbox_out.kernel"].shape == (8, 3 + 2 + 20 * 4 + 20)


def test_head_eval_outputs_match_jax(detector):
    jvars = jax.tree.map(jnp.asarray, detector["variables"])
    jmodel = JaxPointGroup(**CFG)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        jvars, detector["jbatch"])
    model = params.load_detector(detector["variables"], CFG, device="cpu")
    with torch.no_grad():
        got = model(batch_to_torch(detector["batch_np"], "cpu"))
    assert np.asarray(want["cluster_mask_all"]).sum() >= 4
    np.testing.assert_array_equal(got["cluster_mask_all"].numpy(),
                                  np.asarray(want["cluster_mask_all"]))
    for k in HEAD_OUT:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_train_step_with_head_matches_jax(detector, monkeypatch):
    s = detector
    model_j = JaxPointGroup(**CFG)
    tx = jtrainer.make_optimizer()
    v = jax.tree.map(jnp.asarray, s["variables"])
    state = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(s["jitter"]))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(s["perm"]))
    step = jax.jit(functools.partial(jtrainer.detector_train_step, model_j))
    new_state, want = step(state, s["jbatch"], jax.random.key(0))
    want = {k: float(v) for k, v in want.items()}

    model = params.load_detector(s["variables"], CFG, device="cpu")
    tstate = trainer.create_train_state(model)
    _, got = trainer.detector_train_step(
        tstate, batch_to_torch(s["batch_np"], "cpu"),
        jitter_u=torch.from_numpy(s["jitter"]),
        proposal_perm=torch.from_numpy(s["perm"]).long()[None])
    got = {k: float(v) for k, v in got.items()}
    assert set(LOSS_KEYS) <= set(got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)

    mu = [x for x in new_state.opt_state if hasattr(x, "mu")][0].mu
    want_g = params.flatten(jax.tree.map(lambda m: np.asarray(m) / 0.1, mu))
    got_g = params.flatten(params.state_dict_to_flax(
        model, {n: p.grad for n, p in model.named_parameters()})["params"])
    assert set(got_g) == set(want_g)
    assert any(k.startswith("bbox_") and np.abs(g).max() > 0
               for k, g in got_g.items())
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=1e-3, atol=1e-6,
                                   err_msg=k)
