"""One detector train step of the port against d3net_tpu's
``detector_train_step`` on the CPU, at the tests/test_detector.py config,
with the same converted weights and the same cluster jitter and proposal
permutation on both sides (on the JAX side ``jax.random.uniform`` and
``jax.random.permutation`` are patched for the call; they are drawn only
at ``pointgroup.py:395,427``).

The JAX step returns no gradients; optax's first Adam moment is
``(1 - b1) * grad``, so the gradients are read from it through
``optax_adam_state_to_torch`` and compared with the port's ``p.grad``.
Post-step parameters are not compared: the first AdamW step moves every
parameter by about ``lr`` whatever its gradient's size, so a near-zero
gradient of the other sign doubles a tiny difference.

Tolerances: losses and ``grad_norm`` rtol 1e-4; gradients rtol 1e-3 /
atol 1e-6 (they compound over ~40 layers of f32 sums taken in another
order); new BN statistics rtol 1e-4 / atol 1e-5; integer outputs equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3net_tpu.data.collate import BatchSpec as JaxBatchSpec
from d3net_tpu.data.collate import build_batch as jax_build_batch
from d3net_tpu.models.pointgroup import PointGroup as JaxPointGroup
from d3net_tpu.train import trainer as jtrainer
from d3net_tpu_torch import params
from d3net_tpu_torch.data.collate import BatchSpec, batch_to_torch, build_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.train import trainer


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
           cluster_prop_iters=4)
SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
             floor_points=1000, room=4.0)
SPEC = dict(max_points=3072, voxel_caps=[3072, 1536, 768], max_instances=8,
            use_multiview=False, use_normal=True)
B1 = 0.9


@pytest.fixture(scope="module")
def setup():
    scenes = [make_scene(seed=i, **SCENE) for i in range(2)]
    batch_np = build_batch(scenes, BatchSpec(**SPEC))
    jbatch = jax.tree.map(jnp.asarray,
                          jax_build_batch(scenes, JaxBatchSpec(**SPEC)))
    in_ch = batch_np["point_feats"].shape[-1] + 3
    variables = params.init_flax_variables(PointGroup(in_ch, **CFG), seed=0)
    rng = np.random.default_rng(5)
    b = batch_np["point_mask"].shape[0]
    p_total = 2 * CFG["clusters_per_pass"]
    jitter = rng.random((b, p_total, 3)).astype(np.float32)
    perm = rng.permutation(CFG["max_num_proposal"]).astype(np.int32)
    return dict(batch_np=batch_np, jbatch=jbatch, variables=variables,
                jitter=jitter, perm=perm)


def _jax_step(s, do_clustering, monkeypatch):
    model = JaxPointGroup(**CFG)
    tx = jtrainer.make_optimizer()
    v = jax.tree.map(jnp.asarray, s["variables"])
    state = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(s["jitter"]))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(s["perm"]))
    step = jax.jit(functools.partial(
        jtrainer.detector_train_step, model, do_clustering=do_clustering))
    new_state, metrics = step(state, s["jbatch"], jax.random.key(0))
    out = None
    if do_clustering:
        out = jax.jit(lambda v, b: model.apply(
            v, b, train=True, rngs={"cluster_jitter": jax.random.key(1),
                                    "proposal_shuffle": jax.random.key(2)},
            mutable=["batch_stats"])[0])(
            {"params": state.params, "batch_stats": state.batch_stats},
            s["jbatch"])
    return new_state, jax.tree.map(np.asarray, metrics), out


def _port_step(s, do_clustering):
    model = params.load_detector(s["variables"], CFG, device="cpu")
    state = trainer.create_train_state(model)
    batch = batch_to_torch(s["batch_np"], "cpu")
    kw = dict(jitter_u=torch.from_numpy(s["jitter"]),
              proposal_perm=torch.from_numpy(s["perm"]).long()[None])
    _, metrics = trainer.detector_train_step(
        state, batch, do_clustering=do_clustering, **kw)
    with torch.no_grad():
        fresh = params.load_detector(s["variables"], CFG, device="cpu")
        out = fresh(batch, train=True, **kw) if do_clustering else None
    return model, state, {k: float(v) for k, v in metrics.items()}, out


@pytest.fixture(scope="module")
def results(setup):
    """Both sides' step, with and without clustering (one JAX state)."""
    res = {}
    for do_clustering in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            jax_res = _jax_step(setup, do_clustering, mp)
        res[do_clustering] = dict(do_clustering=do_clustering, jax=jax_res,
                                  port=_port_step(setup, do_clustering))
    return res


CASES = pytest.mark.parametrize("do_clustering", [True, False],
                                ids=["clustering", "no_clustering"])


@pytest.fixture
def steps(results, do_clustering):
    return results[do_clustering]


@CASES
def test_losses_and_grad_norm(steps):
    _, jm, _ = steps["jax"]
    _, _, pm, _ = steps["port"]
    keys = {"semantic_loss", "offset_norm_loss", "offset_dir_loss",
            "total_loss", "grad_norm"}
    if steps["do_clustering"]:
        keys |= {"score_loss", "gt_iou_mean"}
    assert set(pm) == set(jm) == keys
    for k in keys:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)


def test_integer_outputs_equal(results):
    _, _, jout = results[True]["jax"]
    _, _, _, pout = results[True]["port"]
    assert int(np.asarray(jout["cluster_mask_all"]).sum()) >= 4
    for k in ("member_pt", "cluster_mask_all", "proposal_slot",
              "proposal_sem_cls_batched", "object_assignment"):
        np.testing.assert_array_equal(pout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)


@CASES
def test_gradients(steps):
    new_state, _, _ = steps["jax"]
    model, _, _, _ = steps["port"]
    adam = new_state.opt_state[0]
    assert isinstance(adam, optax.ScaleByAdamState)
    want = jax.tree.map(lambda m: np.asarray(m) / (1 - B1), adam.mu)
    got = params.state_dict_to_flax(
        model, {n: p.grad for n, p in model.named_parameters()})["params"]
    flat_w, flat_g = params.flatten(want), params.flatten(got)
    assert set(flat_w) == set(flat_g)
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k], w, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    # the comparison is not vacuous: every parameter the loss reaches has a
    # nonzero gradient (without clustering the ScoreNet is not reached)
    zero = {k for k, w in flat_w.items() if not np.abs(w).max() > 0}
    reached = steps["do_clustering"]
    assert zero == {k for k in flat_w
                    if k.startswith("score_net") and not reached}


@CASES
def test_bn_statistics(steps):
    new_state, _, _ = steps["jax"]
    model, _, _, _ = steps["port"]
    want = params.flatten(jax.tree.map(np.asarray, new_state.batch_stats))
    got = params.flatten(params.state_dict_to_flax(model)["batch_stats"])
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)


def test_eval_step_losses(setup):
    """``detector_eval_step`` (eval-mode forward and losses, before
    clustering) against JAX's, at the converted weights."""
    model = JaxPointGroup(**CFG)
    tx = jtrainer.make_optimizer()
    v = jax.tree.map(jnp.asarray, setup["variables"])
    jstate = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx)
    _, want = jax.jit(functools.partial(
        jtrainer.detector_eval_step, model, do_clustering=False))(
        jstate, setup["jbatch"])
    state = trainer.create_train_state(
        params.load_detector(setup["variables"], CFG, device="cpu"))
    _, got = trainer.detector_eval_step(
        state, batch_to_torch(setup["batch_np"], "cpu"), do_clustering=False)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4,
                                   err_msg=k)


@CASES
def test_optimizer_state_carried(steps):
    """optax's moments loaded into a torch AdamW equal the port's own after
    the same step (``optax_adam_state_to_torch``)."""
    new_state, _, _ = steps["jax"]
    model, state, _, _ = steps["port"]
    mirror = torch.optim.AdamW(model.parameters(), lr=0.002)
    params.optax_adam_state_to_torch(new_state.opt_state, model, mirror)
    for name, p in model.named_parameters():
        mine, theirs = state.optimizer.state[p], mirror.state[p]
        assert float(mine["step"]) == float(theirs["step"]) == 1.0
        np.testing.assert_allclose(mine["exp_avg"].numpy(),
                                   theirs["exp_avg"].numpy(),
                                   rtol=1e-3, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(mine["exp_avg_sq"].numpy(),
                                   theirs["exp_avg_sq"].numpy(),
                                   rtol=2e-3, atol=1e-10, err_msg=name)
