"""The port's data-parallel detector step (``parallel/mesh.py``) on 4 gloo
ranks against JAX's dp step on a 4-device mesh, and against its own world
size 1, on one global batch (tests/test_parallel.py's model and scenes)
with the same converted weights and draws.

JAX's side is ``tests/test_parallel.py``'s: ``make_mesh`` over 4 of the
conftest's 8 CPU devices, ``shard_batch``, ``replicate``,
``jit_train_step`` under SGD (lr 1e-3, momentum 0.9), with
``jax.random.uniform``/``permutation`` patched to the case's global jitter
and permutation. Its gradients are SGD's first trace. The port's ranks
take their rows of the batch and of the draws (``checks.
detector_step_rank``, spawned by ``mesh.spawn``); the metrics are global,
the gradients summed.

Tolerances. Clustering off, against JAX: the step's (losses rtol 1e-4,
gradients rtol 1e-3 / atol 1e-6, BN statistics rtol 1e-4 / atol 1e-5);
world 4 against world 1: tests/test_parallel.py's continuous bounds
(losses rtol 1e-5 / atol 1e-6, parameters rtol 1e-5 / atol 2e-6).
Clustering on: the cluster-dependent terms (``score_loss``,
``gt_iou_mean``, ``total_loss``) atol 5e-3 and parameters rtol 2e-3 / atol
5e-5, tests/test_parallel.py's bounds for the chaotic clustering path; the
cluster ids and proposal slots of world 4 are recorded equal to world 1's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3net_tpu.data.collate import BatchSpec as JaxBatchSpec
from d3net_tpu.data.collate import build_batch as jax_build_batch
from d3net_tpu.data.synthetic import make_scene as jax_make_scene
from d3net_tpu.models.pointgroup import PointGroup as JaxPointGroup
from d3net_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from d3net_tpu.train import trainer as jtrainer
from d3net_tpu_torch import checks, params
from d3net_tpu_torch.parallel import mesh

WORLD = 4
CLUSTERED = ("score_loss", "gt_iou_mean", "total_loss")


@pytest.fixture(scope="module")
def case():
    return checks.detector_dp_case(WORLD)


@pytest.fixture(scope="module")
def port(case):
    """World 1 in this process, world 4 in one spawn of 4 gloo ranks; both
    with and without clustering."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {c: checks.detector_step_rank(case, c, "SGD", "cpu")
               for c in (False, True)}
    finally:
        torch.set_num_threads(n)
    ranks = mesh.spawn(checks.rank_calls, WORLD, [
        (checks.detector_step_rank, (case, c, "SGD", "cpu"), {})
        for c in (False, True)], threads=1)
    return {c: {"one": one[c], "ranks": [r[i] for r in ranks]}
            for i, c in enumerate((False, True))}


def _jax_step(case, do_clustering, monkeypatch):
    scenes = [jax_make_scene(seed=i, **checks.DP_SCENE) for i in range(WORLD)]
    batch_np = jax_build_batch(scenes, JaxBatchSpec(**checks.DP_SPEC))
    dp = make_mesh(jax.devices()[:WORLD])
    model = JaxPointGroup(**case["cfg"])
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(case["jitter"]))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, x, *a, **k: jnp.asarray(
                            case["perm"].astype(np.int32)))
    with jax.set_mesh(dp):
        batch = shard_batch(jax.tree.map(jnp.asarray, batch_np), dp)
        tx = jtrainer.make_optimizer(lr=1e-3, steps_per_epoch=10,
                                     optim="SGD")
        v = jax.tree.map(jnp.asarray, case["variables"])
        state = replicate(jtrainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
            tx=tx), dp)
        step = jtrainer.jit_train_step(model, do_clustering=do_clustering)
        state, metrics = step(state, batch, jax.random.key(1))
        trace = next(s for s in state.opt_state
                     if isinstance(s, optax.TraceState)).trace
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": params.flatten(jax.tree.map(np.asarray, trace)),
                "params": params.flatten(jax.tree.map(np.asarray,
                                                      state.params)),
                "stats": params.flatten(jax.tree.map(np.asarray,
                                                     state.batch_stats))}


@pytest.fixture(scope="module")
def jax_steps(case):
    res = {}
    for c in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            res[c] = _jax_step(case, c, mp)
    return res


def _flax(case, arrays, coll):
    """Port arrays by state_dict key -> flat Flax names of ``coll``."""
    model = params.load_detector(case["variables"], case["cfg"], device="cpu")
    tree = params.state_dict_to_flax(
        model, {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})
    return params.flatten(tree[coll])


CASES = pytest.mark.parametrize("do_clustering", [False, True],
                                ids=["no_clustering", "clustering"])


@CASES
def test_losses_match_jax_dp_step(port, jax_steps, do_clustering):
    got = port[do_clustering]["ranks"][0]["metrics"]
    want = jax_steps[do_clustering]["metrics"]
    assert set(got) == set(want)
    for k in want:
        if do_clustering and k in CLUSTERED + ("grad_norm",):
            np.testing.assert_allclose(got[k], want[k], atol=5e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)


@CASES
def test_gradients_and_params_match_jax_dp_step(case, port, jax_steps,
                                                do_clustering):
    rank0 = port[do_clustering]["ranks"][0]
    want = jax_steps[do_clustering]
    if do_clustering:
        got = _flax(case, rank0["state"], "params")
        assert set(got) == set(want["params"])
        for k, w in want["params"].items():
            np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=5e-5,
                                       err_msg=k)
        return
    got = _flax(case, rank0["grads"], "params")
    assert set(got) == set(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    assert max(float(np.abs(g).max()) for g in got.values()) > 0


def test_bn_statistics_match_jax_dp_step(case, port, jax_steps):
    got = _flax(case, port[False]["ranks"][0]["state"], "batch_stats")
    want = jax_steps[False]["stats"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@CASES
def test_world4_matches_world1(port, do_clustering):
    one, rank0 = port[do_clustering]["one"], port[do_clustering]["ranks"][0]
    assert set(one["metrics"]) == set(rank0["metrics"])
    for k, v in one["metrics"].items():
        if do_clustering and k in CLUSTERED + ("grad_norm",):
            np.testing.assert_allclose(rank0["metrics"][k], v, atol=5e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(rank0["metrics"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    tol = dict(rtol=2e-3, atol=5e-5) if do_clustering else dict(
        rtol=1e-5, atol=2e-6)
    for k, v in one["state"].items():
        np.testing.assert_allclose(rank0["state"][k], v, err_msg=k, **tol)


def test_world4_cluster_ids_equal_world1(port):
    """The clustering saw the same offsets to within its tolerance: the
    cluster ids and proposal slots of the 4 ranks' rows are world 1's."""
    one, ranks = port[True]["one"], port[True]["ranks"]
    assert int(one["ints"]["cluster_mask_all"].sum()) >= 4
    for k, v in one["ints"].items():
        np.testing.assert_array_equal(
            np.concatenate([r["ints"][k] for r in ranks]), v, err_msg=k)


@CASES
def test_params_bit_identical_across_ranks(port, do_clustering):
    ranks = port[do_clustering]["ranks"]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_world1_group_step_is_bit_equal_to_no_group(case):
    """The distributed path on a one-rank gloo group computes the step with
    no group bit for bit: every all-reduce is a copy and every other op of
    the path computes the same values (``checks.world1_group_step``, which
    ``chip_smoke.py`` runs on a one-rank NCCL group on the card)."""
    from d3net_tpu_torch.data.collate import batch_to_torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = checks.world1_group_step(
            case["variables"], case["cfg"], batch_to_torch(case["batch"],
                                                           "cpu"),
            dev="cpu", backend="gloo", then=lambda state: mesh.world())
    finally:
        torch.set_num_threads(n)
    assert res["bit_equal"] and res["step_reproducible"] and res["ok"]
    assert res["then"] == 1 and not mesh.active()
    assert res["checked"] > 0 and res["max_abs_err"] == 0.0
