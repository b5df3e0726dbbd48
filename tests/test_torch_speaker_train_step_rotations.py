"""One mode-1 train step with the orientation loss on, the port against
JAX on the CPU: tests/test_torch_speaker_train_step.py's comparison on a
batch of one scene with seeded object rotations about z
(``checks.speaker_step_case``), so that the orientation head's loss, its
accuracy and the gradients of ``edge_layer``/``edge_predict`` are held to
JAX's too.

One scene, because the two losses meet only there: JAX's step passes the
row-expanded ``local_ids`` (B·chunk rows) with the scene-level edge
logits, and its shapes broadcast only at B = 1, where it averages chunk
identical copies of the port's one row per scene.

Tolerances as in the other file: the seven metrics rtol 1e-4; gradients
rtol 1e-3 / atol 1e-6; new BN statistics rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import speaker_step_case
from d3net_tpu_torch.train import pipeline as tpl

from test_torch_speaker_train_step import (  # noqa: F401  (fixture)
    CASES, METRICS, _cfg, _jax_side, _port_side, one_torch_thread,
)

ORIENTATION_HEAD = (".edge_layer.", ".edge_predict.")


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(tcfg.load, batch_size=1)
    vocab, emb = tpl.build_vocab(cfg)
    case = speaker_step_case(cfg, vocab, seed=1)   # a graph with edges
    assert case["batch"]["scene_object_rotations"].shape[0] == 1
    return dict(cfg=cfg, vocab=vocab, emb=emb, scenes=case["scenes"],
                batch_np=case["batch"], lang_np=case["lang"],
                variables=case["variables"], chunk=case["chunk"],
                jitter=case["jitter"], perm=case["perm"],
                gumbel=case["gumbel"])


@pytest.fixture(scope="module")
def results(setup):
    with pytest.MonkeyPatch.context() as mp:
        jax_res, _, _ = _jax_side(setup, mp, targets=False)
    return dict(jax=jax_res,
                port={f: _port_side(setup, f) for f in (False, True)})


@CASES
def test_rotation_metrics(results, freeze):
    want, got = results["jax"][freeze]["metrics"], results["port"][freeze][
        "metrics"]
    assert set(got) == set(want) == METRICS
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
    assert got["orientation_loss"] > 0
    assert got["captioning_loss"] > 0


@CASES
def test_rotation_gradients(results, freeze):
    want = results["jax"][freeze]["grads"]
    model = results["port"][freeze]["model"]
    got = params.flatten(params.state_dict_to_flax(model, {
        n: p.grad for n, p in model.named_parameters()
        if p.grad is not None})["params"])
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == (
        {"speaker"} if freeze else {"detector", "speaker"})
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    # the orientation head now has a loss: each of its gradients is nonzero
    head = [k for k in want if any(h in k for h in ORIENTATION_HEAD)]
    assert head and all(np.abs(want[k]).max() > 0 for k in head)


@CASES
def test_rotation_bn_statistics(results, freeze):
    got = params.flatten(params.state_dict_to_flax(
        results["port"][freeze]["model"])["batch_stats"])
    want = results["jax"][freeze]["batch_stats"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
