"""One mode-3 train step with the detector frozen on GT proposals
(``data.requires_gt_mask``, ``model.freeze_detector``) against the JAX
package's, on the CPU, on conf/debug/tiny_joint.yaml under
``checks.joint_parity_config``.

The step and its tolerances are tests/test_torch_joint_train_step.py's,
with its helpers (the same draws handed to JAX: jitter, permutation,
Gumbel, the listeners' dropout masks by path and shape and the copy-paste
draw), the JAX optimizer masking the detector (``make_frozen_optimizer``)
and the port computing no gradient for it (``freeze_submodules``):

- rollout ids, target ids and host scores equal; sampled log-probs and
  target IoUs rtol 1e-4 / atol 1e-5 (the targets are picked among the
  proposals, so equal targets mean equal proposals);
- the proposals are the scenes' GT instances;
- the metrics rtol 1e-4;
- gradients rtol 1e-3 / atol 1e-6 under the one-ulp rule (an element
  outside passes only within 4x the larger of the two sides' movements
  when every weight moves by one ulp, under 1% of a tensor; the BN-fed
  biases have a zero gradient), for the speaker and the listener only;
- the detector gets no gradient and no update on either side; every BN
  statistic moves, the detector's too, rtol 1e-4 / atol 1e-5.
"""

import os

import jax
import numpy as np
import pytest
import torch

from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import (
    BN_FED_BIASES, grad_mismatches, joint_parity_config, joint_step_case,
    joint_step_inputs, joint_step_kwargs, ulp_moved,
)
from d3net_tpu_torch.train import pipeline as tpl
from test_torch_joint_train_step import (
    METRICS, ULP_FACTOR, _grads, jax_grads, jax_joint_step, port_joint_step,
)
from test_torch_speaker_train_step import _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "conf", "debug", "tiny_joint.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gt_config(load):
    cfg = joint_parity_config(load(TINY))
    cfg.data.requires_gt_mask = True
    cfg.model.freeze_detector = True
    return cfg


@pytest.fixture(scope="module")
def results():
    from d3net_tpu import config as jcfg

    cfg = gt_config(tcfg.load)
    vocab, emb = tpl.build_vocab(cfg)
    case = joint_step_case(cfg, vocab, emb, seed=3)
    moved = dict(case["variables"])
    moved["params"] = ulp_moved(moved["params"], np.random.default_rng(0))
    with pytest.MonkeyPatch.context() as mp:
        jres = jax_joint_step(gt_config(jcfg.load), vocab, emb, case, mp,
                              case["variables"], moved, freeze=True)
    args = (cfg, vocab, emb, case)
    port = port_joint_step(*args, case["variables"], freeze=True)
    ulp = port_joint_step(*args, moved, {k: port["rollout"][k]
                                         for k in tpl.ROLLOUT_KEYS},
                          freeze=True)
    return dict(cfg=cfg, vocab=vocab, emb=emb, case=case, jax=jres,
                port=port, ulp=ulp)


def test_proposals_are_the_gt_instances(results):
    cfg, case = results["cfg"], results["case"]
    inputs = joint_step_inputs(case, results["emb"], "cpu")
    model = params.load_pipeline(case["variables"], cfg, results["vocab"],
                                 device="cpu")
    with torch.no_grad():
        props = model.run_detector(inputs[0], train=True, **{
            k: v for k, v in joint_step_kwargs(case, "cpu").items()
            if k in ("jitter_u", "proposal_perm")})
    n_props = props["proposal_batch_mask"].sum(1).numpy()
    np.testing.assert_array_equal(n_props,
                                  case["spk"][0]["gt_box_mask"].sum(1))
    assert (n_props > 0).all()


def test_rollout_and_scores(results):
    rollout, scores = results["jax"][:2]
    got = results["port"]["rollout"]
    for k in ("sampled_cap", "baseline_cap", "target_ids"):
        np.testing.assert_array_equal(got[k].numpy(), rollout[k], err_msg=k)
    for k in ("target_ious", "sampled_logps"):
        np.testing.assert_allclose(got[k].numpy(), rollout[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for g, w in zip((got["sampled_scores"], got["baseline_scores"]), scores):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    assert float(got["target_ious"].max()) > 0.5


def test_metrics(results):
    want, got = results["jax"][3], results["port"]["metrics"]
    assert set(got) == set(want) == METRICS
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
    assert got["captioning_loss"] != 0 and got["spk_ref_loss"] > 0


def test_gradients(results):
    want, jax_moved = jax_grads(results["jax"][2]), results["jax"][4]
    got = _grads(results["port"]["model"])
    moved = _grads(results["ulp"]["model"])
    assert {k.split(".")[0] for k in got} == {k.split(".")[0] for k in want} \
        == {"speaker", "listener"}
    assert set(got) == set(want)
    bad, _ = grad_mismatches(got, want, {
        k: np.maximum(np.abs(g - moved[k]), np.abs(want[k] - jax_moved[k]))
        for k, g in got.items()},
        ulp_factor=ULP_FACTOR, zero_grads=BN_FED_BIASES)
    assert bad == []


def test_frozen_detector_and_bn_statistics(results):
    new, port = results["jax"][2], results["port"]
    model = port["model"]
    assert all(p.grad is None for p in model.detector.parameters())
    before_j = params.flatten(results["case"]["variables"]["params"]
                              ["detector"])
    after_j = _flat(jax.tree.map(np.asarray, new.params["detector"]))
    assert set(after_j) == set(before_j)
    assert all(np.array_equal(after_j[k], before_j[k]) for k in before_j)
    sd, before = model.state_dict(), port["before"]
    stats = {k for k in sd if k.endswith((".mean", ".var"))}
    det = [k for k in sd if k.startswith("detector.") and k not in stats]
    assert det and all(torch.equal(sd[k], before[k]) for k in det)
    got = params.flatten(params.state_dict_to_flax(model)["batch_stats"])
    want = _flat(jax.tree.map(np.asarray, new.batch_stats))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    assert all(not torch.equal(sd[k], before[k]) for k in stats)
