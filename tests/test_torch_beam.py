"""The port's beam search and joint RL's caption modes (``d3net_tpu_torch/
models/caption.py`` ``beam_decode``, modes ``rl`` and ``rl_tf``) against
``d3net_tpu.models.caption`` on the CPU: the same numpy-seeded inputs, the
same weights converted from the Flax tree (biases drawn, so each is
checked; the eos bias moved so that beams finish at different steps).

- ``beam_decode`` in groups of 1 and 3 (and 3 groups of 2), diversity
  lambda 0 and 0.5, beam 1: sequences equal, log-probs and scores rtol
  1e-4 / atol 1e-5. Beam 1 is the greedy decode up to its first eos.
- All ties: with the output layer zeroed every logit is equal, so every
  pick goes through the tie rule (``lax.top_k``'s lower index first).
- Mode ``rl`` (targets on the same Gumbel draw, beam samples, greedy
  baseline one step longer) and mode ``rl_tf`` on that rollout, whose
  log-probs are the beam's (the JAX package's own
  ``test_rl_tf_logps_match_beam_rollout`` contract).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.models.caption import CaptionModule as JCaption
from d3net_tpu_torch import params
from d3net_tpu_torch.models.caption import CaptionModule
from test_torch_caption import (
    E, F, H, L, MAX_LEN, P, V, _rows, randomize, to_jax, to_torch,
)

EOS, PAD = 3, 0
EOS_BIAS = -0.2    # beams finish at steps 1-7, some never
RTOL, ATOL = 1e-4, 1e-5
KW = dict(num_vocabs=V, sos_id=2, eos_id=EOS, feat_size=F, num_locals=L,
          max_len=MAX_LEN, hidden_size=H)


@pytest.fixture(scope="module")
def setup():
    """Flax caption variables with drawn biases and a moved eos bias, the
    same with the output layer zeroed, and decoder inputs for 5 rows."""
    rng = np.random.default_rng(11)
    n = 5
    x = {"emb": (rng.normal(size=(V, E)) * 0.3).astype(np.float32),
         "target": rng.normal(size=(n, F)).astype(np.float32),
         "obj": rng.normal(size=(n, P, F)).astype(np.float32),
         "vm": (rng.random((n, P)) < 0.6).astype(np.float32)}
    jm = JCaption(num_proposals=P, **KW)
    j = to_jax(x)
    h = jnp.zeros((n, H))
    v = randomize(jm.init(jax.random.key(0), (h, h), j["emb"][:n],
                          j["target"], j["obj"], j["vm"],
                          method=JCaption.step), rng)
    v["params"]["cls_fc2"]["bias"][EOS] += EOS_BIAS
    ties = jax.tree.map(np.array, v)
    ties["params"]["cls_fc2"]["kernel"][:] = 0.0
    ties["params"]["cls_fc2"]["bias"][:] = 0.0
    return {"v": v, "ties": ties, "x": x}


def _port(v, **kw):
    tm = CaptionModule(**KW, **kw)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    return tm


def _beams(v, x, bm, groups, lam):
    j, t = to_jax(x), to_torch(x)
    want = JCaption(num_proposals=P, **KW).apply(
        to_jax(v), j["emb"], j["target"], j["obj"], j["vm"], bm, None,
        groups, lam, method=JCaption.beam_decode)
    with torch.no_grad():
        got = _port(v).beam_decode(t["emb"], t["target"], t["obj"], t["vm"],
                                   bm, group_size=groups,
                                   diversity_lambda=lam)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_same(got, want):
    (seqs, lps, scores), (w_seqs, w_lps, w_scores) = got, want
    assert seqs.dtype == np.int32 and seqs.shape == w_seqs.shape
    np.testing.assert_array_equal(seqs, w_seqs)
    np.testing.assert_allclose(lps, w_lps, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(scores, w_scores, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bm,groups,lam", [(1, 1, 0.5), (3, 1, 0.5),
                                           (3, 3, 0.0), (3, 3, 0.5),
                                           (6, 3, 0.5)])
def test_beam_decode_matches_jax(setup, bm, groups, lam):
    got, want = _beams(setup["v"], setup["x"], bm, groups, lam)
    _assert_same(got, want)
    seqs, lps, _ = got
    n, _, t = seqs.shape
    assert seqs.shape == (5, bm, MAX_LEN + 1)
    # beams finish at different steps; a finished beam is frozen on pad
    # with log-prob 0
    first = np.where((seqs == EOS).any(-1), (seqs == EOS).argmax(-1), t)
    assert (first < t - 1).any() and (first == t).any()
    assert len(np.unique(first)) >= 3
    after = np.arange(t) > first[..., None]
    assert (seqs[after] == PAD).all() and (lps[after] == 0.0).all()
    if groups == 1 and bm > 1:
        # best-first within the group
        assert (np.diff(got[2], axis=1) <= 0).all()


def test_beam_one_is_greedy(setup):
    (seqs, lps, _), _ = _beams(setup["v"], setup["x"], 1, 1, 0.5)
    t = to_torch(setup["x"])
    with torch.no_grad():
        ids, logits = _port(setup["v"]).greedy_decode(
            t["emb"], t["target"], t["obj"], t["vm"])
    greedy_lp = torch.log_softmax(logits, -1).gather(
        -1, ids.long()[..., None])[..., 0].numpy()
    for r in range(seqs.shape[0]):
        row = seqs[r, 0]
        end = int((row == EOS).argmax()) + 1 if (row == EOS).any() \
            else len(row)
        np.testing.assert_array_equal(row[:end], ids[r, :end].numpy())
        np.testing.assert_allclose(lps[r, 0, :end], greedy_lp[r, :end],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bm,groups", [(3, 1), (3, 3)])
def test_all_ties_take_the_lower_index(setup, bm, groups):
    got, want = _beams(setup["ties"], setup["x"], bm, groups, 0.5)
    _assert_same(got, want)
    seqs = got[0]
    # every logit is equal, so every step extends a group's first beam by
    # its lowest words; one beam a group: each later group takes the
    # lowest word no earlier group took (the diversity penalty)
    if groups == 1:
        want = np.zeros((5, bm, MAX_LEN + 1), np.int32)
        want[:, :, -1] = np.arange(bm)
    else:
        want = np.broadcast_to(np.arange(bm)[:, None], (5, bm, MAX_LEN + 1))
    np.testing.assert_array_equal(seqs, want)


def _rl_rows():
    data = _rows(np.random.default_rng(7))
    data["annotated"] = np.array([1, 0, 1, 1], np.float32)
    gumbel = np.random.default_rng(8).gumbel(size=(4, P)).astype(np.float32)
    return data, gumbel


@pytest.fixture(scope="module")
def rl(setup):
    """Modes rl and rl_tf on both sides, 3 beams in 3 groups, top 2."""
    data, gumbel = _rl_rows()
    kw = dict(use_relation=False, beam_group_size=3, diversity_lambda=0.5)
    jm = JCaption(num_proposals=P, **KW, **kw)
    v = to_jax(setup["v"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gumbel",
                   lambda key, shape, *a, **k: jnp.asarray(gumbel))
        want = jax.tree.map(np.asarray, jm.apply(
            v, to_jax(data), mode="rl", rng=jax.random.key(0), beam_size=3,
            sample_topn=2))
    tm = _port(setup["v"], **kw)
    with torch.no_grad():
        got = tm(to_torch(data), mode="rl", gumbel=torch.from_numpy(gumbel),
                 beam_size=3, sample_topn=2)
    rollout = {f"{k}_in": got[k] for k in ("sampled_cap", "baseline_cap",
                                           "target_ids", "target_ious")}
    tf_data = {**to_torch(data), **rollout}
    tf_got = tm(tf_data, mode="rl_tf")
    tf_want = jax.tree.map(np.asarray, jm.apply(
        v, {**to_jax(data), **{k: jnp.asarray(x.numpy())
                               for k, x in rollout.items()}}, mode="rl_tf"))
    return dict(got=got, want=want, tf_got=tf_got, tf_want=tf_want)


def test_rl_mode_matches_jax(rl):
    got, want = rl["got"], rl["want"]
    for k in ("target_ids", "good_bbox_masks", "assigned_bbox_id_labels",
              "sampled_cap", "baseline_cap"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["target_ious"].numpy(),
                               want["target_ious"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["sampled_logps"].numpy(),
                               want["sampled_logps"], rtol=RTOL, atol=ATOL)
    assert got["sampled_cap"].shape == (4, 2, MAX_LEN + 1)
    # the baseline decodes one step more than the beam
    assert got["baseline_cap"].shape == (4, MAX_LEN + 2)
    assert got["sampled_cap"].dtype == got["baseline_cap"].dtype == \
        torch.int32


def test_rl_tf_matches_jax_and_the_beam(rl):
    got, want, tf_got, tf_want = rl["got"], rl["want"], rl["tf_got"], \
        rl["tf_want"]
    assert tf_got["sampled_logps"].requires_grad
    lp = tf_got["sampled_logps"].detach().numpy()
    np.testing.assert_allclose(lp, tf_want["sampled_logps"], rtol=RTOL,
                               atol=ATOL)
    # teacher forcing the rollout gives the beam's own log-probs, 0 after
    # the first eos
    np.testing.assert_allclose(lp, got["sampled_logps"].numpy(), rtol=RTOL,
                               atol=ATOL)
    for k in ("sampled_cap", "baseline_cap", "target_ids",
              "good_bbox_masks"):
        np.testing.assert_array_equal(tf_got[k].numpy(), got[k].numpy(),
                                      err_msg=k)
    # the reused selection has no GT ids, as in the JAX module
    np.testing.assert_array_equal(tf_got["assigned_bbox_id_labels"].numpy(),
                                  tf_want["assigned_bbox_id_labels"])
    assert not tf_got["assigned_bbox_id_labels"].any()
