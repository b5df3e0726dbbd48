"""The pipeline's train steps over a process group (``parallel/mesh.py``):
mode 1 (``speaker_train_step``), mode 2 (``listener_train_step``) and mode
3 (``joint_rl_train_step``) at the conf/debug/ tiny widths (B=2) on 2 gloo
ranks, one scene each, against world size 1 on the whole batch
(``checks.pipeline_step_rank``).

Mode 1 runs on ``checks.speaker_step_case``'s global draws (each rank
takes its rows); modes 2 and 3 draw from one seeded generator at the
global batch's rows on every rank (``mesh.draw_rows``), the listener's
copy-paste rolling over the global batch (``mesh.roll_rows``). Mode 3's
host CIDEr reward scores the global batch's rows as one corpus.

Tolerances, each step's own (PERF.md §2): metrics rtol 1e-4 / atol 1e-6;
gradients rtol 1e-3 / atol 1e-6; rollout ids equal, host scores equal.
Mode 2's backward into the detector is ill-conditioned in f32, and the
listener's Flax BatchNorm takes the fast variance E[x²] - E[x]², whose
cancellation turns the ranks' split sums into more than a weight's ulp at
a few elements: there a gradient element outside passes within 4x the
largest one-ulp movement of its tensor (both worlds' steps rerun on
weights moved by one ulp, the larger taken), for under 1% of the step's
elements (``checks.world_grad_mismatches``; the listener's BN-fed biases,
zero gradients, within the same). Parameters bit-identical across ranks
after every step.
"""

import numpy as np
import pytest
import torch

from d3net_tpu_torch import checks
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.scripts.train import load_task_config
from d3net_tpu_torch.train import pipeline as pl

CONFIGS = {1: "conf/debug/tiny_captioning.yaml",
           2: "conf/debug/tiny_grounding.yaml",
           3: "conf/debug/tiny_joint.yaml"}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for mode, path in CONFIGS.items():
        cfg = load_task_config(path)
        if mode == 3:
            checks.joint_parity_config(cfg)
        vocab, emb = pl.build_vocab(cfg)
        case = (checks.speaker_step_case(cfg, vocab) if mode == 1
                else checks.listener_step_case(cfg, vocab, emb) if mode == 2
                else checks.joint_step_case(cfg, vocab, emb))
        out[mode] = (cfg, case)
    return out


@pytest.fixture(scope="module")
def runs(cases):
    """World 1 (and mode 2 again on weights moved by one ulp) here, world 2
    in one spawn."""
    cfg, case = cases[2]
    moved = dict(case, variables=checks.ulp_moved(
        case["variables"], np.random.default_rng(3)))
    calls = [(checks.pipeline_step_rank, (mode, cfg, case), {})
             for mode, (cfg, case) in cases.items()]
    calls.append((checks.pipeline_step_rank, (2, cfg, moved), {}))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = checks.rank_calls(calls)
    finally:
        torch.set_num_threads(n)
    ranks = mesh.spawn(checks.rank_calls, 2, calls, threads=1)
    keys = list(cases) + ["ulp"]
    return {"one": dict(zip(keys, one)),
            "ranks": {m: [r[i] for r in ranks] for i, m in enumerate(keys)}}


MODES = pytest.mark.parametrize("mode", sorted(CONFIGS))


@MODES
def test_metrics_match_world1(runs, mode):
    want = runs["one"][mode]["metrics"]
    got = runs["ranks"][mode][0]["metrics"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@MODES
def test_gradients_match_world1(runs, mode):
    want = runs["one"][mode]["grads"]
    got = runs["ranks"][mode][0]["grads"]
    if mode == 2:
        bad, _ = checks.world_grad_mismatches(
            got, want, runs["ranks"]["ulp"][0]["grads"],
            runs["one"]["ulp"]["grads"])
    else:
        bad, _ = checks.grad_mismatches(got, want)
    assert bad == []
    assert max(float(np.abs(v).max()) for v in want.values()) > 0


@MODES
def test_params_bit_identical_across_ranks(runs, mode):
    r0, r1 = runs["ranks"][mode]
    assert r0["metrics"] == r1["metrics"]
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(r1["state"][k], v, err_msg=k)


def test_joint_rollout_and_rewards_equal_world1(runs):
    """Each rank's rollout ids and host scores are world 1's rows: the
    reward's corpus is the global batch's."""
    want = runs["one"][3]["rollout"]
    ranks = runs["ranks"][3]
    for k, v in want.items():
        np.testing.assert_array_equal(
            np.concatenate([r["rollout"][k] for r in ranks]), v, err_msg=k)
    assert (want["sampled_scores"] > 0).any()


def test_per_rank_corpus_gives_other_rewards(cases, runs):
    """What the global gather guards against: the same rows scored in each
    rank's own corpus (CIDEr's document frequencies over half the
    references) give other rewards than the global corpus does."""
    cfg, case = cases[3]
    vocab, _ = pl.build_vocab(cfg)
    reward_fn = pl.make_caption_reward_fn(vocab)
    rollout = runs["one"][3]["rollout"]
    topn = int(cfg.train.sample_topn)
    lang = case["spk"][2]
    refs = lang.get("gt_refs", lang["lang_ids"])
    rows = refs.shape[0] * refs.shape[1]
    gt = np.repeat(refs.reshape((rows,) + refs.shape[2:]), topn, axis=0)
    ann = np.repeat(lang["annotated"].reshape(-1), topn, axis=0)
    ids = rollout["sampled_cap"].reshape(rows * topn, -1)
    half = rows * topn // 2
    global_scores = reward_fn(ids, gt, ann)
    np.testing.assert_array_equal(global_scores, rollout["sampled_scores"])
    per_rank = np.concatenate([reward_fn(ids[s], gt[s], ann[s]) for s in (
        slice(0, half), slice(half, None))])
    assert not np.allclose(per_rank, global_scores, rtol=1e-4, atol=1e-6)
