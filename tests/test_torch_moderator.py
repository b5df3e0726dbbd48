"""Joint RL's moderator and host reward (``d3net_tpu_torch/models/
pipeline.py`` ``moderate_captions`` and ``PipelineNet.moderator``,
``train/pipeline.py`` ``make_caption_reward_fn`` and ``caption_scores``)
against ``d3net_tpu.models.pipeline`` and ``d3net_tpu.train.
pipeline_loop`` on the CPU, on the same numpy-seeded ids.

- ``moderate_captions``: rows with no eos, with eos at 0 and later, and
  the baseline one step longer than the beam, whose eos forced at the last
  slot falls to the cut (length ``max_len``, no eos): ids and lengths
  equal.
- ``moderator``: ids, lengths and the pseudo-GT (the target proposal's box
  and class - 2, 17 where negative) equal, embeddings equal.
- The reward: CIDEr of one and of several references a row (all-zero rows
  are padding, duplicates dropped), unannotated rows 0, and the
  self-critical symmetry (equal ids give a zero delta): equal to JAX's to
  1e-6 relative (the same float64 host code, cast to f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.models.pipeline import PipelineNet as JPipeline
from d3net_tpu.models.pipeline import moderate_captions as j_moderate
from d3net_tpu.train import pipeline_loop as jpl
from d3net_tpu_torch.data.language import base_corpus
from d3net_tpu_torch.data.vocab import Vocabulary
from d3net_tpu_torch.models.pipeline import PipelineNet, moderate_captions
from d3net_tpu_torch.train import pipeline as tpl
from d3net_tpu_torch.utils.bbox import box_corners

SOS, EOS, PAD = 2, 3, 0
MAX_SPK = 8          # the listener's rows: max_spk_len + 2
N, TOPN, P, V, E = 6, 3, 10, 30, 16


def _ids(rng, shape):
    """Word ids without sos/eos/pad, then eos placed per row: at 0, in the
    middle, at the last slot, or nowhere."""
    ids = rng.integers(4, V, shape).astype(np.int32)
    flat = ids.reshape(-1, shape[-1])
    for r in range(flat.shape[0]):
        where = r % 4
        if where == 0:
            flat[r, 0] = EOS
        elif where == 1:
            flat[r, shape[-1] // 2] = EOS
            flat[r, shape[-1] // 2 + 2:] = PAD
        elif where == 2:
            flat[r, -1] = EOS
    return ids


@pytest.mark.parametrize("t", [MAX_SPK - 1, MAX_SPK],
                         ids=["beam_length", "baseline_length"])
def test_moderate_captions_matches_jax(t):
    ids = _ids(np.random.default_rng(t), (N, TOPN, t))
    got_ids, got_lens = moderate_captions(torch.from_numpy(ids), SOS, EOS,
                                          PAD, MAX_SPK)
    want_ids, want_lens = j_moderate(jnp.asarray(ids), SOS, EOS, PAD,
                                     MAX_SPK)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    got_ids, got_lens = got_ids.numpy(), got_lens.numpy()
    assert got_ids.shape == (N, TOPN, MAX_SPK)
    assert (got_ids[..., 0] == SOS).all()
    no_eos = ~(ids == EOS).any(-1)
    assert no_eos.any() and ((ids == EOS)[..., 0]).any()
    if t == MAX_SPK:
        # the forced eos sat at slot t = MAX_SPK and the cut dropped it
        assert (got_lens[no_eos] == MAX_SPK).all()
        assert not (got_ids[no_eos] == EOS).any()
    else:
        assert (got_lens[no_eos] == MAX_SPK).all()
        assert (got_ids[no_eos][:, -1] == EOS).all()
    eos0 = (ids == EOS)[..., 0]
    assert (got_lens[eos0] == 2).all() and (got_ids[eos0][:, 2:] == PAD).all()


def test_moderator_matches_jax():
    rng = np.random.default_rng(3)
    centers = rng.uniform(0, 4, (N, P, 3)).astype(np.float32)
    data = {
        "sampled_cap": _ids(rng, (N, TOPN, MAX_SPK - 1)),
        "baseline_cap": _ids(rng, (N, MAX_SPK)),
        "target_ids": rng.integers(0, P, N).astype(np.int32),
        "proposal_bbox_batched": box_corners(
            centers, rng.uniform(0.2, 1.0, (N, P, 3)).astype(np.float32)),
        "proposal_sem_cls_batched_rows": rng.integers(0, 20, (N, P)).astype(
            np.int32),
        "glove_embeddings": rng.normal(size=(V, E)).astype(np.float32),
    }
    # classes 0 and 1 map to 17, the others to class - 2
    data["proposal_sem_cls_batched_rows"][:2, :] = np.array([0, 1] * (P // 2))
    want = JPipeline(detector_cfg={}, max_spk_len=MAX_SPK - 2).apply(
        {}, {k: jnp.asarray(v) for k, v in data.items()}, TOPN,
        method=JPipeline.moderator)
    model = PipelineNet(9, dict(m=4, blocks=(1, 2)), max_spk_len=MAX_SPK - 2,
                        no_grounding=False)
    got = model.moderator({k: torch.from_numpy(v) for k, v in data.items()},
                          TOPN)
    keys = [k for k in want if k.startswith("mod_")]
    assert sorted(keys) == sorted(k for k in got if k.startswith("mod_"))
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["mod_sampled_ids"].shape == (N * TOPN, MAX_SPK)
    assert got["mod_ref_cat_label"].dtype == torch.int32
    assert (got["mod_ref_cat_label"].numpy()[:2 * TOPN] != 0).all()
    assert 17 in got["mod_ref_cat_label"].numpy()[:2 * TOPN]


@pytest.fixture(scope="module")
def vocab():
    return Vocabulary.build(base_corpus())


def _sentences(vocab, rng, n, t=12):
    """Encoded grammar-like rows: words of the vocabulary, sos..eos, pad."""
    words = [w for w in vocab.word2idx if w not in ("pad_", "unk", "sos",
                                                    "eos")]
    rows = []
    for _ in range(n):
        k = int(rng.integers(3, t - 2))
        rows.append(vocab.encode(list(rng.choice(words[:12], k)), t - 2))
    return np.stack(rows).astype(np.int32)


def test_reward_matches_jax(vocab):
    rng = np.random.default_rng(5)
    cand = _sentences(vocab, rng, N)
    refs = np.stack([_sentences(vocab, rng, 4) for _ in range(N)])
    refs[0, 2:] = 0                        # padding rows
    refs[1, 3] = refs[1, 1]                # a duplicate reference
    cand[2] = refs[2, 0]                   # one exact match
    ann = np.array([1, 1, 1, 0, 1, 1], np.float32)
    # the JAX loop's call: CIDEr alone (bleu_weight 0)
    fn = tpl.make_caption_reward_fn(vocab)
    jfn = jpl.make_caption_reward_fn(vocab, 1.0, 0.0)
    for gt in (refs, refs[:, 0]):          # several references; one
        got, want = fn(cand, gt, ann), np.asarray(jfn(cand, gt, ann))
        assert got.dtype == np.float32 and got.shape == (N,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert got[3] == 0.0 and got[2] > got[[0, 1, 4, 5]].max()
    # self-critical symmetry: equal ids, zero delta
    np.testing.assert_array_equal(fn(cand, refs, ann) - fn(cand, refs, ann),
                                  0.0)
    # an unannotated batch scores 0 without a CIDEr call
    assert not fn(cand, refs, np.zeros(N, np.float32)).any()


def test_caption_scores_two_corpora(vocab):
    """``caption_scores``: sampled and baseline rows scored in two reward
    calls (their document frequencies differ), each row repeated topn
    times, with ``gt_refs`` as the references."""
    rng = np.random.default_rng(9)
    n, topn, t = 4, 2, 12
    sampled = _sentences(vocab, rng, n * topn, t - 1)
    baseline = _sentences(vocab, rng, n, t + 1)
    refs = np.stack([_sentences(vocab, rng, 3, t) for _ in range(n)])
    lang = {"gt_refs": torch.from_numpy(refs),
            "lang_ids": torch.from_numpy(refs[:, 0]),
            "annotated": torch.tensor([1.0, 0.0, 1.0, 1.0])}
    rollout = {"sampled_cap": torch.from_numpy(sampled.reshape(n, topn, -1)),
               "baseline_cap": torch.from_numpy(baseline)}
    fn = tpl.make_caption_reward_fn(vocab)
    s, b = tpl.caption_scores(fn, rollout, lang, topn)
    ann = np.repeat(lang["annotated"].numpy(), topn)
    gt = np.repeat(refs, topn, axis=0)
    np.testing.assert_array_equal(s.numpy(), fn(sampled, gt, ann))
    np.testing.assert_array_equal(
        b.numpy(), fn(np.repeat(baseline, topn, axis=0), gt, ann))
    assert s.shape == b.shape == (n * topn,) and s.dtype == torch.float32
    assert not s[2:4].any() and s.any()
