"""The port's caption decoder and speaker (``d3net_tpu_torch/models/
caption.py``, ``speaker.py``) against ``d3net_tpu.models`` on the CPU, same
inputs made by numpy from a seed, same weights converted from the Flax tree
(biases made nonzero, so each one is checked).

- ``GRUCell`` against ``flax.linen.GRUCell`` (rtol 1e-5): Flax's gates, no
  ``b_hr``/``b_hz``, ``b_hn`` inside ``r * (W_hn h + b_hn)``.
- ``step`` logits (rtol 1e-5), ``greedy_decode`` ids (equal) and logits
  (rtol 1e-4), ``add_relation_feat`` (rtol 1e-5).
- ``CaptionModule`` and ``SpeakerNet`` in eval mode on the fake proposals
  of tests/test_speaker_listener.py: ``lang_cap`` ids equal.
- The modes and entry points of the speaker's training path raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from d3net_tpu.models.caption import CaptionModule as JCaption
from d3net_tpu.models.graph import GraphModule as JGraph
from d3net_tpu.models.speaker import SpeakerNet as JSpeaker
from d3net_tpu.utils.bbox import box_corners
from d3net_tpu_torch import params
from d3net_tpu_torch.checks import teacher_forced_logits
from d3net_tpu_torch.models.caption import CaptionModule, GRUCell
from d3net_tpu_torch.models.pipeline import PipelineNet
from d3net_tpu_torch.models.speaker import SpeakerNet

B, P, F, V, L = 2, 12, 32, 40, 4
H, E, MAX_LEN = 64, 300, 10


def fake_proposals(rng):
    """tests/test_speaker_listener.py's fake proposals (numpy)."""
    centers = rng.uniform(0, 5, (B, P, 3)).astype(np.float32)
    sizes = rng.uniform(0.3, 1.0, (B, P, 3)).astype(np.float32)
    mask = np.ones((B, P), np.float32)
    mask[:, -2:] = 0
    return {
        "proposal_feats_batched": rng.normal(size=(B, P, F)).astype(np.float32),
        "proposal_batch_mask": mask,
        "proposal_bbox_batched": box_corners(centers, sizes),
        "proposal_center_batched": centers,
    }


def randomize(tree, rng):
    """Flax initialises biases at 0: draw them, so each is checked."""
    tree = jax.tree.map(np.array, tree)

    def walk(t):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "bias":
                t[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    walk(tree)
    return tree


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_gru_cell_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    h = rng.normal(size=(5, 9)).astype(np.float32)
    cell = fnn.GRUCell(9)
    v = randomize(cell.init(jax.random.key(0), jnp.asarray(h),
                            jnp.asarray(x)), rng)
    want, _ = cell.apply(to_jax(v), jnp.asarray(h), jnp.asarray(x))
    port = GRUCell(7, 9)
    port.load_state_dict(params.flax_to_state_dict(v, port))
    assert sorted(n for n, _ in port.named_parameters()) == [
        "bias_hn", "bias_ih", "weight_hh", "weight_ih"]
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree.leaves(v))
    with torch.no_grad():
        got = port(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def decoder():
    """A Flax CaptionModule with drawn biases, its port, and step inputs."""
    rng = np.random.default_rng(1)
    n = 6
    inputs = {
        "emb": (rng.normal(size=(V, E)) * 0.3).astype(np.float32),
        "target": rng.normal(size=(n, F)).astype(np.float32),
        "obj": rng.normal(size=(n, P, F)).astype(np.float32),
        "vm": (rng.random((n, P)) < 0.6).astype(np.float32),
        "h1": rng.normal(size=(n, H)).astype(np.float32),
        "h2": rng.normal(size=(n, H)).astype(np.float32),
    }
    jm = JCaption(num_vocabs=V, sos_id=2, eos_id=3, feat_size=F,
                  num_proposals=P, num_locals=L, max_len=MAX_LEN,
                  hidden_size=H)
    j = to_jax(inputs)
    v = jm.init(jax.random.key(0), (j["h1"], j["h2"]), j["emb"][:n],
                j["target"], j["obj"], j["vm"], method=JCaption.step)
    v = randomize(v, rng)
    tm = CaptionModule(num_vocabs=V, sos_id=2, eos_id=3, feat_size=F,
                       num_locals=L, max_len=MAX_LEN, hidden_size=H)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    return jm, to_jax(v), tm, inputs


def test_step_logits_match_jax(decoder):
    jm, v, tm, x = decoder
    j, t = to_jax(x), to_torch(x)
    word = np.arange(6) + 4
    want = jm.apply(v, (j["h1"], j["h2"]), j["emb"][word], j["target"],
                    j["obj"], j["vm"], method=JCaption.step)
    with torch.no_grad():
        got = tm.step((t["h1"], t["h2"]), t["emb"][word], t["target"],
                      t["obj"], t["vm"])
    for g, w, name in ((got[0], want[0], "logits"), (got[1][0], want[1][0], "h1"),
                       (got[1][1], want[1][1], "h2"), (got[2], want[2], "attn")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_greedy_decode_matches_jax(decoder):
    jm, v, tm, x = decoder
    j, t = to_jax(x), to_torch(x)
    want_ids, want_logits = jm.apply(v, j["emb"], j["target"], j["obj"],
                                     j["vm"], method=JCaption.greedy_decode)
    with torch.no_grad():
        ids, logits = tm.greedy_decode(t["emb"], t["target"], t["obj"], t["vm"])
        # the card check's teacher-forced loop, on the rollout's own ids,
        # gives the rollout's logits
        forced = teacher_forced_logits(tm, t["emb"], t["target"], t["obj"],
                                       t["vm"], ids)
    assert ids.dtype == torch.int32 and ids.shape == (6, MAX_LEN + 1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert len(np.unique(ids.numpy())) >= 3           # not one repeated word
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(forced, logits)


def test_add_relation_feat_matches_jax(decoder):
    jm, v, tm, _ = decoder
    rng = np.random.default_rng(3)
    n, c = 5, F
    edge = rng.normal(size=(n, P, L, c)).astype(np.float32)
    lids = np.sort(rng.integers(0, P, (n, P, L)), -1).astype(np.int32)
    lmask = (rng.random((n, P, L)) < 0.7).astype(np.float32)
    lids = np.where(lmask > 0, lids, P - 1).astype(np.int32)
    obj = rng.normal(size=(n, P, c)).astype(np.float32)
    tid = rng.integers(0, P, n).astype(np.int32)
    args = (edge, lids, lmask, obj, tid)
    want = jm.apply(v, *map(jnp.asarray, args),
                    method=JCaption.add_relation_feat)
    got = tm.add_relation_feat(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _graph_out():
    data = to_jax(fake_proposals(np.random.default_rng(0)))
    gm = JGraph(out_size=F, num_layers=2, num_locals=L)
    return jax.tree.map(np.asarray, gm.apply(gm.init(jax.random.key(0), data),
                                             data))


@pytest.mark.parametrize("use_relation,num_locals", [(True, L), (False, L),
                                                     (True, -1)])
def test_caption_module_eval_matches_jax(use_relation, num_locals):
    data = {k: v for k, v in _graph_out().items()}
    data["glove_embeddings"] = (np.random.default_rng(2).normal(
        size=(V, E)) * 0.3).astype(np.float32)
    kw = dict(num_vocabs=V, sos_id=2, eos_id=3, feat_size=F,
              num_locals=num_locals, max_len=MAX_LEN, hidden_size=H,
              use_relation=use_relation)
    jm = JCaption(num_proposals=P, **kw)
    v = randomize(jm.init(jax.random.key(1), to_jax(data), mode="eval"),
                  np.random.default_rng(4))
    want = np.asarray(jm.apply(to_jax(v), to_jax(data), mode="eval")[
        "lang_cap"])
    tm = CaptionModule(**kw)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    with torch.no_grad():
        got = tm(to_torch(data), mode="eval")["lang_cap"]
    assert got.shape == (B, P, MAX_LEN + 1) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_speaker_eval_matches_jax():
    data = fake_proposals(np.random.default_rng(0))
    data["glove_embeddings"] = (np.random.default_rng(5).normal(
        size=(V, E)) * 0.3).astype(np.float32)
    kw = dict(num_vocabs=V, sos_id=2, eos_id=3, feat_size=F,
              num_graph_steps=2, num_locals=L, max_len=MAX_LEN)
    js = JSpeaker(num_proposals=P, **kw)
    v = randomize(js.init(jax.random.key(2), to_jax(data), mode="eval"),
                  np.random.default_rng(6))
    want = jax.tree.map(np.asarray, js.apply(to_jax(v), to_jax(data),
                                             mode="eval"))
    ts = SpeakerNet(m=F, **kw)
    ts.load_state_dict(params.flax_to_state_dict(v, ts))
    with torch.no_grad():
        got = ts(to_torch(data), mode="eval")
    np.testing.assert_array_equal(got["lang_cap"].numpy(), want["lang_cap"])
    for k in ("adjacent_mat", "local_ids", "local_mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], k)
    for k in ("bbox_feature", "edge_feature", "edge_orientations"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_training_path_raises():
    tm = CaptionModule(num_vocabs=V, sos_id=2, eos_id=3, feat_size=F,
                       hidden_size=H)
    for mode in ("tf", "free", "rl", "rl_tf"):
        with pytest.raises(NotImplementedError, match="queue A item 13"):
            tm({}, mode=mode)
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        tm.beam_decode()
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        SpeakerNet(V, 2, 3, num_graph_steps=0)({}, mode="tf")
    with pytest.raises(NotImplementedError, match="queue A item 14"):
        PipelineNet(9, dict(m=4, blocks=(1, 2)), no_grounding=False)
