"""The caption decoder's training modes (``d3net_tpu_torch/models/
caption.py``, ``speaker.py``) against ``d3net_tpu.models`` on the CPU, same
numpy inputs from a seed, same weights converted from the Flax tree (biases
made nonzero). ``jax.random.gumbel`` is patched to return the draw the
port is given.

- ``teacher_forcing``: logits (rtol 1e-4) in ``tf`` (step t reads word t)
  and ``free`` (step t reads the previous argmax), and in ``tf`` the
  gradients of the inputs and of every parameter (1e-3 / 1e-6).
- ``select_target``: target ids and assignments equal, IoUs rtol 1e-5, over
  annotated and unannotated rows, a scene with no valid proposal, a row
  whose referred box meets no proposal (all IoUs 0: the first index), and
  tied Gumbel values among valid proposals (the first index).
- ``CaptionModule`` and ``SpeakerNet`` (description rows expanded from the
  scenes by ``chunk_size``) in modes ``tf`` and ``free``: ``target_ids``,
  ``target_ious``, ``assigned_bbox_id_labels``, ``good_bbox_masks`` and the
  ``lang_cap`` logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.models.caption import CaptionModule as JCaption
from d3net_tpu.models.speaker import SpeakerNet as JSpeaker
from d3net_tpu.utils.bbox import box_corners
from d3net_tpu_torch import params
from d3net_tpu_torch.models.caption import CaptionModule
from d3net_tpu_torch.models.speaker import SpeakerNet

B, CHUNK, P, F, V, L, I = 2, 3, 10, 32, 30, 4, 5
N = B * CHUNK
H, E, T = 48, 300, 8
KW = dict(num_vocabs=V, sos_id=2, eos_id=3, feat_size=F, num_locals=L,
          max_len=T - 2, hidden_size=H)


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


def to_jax(d):
    return jax.tree.map(jnp.asarray, d)


def to_torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def boxes(rng, shape, lo=0.3, hi=1.0):
    centers = rng.uniform(0, 4, shape + (3,)).astype(np.float32)
    sizes = rng.uniform(lo, hi, shape + (3,)).astype(np.float32)
    return centers, box_corners(centers, sizes)


def row_inputs(seed):
    """Description-row inputs of ``select_target`` and the caption head:
    row 0 annotated with a referred box far from every proposal (all IoUs
    0), rows 1-2 annotated on a proposal's box, rows 3-4 not annotated
    (row 4 in a scene with no valid proposal), row 5 annotated; row 3's
    Gumbel draw ties between its two largest valid entries."""
    rng = np.random.default_rng(seed)
    centers, corners = boxes(rng, (N, P))
    mask = (rng.random((N, P)) < 0.8).astype(np.float32)
    mask[4] = 0.0
    gt_centers, gt_corners = boxes(rng, (N, I))
    ref = gt_corners[np.arange(N), rng.integers(0, I, N)].copy()
    ref[0] += 50.0
    mid = corners[2, 7].mean(0)
    ref[1], ref[2] = corners[1, 3], mid + (corners[2, 7] - mid) * 1.1
    annotated = np.array([1, 1, 1, 0, 0, 1], np.float32)
    gumbel = rng.gumbel(size=(N, P)).astype(np.float32)
    valid3 = np.nonzero(mask[3])[0]
    top = gumbel[3, valid3].max() + 1.0
    gumbel[3, valid3[-2:]] = top
    return dict(obj_masks=mask, centers=centers, corners=corners,
                center_labels=gt_centers, corner_labels=gt_corners,
                ref_corner_label=ref, is_annotated=annotated), gumbel


def patch_gumbel(monkeypatch, gumbel):
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, *a, **k: jnp.asarray(gumbel))


def test_select_target_matches_jax(monkeypatch):
    x, gumbel = row_inputs(0)
    patch_gumbel(monkeypatch, gumbel)
    order = ("obj_masks", "centers", "corners", "center_labels",
             "corner_labels", "ref_corner_label", "is_annotated")
    want = jax.tree.map(np.asarray, JCaption(**KW).apply(
        {}, jax.random.key(0), *(jnp.asarray(x[k]) for k in order),
        method=JCaption.select_target))
    got = CaptionModule.select_target(torch.from_numpy(gumbel),
                                      *(torch.from_numpy(x[k]) for k in order))
    assert got[0].dtype == got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-5, atol=1e-7)
    ids = got[0].numpy()
    assert ids[0] == 0 and want[1][0] == 0.0           # all IoUs 0
    assert ids[1] == 3 and ids[2] == 7                 # the referred boxes
    assert ids[3] == np.nonzero(x["obj_masks"][3])[0][-2]   # first of a tie
    assert ids[4] == gumbel[4].argmax()                # no valid proposal
    assert (want[1][1:3] > 0.5).all()


def _decoder():
    rng = np.random.default_rng(1)
    jm = JCaption(num_proposals=P, **KW)
    x = {
        "ids": rng.integers(4, V, (N, T)).astype(np.int32),
        "emb": (rng.normal(size=(V, E)) * 0.3).astype(np.float32),
        "target": rng.normal(size=(N, F)).astype(np.float32),
        "obj": rng.normal(size=(N, P, F)).astype(np.float32),
        "vm": (rng.random((N, P)) < 0.6).astype(np.float32),
    }
    x["ids"][:, 0] = 2
    j = to_jax(x)
    v = jm.init(jax.random.key(0), j["ids"], j["emb"], j["target"], j["obj"],
                j["vm"], method=JCaption.teacher_forcing)
    v = randomize(v, rng)
    tm = CaptionModule(**KW)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    return jm, to_jax(v), tm, x


@pytest.mark.parametrize("use_tf", [True, False], ids=["tf", "free"])
def test_teacher_forcing_matches_jax(use_tf):
    jm, v, tm, x = _decoder()
    j, t = to_jax(x), to_torch(x)

    def jax_fn(variables, target, obj):
        return jm.apply(variables, j["ids"], j["emb"], target, obj, j["vm"],
                        use_tf=use_tf, method=JCaption.teacher_forcing)

    want = np.asarray(jax_fn(v, j["target"], j["obj"]))
    target = t["target"].requires_grad_()
    obj = t["obj"].requires_grad_()
    got = tm.teacher_forcing(t["ids"], t["emb"], target, obj, t["vm"],
                             use_tf=use_tf)
    assert got.shape == (N, T - 1, V)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    if not use_tf:
        # the free-running rollout reads its own picks, not the words
        tf = tm.teacher_forcing(t["ids"], t["emb"], t["target"], t["obj"],
                                t["vm"])
        assert not torch.allclose(tf[:, 1:], got[:, 1:].detach())
        return
    # the loop is differentiable: inputs and every parameter
    w = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    gv, gt, go = jax.grad(lambda *a: (jax_fn(*a) * w).sum(),
                          argnums=(0, 1, 2))(v, j["target"], j["obj"])
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(target.grad.numpy(), np.asarray(gt),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(obj.grad.numpy(), np.asarray(go), rtol=1e-3,
                               atol=1e-6)
    want_p = params.flatten(jax.tree.map(np.asarray, gv)["params"])
    got_p = params.flatten(params.state_dict_to_flax(
        tm, {n: p.grad for n, p in tm.named_parameters()})["params"])
    assert set(got_p) == set(want_p)
    for k, g in want_p.items():
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(got_p[k], g, rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def scene_inputs(seed):
    """Scene-level proposals (B, P) and description rows (N = B·CHUNK)."""
    rng = np.random.default_rng(seed)
    centers, corners = boxes(rng, (B, P))
    mask = np.ones((B, P), np.float32)
    mask[:, -2:] = 0
    rows, gumbel = row_inputs(seed + 1)
    ids = rng.integers(4, V, (N, T)).astype(np.int32)
    ids[:, 0] = 2
    ids[:, -2:] = 0
    scenes = {
        "proposal_feats_batched": rng.normal(size=(B, P, F)).astype(np.float32),
        "proposal_batch_mask": mask,
        "proposal_bbox_batched": corners * mask[..., None, None],
        "proposal_center_batched": centers * mask[..., None],
    }
    lang = {
        "lang_ids": ids, "annotated": rows["is_annotated"],
        "ref_box_corner_label": rows["ref_corner_label"],
        "center_label_chunk": rows["center_labels"],
        "gt_bbox_chunk": rows["corner_labels"],
        "glove_embeddings": (rng.normal(size=(V, E)) * 0.3).astype(np.float32),
    }
    # row 2 refers to a proposal of its scene (row 2 is scene 0's)
    lang["ref_box_corner_label"][2] = corners[0, 4]
    return scenes, lang, gumbel


def _compare(got, want, graph_keys=()):
    for k in ("target_ids", "assigned_bbox_id_labels", "good_bbox_masks",
              *graph_keys):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["target_ious"].numpy(), want["target_ious"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["lang_cap"].numpy(), want["lang_cap"],
                               rtol=1e-4, atol=1e-5)
    assert got["lang_cap"].shape == (N, T - 1, V)
    assert got["good_bbox_masks"].any()


@pytest.mark.parametrize("mode", ["tf", "free"])
def test_caption_module_train_modes_match_jax(mode, monkeypatch):
    """The caption head on description rows (the speaker's expansion done
    by hand: each scene's proposals repeated per row)."""
    scenes, lang, gumbel = scene_inputs(3)
    patch_gumbel(monkeypatch, gumbel)
    rep = lambda a: np.repeat(a, CHUNK, axis=0)   # noqa: E731
    rng = np.random.default_rng(4)
    lids = np.sort(rng.integers(0, P, (B, P, L)), -1).astype(np.int32)
    data = {"bbox_feature": rep(scenes["proposal_feats_batched"]),
            "proposal_batch_mask": rep(scenes["proposal_batch_mask"]),
            "proposal_bbox_batched": rep(scenes["proposal_bbox_batched"]),
            "edge_feature": rep(rng.normal(size=(B, P, L, F)).astype(
                np.float32)),
            "local_ids": rep(lids),
            "local_mask": rep((rng.random((B, P, L)) < 0.7).astype(
                np.float32)),
            **lang}
    jm = JCaption(num_proposals=P, min_iou_threshold=0.1, **KW)
    v = randomize(jm.init(jax.random.key(1), to_jax(data), mode=mode,
                          rng=jax.random.key(2)), rng)
    want = jax.tree.map(np.asarray, jm.apply(to_jax(v), to_jax(data),
                                             mode=mode, rng=jax.random.key(2)))
    tm = CaptionModule(min_iou_threshold=0.1, **KW)
    tm.load_state_dict(params.flax_to_state_dict(v, tm))
    with torch.no_grad():
        got = tm(to_torch(data), mode=mode, gumbel=torch.from_numpy(gumbel))
    _compare(got, want)


@pytest.mark.parametrize("mode", ["tf", "free"])
def test_speaker_train_modes_match_jax(mode, monkeypatch):
    scenes, lang, gumbel = scene_inputs(5)
    patch_gumbel(monkeypatch, gumbel)
    data = {**scenes, **lang}
    kw = dict(num_vocabs=V, sos_id=2, eos_id=3, feat_size=F,
              num_graph_steps=2, num_locals=L, max_len=T - 2,
              min_iou_threshold=0.1)
    js = JSpeaker(num_proposals=P, **kw)
    v = randomize(js.init(jax.random.key(3), to_jax(data), mode=mode,
                          rng=jax.random.key(4), chunk_size=CHUNK),
                  np.random.default_rng(6))
    want = jax.tree.map(np.asarray, js.apply(
        to_jax(v), to_jax(data), mode=mode, rng=jax.random.key(4),
        chunk_size=CHUNK))
    ts = SpeakerNet(m=F, **kw)
    ts.load_state_dict(params.flax_to_state_dict(v, ts))
    with torch.no_grad():
        got = ts(to_torch(data), mode=mode, chunk_size=CHUNK,
                 gumbel=torch.from_numpy(gumbel))
    _compare(got, want, graph_keys=("local_ids", "local_mask"))
    assert got["bbox_feature"].shape[0] == N
    np.testing.assert_allclose(got["edge_orientations"].numpy(),
                               want["edge_orientations"], rtol=1e-4,
                               atol=1e-5)
