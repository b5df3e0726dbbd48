"""``data/scanrefer.py`` against the JAX package's, on the CPU: a small
JSON in ScanRefer's format (``scene_id``, ``object_id``, ``object_name``,
``token``) written by the test over ``make_scene`` scenes. ``scene_ids``,
``corpus``, ``build_vocab`` and ``gt_descriptions`` are equal, and
``lang_chunk_for_scene`` gives equal arrays from one seed, with word erase
on and off and ``num_refs`` 1 and 3 (the ``gt_refs`` of every annotation
of the target). Entries whose object has no box in the scene, and a scene
with no entries, are in the file too.
"""

import json

import numpy as np
import pytest

from d3net_tpu_torch.data.scanrefer import ScanRefer
from d3net_tpu_torch.data.synthetic import make_scene

SCENE_KW = dict(num_instances=4, points_per_instance=200, floor_points=300)
WORDS = ["the", "chair", "table", "is", "next", "to", "a", "brown", "wooden",
         "window", "under", "lamp", "big", "small", "on", "left"]


def _write_json(path, scenes, rng):
    """ScanRefer-format entries: 1-3 descriptions of each instance of the
    first two scenes, two of an object id with no box, none for the
    third scene."""
    entries = []
    for scene in scenes[:2]:
        ids = [int(b[7]) for b in scene.instance_bboxes] + [99]
        for oid in ids:
            for _ in range(int(rng.integers(1, 4)) if oid != 99 else 2):
                n = int(rng.integers(3, 14))
                entries.append({
                    "scene_id": scene.scene_id, "object_id": str(oid),
                    "object_name": "thing", "ann_id": str(len(entries)),
                    "token": [WORDS[i] for i in rng.integers(0, len(WORDS),
                                                             n)]})
    order = rng.permutation(len(entries))
    with open(path, "w") as f:
        json.dump([entries[i] for i in order], f)


@pytest.fixture(scope="module")
def refer(tmp_path_factory):
    from d3net_tpu.data.scanrefer import ScanRefer as JScanRefer
    from d3net_tpu.data.synthetic import make_scene as jmake

    path = str(tmp_path_factory.mktemp("scanrefer") / "ScanRefer_val.json")
    scenes = [make_scene(seed=s, **SCENE_KW) for s in range(3)]
    _write_json(path, scenes, np.random.default_rng(0))
    return dict(port=ScanRefer(path), jax=JScanRefer(path), scenes=scenes,
                jscenes=[jmake(seed=s, **SCENE_KW) for s in range(3)])


def test_index_and_corpus_match_jax(refer):
    got, want = refer["port"], refer["jax"]
    assert got.scene_ids() == want.scene_ids() == sorted(
        s.scene_id for s in refer["scenes"][:2])
    assert got.corpus() == want.corpus() and len(got.corpus()) > 10
    gv, wv = got.build_vocab(), want.build_vocab()
    assert gv.idx2word == wv.idx2word and gv.word2idx == wv.word2idx
    for scene in refer["scenes"]:
        g = got.gt_descriptions(scene.scene_id)
        assert g == want.gt_descriptions(scene.scene_id)
        assert bool(g) == (scene is not refer["scenes"][2])


@pytest.mark.parametrize("num_refs", [1, 3])
@pytest.mark.parametrize("erase", [False, True], ids=["plain", "word_erase"])
@pytest.mark.parametrize("scene_idx", [0, 1, 2])
def test_lang_chunk_matches_jax(refer, scene_idx, erase, num_refs):
    vocab = refer["port"].build_vocab()
    jvocab = refer["jax"].build_vocab()
    seed = 10 * scene_idx + num_refs
    kw = dict(chunk_size=6, max_len=8, max_instances=16,
              apply_word_erase=erase, num_refs=num_refs)
    got = refer["port"].lang_chunk_for_scene(
        refer["scenes"][scene_idx], vocab, rng=np.random.default_rng(seed),
        **kw)
    want = refer["jax"].lang_chunk_for_scene(
        refer["jscenes"][scene_idx], jvocab,
        rng=np.random.default_rng(seed), **kw)
    assert set(got) == set(want)
    assert ("gt_refs" in got) == (num_refs > 1)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    annotated = got["annotated"].sum()
    if scene_idx == 2:
        assert annotated == 0
    else:
        # the rows that drew the object with no box stay empty
        assert 0 < annotated <= 6
        assert (got["ref_box_label"].sum(1) == got["annotated"]).all()


def test_word_erase_changes_rows(refer):
    """With word erase on, some row of some draw holds an unk id where the
    plain draw from the same seed has a word (both sides equal above)."""
    port = refer["port"]
    vocab = port.build_vocab()
    changed = 0
    for seed in range(8):
        a, b = (port.lang_chunk_for_scene(
            refer["scenes"][0], vocab, 6, 8, np.random.default_rng(seed), 16,
            apply_word_erase=e) for e in (False, True))
        changed += int((a["lang_ids"] != b["lang_ids"]).any())
        assert (b["lang_ids"][a["lang_ids"] != b["lang_ids"]]
                == vocab.unk_id).all()
    assert changed > 0
