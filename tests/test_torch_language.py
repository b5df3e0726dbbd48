"""The port's vocabulary and language data (``d3net_tpu_torch/data/vocab.py``,
``language.py``) against ``d3net_tpu.data``: the same corpus, scenes and
generators give byte-identical ids, embedding matrices, descriptions and
lang batches."""

import numpy as np
import pytest

from d3net_tpu.data import language as jlang
from d3net_tpu.data import vocab as jvocab
from d3net_tpu.data.synthetic import make_scene as jscene
from d3net_tpu_torch.data import language as tlang
from d3net_tpu_torch.data import vocab as tvocab
from d3net_tpu_torch.data.synthetic import make_scene as tscene

SCENE = dict(num_instances=5, points_per_instance=200, floor_points=300,
             room=5.0)


def _vocabs():
    return (jvocab.Vocabulary.build(jlang.base_corpus()),
            tvocab.Vocabulary.build(tlang.base_corpus()))


def test_vocabulary_and_embeddings_identical(tmp_path):
    jv, tv = _vocabs()
    assert tlang.base_corpus() == jlang.base_corpus()
    assert tv.word2idx == jv.word2idx and len(tv) == 44
    assert (tv.pad_id, tv.unk_id, tv.sos_id, tv.eos_id) == (0, 1, 2, 3)
    want = jvocab.embedding_matrix(jv)
    got = tvocab.embedding_matrix(tv, str(tmp_path / "no_glove.pkl"))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert not got[0].any()
    for w in ("chair", "left", "sos"):
        assert tvocab._hash_vector(w, 300).tobytes() == \
            jvocab._hash_vector(w, 300).tobytes()
    toks = ["the", "tall", "chair", "zebra"]
    assert tv.encode(toks, 6).tobytes() == jv.encode(toks, 6).tobytes()
    ids = np.array([2, 7, 9, 1, 3, 5, 0], np.int32)
    assert tv.decode(ids) == jv.decode(ids)
    assert tv.decode(ids, stop_at_eos=False) == jv.decode(ids,
                                                          stop_at_eos=False)
    tv.save(str(tmp_path / "v.json"))
    assert jvocab.Vocabulary.load(str(tmp_path / "v.json")).word2idx \
        == jv.word2idx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_describe_instance_identical(seed):
    js, ts = jscene(seed=seed, **SCENE), tscene(seed=seed, **SCENE)
    for j in range(len(ts.instance_bboxes)):
        for r in range(6):
            assert tlang.describe_instance(ts, j, np.random.default_rng(r)) \
                == jlang.describe_instance(js, j, np.random.default_rng(r))


@pytest.mark.parametrize("word_erase,num_refs", [(False, 1), (True, 3)])
def test_build_lang_batch_identical(word_erase, num_refs):
    jv, tv = _vocabs()
    seeds = (3, 4, 5)
    kw = dict(chunk_size=8, max_len=12, max_instances=6,
              apply_word_erase=word_erase, num_refs=num_refs)
    want = jlang.build_lang_batch([jscene(seed=s, **SCENE) for s in seeds], jv,
                                  rng=np.random.default_rng(9), **kw)
    got = tlang.build_lang_batch([tscene(seed=s, **SCENE) for s in seeds], tv,
                                 rng=np.random.default_rng(9), **kw)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    ids = np.arange(20, dtype=np.int32)
    for s in range(8):
        assert tlang.word_erase(ids, 12, 1, np.random.default_rng(s)).tobytes() \
            == jlang.word_erase(ids, 12, 1, np.random.default_rng(s)).tobytes()
