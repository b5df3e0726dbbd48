"""Vocabulary + word-embedding matrix.

A copy of ``d3net_tpu/data/vocab.py`` (the port never imports the JAX
package): the same corpus gives the same ids and the same matrix, byte for
byte, so the two files change together.

Parity: the reference builds a vocabulary from ScanRefer train descriptions
and trims a GLoVE pickle to it (``lib/dataset/pipeline.py:433-502``); pad
id 0 doubles as the CE ignore_index.  When no GLoVE pickle is available,
embeddings fall back to deterministic random vectors keyed by the word —
stable across runs/processes.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Dict, Iterable, List, Optional

import numpy as np

SPECIALS = ["pad_", "unk", "sos", "eos"]


class Vocabulary:
    def __init__(self, word2idx: Dict[str, int]):
        self.word2idx = word2idx
        self.idx2word = {i: w for w, i in word2idx.items()}

    @property
    def pad_id(self):
        return self.word2idx["pad_"]

    @property
    def unk_id(self):
        return self.word2idx["unk"]

    @property
    def sos_id(self):
        return self.word2idx["sos"]

    @property
    def eos_id(self):
        return self.word2idx["eos"]

    def __len__(self):
        return len(self.word2idx)

    @classmethod
    def build(cls, corpus: Iterable[List[str]]) -> "Vocabulary":
        words = sorted({w for sent in corpus for w in sent})
        word2idx = {w: i for i, w in enumerate(SPECIALS)}
        for w in words:
            if w not in word2idx:
                word2idx[w] = len(word2idx)
        return cls(word2idx)

    def encode(self, tokens: List[str], max_len: int) -> np.ndarray:
        """tokens -> [sos, w1.., eos, pad..] of length max_len+2."""
        ids = [self.sos_id]
        for w in tokens[:max_len]:
            ids.append(self.word2idx.get(w, self.unk_id))
        ids.append(self.eos_id)
        out = np.full(max_len + 2, self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids, stop_at_eos: bool = True) -> List[str]:
        words = []
        for i in np.asarray(ids).tolist():
            w = self.idx2word.get(int(i), "unk")
            if w == "sos":
                continue
            if w == "eos" and stop_at_eos:
                break
            if w == "pad_":
                break
            words.append(w)
        return words

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.word2idx, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            return cls(json.load(f))


def _hash_vector(word: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.3, size=dim).astype(np.float32)


def embedding_matrix(vocab: Vocabulary, glove_path: Optional[str] = None,
                     dim: int = 300) -> np.ndarray:
    """(V, dim) float32: GLoVE vectors where available, else hash-random.
    Row pad_=0 is all zeros (matching the reference's pad embedding)."""
    glove = {}
    if glove_path and os.path.exists(glove_path):
        with open(glove_path, "rb") as f:
            glove = pickle.load(f)
    emb = np.zeros((len(vocab), dim), np.float32)
    for w, i in vocab.word2idx.items():
        if w == "pad_":
            continue
        if w in glove:
            emb[i] = np.asarray(glove[w], np.float32)[:dim]
        else:
            emb[i] = _hash_vector(w, dim)
    return emb
