"""Language data: synthetic referring descriptions + chunked lang batches.

A copy of ``d3net_tpu/data/language.py`` over the port's own ``Scene`` and
box helper (the port never imports the JAX package): the same scene and
generator give the same tokens and the same arrays, byte for byte, so the
two files change together.

Parity: the reference tokenizes ScanRefer descriptions and groups them into
per-scene chunks of ``num_des_per_scene`` (``lib/dataset/pipeline.py:
504-604``), with 50%-probability 20% word-erase augmentation (``:554-565``)
and "annotated" flags for semi-supervised caption entries.

With no ScanRefer on disk, ``describe_instance`` generates grammatical
referring expressions from scene geometry (class name, size, spatial
relations) over a small closed vocabulary.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.reference.frozen.data.synthetic import Scene
from perfbench.reference.frozen.data.vocab import Vocabulary
from perfbench.reference.frozen.utils.bbox import box_corners

# NYU20 class names (ScanNet remap order) — doubles as synthetic class names
NYU20_NAMES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "showercurtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]

_SIZES = ["small", "large", "tall", "wide", "low"]
_RELS = ["near", "next to", "far from", "left of", "right of", "behind",
         "in front of"]
_POS = ["corner", "center", "side"]


def _size_adj(size: np.ndarray) -> str:
    vol = float(np.prod(size))
    if size[2] > 1.5 * max(size[0], size[1]):
        return "tall"
    if vol < 0.1:
        return "small"
    if vol > 0.5:
        return "large"
    return "wide" if size[0] > size[1] else "low"


def describe_instance(scene: Scene, inst_idx: int, rng: np.random.Generator) -> List[str]:
    """Referring expression for one instance from scene geometry."""
    boxes = scene.instance_bboxes
    box = boxes[inst_idx]
    cls = NYU20_NAMES[int(box[6])]
    center, size = box[:3], box[3:6]
    tokens = ["the", _size_adj(size), cls]

    others = [b for j, b in enumerate(boxes) if j != inst_idx]
    if others and rng.random() < 0.9:
        d = [np.linalg.norm(b[:3] - center) for b in others]
        j = int(np.argmin(d))
        other = others[j]
        rel = "near" if d[j] < 1.5 else "far from"
        if rng.random() < 0.4:
            dx = other[0] - center[0]
            rel = "left of" if dx > 0 else "right of"
        tokens += rel.split() + ["the", NYU20_NAMES[int(other[6])]]
    else:
        tokens += ["in", "the", rng.choice(_POS)]
    return tokens


def base_corpus() -> List[List[str]]:
    """Closed vocabulary covering every producible synthetic sentence."""
    words = set(NYU20_NAMES) | set(_SIZES) | set(_POS)
    for r in _RELS:
        words |= set(r.split())
    words |= {"the", "in"}
    return [sorted(words)]


def word_erase(ids: np.ndarray, length: int, unk_id: int,
               rng: np.random.Generator, p_apply: float = 0.5,
               frac: float = 0.2) -> np.ndarray:
    """Reference word-erase aug: 50% chance to unk-out 20% of words."""
    if rng.random() >= p_apply:
        return ids
    out = ids.copy()
    # interior words only (skip sos at 0 and eos at length-1)
    n_words = max(length - 2, 0)
    n_erase = int(np.floor(n_words * frac))
    if n_erase > 0:
        sel = rng.choice(n_words, n_erase, replace=False) + 1
        out[sel] = unk_id
    return out


def lang_chunk_for_scene(
    scene: Scene,
    vocab: Vocabulary,
    chunk_size: int,
    max_len: int,
    rng: np.random.Generator,
    max_instances: int,
    apply_word_erase: bool = False,
    num_refs: int = 1,
) -> Dict[str, np.ndarray]:
    """One scene's chunk of descriptions (ref chunking :583-604).

    Entries beyond the instance count are unannotated (annotated=0, len 0) —
    the speaker captions random proposals for them (semi-supervised path).

    ``num_refs > 1`` additionally emits ``gt_refs`` (chunk, num_refs, T):
    several independent descriptions of the SAME target instance (ref 0 is
    the clean, pre-word-erase training description; the rest are resampled
    from the grammar; all-zero rows mean "no reference").
    """
    t = max_len + 2
    n_inst = min(len(scene.instance_bboxes), max_instances)
    out = {
        "lang_ids": np.zeros((chunk_size, t), np.int32),
        "lang_len": np.zeros(chunk_size, np.int32),
        "annotated": np.zeros(chunk_size, np.float32),
        "ref_box_corner_label": np.zeros((chunk_size, 8, 3), np.float32),
        "ref_box_label": np.zeros((chunk_size, max_instances), np.float32),
        "ref_cat_label": np.zeros(chunk_size, np.int32),
        # 0 = unique (object class appears once in the scene), 1 = multiple
        # (ScanRefer's ``unique_multiple`` label; ref eval_helper.py:106-112)
        "unique_multiple": np.zeros(chunk_size, np.float32),
    }
    if num_refs > 1:
        out["gt_refs"] = np.zeros((chunk_size, num_refs, t), np.int32)
    if n_inst == 0:
        return out
    cls_counts = np.bincount(
        scene.instance_bboxes[:, 6].astype(np.int64), minlength=20
    )
    order = rng.permutation(n_inst)
    for c in range(chunk_size):
        # ~10% unannotated entries exercise the semi-supervised caption path
        # (the reference gets these from extra_ratio synthetic entries)
        if c >= n_inst and rng.random() < 0.1:
            continue  # unannotated slot
        inst = int(order[c % n_inst])
        tokens = describe_instance(scene, inst, rng)
        ids = vocab.encode(tokens, max_len)
        length = len(tokens) + 2
        if num_refs > 1:
            out["gt_refs"][c, 0] = ids
            seen = {tuple(tokens)}
            r = 1
            for _ in range(4 * (num_refs - 1)):
                if r >= num_refs:
                    break
                alt = describe_instance(scene, inst, rng)
                if tuple(alt) in seen:
                    continue
                seen.add(tuple(alt))
                out["gt_refs"][c, r] = vocab.encode(alt, max_len)
                r += 1
        if apply_word_erase:
            ids = word_erase(ids, length, vocab.unk_id, rng)
        box = scene.instance_bboxes[inst]
        out["lang_ids"][c] = ids
        out["lang_len"][c] = length
        out["annotated"][c] = 1.0
        out["ref_box_corner_label"][c] = box_corners(box[:3], box[3:6])
        out["ref_box_label"][c, inst] = 1.0
        cat = int(box[6]) - 2
        out["ref_cat_label"][c] = cat if cat >= 0 else 17
        out["unique_multiple"][c] = float(cls_counts[int(box[6])] > 1)
    return out


def build_lang_batch(scenes: List[Scene], vocab: Vocabulary, chunk_size: int,
                     max_len: int, rng: np.random.Generator,
                     max_instances: int, apply_word_erase: bool = False,
                     num_refs: int = 1) -> Dict[str, np.ndarray]:
    chunks = [
        lang_chunk_for_scene(s, vocab, chunk_size, max_len, rng, max_instances,
                             apply_word_erase, num_refs=num_refs)
        for s in scenes
    ]
    return {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
