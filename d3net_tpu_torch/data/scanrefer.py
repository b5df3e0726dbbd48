"""ScanRefer dataset loading (real-data path).

A copy of ``d3net_tpu/data/scanrefer.py`` over the port's own ``Scene``,
vocabulary, word erase and box helper (the port never imports the JAX
package): the same file, scene and generator give the same arrays. No
loader reads it, in either package: both train on the grammar
descriptions of ``data/language.py``.

Parity: ``lib/dataset/pipeline.py`` vocabulary building (:433-502),
tokenization (:504-552), and per-scene chunking (:583-604) over the
ScanRefer_filtered_{train,val}.json entries
({scene_id, object_id, object_name, token, ...}).

When ScanRefer json files exist on disk this module supplies descriptions
to the same chunk format the synthetic generator emits, so the rest of the
pipeline is source-agnostic.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np

from d3net_tpu_torch.data.synthetic import Scene
from d3net_tpu_torch.data.vocab import Vocabulary
from d3net_tpu_torch.utils.bbox import box_corners


class ScanRefer:
    def __init__(self, json_path: str):
        with open(json_path) as f:
            self.entries = json.load(f)
        # scene -> object_id -> [entries]
        self.organized: Dict[str, Dict[int, List[dict]]] = defaultdict(
            lambda: defaultdict(list)
        )
        for e in self.entries:
            self.organized[e["scene_id"]][int(e["object_id"])].append(e)

    def scene_ids(self) -> List[str]:
        return sorted(self.organized.keys())

    def corpus(self) -> List[List[str]]:
        return [e["token"] for e in self.entries]

    def build_vocab(self) -> Vocabulary:
        return Vocabulary.build(self.corpus())

    def gt_descriptions(self, scene_id: str) -> Dict[int, List[str]]:
        """object_id -> reference strings (for caption eval)."""
        return {
            oid: [" ".join(e["token"]) for e in lst]
            for oid, lst in self.organized.get(scene_id, {}).items()
        }

    def lang_chunk_for_scene(
        self,
        scene: Scene,
        vocab: Vocabulary,
        chunk_size: int,
        max_len: int,
        rng: np.random.Generator,
        max_instances: int,
        apply_word_erase: bool = False,
        num_refs: int = 1,
    ) -> Dict[str, np.ndarray]:
        """Sample chunk_size ScanRefer entries for one scene (ref :583-604).

        ``num_refs > 1`` emits ``gt_refs``: every human annotation of the
        target object (up to num_refs), matching the reference's RL reward
        corpus (``lib/captioning/loss_helper.py:58-67``).
        """
        from d3net_tpu_torch.data.language import word_erase

        t = max_len + 2
        out = {
            "lang_ids": np.zeros((chunk_size, t), np.int32),
            "lang_len": np.zeros(chunk_size, np.int32),
            "annotated": np.zeros(chunk_size, np.float32),
            "ref_box_corner_label": np.zeros((chunk_size, 8, 3), np.float32),
            "ref_box_label": np.zeros((chunk_size, max_instances), np.float32),
            "ref_cat_label": np.zeros(chunk_size, np.int32),
        }
        if num_refs > 1:
            out["gt_refs"] = np.zeros((chunk_size, num_refs, t), np.int32)
        per_obj = self.organized.get(scene.scene_id, {})
        entries = [e for lst in per_obj.values() for e in lst]
        if not entries:
            return out
        # object_id -> box row in the scene
        obj2box = {int(b[7]): b for b in scene.instance_bboxes}
        order = rng.permutation(len(entries))
        for c in range(chunk_size):
            e = entries[int(order[c % len(entries)])]
            oid = int(e["object_id"])
            box = obj2box.get(oid)
            if box is None:
                continue
            tokens = e["token"]
            ids = vocab.encode(tokens, max_len)
            length = min(len(tokens), max_len) + 2
            if num_refs > 1:
                out["gt_refs"][c, 0] = ids
                others = [o for o in per_obj.get(oid, []) if o is not e]
                for r, o in enumerate(others[: num_refs - 1], start=1):
                    out["gt_refs"][c, r] = vocab.encode(o["token"], max_len)
            if apply_word_erase:
                ids = word_erase(ids, length, vocab.unk_id, rng)
            out["lang_ids"][c] = ids
            out["lang_len"][c] = length
            out["annotated"][c] = 1.0
            out["ref_box_corner_label"][c] = box_corners(box[:3], box[3:6])
            if 0 <= oid < max_instances:
                out["ref_box_label"][c, oid] = 1.0
            cat = int(box[6]) - 2
            out["ref_cat_label"][c] = cat if cat >= 0 else 17
        return out
