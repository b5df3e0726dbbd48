"""The traffic generator: seeded ScanNet-like scenes from a traffic file.

A traffic file (``perfbench/traffic/<name>.json``) gives ``num_scenes``,
``batch_size``, ``scene`` (the keyword arguments of the scene generator,
a frozen copy of the port's ``data/synthetic.make_scene``) and
``workers``, the host threads that make and collate them. Scene ``i`` of
run ``seed`` is drawn from ``derive(seed, "scene")`` and ``i``: every seed
gives the same counts and sizes, other scenes.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

from perfbench.harness.seeds import derive
from perfbench.reference.frozen.data.synthetic import Scene, make_scene


def make_scenes(traffic: Dict[str, Any], seed: int,
                split: str = "train") -> List[Scene]:
    """The traffic's ``num_scenes`` scenes of ``split`` for run ``seed``."""
    base = derive(seed, f"scene.{split}") * 4096
    n = int(traffic["num_scenes" if split == "train" else "num_val_scenes"])
    kw = dict(traffic["scene"])
    if "size_range" in kw:
        kw["size_range"] = tuple(kw["size_range"])
    with ThreadPoolExecutor(max(1, int(traffic.get("workers", 1)))) as ex:
        return list(ex.map(lambda i: make_scene(seed=base + i, **kw),
                           range(n)))
