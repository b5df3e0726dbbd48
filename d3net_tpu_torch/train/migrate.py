"""Checkpoint param-path migration (a copy of ``d3net_tpu/train/migrate.py``:
the port never imports the JAX package).

The JAX package's round 3 gave the U-Net residual/VGG blocks explicit
names (``blk{r}`` head reps, ``tail{i}`` post-skip reps), which the port's
modules share. Older JAX artifacts (``pretrained/*.pkl``) carry Flax's auto
names. :func:`migrate_legacy_block_names` rewrites those trees on load; new
trees pass through untouched.

Mapping per module scope: auto-numbered ``(Checkpoint)?ResidualBlock_i`` /
``(Checkpoint)?VGGBlock_i`` children split into head/tail by position —
scopes that also contain a nested ``UBlock_0`` (non-deepest U-Net levels)
have ``2*block_reps`` blocks, first half ``blk{i}``, second half
``tail{i}``; deepest scopes have only head reps.
"""

from __future__ import annotations

import re
from typing import Any, Dict

_BLOCK_RE = re.compile(r"^(?:Checkpoint)?(?:ResidualBlock|VGGBlock)_(\d+)$")


def migrate_legacy_block_names(tree: Any) -> Any:
    """Rename legacy auto-numbered U-Net block params to blk/tail names.

    Pure function over nested dicts; non-dict leaves pass through.  Safe to
    apply to already-migrated trees (no legacy keys -> identity).
    """
    if not isinstance(tree, dict):
        return tree
    legacy = {}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        m = _BLOCK_RE.match(k) if isinstance(k, str) else None
        if m:
            legacy[int(m.group(1))] = migrate_legacy_block_names(v)
        else:
            out[k] = migrate_legacy_block_names(v)
    if legacy:
        ids = sorted(legacy)
        has_child = any(isinstance(k, str) and k.startswith("UBlock_")
                        for k in tree)
        half = len(ids) // 2 if has_child else len(ids)
        for pos, i in enumerate(ids):
            name = f"blk{pos}" if pos < half else f"tail{pos - half}"
            out[name] = legacy[i]
    return out
