"""Every draw of a run comes from ``--seed`` through :func:`derive`."""

from __future__ import annotations

import hashlib


def derive(seed: int, tag: str) -> int:
    """A seed in ``[0, 2**31)`` for the part ``tag`` of run ``seed`` (any
    whole number, however large)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF
