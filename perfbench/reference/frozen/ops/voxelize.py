"""Host-side voxelization and sparse-conv kernel maps (gather mode).

The gather-mode subset of ``d3net_tpu/ops/voxelize.py``. ``voxelize``,
``submanifold_table``, ``downsample_level`` and ``upsample_table`` run the
C++ host library (``ops/native.py``) on every path; the numpy functions
beside them (``*_plain``) are the plain versions the tests hold the
library against, byte for byte, and nothing on the main path calls them.
Outputs are byte-identical to the JAX package's host path.

- ``p2v``   (N,)      point -> voxel index
- ``coords``(M, 3)    unique voxel integer coords
- per U-Net level:
    ``nbr``  (M_l, 27)     submanifold 3^3 neighbor table; tap
                           ``(1+ox)*9 + (1+oy)*3 + (1+oz)``, tap 13 = centre
    ``down`` (M_{l+1}, 8)  stride-2 kernel-2 conv table into level l
    ``up``   (M_l, 8)      transposed stride-2 table into level l+1

INVALID entries point one past the real voxel count (the level cap after
padding); the device side reads a zero row there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


_KEY_BOUND = 1 << 20  # per-axis headroom inside int64
_KEY_BIAS = 1 << 10


def pack_keys(coords: np.ndarray) -> np.ndarray:
    """(M, 3) int coords -> (M,) unique int64 keys (order-preserving lex)."""
    c = coords.astype(np.int64) + _KEY_BIAS
    return (c[:, 0] * _KEY_BOUND + c[:, 1]) * _KEY_BOUND + c[:, 2]


def voxelize_plain(coords: np.ndarray):
    """Deduplicate (N, 3) integer point coords into voxels.

    Returns voxel_coords (M, 3) int32 (sorted by key, first occurrence's
    coords), p2v (N,) int32 and counts (M,) int32.
    """
    keys = pack_keys(coords)
    uniq, p2v, counts = np.unique(keys, return_inverse=True, return_counts=True)
    order = np.argsort(keys, kind="stable")
    first = order[np.searchsorted(keys[order], uniq, side="left")]
    voxel_coords = coords[first].astype(np.int32)
    return voxel_coords, p2v.astype(np.int32), counts.astype(np.int32)


def _lookup(sorted_keys: np.ndarray, sorted_to_orig: np.ndarray,
            query: np.ndarray, invalid: int) -> np.ndarray:
    """Find each query key's voxel index, or ``invalid`` if absent."""
    pos = np.searchsorted(sorted_keys, query)
    pos = np.clip(pos, 0, len(sorted_keys) - 1)
    hit = sorted_keys[pos] == query
    return np.where(hit, sorted_to_orig[pos], invalid).astype(np.int32)


def _offsets(kernel_size: int) -> np.ndarray:
    """Lexicographic kernel offsets. size 3 -> -1..1 (27), size 2 -> 0..1 (8)."""
    if kernel_size == 3:
        r = np.arange(-1, 2)
    elif kernel_size == 2:
        r = np.arange(0, 2)
    else:
        raise ValueError(f"unsupported kernel_size {kernel_size}")
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(np.int64)


def _query(base: np.ndarray, o: np.ndarray) -> np.ndarray:
    return ((base[:, 0] + o[0]) * _KEY_BOUND + (base[:, 1] + o[1])) \
        * _KEY_BOUND + (base[:, 2] + o[2])


def submanifold_table_plain(coords: np.ndarray) -> np.ndarray:
    """(M, 3) voxel coords -> (M, 27) stride-1 neighbor table (INVALID = M)."""
    m = len(coords)
    keys = pack_keys(coords)
    order = np.argsort(keys)
    sk = keys[order]
    c = coords.astype(np.int64) + _KEY_BIAS
    offs = _offsets(3)
    out = np.empty((m, len(offs)), dtype=np.int32)
    for k, o in enumerate(offs):
        out[:, k] = _lookup(sk, order, _query(c, o), m)
    return out


def downsample_level_plain(coords: np.ndarray):
    """Stride-2 kernel-2 conv: coarse coords (M2, 3) and down table (M2, 8).

    ``down[p, k]`` is the fine voxel at ``2p + k`` or INVALID (= M_fine).
    """
    m = len(coords)
    coarse = np.floor_divide(coords.astype(np.int64), 2)
    coarse_coords = np.unique(coarse, axis=0).astype(np.int32)
    keys = pack_keys(coords)
    order = np.argsort(keys)
    sk = keys[order]
    base = coarse_coords.astype(np.int64) * 2 + _KEY_BIAS
    down = np.empty((len(coarse_coords), 8), dtype=np.int32)
    for k, o in enumerate(_offsets(2)):
        down[:, k] = _lookup(sk, order, _query(base, o), m)
    return coarse_coords, down


def upsample_table_plain(fine_coords: np.ndarray,
                         coarse_coords: np.ndarray) -> np.ndarray:
    """(M_fine, 8) transposed-conv table: one valid parent per row, at the
    child's offset ``f mod 2``; INVALID = M_coarse elsewhere."""
    mc = len(coarse_coords)
    ckeys = pack_keys(coarse_coords)
    order = np.argsort(ckeys)
    sk = ckeys[order]
    f = fine_coords.astype(np.int64)
    parent_coord = np.floor_divide(f, 2)
    off = f - parent_coord * 2
    off_id = (off[:, 0] * 2 + off[:, 1]) * 2 + off[:, 2]
    pc = parent_coord + _KEY_BIAS
    q = (pc[:, 0] * _KEY_BOUND + pc[:, 1]) * _KEY_BOUND + pc[:, 2]
    parent = _lookup(sk, order, q, mc)
    up = np.full((len(fine_coords), 8), mc, dtype=np.int32)
    up[np.arange(len(fine_coords)), off_id] = parent
    return up


# the reference takes the plain numpy versions (the program's main path
# binds the C++ host library here, with the same signatures and outputs)
voxelize = voxelize_plain
submanifold_table = submanifold_table_plain
downsample_level = downsample_level_plain
upsample_table = upsample_table_plain


@dataclass
class LevelMaps:
    """Static-shape kernel maps for one U-Net level (one scene)."""

    num_voxels: int
    coords: np.ndarray                 # (cap, 3) int32, zero-padded
    nbr: np.ndarray                    # (cap, 27) int32, INVALID = cap
    down: Optional[np.ndarray] = None  # (cap_next, 8) into this level
    up: Optional[np.ndarray] = None    # (cap, 8) into next level


def _pad_rows(a: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
    n = min(len(a), cap)
    out[:n] = a[:n]
    return out


def build_unet_maps(coords: np.ndarray, caps: List[int]) -> List[LevelMaps]:
    """Padded kernel maps for every U-Net level of one scene, finest first.

    Entries pointing past a level's real voxel count are remapped to that
    level's cap (the padded zero row), so truncation keeps indices in range.
    """
    levels: List[LevelMaps] = []
    cur = coords
    for li, cap in enumerate(caps):
        m = min(len(cur), cap)
        cur = cur[:m]
        nbr = submanifold_table(cur)
        nbr = np.where(nbr >= m, cap, nbr)
        lv = LevelMaps(
            num_voxels=m,
            coords=_pad_rows(cur.astype(np.int32), cap, 0),
            nbr=_pad_rows(nbr, cap, cap),
        )
        levels.append(lv)
        if li + 1 < len(caps):
            coarse, down = downsample_level(cur)
            next_cap = caps[li + 1]
            mc = min(len(coarse), next_cap)
            coarse = coarse[:mc]
            down = np.where(down[:mc] >= m, cap, down[:mc])
            lv.down = _pad_rows(down, next_cap, cap)
            up = upsample_table(cur, coarse)
            up = np.where(up >= mc, next_cap, up)
            lv.up = _pad_rows(up, cap, next_cap)
            cur = coarse
    return levels
