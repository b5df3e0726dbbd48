"""Host-side point-cloud augmentation (numpy, runs in the input pipeline).

A copy of ``d3net_tpu/utils/transform.py``: the same generator state gives
the same augmentation on both sides, so the two files change together.
Parity targets: ``lib/utils/transform.py`` (jitter/flip/rotz/elastic) and
``lib/utils/pc.py:crop`` in the reference.  All randomness flows through an
explicit ``np.random.Generator`` so the pipeline is reproducible and
shardable across input-pipeline workers.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import scipy.interpolate


def jitter_matrix(rng: np.random.Generator, intensity: float = 0.1) -> np.ndarray:
    """3x3 matrix = I + N(0, intensity)."""
    return np.eye(3) + rng.standard_normal((3, 3)) * intensity


def flip_matrix(rng: np.random.Generator, axis: int = 0, random: bool = True) -> np.ndarray:
    """3x3 matrix flipping `axis` (randomly sign-flipped if random)."""
    m = np.eye(3)
    m[axis, axis] *= (int(rng.integers(0, 2)) * 2 - 1) if random else -1
    return m


def rotz_matrix(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def random_rotz_matrix(rng: np.random.Generator) -> np.ndarray:
    return rotz_matrix(rng.uniform(0, 2 * np.pi))


def elastic(x: np.ndarray, gran: float, mag: float, rng: np.random.Generator) -> np.ndarray:
    """Elastic distortion on (N, 3) coords (PointGroup-style).

    Smooth 3-axis noise fields on a grid of granularity ``gran`` (box-blurred
    twice along each axis), trilinearly interpolated at point positions and
    scaled by ``mag``.
    """
    blurs = [
        np.ones((3, 1, 1), np.float32) / 3,
        np.ones((1, 3, 1), np.float32) / 3,
        np.ones((1, 1, 3), np.float32) / 3,
    ]
    bb = (np.abs(x).max(0).astype(np.int32) // gran + 3).astype(np.int64)
    noise = [rng.standard_normal(tuple(bb)).astype(np.float32) for _ in range(3)]
    for _ in range(2):
        for b in blurs:
            noise = [scipy.ndimage.convolve(n, b, mode="constant", cval=0) for n in noise]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in bb]
    interp = [
        scipy.interpolate.RegularGridInterpolator(ax, n, bounds_error=False, fill_value=0)
        for n in noise
    ]
    disp = np.stack([f(x) for f in interp], axis=1)
    return x + disp * mag


def crop(pc: np.ndarray, max_num_point: int, scale: float, rng: np.random.Generator):
    """Random spatial crop so at most ``max_num_point`` points survive.

    ``pc`` is non-negative scaled coords.  Returns (shifted pc, valid mask).
    Shrinks the allowed xy-range until the count fits, like the reference.
    """
    pc_offset = pc.copy()
    valid = pc_offset.min(1) >= 0
    max_range = np.array([scale] * 3, dtype=np.float64)
    pc_range = pc.max(0) - pc.min(0)
    while valid.sum() > max_num_point:
        offset = np.clip(max_range - pc_range + 0.001, None, 0) * rng.random(3)
        pc_offset = pc + offset
        valid = (pc_offset.min(1) >= 0) & ((pc_offset < max_range).sum(1) == 3)
        max_range[:2] -= 32
    return pc_offset, valid
