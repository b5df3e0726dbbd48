"""ctypes bindings of the C++ host library (``csrc/host_voxelize.cc``).

Counterpart of ``d3net_tpu/ops/native.py``, gather-mode subset. The
library is built with g++ at first use (``kernels/build.py``), never at
import. Unlike the JAX module there is no numpy fallback: ``get_lib``
raises when the library cannot be built or loaded. The tables are
byte-identical to the numpy plain versions in ``ops/voxelize.py``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from d3net_tpu_torch.kernels import build

SOURCE = "host_voxelize.cc"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """Build (first use) and bind the host library; raises RuntimeError
    (with the compiler's stderr) when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = build.build_host_library(SOURCE)
            i32p = ctypes.POINTER(ctypes.c_int32)
            try:
                lib = ctypes.CDLL(path)
                lib.d3_voxelize.restype = ctypes.c_int64
                lib.d3_voxelize.argtypes = [i32p, ctypes.c_int64, i32p, i32p]
                lib.d3_subm_table.restype = None
                lib.d3_subm_table.argtypes = [i32p, ctypes.c_int64, i32p]
                lib.d3_downsample.restype = ctypes.c_int64
                lib.d3_downsample.argtypes = [i32p, ctypes.c_int64, i32p,
                                              i32p]
                lib.d3_upsample.restype = None
                lib.d3_upsample.argtypes = [i32p, ctypes.c_int64, i32p,
                                            ctypes.c_int64, i32p]
            except (OSError, AttributeError) as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _c(coords: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(coords, dtype=np.int32)


def voxelize(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = get_lib()
    coords = _c(coords)
    n = len(coords)
    p2v = np.empty(n, np.int32)
    vc = np.empty((n, 3), np.int32)
    m = lib.d3_voxelize(_ptr(coords), n, _ptr(p2v), _ptr(vc))
    counts = np.bincount(p2v, minlength=m).astype(np.int32)
    return vc[:m].copy(), p2v, counts


def submanifold_table(coords: np.ndarray) -> np.ndarray:
    lib = get_lib()
    coords = _c(coords)
    nbr = np.empty((len(coords), 27), np.int32)
    lib.d3_subm_table(_ptr(coords), len(coords), _ptr(nbr))
    return nbr


def downsample_level(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lib = get_lib()
    coords = _c(coords)
    m = len(coords)
    coarse = np.empty((max(m, 1), 3), np.int32)
    down = np.empty((max(m, 1), 8), np.int32)
    mc = lib.d3_downsample(_ptr(coords), m, _ptr(coarse), _ptr(down))
    return coarse[:mc].copy(), down[:mc].copy()


def upsample_table(fine: np.ndarray, coarse: np.ndarray) -> np.ndarray:
    lib = get_lib()
    fine, coarse = _c(fine), _c(coarse)
    up = np.empty((len(fine), 8), np.int32)
    lib.d3_upsample(_ptr(fine), len(fine), _ptr(coarse), len(coarse), _ptr(up))
    return up
