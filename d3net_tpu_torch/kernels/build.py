"""Build a source of ``csrc/`` into a shared library and load it.

Each source has a plain C interface and is bound with ``ctypes``: a CUDA
kernel source (``*.cu``) is built by ``nvcc`` for sm_90a, the host library
(``host_voxelize.cc``) by ``g++``, each in seconds, with no PyTorch
headers. The library goes into ``d3net_tpu_torch/build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source and the flags,
so an edited source is rebuilt and a stale one is never loaded. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# cc/Makefile's flags without -march=native: the build directory may be
# shared between hosts, and the integer tables do not depend on the flag
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH (needed for the host "
                           "library csrc/host_voxelize.cc)")
    return found


def _compile(source: str, compiler: str, flags: Sequence[str]) -> str:
    """Compile ``csrc/<source>`` unless this exact source was built with
    these flags already; returns the ``.so`` path. Raises RuntimeError
    carrying the compiler's stderr when the build fails."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [compiler, *flags, "-o", tmp, os.path.join(CSRC, source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed to build {source} "
                f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_library(source: str) -> str:
    """nvcc for sm_90a: the ``.so`` path of CUDA source ``csrc/<source>``."""
    return _compile(source, nvcc_path(), NVCC_FLAGS)


def load_library(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(source))


def build_host_library(source: str) -> str:
    """g++: the ``.so`` path of host source ``csrc/<source>``."""
    return _compile(source, gxx_path(), HOST_FLAGS)
