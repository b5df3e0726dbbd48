"""The port's C++ host library (``csrc/host_voxelize.cc`` through
``ops/native.py``) on the CPU.

Its tables are byte-identical to the port's numpy plain versions
(``ops/voxelize.py`` ``*_plain``) and to the JAX package's C++ library
(``d3net_tpu.ops.native``), on scenes at three sizes down to a level of one
voxel, and through ``build_unet_maps`` level by level. The main path's
names are the library's, and a library that does not build or load raises
(no numpy fallback).

The JAX package's library (``cc/libd3net_host.so``) is built by its first
caller with ``make``; under pytest-xdist several workers may run that
``make`` at once, and one whose load lands on a library still being linked
caches ``None`` for the life of its process. The ``jax_lib`` fixture loads
it under a lock and retries until it loads with its entry points.
"""

import fcntl
import os
import tempfile
import time

import numpy as np
import pytest

from d3net_tpu.ops import native as jax_native
from d3net_tpu.ops import voxelize as jax_voxelize
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.kernels import build
from d3net_tpu_torch.ops import native, voxelize as V


def _coords(size):
    """Integer point coords of a synthetic scene (as ``build_batch`` makes
    them), or a single point."""
    if size == "one":
        return np.array([[3, -1, 7]], np.int32)
    kw = {"small": dict(num_instances=2, density=1500.0, floor_points=500,
                        room=3.0),
          "medium": dict(num_instances=8, density=2500.0, floor_points=8000,
                         room=6.0)}[size]
    xyz = make_scene(seed=3, **kw).xyz
    return np.floor((xyz - xyz.min(0)) * 50.0).astype(np.int32)


def _levels(coords):
    """Voxel coords of every stride-2 level down to a single voxel."""
    vc = V.voxelize_plain(coords)[0]
    levels = [vc]
    while len(levels[-1]) > 1:
        levels.append(V.downsample_level_plain(levels[-1])[0])
    return levels


SIZES = ("one", "small", "medium")
JAX_LIB_WAIT_S = 120.0   # long enough for another worker's make to finish


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's C++ library, loaded with ``d3_voxelize``: under an
    exclusive lock, its cached load is reset and retried until it loads or
    ``JAX_LIB_WAIT_S`` pass, which fails the test (never a skip, never numpy
    in its place)."""
    path = os.path.join(tempfile.gettempdir(), "d3net_host_library.lock")
    deadline = time.monotonic() + JAX_LIB_WAIT_S
    last = None
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                jax_native._lib, jax_native._tried = None, False
                try:
                    lib = jax_native.get_lib()
                    if lib is not None and hasattr(lib, "d3_voxelize"):
                        return jax_native
                    last = "get_lib() returned None"
                except (OSError, AttributeError) as e:
                    last = repr(e)
                if time.monotonic() > deadline:
                    pytest.fail(f"the JAX package's host library "
                                f"({jax_native._LIB_PATH}) did not load with "
                                f"d3_voxelize in {JAX_LIB_WAIT_S:.0f} s: "
                                f"{last}")
                time.sleep(0.5)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.mark.parametrize("size", SIZES)
def test_voxelize_matches_numpy_and_jax_library(size, jax_lib):
    coords = _coords(size)
    # shuffled points and negative coordinates too
    rng = np.random.default_rng(0)
    coords = coords[rng.permutation(len(coords))] - 5
    want = V.voxelize_plain(coords)
    for got in (native.voxelize(coords), jax_lib.voxelize(coords)):
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and w.shape == g.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", SIZES)
def test_level_tables_match_numpy_and_jax_library(size, jax_lib):
    levels = _levels(_coords(size))
    assert len(levels[-1]) == 1
    for fine in levels:
        nbr = V.submanifold_table_plain(fine)
        coarse, down = V.downsample_level_plain(fine)
        up = V.upsample_table_plain(fine, coarse)
        for lib in (native, jax_lib):
            got = lib.submanifold_table(fine)
            assert got.dtype == nbr.dtype
            np.testing.assert_array_equal(got, nbr)
            c2, d2 = lib.downsample_level(fine)
            np.testing.assert_array_equal(c2, coarse)
            np.testing.assert_array_equal(d2, down)
            assert c2.dtype == coarse.dtype and d2.dtype == down.dtype
            np.testing.assert_array_equal(lib.upsample_table(fine, coarse), up)


@pytest.mark.parametrize("size", SIZES)
def test_unet_maps_match_plain_and_jax(size, monkeypatch):
    coords = _coords(size)
    caps = [2048, 1024, 512, 256]
    vc = V.voxelize(coords)[0]
    got = V.build_unet_maps(vc, caps)
    want_jax = jax_voxelize.build_unet_maps(vc, caps)
    for name in ("voxelize", "submanifold_table", "downsample_level",
                 "upsample_table"):
        monkeypatch.setattr(V, name, getattr(V, f"{name}_plain"))
    want = V.build_unet_maps(vc, caps)
    for g, w, wj in zip(got, want, want_jax):
        assert g.num_voxels == w.num_voxels == wj.num_voxels
        for key in ("coords", "nbr", "down", "up"):
            a, b, c = (getattr(x, key) for x in (g, w, wj))
            if b is None:
                assert a is None and c is None
                continue
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_main_path_uses_the_library():
    assert V.voxelize is native.voxelize
    assert V.submanifold_table is native.submanifold_table
    assert V.downsample_level is native.downsample_level
    assert V.upsample_table is native.upsample_table


def _isolated_build(tmp_path, monkeypatch, source_text):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / native.SOURCE).write_text(source_text)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)


def test_a_library_that_fails_to_build_raises(tmp_path, monkeypatch):
    _isolated_build(tmp_path, monkeypatch, "this is not C++;\n")
    with pytest.raises(RuntimeError, match="failed to build host_voxelize.cc"):
        native.voxelize(np.zeros((4, 3), np.int32))
    with pytest.raises(RuntimeError):
        V.voxelize(np.zeros((4, 3), np.int32))


def test_a_library_without_its_entry_points_raises(tmp_path, monkeypatch):
    _isolated_build(tmp_path, monkeypatch, 'extern "C" int other() {return 0;}\n')
    with pytest.raises(RuntimeError, match="d3_voxelize"):
        native.get_lib()


def test_no_compiler_raises(tmp_path, monkeypatch):
    _isolated_build(tmp_path, monkeypatch, "int x;\n")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.get_lib()


def test_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    src = open(f"{build.CSRC}/{native.SOURCE}").read()
    _isolated_build(tmp_path, monkeypatch, src)
    first = build.build_host_library(native.SOURCE)
    assert build.build_host_library(native.SOURCE) == first
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ("-g",))
    assert build.build_host_library(native.SOURCE) != first
