"""Port host path vs d3net_tpu: synthetic scenes and gather-mode batches
must be byte-identical (integers and floats alike); a batch collated a row
at a time, in any order or from several threads, equals ``build_batch``."""

import sys
import threading

import numpy as np
import pytest

from d3net_tpu.data import collate as jcollate
from d3net_tpu.data.synthetic import make_scene as jax_make_scene
from d3net_tpu.ops import voxelize as jvox
from d3net_tpu_torch.data import collate
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.ops import voxelize

SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
             floor_points=1000, room=4.0)
SPEC = dict(max_points=3072, voxel_caps=[3072, 1536, 768], max_instances=8,
            use_multiview=False, use_normal=True)


def _assert_same(a, b, what):
    assert a.dtype == b.dtype, what
    assert a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("seed", [0, 1])
def test_make_scene_identical(seed):
    kw = dict(SCENE, with_multiview=True)
    a, b = make_scene(seed=seed, **kw), jax_make_scene(seed=seed, **kw)
    for f in ("xyz", "rgb", "normal", "multiview", "sem_labels",
              "instance_ids", "instance_bboxes"):
        _assert_same(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("max_points,caps", [
    (3072, [3072, 1536, 768]),          # truncated: points and voxels capped
    (16384, [16384, 8192, 4096, 2048]),  # every point and voxel fits
])
def test_build_batch_byte_identical(max_points, caps):
    spec_kw = dict(SPEC, max_points=max_points, voxel_caps=caps)
    scenes = [make_scene(seed=i, **SCENE) for i in range(2)]
    jcollate.CAP_STATS.reset()
    collate.CAP_STATS.reset()
    got = collate.build_batch(scenes, collate.BatchSpec(**spec_kw))
    want = jcollate.build_batch(scenes, jcollate.BatchSpec(**spec_kw))
    assert jcollate.CAP_STATS.snapshot()["cap_dropped_phantoms"] == 0
    assert collate.CAP_STATS.snapshot() == jcollate.CAP_STATS.snapshot()
    assert set(got) == set(want)
    for k in want:
        if k == "tables":
            assert len(got[k]) == len(want[k]) == len(caps)
            for li, (tg, tw) in enumerate(zip(got[k], want[k])):
                assert set(tg) == set(tw), li
                for kk in tw:
                    _assert_same(tg[kk], tw[kk], f"level {li} {kk}")
        else:
            _assert_same(got[k], want[k], k)


def _assert_tree_same(a, b, what=""):
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _assert_tree_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_same(x, y, f"{what}[{i}]")
    else:
        _assert_same(a, b, what)


@pytest.mark.parametrize("order", ["forward", "reversed", "threads"])
def test_rows_in_any_order_equal_build_batch(order):
    """``new_batch`` then ``collate_scene`` a row at a time gives
    ``build_batch``'s bytes and counters, whatever order the rows come in;
    scene 0 overflows the first level's cap (7,591 voxels over 7,500)."""
    spec = collate.BatchSpec(**dict(SPEC, max_points=12288,
                                    voxel_caps=[7500, 4096, 2048]))
    scenes = [make_scene(seed=i, **SCENE) for i in range(3)]
    collate.CAP_STATS.reset()
    want = collate.build_batch(scenes, spec)
    want_stats = collate.CAP_STATS.reset()
    assert want_stats["cap_voxel_overflow"] > 0
    assert want["tables"][0]["mask"].sum(1).tolist() == [7500, 6091, 7424]

    out = collate.new_batch(len(scenes), spec)
    rows = list(range(len(scenes)))
    if order == "threads":
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            pool = [threading.Thread(target=collate.collate_scene,
                                     args=(scenes[r], spec, out, r))
                    for r in rows]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
        finally:
            sys.setswitchinterval(old)
    else:
        for r in (rows if order == "forward" else rows[::-1]):
            collate.collate_scene(scenes[r], spec, out, r)
    assert collate.CAP_STATS.reset() == want_stats
    _assert_tree_same(out, want)


def test_voxelize_tables_match_numpy_path():
    rng = np.random.default_rng(3)
    coords = rng.integers(0, 12, size=(600, 3)).astype(np.int32)
    vc, p2v, counts = voxelize.voxelize(coords)
    jvc, jp2v, jcounts = jvox.voxelize(coords)
    for a, b in ((vc, jvc), (p2v, jp2v), (counts, jcounts)):
        _assert_same(a, b, "voxelize")
    _assert_same(voxelize.submanifold_table(vc), jvox.submanifold_table(vc),
                 "nbr")
    coarse, down = voxelize.downsample_level(vc)
    jcoarse, jdown = jvox.downsample_level(vc)
    _assert_same(coarse, jcoarse, "coarse")
    _assert_same(down, jdown, "down")
    _assert_same(voxelize.upsample_table(vc, coarse),
                 jvox.upsample_table(vc, jcoarse), "up")
    # tap order: (1+ox)*9 + (1+oy)*3 + (1+oz); tap 13 is the centre
    offs = voxelize._offsets(3)
    assert tuple(offs[13]) == (0, 0, 0)
    assert tuple(offs[1 * 9 + 2 * 3 + 0]) == (0, 1, -1)


def test_other_conv_impls_raise():
    spec = collate.BatchSpec(**SPEC, conv_impl="colres")
    with pytest.raises(NotImplementedError, match="colres"):
        collate.build_batch([make_scene(seed=0, **SCENE)], spec)
