"""Port host path vs d3net_tpu: synthetic scenes and gather-mode batches
must be byte-identical (integers and floats alike)."""

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
