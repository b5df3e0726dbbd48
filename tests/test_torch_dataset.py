"""The port's input pipeline (``d3net_tpu_torch/data/dataset.py`` and
``utils/transform.py``) against d3net_tpu's on the CPU.

``BatchIterator`` batches are byte-identical to the JAX iterator's, every
array and every level table, with shuffle, augmentation (jitter, flip,
rotation, elastic), the random crop and the C++ host library on the port's
side, for one worker (the prefetch thread), three workers (the thread
pool) and no prefetch, over two epochs. Augmented scenes and their boxes
equal the JAX package's, and so do ``crop_scene``, ``NpzScenes`` and the
run loop's loaders.
"""

import numpy as np
import pytest

from d3net_tpu.data import collate as jcollate
from d3net_tpu.data import dataset as jds
from d3net_tpu.data.synthetic import make_scene as jax_make_scene
from d3net_tpu_torch.data import collate as tcollate
from d3net_tpu_torch.data import dataset as tds
from d3net_tpu_torch.data.synthetic import make_scene

SCENE = dict(num_instances=3, points_per_instance=600, floor_points=1000,
             room=4.0)
# max_points below a scene's point count, so augmented scenes are cropped
SPEC = dict(max_points=2500, voxel_caps=[2560, 1280, 640], max_instances=8,
            use_multiview=False, use_normal=True)


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.fixture(scope="module")
def scenes():
    return [make_scene(seed=i, **SCENE) for i in range(5)]


@pytest.mark.parametrize("workers,prefetch", [(1, 2), (3, 2), (1, 0)])
def test_batches_equal_jax_over_two_epochs(scenes, workers, prefetch):
    kw = dict(shuffle=True, augment=True, elastic=True, seed=7,
              workers=workers, prefetch=prefetch, return_scenes=True)
    got_it = tds.BatchIterator(scenes, tcollate.BatchSpec(**SPEC), 2, **kw)
    want_it = jds.BatchIterator(scenes, jcollate.BatchSpec(**SPEC), 2, **kw)
    cropped = 0
    for epoch in range(2):
        got, want = list(got_it), list(want_it)
        assert len(got) == len(want) == 2
        for (gb, gs), (wb, ws) in zip(got, want):
            _assert_same(gb, wb, f"epoch {epoch}")
            for g, w in zip(gs, ws):
                _assert_same(g.instance_bboxes, w.instance_bboxes, "boxes")
                cropped += len(g.xyz) < len(scenes[0].xyz)
    assert got_it.epoch == want_it.epoch == 2
    assert cropped > 0


def test_stopping_early_skips_the_queued_builds(scenes, monkeypatch):
    """A consumer that stops after batch 0 (a run's last step) waits for
    the two builds under way and cancels the queued one."""
    import threading

    it = tds.BatchIterator(scenes * 4, tcollate.BatchSpec(**SPEC), 2,
                           shuffle=False, augment=False, workers=2,
                           prefetch=2)
    built, release, real = [], threading.Event(), it._build_one

    def build(order, b):
        if b:
            release.wait(10)
        built.append(b)
        return real(order, b)

    monkeypatch.setattr(it, "_build_one", build)
    batches = iter(it)
    next(batches)
    threading.Timer(0.2, release.set).start()
    batches.close()
    assert sorted(built) == [0, 1, 2]


def test_val_iterator_keeps_the_last_partial_batch(scenes):
    kw = dict(shuffle=False, augment=False, seed=0, drop_last=False,
              workers=3)
    got = list(tds.BatchIterator(scenes, tcollate.BatchSpec(**SPEC), 2, **kw))
    want = list(jds.BatchIterator(scenes, jcollate.BatchSpec(**SPEC), 2, **kw))
    assert len(got) == len(want) == 3
    _assert_same(got, want)


def test_scene_transforms_equal_jax(scenes):
    s = scenes[1]
    assert len(s.instance_bboxes)
    for elastic in (False, True):
        got = tds.augment_scene(s, np.random.default_rng(3), elastic=elastic)
        want = jds.augment_scene(s, np.random.default_rng(3), elastic=elastic)
        for name in ("xyz", "normal", "instance_bboxes"):
            _assert_same(getattr(got, name), getattr(want, name), name)
        # the box center rides the linear map; the warp moves points only
        assert not np.array_equal(got.instance_bboxes, s.instance_bboxes)
    got = tds.crop_scene(s, 1500, 50.0, 512.0, np.random.default_rng(4))
    want = jds.crop_scene(s, 1500, 50.0, 512.0, np.random.default_rng(4))
    assert len(got.xyz) <= 1500 < len(s.xyz)
    for name in ("xyz", "rgb", "normal", "sem_labels", "instance_ids"):
        _assert_same(getattr(got, name), getattr(want, name), name)


def test_npz_scenes_equal_jax(scenes, tmp_path):
    s = jax_make_scene(seed=1, **SCENE)
    path = str(tmp_path / "scene0000_00.npz")
    np.savez(path, xyz=s.xyz, rgb=s.rgb, normal=s.normal,
             sem_labels=s.sem_labels, instance_ids=s.instance_ids,
             instance_bboxes=s.instance_bboxes, scene_id="scene0000_00")
    got, want = tds.NpzScenes([path])[0], jds.NpzScenes([path])[0]
    assert got.scene_id == want.scene_id == "scene0000_00"
    assert got.multiview is None and want.multiview is None
    for name in ("xyz", "rgb", "normal", "sem_labels", "instance_ids",
                 "instance_bboxes"):
        _assert_same(getattr(got, name), getattr(want, name), name)
    _assert_same(got.xyz, scenes[1].xyz)


def test_loop_loaders_equal_jax(monkeypatch):
    from d3net_tpu import config as jcfg
    from d3net_tpu.train import loop as jloop
    from d3net_tpu_torch import config as tcfg
    from d3net_tpu_torch.train import loop as tloop

    monkeypatch.setenv("D3NET_VAL_SCENES", "3")
    path = "conf/debug/tiny_pointgroup.yaml"
    tc, jc = tcfg.load(path), jcfg.load(path)
    for c in (tc, jc):
        c.data.elastic = True
        c.data.num_workers = 2
    got = tloop.make_dataloaders(tc, tloop.spec_from_cfg(tc))
    want = jloop.make_dataloaders(jc, jloop.spec_from_cfg(jc))
    assert [len(i) for i in got] == [len(i) for i in want] == [4, 2]
    for g, w in zip(got, want):
        assert (g.shuffle, g.augment, g.elastic, g.seed, g.workers) == (
            w.shuffle, w.augment, w.elastic, w.seed, w.workers)
        _assert_same(next(iter(g)), next(iter(w)))
