"""The port's input pipeline (``d3net_tpu_torch/data/dataset.py`` and
``utils/transform.py``) against d3net_tpu's on the CPU.

``BatchIterator`` batches are byte-identical to the JAX iterator's, every
array and every level table, with shuffle, augmentation (jitter, flip,
rotation, elastic), the random crop and the C++ host library on the port's
side, for one worker (the prefetch thread), three, four and eight workers
(a batch's rows collated on the loader threads) and no prefetch, over two
epochs, and each rank's rows equal the serial build's. Augmented scenes
and their boxes equal the JAX package's, and so do ``crop_scene``,
``NpzScenes`` and the run loop's loaders. With rows that take time, the
loader threads hand the first batch over before the last is collated,
spread each batch over several threads, never deadlock when the consumer
stops early, and pass a row's error on.
"""

import threading
import time
from dataclasses import replace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from d3net_tpu.data import collate as jcollate
from d3net_tpu.data import dataset as jds
from d3net_tpu.data.synthetic import make_scene as jax_make_scene
from d3net_tpu_torch.data import collate as tcollate
from d3net_tpu_torch import trace
from d3net_tpu_torch.data import dataset as tds
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.parallel import mesh

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


@pytest.mark.parametrize("workers,prefetch",
                         [(1, 2), (3, 2), (1, 0), (8, 2), (4, 0)])
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


def _within(seconds, fn):
    """``fn()`` on a thread of its own; fails the test if it has not
    returned within ``seconds`` (a deadlock), else returns its value or
    raises its error."""
    got = {}

    def run():
        try:
            got["value"] = fn()
        except BaseException as e:     # re-raised below
            got["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"not done within {seconds} s"
    if "error" in got:
        raise got["error"]
    return got["value"]


def _distinct(scenes, n):
    """``n`` scene objects (copies of ``scenes`` in turn), each its own
    object, so a row tells its scene's index."""
    return [replace(scenes[i % len(scenes)]) for i in range(n)]


def _timed_rows(monkeypatch, scenes, delay, fail=None):
    """``collate_scene`` as the loader calls it, made to take ``delay`` s a
    row; logs (scene index, thread, end time) and raises on scene
    ``fail``."""
    log, lock, real = [], threading.Lock(), tds.collate_scene
    index = {id(s): i for i, s in enumerate(scenes)}

    def collate(scene, spec, out, row):
        i = index[id(scene)]
        if i == fail:
            raise ValueError(f"scene {i}")
        time.sleep(delay)
        real(scene, spec, out, row)
        with lock:
            log.append((i, threading.get_ident(), time.perf_counter()))

    monkeypatch.setattr(tds, "collate_scene", collate)
    return log


def _serial(scenes, batch_size, **kw):
    return list(tds.BatchIterator(scenes, tcollate.BatchSpec(**SPEC),
                                  batch_size, workers=1, prefetch=0, **kw))


def test_stopping_early_skips_the_queued_builds(scenes, monkeypatch):
    """A consumer that stops after batch 0 (a run's last step) waits for
    the rows under way (at most one a thread: each holds until 0.2 s
    after the close) and drops the queued ones."""
    many = _distinct(scenes, 20)
    index = {id(s): i for i, s in enumerate(many)}
    started, finished, release = [], [], threading.Event()
    real = tds.collate_scene

    def collate(scene, spec, out, row):
        i = index[id(scene)]
        started.append(i)
        if i >= 2:
            release.wait(10)
        real(scene, spec, out, row)
        finished.append(i)

    monkeypatch.setattr(tds, "collate_scene", collate)
    it = tds.BatchIterator(many, tcollate.BatchSpec(**SPEC), 2,
                           shuffle=False, augment=False, workers=2,
                           prefetch=2)
    batches = iter(it)
    next(batches)
    threading.Timer(0.2, release.set).start()
    batches.close()
    assert {0, 1} <= set(started) and len(started) <= 2 + 2
    assert sorted(finished) == sorted(started)


def test_first_batch_is_handed_over_before_the_last_is_collated(
        scenes, monkeypatch):
    """Four workers, four batches of four rows at 0.2 s a row: batch 0's
    rows go first (a thread whose later draw ended first may take a later
    row), so it is handed over before a third round of rows is done (a
    batch a thread would have done 13 rows by then) and before batch 3 is
    collated; the batches equal the serial build's."""
    many = _distinct(scenes, 16)
    want = _serial(many, 4, shuffle=False, augment=False)
    log = _timed_rows(monkeypatch, many, 0.2)
    it = tds.BatchIterator(many, tcollate.BatchSpec(**SPEC), 4,
                           shuffle=False, augment=False, workers=4)

    def consume():
        batches = iter(it)
        first = next(batches)
        done_then = {i for i, _, _ in list(log)}
        return [first, *batches], done_then

    got, done_then = _within(60, consume)
    assert set(range(4)) <= done_then and len(done_then) < 12
    assert not set(range(12, 16)) <= done_then
    _assert_same(got, want)


@pytest.mark.parametrize("workers", [1, 4])
def test_collate_threads_counts_each_batchs_threads(scenes, monkeypatch,
                                                    workers):
    """Traced, each batch's ``data.collate`` span holds ``collate_threads``:
    1 on the serial path, more than 1 where its rows spread over the
    loader threads; a ``data.collate.scene`` span a row lies inside its
    batch's."""
    many = _distinct(scenes, 16)
    _timed_rows(monkeypatch, many, 0.1)
    it = tds.BatchIterator(many, tcollate.BatchSpec(**SPEC), 4,
                           shuffle=False, augment=False, workers=workers)
    with profile(activities=[ProfilerActivity.CPU]):
        _within(60, lambda: list(it))
    w = trace.last_window()
    batches = {s.id: s for s in w.named("data.collate")}
    assert sorted(batches) == [(0, b) for b in range(4)]
    n = [batches[(0, b)].counts["collate_threads"] for b in range(4)]
    assert n == [1] * 4 if workers == 1 else all(k > 1 for k in n), n
    assert w.counts["collate_threads"] == sum(n)
    rows = w.named("data.collate.scene")
    assert len(rows) == 16
    for s in rows:
        top = batches[s.id]
        assert s.parent is top and top.t0 <= s.t0 <= s.t1 <= top.t1


def test_a_consumer_that_stops_after_the_first_batch_returns(
        scenes, monkeypatch):
    """Two workers, no prefetch: taking batch 0 and closing returns, with
    batch 0 whole."""
    many = _distinct(scenes, 16)
    want = _serial(many[:4], 4, shuffle=False, augment=False)
    _timed_rows(monkeypatch, many, 0.02)
    it = tds.BatchIterator(many, tcollate.BatchSpec(**SPEC), 4,
                           shuffle=False, augment=False, workers=2,
                           prefetch=0)

    def first():
        batches = iter(it)
        got = next(batches)
        batches.close()
        return got

    _assert_same(_within(60, first), want[0])


@pytest.mark.parametrize("workers", [1, 4])
def test_a_row_that_raises_reaches_the_consumer(scenes, monkeypatch,
                                                workers):
    many = _distinct(scenes, 16)
    _timed_rows(monkeypatch, many, 0.01, fail=9)    # batch 2, row 1
    it = tds.BatchIterator(many, tcollate.BatchSpec(**SPEC), 4,
                           shuffle=False, augment=False, workers=workers)

    def consume():
        got = []
        with pytest.raises(ValueError, match="scene 9"):
            for b in it:
                got.append(b)
        return got

    assert len(_within(60, consume)) == 2


def test_rank_rows_equal_the_serial_build(scenes):
    """Two ranks, three workers each: a rank's rows of each batch equal the
    serial world-1 build's, and a short last batch is rank 0's alone."""
    kw = dict(shuffle=True, augment=True, elastic=True, seed=5,
              drop_last=False, return_scenes=True)
    whole = _serial(scenes, 4, **kw)
    assert len(whole) == 2
    for r in range(2):
        it = tds.BatchIterator(scenes, tcollate.BatchSpec(**SPEC), 4,
                               workers=3, rank=r, world=2, **kw)
        got = list(it)
        assert len(got) == 2
        for b, ((gb, gs), (wb, ws)) in enumerate(zip(got, whole)):
            for g, w in zip(gs, ws):
                _assert_same(g.xyz, w.xyz, "scenes")
            if it.splits(b):
                _assert_same(gb, mesh.shard_batch(wb, r, 2), f"rank {r}")
            elif r == 0:
                _assert_same(gb, wb, "short batch")
            else:
                assert gb is None


def test_cap_stats_equal_for_one_and_eight_workers(scenes):
    """The truncation counters of an epoch do not depend on the workers
    (points and voxels past the caps of a tighter spec)."""
    spec = tcollate.BatchSpec(**dict(SPEC, max_points=2000,
                                     voxel_caps=[1024, 512, 256]))
    totals = []
    for workers in (1, 8):
        tcollate.CAP_STATS.reset()
        list(tds.BatchIterator(scenes, spec, 2, shuffle=True, augment=False,
                               seed=7, workers=workers))
        totals.append(tcollate.CAP_STATS.reset())
    assert totals[0] == totals[1]
    assert totals[0]["batches"] == 2
    assert totals[0]["cap_points_truncated"] == 4 * 800
    assert totals[0]["cap_voxel_overflow"] > 0


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
