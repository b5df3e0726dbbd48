"""Scene datasets and the host-side batch iterator (the input pipeline).

Counterpart of ``d3net_tpu/data/dataset.py``: sources provide scenes, the
iterator applies augmentation (jitter/flip/rotz/elastic and the box
transform), crops, assembles static-shape batches with
:mod:`d3net_tpu_torch.data.collate` and builds them ahead of the consumer:
one prefetch thread, or ``workers`` threads (the hot collate work, numpy
and the C++ host library, releases the GIL). Each batch draws from its own
generator seeded by ``(seed, epoch, batch)``, so batches do not depend on
the worker count and equal the JAX package's byte for byte.

Multiview features come from the scene source (the synthetic scenes' noise,
an npz's own ``multiview``) or from a feature store
(:mod:`d3net_tpu_torch.data.multiview`, in place of JAX's HDF5) through
``MultiviewAttached`` or ``NpzScenes(multiview_store=)``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import replace
from typing import Iterator, Optional, Sequence

import numpy as np

from d3net_tpu_torch import trace
from d3net_tpu_torch.data.collate import BatchSpec, build_batch
from d3net_tpu_torch.data.multiview import (
    open_multiview_store, read_multiview_store,
)
from d3net_tpu_torch.data.synthetic import Scene, make_scene
from d3net_tpu_torch.parallel.mesh import split_rows
from d3net_tpu_torch.utils import transform as T


class SyntheticScenes:
    """Deterministic synthetic scene list (no ScanNet on disk)."""

    def __init__(self, num_scenes: int = 64, split: str = "train", **scene_kw):
        base = 0 if split == "train" else 10_000
        self.scenes = [make_scene(seed=base + i, **scene_kw)
                       for i in range(num_scenes)]

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i) -> Scene:
        return self.scenes[i]


class NpzScenes:
    """ScanNet scenes preprocessed by ``scripts/prepare_scannet.py`` (one
    npz file each). ``multiview_store`` (a ``data.multiview_hdf5`` value:
    the store, or the HDF5 path it stands for) attaches per-point ENet
    features by scene id, in place of the npz's own ``multiview``."""

    def __init__(self, paths: Sequence[str],
                 multiview_store: Optional[str] = None):
        self.paths = list(paths)
        self.multiview_store = (open_multiview_store(multiview_store)
                                if multiview_store else None)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> Scene:
        d = np.load(self.paths[i], allow_pickle=False)
        scene_id = str(d.get("scene_id", "scan"))
        mv = d["multiview"] if "multiview" in d else None
        if self.multiview_store:
            mv = read_multiview_store(self.multiview_store, scene_id)
        return Scene(
            xyz=d["xyz"],
            rgb=d["rgb"],
            normal=d["normal"],
            multiview=mv,
            sem_labels=d["sem_labels"],
            instance_ids=d["instance_ids"],
            instance_bboxes=d["instance_bboxes"],
            scene_id=scene_id,
        )


class MultiviewAttached:
    """Wrap any scene source, swapping in a feature store's multiview
    features by scene id (``scripts/compute_multiview_features.py``'s
    output). ``store`` is a ``data.multiview_hdf5`` value."""

    def __init__(self, scenes, store: str):
        self.scenes = scenes
        self.store = open_multiview_store(store)

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i) -> Scene:
        s = self.scenes[i]
        mv = read_multiview_store(self.store, s.scene_id)
        if len(mv) != len(s.xyz):
            raise ValueError(
                f"{s.scene_id}: {len(mv)} feature rows in {self.store} for "
                f"{len(s.xyz)} points (a store of other scenes)")
        return replace(s, multiview=mv)


def augment_scene(scene: Scene, rng: np.random.Generator, *, jitter=True,
                  flip=True, rot=True, elastic=False, scale=50.0) -> Scene:
    m = np.eye(3)
    if jitter:
        m = m @ T.jitter_matrix(rng)
    if flip:
        m = m @ T.flip_matrix(rng, 0, random=True)
    if rot:
        m = m @ T.random_rotz_matrix(rng)
    xyz = (scene.xyz @ m.T).astype(np.float32)
    if elastic:
        s = xyz * scale
        s = T.elastic(s, 6 * 1, 40 * 0.1, rng)
        s = T.elastic(s, 20 * 1, 160 * 0.4, rng)
        xyz = (s / scale).astype(np.float32)
    normal = (scene.normal @ np.linalg.inv(m).T).astype(np.float32)
    bboxes = scene.instance_bboxes
    if bboxes is not None and len(bboxes):
        # boxes ride the same linear map: the center maps exactly, the AABB
        # of a linearly mapped box has extents |m| @ d (the elastic warp
        # after it is not applied to boxes)
        bboxes = bboxes.copy()
        bboxes[:, :3] = (bboxes[:, :3] @ m.T).astype(np.float32)
        bboxes[:, 3:6] = (bboxes[:, 3:6] @ np.abs(m).T).astype(np.float32)
    return replace(scene, xyz=xyz, normal=normal, instance_bboxes=bboxes)


def subset_scene(scene: Scene, keep: np.ndarray) -> Scene:
    """Point-wise subset of a scene (boolean mask or index array)."""
    return replace(
        scene,
        xyz=scene.xyz[keep],
        rgb=scene.rgb[keep] if scene.rgb is not None else None,
        normal=scene.normal[keep] if scene.normal is not None else None,
        multiview=scene.multiview[keep] if scene.multiview is not None else None,
        sem_labels=scene.sem_labels[keep],
        instance_ids=scene.instance_ids[keep],
    )


def crop_scene(scene: Scene, max_points: int, scale: float, full_scale: float,
               rng: np.random.Generator) -> Scene:
    """Random spatial crop to at most ``max_points`` points: a window of
    scaled coords at a random offset, shrunk until the points fit."""
    scaled = (scene.xyz - scene.xyz.min(0)) * scale
    _, keep = T.crop(scaled, max_points, full_scale, rng)
    if keep.all():
        return scene
    return subset_scene(scene, keep)


class BatchIterator:
    """Shuffled, augmented, prefetched static-shape batches (numpy)."""

    def __init__(
        self,
        scenes,
        spec: BatchSpec,
        batch_size: int,
        *,
        shuffle: bool = True,
        augment: bool = True,
        elastic: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        workers: int = 1,
        drop_last: bool = True,
        return_scenes: bool = False,
        rank: int = 0,
        world: int = 1,
    ):
        self.scenes = scenes
        self.spec = spec
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.elastic = elastic
        self.seed = seed
        self.prefetch = prefetch
        self.workers = max(1, int(workers))
        self.drop_last = drop_last
        self.return_scenes = return_scenes
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{world} ranks")
        self.rank, self.world = rank, world
        self.epoch = 0

    def __len__(self):
        n = len(self.scenes)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def splits(self, b: int) -> bool:
        """Whether the ranks split batch ``b`` of the epoch: its scenes are
        a multiple of ``world`` (always at world 1; only a short last batch
        can fail it)."""
        rows = min(self.batch_size, len(self.scenes) - b * self.batch_size)
        return rows % self.world == 0

    def _build_one(self, order: np.ndarray, b: int):
        """Batch ``b`` of the epoch, from its own generator (so builds in any
        order and on any worker give the same batch).

        With ``world`` ranks, rank ``r`` collates its rows of the batch
        (``mesh.split_rows``: ``[r·b/N, (r+1)·b/N)``, or the whole of a
        short last batch on rank 0 and None on the others), after
        augmenting every scene of the batch in order (one generator runs
        through them, so the rows equal the global batch's);
        ``return_scenes`` gives every scene of the global batch, over which
        the description rows are drawn. Its ``data.collate`` span has the
        id ``(epoch, b)``."""
        with trace.span("data.collate", id=(self.epoch, b)):
            return self._build(order, b)

    def _build(self, order: np.ndarray, b: int):
        rng = np.random.default_rng(
            (self.seed + 1) * 1_000_003 + self.epoch * 131_071 + b
        )
        idx = order[b * self.batch_size:(b + 1) * self.batch_size]
        scenes = []
        for i in idx:
            s = self.scenes[int(i)]
            if self.augment:
                s = augment_scene(s, rng, elastic=self.elastic,
                                  scale=self.spec.scale)
                if len(s.xyz) > self.spec.max_points:
                    s = crop_scene(s, self.spec.max_points, self.spec.scale,
                                   self.spec.full_scale, rng)
            scenes.append(s)
        lo, hi = split_rows(len(scenes), self.rank, self.world)
        batch = build_batch(scenes[lo:hi], self.spec) if hi > lo else None
        return (batch, scenes) if self.return_scenes else batch

    def _order(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.epoch)
        order = np.arange(len(self.scenes))
        if self.shuffle:
            rng.shuffle(order)
        return order

    def _epoch_batches(self) -> Iterator[dict]:
        order = self._order()
        for b in range(len(self)):
            yield self._build_one(order, b)

    def _epoch_batches_parallel(self) -> Iterator[dict]:
        """``workers`` threads, ``workers + prefetch`` batches in flight,
        yielded in batch order. A consumer that stops early (a run's last
        step) waits for the builds under way, not for the queued ones."""
        from concurrent.futures import ThreadPoolExecutor

        order = self._order()
        nb = len(self)
        inflight = self.workers + max(1, self.prefetch)
        ex = ThreadPoolExecutor(max_workers=self.workers)
        try:
            futs = {b: ex.submit(self._build_one, order, b)
                    for b in range(min(inflight, nb))}
            nxt = len(futs)
            for b in range(nb):
                yield futs.pop(b).result()
                if nxt < nb:
                    futs[nxt] = ex.submit(self._build_one, order, nxt)
                    nxt += 1
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> Iterator[dict]:
        """The epoch's batches in order; each is handed over with its id
        ``(epoch, b)`` given to the consumer's open spans (``trace.tag``)."""
        epoch, batches = self.epoch, self._batches()
        try:
            for b, item in enumerate(batches):
                trace.tag((epoch, b))
                yield item
        finally:
            batches.close()
        self.epoch += 1

    def _batches(self) -> Iterator[dict]:
        if self.workers > 1:
            yield from self._epoch_batches_parallel()
        elif self.prefetch <= 0:
            yield from self._epoch_batches()
        else:
            q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
            done = object()
            failed = []

            def worker():
                try:
                    for item in self._epoch_batches():
                        q.put(item)
                except BaseException as e:   # re-raised by the consumer
                    failed.append(e)
                finally:
                    q.put(done)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is done:
                    if failed:
                        raise failed[0]
                    break
                yield item
