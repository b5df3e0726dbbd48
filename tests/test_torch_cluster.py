"""Clustering against d3net_tpu: roots bit-identical, compact_clusters
members/masks identical including the tie order of top_k."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.ops import cluster as jcluster
from d3net_tpu_torch.ops import cluster

CELL = 0.015


def _blob_scene(rng, m, n_blobs=5):
    """Points in distinct 1.5cm cells (so no two share a sort key), grouped
    in blobs; labels in {0..3}, ~10% invalid. Point 0 is a valid anchor on
    a cell corner below all others, so it is the origin and every point's
    cell is its generating cell."""
    centres = rng.integers(10, 200, size=(n_blobs, 3))
    cells = set()
    while len(cells) < m - 1:
        c = centres[rng.integers(n_blobs)] + rng.integers(-6, 7, size=3)
        cells.add(tuple(int(v) for v in c))
    cells = np.array(sorted(cells))[rng.permutation(m - 1)]
    frac = rng.uniform(0.1, 0.9, size=(m - 1, 3))
    cells = np.concatenate([cells.min(0, keepdims=True) - 2, cells])
    frac = np.concatenate([np.zeros((1, 3)), frac])
    coords = (cells + frac) * CELL
    blob = np.argmin(((cells[:, None] - centres[None]) ** 2).sum(-1), axis=1)
    sem = (blob % 4).astype(np.int32)
    valid = rng.random(m) > 0.1
    valid[0] = True
    return coords, sem, valid


def _fixture(seed, b=2, m=700):
    rng = np.random.default_rng(seed)
    scenes = [_blob_scene(rng, m) for _ in range(b)]
    coords = np.stack([s[0] for s in scenes])
    sem = np.stack([s[1] for s in scenes])
    valid = np.stack([s[2] for s in scenes])
    # dual pass: the second half is the scene moved 400 cells along x (its
    # own cells, no key ties with the first) with the pass bit folded in
    coords = np.concatenate([coords, coords + [400 * CELL, 0.0, 0.0]], axis=1)
    sem = np.concatenate([sem, sem + 32], axis=1)
    valid = np.concatenate([valid, valid], axis=1)
    return coords.astype(np.float32), sem, valid


def _sort_keys(coords, sem, valid):
    """The two (khi, klo) sort keys per point, as the op builds them."""
    b, m, _ = coords.shape
    c = torch.from_numpy(coords)
    origin = torch.where(torch.from_numpy(valid)[..., None], c,
                         torch.tensor(float("inf"))).amin(1, keepdim=True)
    cell = torch.floor((c - origin) / CELL).to(torch.int32).clamp(0, 1023)
    cell = cell.reshape(b * m, 3)
    scene = np.repeat(np.arange(b), m)
    khi = scene * 128 + np.where(valid.reshape(-1), sem.reshape(-1), 127)
    return [(khi, cluster.morton_code(cell).numpy()),
            (khi, cluster._morton_code_curve2(cell).numpy())]


@pytest.mark.parametrize("seed,iters", [(0, 8), (1, 3)])
def test_grid_cluster_roots_bit_identical(seed, iters):
    coords, sem, valid = _fixture(seed)
    for khi, klo in _sort_keys(coords, sem, valid):
        keys = khi.astype(np.int64) << 30 | klo.astype(np.int64)
        assert len(np.unique(keys)) == len(keys), "fixture has sort-key ties"
    kw = dict(cell_size=CELL, num_iters=iters, radius=0.03)
    want = np.asarray(jcluster.grid_cluster_batched(
        jnp.asarray(coords), jnp.asarray(sem), jnp.asarray(valid), **kw))
    got = cluster.grid_cluster_batched(
        torch.from_numpy(coords), torch.from_numpy(sem),
        torch.from_numpy(valid), **kw).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the fixture really clusters: several multi-point components per scene
    roots = got[0][got[0] >= 0]
    assert (np.bincount(roots) > 10).sum() >= 3


def test_xla_cpu_two_key_sort_keeps_index_order_on_ties():
    """The whole-detector parity relies on XLA's CPU sort giving ties in
    index order (as torch's stable sort does): pin it."""
    rng = np.random.default_rng(0)
    n = 20000
    khi = rng.integers(0, 5, n).astype(np.int32)
    klo = rng.integers(0, 40, n).astype(np.int32)
    idx = np.arange(n, dtype=np.int32)
    _, _, perm = jax.lax.sort(
        (jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(idx)), num_keys=2)
    key = torch.from_numpy(khi.astype(np.int64) << 30 | klo.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(perm), torch.sort(key, stable=True).indices.numpy())


def test_morton_codes_match():
    rng = np.random.default_rng(4)
    cell = rng.integers(0, 1024, size=(500, 3)).astype(np.int32)
    t = torch.from_numpy(cell)
    np.testing.assert_array_equal(cluster.morton_code(t).numpy(),
                                  np.asarray(jcluster.morton_code(jnp.asarray(cell))))
    np.testing.assert_array_equal(
        cluster._morton_code_curve2(t).numpy(),
        np.asarray(jcluster._morton_code_curve2(jnp.asarray(cell))))


def test_compact_clusters_identical_with_ties():
    """Equal-size clusters everywhere: slots must follow top_k's
    lower-index-first order exactly."""
    rng = np.random.default_rng(5)
    m, k = 400, 6
    problems = []
    for _ in range(4):
        roots = np.sort(rng.choice(m, size=20, replace=False))
        root = roots[rng.integers(0, 20, size=m)].astype(np.int32)
        root[roots] = roots                       # a root is its own root
        root[rng.random(m) < 0.1] = -1
        weights = rng.integers(1, 3, size=m).astype(np.float32)
        weights[:] = 2.0 if rng.random() < 0.5 else weights  # force size ties
        valid = rng.random(m) > 0.05
        valid[roots] = True
        problems.append((root, weights, valid))
    root, weights, valid = (np.stack(x) for x in zip(*problems))
    got = cluster.compact_clusters(torch.from_numpy(root),
                                   torch.from_numpy(weights),
                                   torch.from_numpy(valid),
                                   max_clusters=k, min_points=20.0)
    for i in range(len(problems)):
        want = jcluster.compact_clusters(
            jnp.asarray(root[i]), jnp.asarray(weights[i]),
            jnp.asarray(valid[i]), max_clusters=k, min_points=20.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert bool(got[1].all())        # more clusters than slots: all filled


def test_topk_stable_prefers_lower_index():
    x = torch.tensor([[0.5, -1.0, 0.5, 0.9, -1.0, 0.5]])
    vals, idx = cluster.topk_stable(x, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
