"""The port's speaker losses (``d3net_tpu_torch/train/losses_slt.py``)
against ``d3net_tpu.train.losses_slt`` on the CPU, on the same numpy inputs
made from a seed.

- ``caption_loss``: loss and accuracy (rtol 1e-5) over good rows with pad
  words, both exactly 0 when no row is good, and its gradient.
- ``radian_to_label``: equal bins on seeded angles, the bin edges included.
- ``orientation_loss``: loss and accuracy (rtol 1e-5) on seeded rotations
  about z, with masked objects and masked edges, and its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.train import losses_slt as jl
from d3net_tpu_torch.checks import rot_z
from d3net_tpu_torch.train import losses_slt as tl

N, T, V = 6, 9, 13


def _caption_inputs(seed, good):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, T - 1, V)).astype(np.float32)
    ids = rng.integers(1, V, (N, T)).astype(np.int32)
    ids[:, 0] = 2
    for i in range(N):                     # pad tails of different lengths
        ids[i, T - i:] = 0
    # a few predictions right, so the accuracy is not 0
    logits[0, 1, ids[0, 2]] += 10.0
    logits[3, 0, ids[3, 1]] += 10.0
    return logits, ids, np.asarray(good)


@pytest.mark.parametrize("good", [
    [True, False, True, True, False, True],
    [False] * N,
], ids=["some_good", "no_good_row"])
def test_caption_loss_matches_jax(good):
    logits, ids, good = _caption_inputs(0, good)
    want_l, want_a = jl.caption_loss(jnp.asarray(logits), jnp.asarray(ids),
                                     jnp.asarray(good))
    want_g = jax.grad(lambda x: jl.caption_loss(
        x, jnp.asarray(ids), jnp.asarray(good))[0])(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got_l, got_a = tl.caption_loss(x, torch.from_numpy(ids),
                                   torch.from_numpy(good))
    got_l.backward()
    got_l = got_l.detach()
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-8)
    if good.any():
        assert float(got_l) > 0 and float(got_a) > 0
    else:
        assert float(got_l) == 0.0 and float(got_a) == 0.0
        assert not x.grad.any()


def test_radian_to_label_matches_jax():
    rng = np.random.default_rng(1)
    width = np.float32(np.pi / 6)
    edges = np.arange(7, dtype=np.float32) * width
    ang = np.concatenate([rng.uniform(0, np.pi, 200), edges,
                          np.nextafter(edges, np.float32(-1)),
                          [-0.1, np.pi, 4.0]]).astype(np.float32)
    want = np.asarray(jl.radian_to_label(jnp.asarray(ang)))
    got = tl.radian_to_label(torch.from_numpy(ang))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want) == set(range(6))


def test_orientation_loss_matches_jax():
    rng = np.random.default_rng(2)
    b, p, l, i, bins = 2, 7, 3, 5, 6
    edge = rng.normal(size=(b, p, l, bins)).astype(np.float32)
    lids = rng.integers(0, p, (b, p, l)).astype(np.int32)
    lmask = (rng.random((b, p, l)) < 0.8).astype(np.float32)
    assign = rng.integers(0, i, (b, p)).astype(np.int32)
    rots = rot_z(rng.uniform(-np.pi, np.pi, (b, i)))
    rmask = (rng.random((b, i)) < 0.8).astype(np.float32)
    args = (edge, lids, lmask, assign, rots, rmask)
    want_l, want_a = jl.orientation_loss(*map(jnp.asarray, args))
    want_g = jax.grad(lambda e: jl.orientation_loss(
        e, *map(jnp.asarray, args[1:]))[0])(jnp.asarray(edge))
    x = torch.from_numpy(edge).requires_grad_()
    got_l, got_a = tl.orientation_loss(x, *map(torch.from_numpy, args[1:]))
    got_l.backward()
    got_l = got_l.detach()
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-8)
    assert float(got_l) > 0 and 0 < float(got_a) < 1
