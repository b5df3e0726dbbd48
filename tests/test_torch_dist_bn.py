"""The port's train-mode BatchNorms over a process group
(``parallel/mesh.py``): ``MaskedBatchNorm`` on (B, M, C) rows and on the
ScoreNet's NCDHW grids (``scorenet._bn``), and the listener's Flax
``BatchNorm``, on 2 and 4 gloo ranks each holding its rows, against one
process on the concatenated input (``checks.bn_rank``: the forward, the
backward of ``Σ y·dy``, the parameters' gradients summed over the ranks).

JAX computes these statistics over the global batch under GSPMD
(``d3net_tpu/models/blocks.py:174-182``). Output, running statistics, dx,
dscale and dbias within rtol 1e-5 / atol 1e-6; the parameters' gradients
and statistics bit-identical across ranks. On 2 ranks the second rank's
rows are all masked out, and it still joins every collective.

The same spawn also runs ``MaskedBatchNorm`` in bf16, as the backbone and
ScoreNet run under ``tpu.activation_dtype: bfloat16``, at counts above
256 where bf16 rounds integers: the global count is rounded to bf16 once,
as one process rounds it, not rank by rank.
"""

import numpy as np
import pytest
import torch

from d3net_tpu_torch import checks
from d3net_tpu_torch.parallel import mesh

SHAPES = {"rows": (4, 64, 8), "grid": (8, 6, 4, 4, 4), "listener": (32, 8)}
# bf16 counts above 256 on every rank: 60% of 4·512 rows, of 8·8³ cells;
# the seed's ranks' counts round apart from the global count (checked)
BF16_SHAPES, BF16_SEED = checks.BF16_BN_SHAPES, checks.BF16_BN_SEED
WORLDS = {2: True, 4: False}    # world size -> second half masked out


@pytest.fixture(scope="module")
def runs():
    """world -> {dtype: (one process's result, the ranks' results)}."""
    out = {}
    for world, empty in WORLDS.items():
        calls = [
            (checks.bn_rank, (checks.bn_case(SHAPES, seed=world,
                                             empty_half=empty),), {}),
            (checks.bn_rank, (checks.bn_case(BF16_SHAPES, seed=BF16_SEED),
                              "bfloat16"), {})]
        one = checks.rank_calls(calls)
        ranks = mesh.spawn(checks.rank_calls, world, calls, threads=1)
        out[world] = {dt: (one[i], [r[i] for r in ranks])
                      for i, dt in enumerate(("float32", "bfloat16"))}
    return out


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_ranks_match_one_process(runs, world, name):
    one, ranks = runs[world]["float32"]
    want = one[name]
    for k in ("y", "dx"):
        got = np.concatenate([r[name][k] for r in ranks])
        np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ("dscale", "dbias", "mean", "var"):
        np.testing.assert_allclose(ranks[0][name][k], want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[name][k], ranks[0][name][k],
                                          err_msg=k)
    assert np.abs(want["dscale"]).max() > 0


def test_all_masked_rank_joins_and_outputs_zero(runs):
    """The 2-rank case's second rank has no active entry: its output and
    dx are zero there, and its statistics are the first rank's rows'."""
    one, ranks = runs[2]["float32"]
    for name in ("rows", "grid"):
        assert not ranks[1][name]["y"].any()
        assert not ranks[1][name]["dx"].any()
        np.testing.assert_allclose(ranks[1][name]["mean"], one[name]["mean"],
                                   rtol=1e-5, atol=1e-6)


def test_one_process_statistics_are_the_masked_batch_statistics(runs):
    """The reference both sides are held to: without a group the running
    statistics move to the batch's masked mean and biased variance
    (momentum 0.1 from 0 and 1) in ``MaskedBatchNorm``, and to its mean and
    fast variance (momentum 0.9) in the listener's."""
    assert not mesh.active() and mesh.world() == 1
    case = checks.bn_case(SHAPES, seed=4)
    one = runs[4]["float32"][0]
    x, m = case["rows"]["x"].reshape(-1, 8), case["rows"]["mask"].reshape(-1)
    mean = x[m].mean(0)
    var = ((x[m] - mean) ** 2).mean(0)
    np.testing.assert_allclose(one["rows"]["mean"], 0.1 * mean, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(one["rows"]["var"], 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)
    xl = case["listener"]["x"].astype(np.float64)
    mean = xl.mean(0)
    var = (xl * xl).mean(0) - mean * mean
    np.testing.assert_allclose(one["listener"]["mean"], 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(one["listener"]["var"], 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_bf16_ranks_match_one_process(runs, world):
    """bf16 inputs to ``MaskedBatchNorm`` (rows and grid): the running
    statistics and the parameters' gradients (f32) within rtol 1e-5 /
    atol 1e-6 of one process's and bit-identical across ranks, output and
    dx (bf16) within one bf16 ulp (``checks.bf16_bn_mismatches``). A count
    rounded rank by rank would move the statistics by up to bf16's spacing
    over the count (0.4-0.8% here)."""
    case = checks.bn_case(BF16_SHAPES, seed=BF16_SEED)
    bf = lambda v: torch.tensor(float(v)).to(torch.bfloat16).item()
    for name in ("rows", "grid"):
        counts = case[name]["mask"].reshape(world, -1).sum(1)
        assert counts.min() > 256
        assert sum(bf(c) for c in counts) != bf(counts.sum()), \
            f"{name}: the ranks' counts must round apart from the global one"
    one, ranks = runs[world]["bfloat16"]
    assert checks.bf16_bn_mismatches(ranks, one) == []
    assert np.abs(one["rows"]["dscale"]).max() > 0
