"""The port's relational graph (``d3net_tpu_torch/models/graph.py``) against
``d3net_tpu.models.graph`` on the CPU, same inputs made by numpy from a
seed, same weights converted from the Flax tree.

Integers (the local masks, the adjacency, ``local_ids``/``local_mask``)
must be equal; floats within rtol 1e-5 per op and 1e-4 through the module.
Cases: random boxes; a lattice of equal boxes, where many distances tie
exactly (``lax.top_k`` keeps the lower index, the port a stable sort); a
scene with fewer valid proposals than locals (the picks at ``_BIG`` are
masked out); and an asymmetric adjacency, where a transposed index in the
EdgeConv would pass every shape check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.models import graph as jgraph
from d3net_tpu.utils.bbox import box_corners
from d3net_tpu_torch import params
from d3net_tpu_torch.models import graph as tgraph

B, P, F, L = 2, 12, 32, 4


def random_boxes(rng):
    centers = rng.uniform(0, 5, (B, P, 3)).astype(np.float32)
    sizes = rng.uniform(0.3, 1.0, (B, P, 3)).astype(np.float32)
    mask = np.ones((B, P), np.float32)
    mask[:, -2:] = 0
    return box_corners(centers, sizes) * mask[..., None, None], mask


def lattice_boxes():
    """Equal 0.5 m boxes on a 3 x 4 grid of 2 m: neighbour distances tie
    exactly; scene 1 keeps only 3 proposals valid (fewer than L + 1)."""
    gx, gy = np.meshgrid(np.arange(4.0), np.arange(3.0), indexing="xy")
    c = np.stack([2 * gx.ravel(), 2 * gy.ravel(), np.full(P, 0.5)], -1)
    centers = np.broadcast_to(c, (B, P, 3)).astype(np.float32)
    corners = box_corners(centers, np.full((B, P, 3), 0.5, np.float32))
    mask = np.ones((B, P), np.float32)
    mask[1, 3:] = 0
    return corners * mask[..., None, None], mask


CASES = {"random": lambda: random_boxes(np.random.default_rng(0)),
         "lattice_ties": lattice_boxes}


def _centers(corners):
    return (corners.min(2) + corners.max(2)) * 0.5


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("include_self", [True, False])
def test_query_locals_matches_jax(case, include_self):
    corners, mask = CASES[case]()
    for t in range(P):
        tid = np.array([t, (t * 5) % P], np.int32)
        want = jgraph.query_locals(jnp.asarray(corners),
                                   jnp.asarray(_centers(corners)),
                                   jnp.asarray(tid), jnp.asarray(mask), L,
                                   include_self=include_self)
        got = tgraph.query_locals(torch.from_numpy(corners),
                                  torch.from_numpy(_centers(corners)),
                                  torch.from_numpy(tid), torch.from_numpy(mask),
                                  L, include_self=include_self)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), str(t))


@pytest.mark.parametrize("case", sorted(CASES))
def test_adjacency_matches_jax(case):
    corners, mask = CASES[case]()
    want = np.asarray(jgraph.adjacency_matrix(
        jnp.asarray(corners), jnp.asarray(_centers(corners)),
        jnp.asarray(mask), L))
    got = tgraph.adjacency_matrix(torch.from_numpy(corners),
                                  torch.from_numpy(_centers(corners)),
                                  torch.from_numpy(mask), L).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "lattice_ties":
        # scene 1: each of the 3 valid proposals has 2 locals, not L
        assert got[1, :3].sum(-1).tolist() == [2.0, 2.0, 2.0]
        assert got[1, 3:].sum() == 0


def _graph_data(case):
    corners, mask = CASES[case]()
    feats = np.random.default_rng(1).normal(size=(B, P, 16)).astype(np.float32)
    return {"proposal_feats_batched": feats * mask[..., None],
            "proposal_batch_mask": mask, "proposal_bbox_batched": corners}


def _randomize(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize(v, rng)
        elif k == "bias":
            tree[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("orientation", [True, False])
def test_graph_module_matches_jax(case, orientation):
    data = _graph_data(case)
    jm = jgraph.GraphModule(out_size=F, num_layers=2, num_locals=L,
                            return_orientation=orientation)
    jdata = jax.tree.map(jnp.asarray, data)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jdata))
    variables = {"params": _randomize(
        jax.tree.map(np.array, variables["params"]),
        np.random.default_rng(2))}
    want = jax.tree.map(np.asarray, jm.apply(
        jax.tree.map(jnp.asarray, variables), jdata))

    tm = tgraph.GraphModule(16, out_size=F, num_layers=2, num_locals=L,
                            return_orientation=orientation)
    tm.load_state_dict(params.flax_to_state_dict(variables, tm))
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in data.items()})

    adj = want["adjacent_mat"]
    if case == "random":
        assert (adj != adj.transpose(0, 2, 1)).any()      # asymmetric
    for k in ("adjacent_mat", "local_ids", "local_mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], k)
    keys = ["bbox_feature", "edge_feature"]
    if orientation:
        keys += ["edge_orientations", "edge_distances"]
    else:
        assert "edge_orientations" not in got
    for k in keys:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)


def test_edge_conv_index_order():
    """One hand-checked message: edge_feature[b, i, k] is the last layer's
    MLP([x_t, x_s - x_t]) with source s = i and target t = its k-th local,
    and the aggregate at t sums over the sources s whose row holds t."""
    data = _graph_data("random")
    tm = tgraph.GraphModule(16, out_size=F, num_layers=1, num_locals=L,
                            return_orientation=False)
    with torch.no_grad():
        out = tm({k: torch.from_numpy(v) for k, v in data.items()})
        x = tm.map_input(torch.from_numpy(data["proposal_feats_batched"]))
        b, i = 1, 4
        k = int(out["local_mask"][b, i].sum()) - 1
        t = int(out["local_ids"][b, i, k])
        want = tm.gc_0(x[b, t], x[b, i])
        torch.testing.assert_close(out["edge_feature"][b, i, k], want)
        adj = out["adjacent_mat"][b]
        agg = sum(adj[s, t] * tm.gc_0(x[b, t], x[b, s]) for s in range(P))
        mask = torch.from_numpy(data["proposal_batch_mask"])[b, t]
        torch.testing.assert_close(out["bbox_feature"][b, t],
                                   (x[b, t] + agg) * mask)
