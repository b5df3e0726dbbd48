"""Flax -> state_dict converter: every leaf of a small PointGroup consumed
exactly once; Dense/Conv/ConvTranspose layouts pinned against Flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from d3net_tpu.data.collate import BatchSpec, build_batch
from d3net_tpu.data.synthetic import make_scene
from d3net_tpu.models.pointgroup import PointGroup as JaxPointGroup
from d3net_tpu_torch import params
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.models.scorenet import Conv, ConvTranspose

SMALL = dict(m=8, blocks=(1, 2, 3), cluster_blocks=(1, 2), clusters_per_pass=16,
             max_num_proposal=8, cluster_npoint_thre=30, test_npoint_thresh=30,
             test_score_thresh=0.0, cluster_ring=1, cluster_cell_size=0.03,
             cluster_prop_iters=4)


def randomize(tree, rng):
    """Nonzero biases and BN statistics, so every leaf matters."""
    for k, v in tree.items():
        if isinstance(v, dict):
            randomize(v, rng)
        elif k in ("bias", "mean"):
            tree[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return tree


def flax_shapes(cfg=SMALL):
    """{dotted path: shape} of the JAX PointGroup's variables (traced only)."""
    scenes = [make_scene(seed=i, num_instances=2, floor_points=300,
                         points_per_instance=300, room=3.0) for i in range(2)]
    spec = BatchSpec(max_points=1024, voxel_caps=[1024, 512, 256],
                     max_instances=4, use_multiview=False, use_normal=True)
    batch = jax.tree.map(jnp.asarray, build_batch(scenes, spec))
    model = JaxPointGroup(**cfg)
    shapes = jax.eval_shape(
        lambda b: model.init({"params": jax.random.key(0)}, b, train=False),
        batch)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat = {".".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in leaves}
    return flat, spec.feat_dim() + 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def test_every_flax_leaf_consumed_once():
    want, in_ch = flax_shapes()
    model = PointGroup(in_ch, **SMALL)
    variables = params.init_flax_variables(model, seed=0)
    # the port's own init tree has exactly the Flax tree's leaves and shapes
    got = {k: tuple(v.shape) for k, v in _flat(variables).items()}
    assert got == want
    randomize(variables, np.random.default_rng(0))
    sd = params.flax_to_state_dict(variables, model)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(want)
    # each leaf lands once, untouched apart from its layout change
    flat = _flat(variables)
    for key, t in sd.items():
        mod, leaf = key.rsplit(".", 1)
        src = {"weight": "kernel"}.get(leaf, leaf)
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        assert np.isclose(float(t.sum()), float(flat[f"{coll}.{mod}.{src}"].sum()),
                          rtol=1e-5, atol=1e-5), key


def test_converter_rejects_unused_and_missing_leaves():
    model = PointGroup(9, m=4, blocks=(1, 2), cluster_blocks=(1, 2))
    variables = params.init_flax_variables(model, seed=0)
    variables["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unused"):
        params.flax_to_state_dict(variables, model)
    del variables["params"]["extra"]
    del variables["batch_stats"]["out_bn"]
    with pytest.raises(ValueError, match="out_bn.mean"):
        params.flax_to_state_dict(variables, model)


def test_conv_transpose_impulse():
    """One-channel impulse: Flax ConvTranspose(transpose_kernel=False) and
    the port's conv_transpose3d agree only with the spatial flip."""
    k = np.arange(1, 9, dtype=np.float32).reshape(2, 2, 2, 1, 1)
    x = np.zeros((1, 3, 3, 3, 1), np.float32)
    x[0, 1, 2, 0, 0] = 1.0
    flax_mod = nn.ConvTranspose(1, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
    want = np.asarray(flax_mod.apply({"params": {"kernel": jnp.asarray(k)}},
                                     jnp.asarray(x)))
    port = ConvTranspose(1, 1)
    port.weight.data = torch.from_numpy(params._CONVT(k).copy())
    got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # Flax writes the impulse's 2x2x2 block as the kernel flipped in every
    # axis; conv_transpose3d writes its weight unflipped, hence the flip
    np.testing.assert_array_equal(want[0, 2:4, 4:6, 0:2, 0],
                                  k[::-1, ::-1, ::-1, 0, 0])
    np.testing.assert_array_equal(port.weight.detach().numpy()[0, 0],
                                  want[0, 2:4, 4:6, 0:2, 0])


@pytest.mark.parametrize("kernel,stride,g", [(3, 1, 5), (1, 1, 4), (2, 2, 6)])
def test_conv_layout_matches_flax(kernel, stride, g):
    rng = np.random.default_rng(kernel)
    cin, cout = 3, 4
    w = rng.standard_normal((kernel,) * 3 + (cin, cout)).astype(np.float32)
    x = rng.standard_normal((2, g, g, g, cin)).astype(np.float32)
    flax_mod = nn.Conv(cout, (kernel,) * 3, strides=(stride,) * 3,
                       use_bias=False)
    want = np.asarray(flax_mod.apply({"params": {"kernel": jnp.asarray(w)}},
                                     jnp.asarray(x)))
    port = Conv(cin, cout, kernel, stride)
    port.weight.data = torch.from_numpy(params._CONV(w).copy())
    got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv_transpose_layout_matches_flax():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((2, 2, 2, 5, 3)).astype(np.float32)
    x = rng.standard_normal((2, 4, 4, 4, 5)).astype(np.float32)
    flax_mod = nn.ConvTranspose(3, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
    want = np.asarray(flax_mod.apply({"params": {"kernel": jnp.asarray(w)}},
                                     jnp.asarray(x)))
    port = ConvTranspose(5, 3)
    port.weight.data = torch.from_numpy(params._CONVT(w).copy())
    got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_dense_layout_matches_flax():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    want = np.asarray(nn.Dense(4).apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x)))
    lin = torch.nn.Linear(6, 4)
    lin.weight.data = torch.from_numpy(params._T(w).copy())
    lin.bias.data = torch.from_numpy(b)
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_load_detector_on_cpu_and_flagship_config():
    model = PointGroup(9, m=4, blocks=(1, 2), cluster_blocks=(1, 2))
    variables = params.init_flax_variables(model, seed=1)
    det = params.load_detector(variables, dict(m=4, blocks=(1, 2)),
                               device="cpu")
    assert not det.training
    assert det.input_conv.kernel.shape == (27, 9, 4)
    flag = params.flagship_config()
    assert flag.batch_size == 4
    assert flag.spec.feat_dim() + 3 == 134
    assert flag.spec.caps() == [131072 >> i for i in range(7)]
    assert flag.model == {"compute_dtype": "bfloat16"}


def test_state_dict_to_flax_is_a_copy():
    """The tree taken before an optimizer step keeps its values after it:
    no leaf is a view of a parameter or a BN buffer (a CPU tensor's numpy
    view would follow later steps)."""
    model = PointGroup(9, m=4, blocks=(1, 2), cluster_blocks=(1, 2))
    model.load_state_dict(params.flax_to_state_dict(
        params.init_flax_variables(model, seed=1), model))
    tree = params.state_dict_to_flax(model)
    before = {k: v.copy() for k, v in params.flatten(tree).items()}
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if buf.is_floating_point():
                buf.add_(1.0)
    after = params.flatten(tree)
    assert list(after) == list(before)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    live = [t.detach().numpy() for t in list(model.parameters())
            + [b for b in model.buffers() if b.is_floating_point()]]
    assert not any(np.shares_memory(leaf, t)
                   for leaf in after.values() for t in live)
    # the step moved every parameter, so a view would have shown it
    moved = params.flatten(params.state_dict_to_flax(model))
    assert all(not np.array_equal(moved[k], v) for k, v in before.items())
