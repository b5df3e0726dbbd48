"""The port's ENet (``d3net_tpu_torch/models/enet.py``), its Flax
converter and pickle loader (``params.py``) and ``train_enet``'s step
against the JAX package on the CPU:

- the eval forward of ``ENetEncoder``, light and ``full``, at (2, 48, 64,
  3) and at (1, 38, 54, 3) (odd extents after the first stride), from the
  same Flax variables (random BN statistics and biases): rtol 1e-4 /
  atol 1e-5;
- the converter's round trip, exact;
- ``load_enet_pickle`` on the committed ``outputs/enet/enet_weights.pkl``
  with ``jax`` blocked, equal to ``pickle.load`` under JAX;
- one ``train_enet`` step against the JAX script's ``train`` (its
  ``step_fn``, one step) on the same batch, initial variables and dropout
  masks (given to JAX through ``flax.linen.intercept_methods``): loss and
  accuracy rtol 1e-4, every gradient 1e-3 / 1e-6 (the initial block's
  conv bias only shifts a train-mode BatchNorm's input: its gradient is
  float noise on both sides, held under 1e-5 of the largest), the new BN
  statistics 1e-4 / 1e-5 and Adam's update rtol 1e-4 where the gradient
  is not noise. The step runs in float64 on both sides (the port's model
  ``.double()``, JAX's under ``jax_enable_x64``): rendered frames' empty
  background is constant, so the max-pools see exact ties and f32
  rounding reroutes gradients (the port's own f32 step differs from its
  f64 step past 1e-3 / 1e-6 in about 2,200 elements; JAX's f32 CPU step
  is 0.7% off its f64 gradients by norm even on tie-free inputs). The f32
  step's loss and accuracy are held to JAX's f32 ones at rtol 1e-4.
"""

import contextlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from d3net_tpu_torch import params
from d3net_tpu_torch.models.enet import ENetEncoder
from d3net_tpu_torch.models.listener import ListenerDraws
from d3net_tpu_torch.scripts import train_enet as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "outputs", "enet", "enet_weights.pkl")
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
NOISE = 1e-5
BN_FED = {"ENetEncoder_0.InitialBlock_0.Conv_0.bias"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_variables(model, seed):
    """Flax variables with nonzero biases and BN statistics."""
    v = params.init_enet_flax_variables(model, seed)
    rng = np.random.default_rng(seed + 100)

    def perturb(tree):
        flat = params.flatten(tree)
        return params._unflatten({
            k: a if k.endswith("kernel") else
            (a + rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32)
            for k, a in flat.items()})

    return {c: perturb(t) for c, t in v.items()}


@pytest.mark.parametrize("full", [False, True], ids=["light", "full"])
@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (1, 38, 54, 3)],
                         ids=["even", "odd"])
def test_encoder_eval_forward_matches_jax(full, shape):
    import jax
    import jax.numpy as jnp
    from d3net_tpu.models.enet import ENetEncoder as JaxENet

    model = ENetEncoder(full)
    v = _random_variables(model, 3)
    model.load_state_dict(params.enet_flax_to_state_dict(v, model))
    x = np.random.default_rng(4).uniform(0, 1, shape).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(JaxENet(full=full).apply(
        jax.tree.map(jnp.asarray, v), jnp.asarray(x), train=False))
    assert got.shape == want.shape == (shape[0], shape[1] // 8,
                                       shape[2] // 8, 128)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("full", [False, True], ids=["light", "full"])
def test_converter_round_trip_is_exact(full):
    model = ENetEncoder(full)
    v = _random_variables(model, 5)
    sd = params.enet_flax_to_state_dict(v, model)
    model.load_state_dict(sd)
    back = params.enet_state_dict_to_flax(model)
    for c in ("params", "batch_stats"):
        want, got = params.flatten(v[c]), params.flatten(back[c])
        assert set(got) == set(want)
        for k, a in want.items():
            assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k
    assert sd["InitialBlock_0.Conv_0.weight"].shape == (13, 3, 3, 3)
    assert ("Bottleneck_21.Conv_0.weight" in sd) == full


_LOAD_BLOCKED = """
import json, sys
sys.modules["jax"] = None          # any import of JAX fails
sys.path.insert(0, {root!r})
from d3net_tpu_torch import params
tree = params.load_enet_pickle({path!r})
import numpy as np
np.savez({out!r}, **{{c + "/" + k: a for c in tree
                      for k, a in params.flatten(tree[c]).items()}})
print(json.dumps(sorted(m for m, mod in sys.modules.items()
                        if mod is not None and m.split(".")[0]
                        in ("jax", "jaxlib", "flax"))))
"""


def test_load_enet_pickle_without_jax(tmp_path):
    import jax  # noqa: F401  (pickle.load of jax.Array leaves needs it)

    out = str(tmp_path / "leaves.npz")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _LOAD_BLOCKED.format(root=ROOT, path=WEIGHTS,
                                                    out=out)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    with open(WEIGHTS, "rb") as f:
        want = pickle.load(f)
    got = np.load(out)
    flat = {f"{c}/{k}": np.asarray(a) for c in want
            for k, a in params.flatten(want[c]).items()}
    assert set(got.files) == set(flat) and len(flat) == 175 + 86
    for k, a in flat.items():
        assert got[k].dtype == a.dtype and np.array_equal(got[k], a), k
    assert got["params/InitialBlock_0.Conv_0.kernel"].shape == (3, 3, 3, 13)
    model = ENetEncoder()       # the light layout takes every leaf
    model.load_state_dict(params.enet_flax_to_state_dict(
        params.load_enet_pickle(WEIGHTS), model))


@contextlib.contextmanager
def _jax_train_enet():
    """The JAX script's module, imported without its cache-dir setup
    leaking into this process's JAX configuration."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import train_enet
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
        jax.config.update("jax_compilation_cache_dir", before)
    yield train_enet


def test_train_step_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp
    import optax
    from flax import linen as fnn

    classes, batch, lr, seed = 20, 3, 1e-3, 0
    colors, labels = ttrain.build_frame_dataset(2, 2, 48, 64, seed=seed)
    with _jax_train_enet() as jte:
        jcolors, jlabels = jte.build_frame_dataset(2, 2, 48, 64, seed=seed)
    assert np.array_equal(colors, jcolors) and np.array_equal(labels, jlabels)
    assert (labels >= 0).mean() > 0.1

    # the port's step, its masks drawn from a generator: in f32 for the
    # loss, then in f64 on the same masks
    model = ttrain.make_model(classes, seed, "cpu")
    v0 = params.enet_state_dict_to_flax(model)
    idx = np.random.default_rng(seed).integers(0, len(colors), size=batch)
    draws = ListenerDraws(torch.Generator().manual_seed(9))
    loss32, acc32 = ttrain.enet_train_step(
        model, ttrain.make_optimizer(model, lr), torch.from_numpy(colors[idx]),
        torch.from_numpy(labels[idx]), draws)
    assert len(draws.drawn) == 14
    model = ttrain.make_model(classes, seed, "cpu").double()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    loss, acc = ttrain.enet_train_step(
        model, ttrain.make_optimizer(model, lr),
        torch.from_numpy(colors[idx]).double(), torch.from_numpy(labels[idx]),
        ListenerDraws(masks=draws.drawn))
    grads = params.flatten(params.state_dict_to_flax(
        model, {k: p.grad for k, p in model.named_parameters()})["params"])

    # JAX's train(): its init patched to the same variables, its dropout
    # to the same masks, its gradients caught in the optimizer
    jgrads = []
    real_adam = optax.adam

    def adam_catching(lr_):
        tx = real_adam(lr_)

        def update(g, state, p=None):
            jax.debug.callback(lambda t: jgrads.append(jax.tree.map(
                np.asarray, t)), g)
            return tx.update(g, state, p)

        return optax.GradientTransformation(tx.init, update)

    monkeypatch.setattr(optax, "adam", adam_catching)
    masks = {k: jnp.asarray(m.numpy()) for k, m in draws.drawn.items()}
    real_b = jax.random.bernoulli
    taken = []

    def interceptor(next_fun, args, kwargs, context):
        key = ".".join(context.module.path)
        if isinstance(context.module, fnn.Dropout) and key in masks:
            def given(k, p=0.5, shape=None):
                assert tuple(shape) == masks[key].shape, key
                taken.append(key)
                return masks[key]

            jax.random.bernoulli = given
        try:
            return next_fun(*args, **kwargs)
        finally:
            jax.random.bernoulli = real_b

    def jax_train(dtype):
        monkeypatch.setattr(fnn.Module, "init", lambda self, *a, **k:
                            jax.tree.map(lambda a: jnp.asarray(a, dtype), v0))
        taken.clear()
        jgrads.clear()
        with _jax_train_enet() as jte, fnn.intercept_methods(interceptor):
            out = jte.train(colors.astype(dtype), labels, classes, 1, batch,
                            lr, seed=seed)
        assert len(jgrads) == 1 and sorted(taken) == sorted(masks)
        return jax.tree.map(np.asarray, out[:2]) + (out[2][0],)

    rec32 = jax_train(np.float32)[2]
    np.testing.assert_allclose(float(loss32), rec32["loss"], rtol=RTOL)
    np.testing.assert_allclose(float(acc32), rec32["acc"], rtol=RTOL)
    jax.config.update("jax_enable_x64", True)
    try:
        jparams, jstats, rec = jax_train(np.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(float(loss), rec["loss"], rtol=RTOL)
    np.testing.assert_allclose(float(acc), rec["acc"], rtol=RTOL)

    jg = params.flatten(jgrads[0])
    assert set(grads) == set(jg)
    scale = max(np.abs(a).max() for a in jg.values())
    for k, want in jg.items():
        if k in BN_FED:
            assert np.abs(want).max() < NOISE * scale, k
            assert np.abs(grads[k]).max() < NOISE * scale, k
            continue
        np.testing.assert_allclose(grads[k], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)

    new_stats = params.flatten(params.enet_state_dict_to_flax(
        model)["batch_stats"])
    for k, want in params.flatten(jstats).items():
        np.testing.assert_allclose(new_stats[k], want, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # Adam's first update is about lr·sign(g): held where g is not noise
    after = params.flatten(params.state_dict_to_flax(
        model, {k: p.detach() - before[k]
                for k, p in model.named_parameters()})["params"])
    jafter = params.flatten(jax.tree.map(lambda a, b: a - b, jparams,
                                         v0["params"]))
    for k, want in jafter.items():
        if k in BN_FED:
            continue
        big = np.abs(jg[k]) > 1e-3 * np.abs(jg[k]).max()
        np.testing.assert_allclose(after[k][big], want[big], rtol=RTOL,
                                   atol=1e-8, err_msg=k)
