"""``scripts/port_enet_weights.py`` against the JAX package's, on the CPU.

- On ``synth_state_dict(0)`` (the reference checkpoint's keys and shapes,
  random values) the port's mapping equals the JAX script's leaf for leaf,
  and so do the key tables.
- The port's ``ENetEncoder(full=True)`` with the mapped weights equals
  JAX's ``ENetEncoder(full=True).apply`` on a seeded (1, 64, 64, 3) image
  within rtol 1e-4 / atol 1e-5.
- ``--checkpoint`` on a ``torch.save`` of that state_dict writes the JAX
  script's pickle, byte for byte; ``params.load_enet_pickle`` reads it and
  ``compute_multiview_features`` builds the full layout from it.
- ``--selftest --cpu`` passes without JAX; a state_dict missing a key, or
  holding one no leaf takes, is refused.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from d3net_tpu_torch import params
from d3net_tpu_torch.models.enet import ENetEncoder
from d3net_tpu_torch.scripts import port_enet_weights as tport
from test_torch_benchmark import load_jax_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = "scripts/port_enet_weights.py"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jport():
    return load_jax_script(JAX_SCRIPT)


def test_key_table_and_synthetic_state_dict_match_jax(jport):
    assert tport.expected_torch_keys() == jport.expected_torch_keys()
    got, want = tport.synth_state_dict(0), jport.synth_state_dict(0)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


def test_mapping_matches_jax_leaf_for_leaf(jport):
    sd = tport.synth_state_dict(0)
    got = params.flatten(dict(zip(("params", "batch_stats"),
                                  tport.port_enet_state_dict(sd))))
    want = params.flatten(dict(zip(("params", "batch_stats"),
                                   jport.port_enet_state_dict(sd))))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # every leaf of the port's full encoder is written, with its shape
    ref = params.flatten(params.enet_state_dict_to_flax(ENetEncoder(full=True)))
    assert {k: v.shape for k, v in ref.items()} == \
        {k: v.shape for k, v in got.items()}


def test_full_encoder_forward_matches_jax():
    import jax
    import jax.numpy as jnp

    from d3net_tpu.models.enet import ENetEncoder as JENet

    p, s = tport.port_enet_state_dict(tport.synth_state_dict(0))
    variables = {"params": p, "batch_stats": s}
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(JENet(full=True).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False))
    model = ENetEncoder(full=True)
    model.load_state_dict(params.enet_flax_to_state_dict(variables, model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 8, 8, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(want).max() > 1e-2


def test_checkpoint_cli_writes_jax_pickle(jport, tmp_path, monkeypatch,
                                          capsys):
    from d3net_tpu_torch.scripts.compute_multiview_features import (
        make_encoder,
    )

    sd = tport.synth_state_dict(0)
    sd["26.weight"] = np.zeros((20, 16, 1, 1), np.float32)   # classifier
    sd["2.num_batches_tracked"] = np.zeros((), np.int64)
    ckpt = str(tmp_path / "scannetv2_enet.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    out, jout = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT, "--checkpoint", ckpt,
                                      "--output", jout])
    jport.main()
    tport.main(["--checkpoint", ckpt, "--output", out])
    assert capsys.readouterr().out.splitlines()[-1] == f"wrote {out}"
    with open(out, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
    tree = params.load_enet_pickle(out)
    assert tree["full"] and set(tree) == {"params", "batch_stats", "full"}
    want = tport.port_enet_state_dict(tport.synth_state_dict(0))
    for got_t, want_t in zip((tree["params"], tree["batch_stats"]), want):
        g, w = params.flatten(got_t), params.flatten(want_t)
        assert list(g) == list(w)
        assert all(np.array_equal(g[k], w[k]) for k in w)
    apply_fn, model = make_encoder(out, device="cpu")
    assert model.full and model.n_blocks == 22
    assert apply_fn(np.zeros((1, 32, 32, 3), np.float32)).shape == \
        (1, 4, 4, 128)


def test_unmapped_or_missing_keys_raise():
    sd = tport.synth_state_dict(0)
    with pytest.raises(ValueError, match="unmapped checkpoint keys"):
        tport.port_enet_state_dict({**sd, "27.weight": np.zeros(3)})
    del sd["5.0.0.3.bias"]
    with pytest.raises(KeyError, match="5.0.0.3.bias"):
        tport.port_enet_state_dict(sd)


def test_selftest_cli_on_cpu_without_jax(tmp_path):
    """``--selftest --cpu`` in its own process, which imports no JAX; the
    forward it returns is the mapped encoder's."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    code = ("import sys, runpy\n"
            "sys.argv = ['port_enet_weights', '--selftest', '--cpu']\n"
            "runpy.run_module('d3net_tpu_torch.scripts.port_enet_weights',"
            " run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'd3net_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith(
        "leaves mapped, output (1, 8, 8, 128)")
    y = tport.selftest("cpu")
    assert y.shape == (1, 8, 8, 128) and np.isfinite(y).all()
