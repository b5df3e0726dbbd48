"""``make_optimizer`` (AdamW, Adam, SGD with the staircase StepLR) against
``d3net_tpu/train/trainer.py``'s optax chains over 5 steps on the same
numpy gradients, crossing StepLR boundaries (step_epoch 2, so the rate
halves before updates 2 and 4). rtol 1e-6, atol 5e-7 (about four ulps of
the O(1) starting parameters, for entries the updates carry near zero):
the same update formulas in f32, evaluated in another order."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3net_tpu.train import trainer as jtrainer
from d3net_tpu_torch.train import trainer

SHAPES = {"kernel": (3, 4, 5), "scale": (5,), "bias": (5,)}
KW = dict(lr=0.01, weight_decay=0.05, momentum=0.9, step_epoch=2,
          multiplier=0.5, steps_per_epoch=1)


@pytest.mark.parametrize("optim", ["AdamW", "Adam", "SGD"])
def test_make_optimizer_matches_optax(optim):
    rng = np.random.default_rng(4)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]

    tx = jtrainer.make_optimizer(optim=optim, **KW)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, sched = trainer.make_optimizer(tp.values(), optim=optim, **KW)
    lrs = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=5e-7, err_msg=f"{optim} {k}")
    assert lrs == [0.01, 0.01, 0.005, 0.005, 0.0025]


def test_train_state_and_unknown_optimizer():
    model = torch.nn.Linear(3, 2)
    state = trainer.create_train_state(model, optim="SGD", lr=0.1)
    assert state.model is model and state.step == 0
    assert isinstance(state.optimizer, torch.optim.SGD)
    with pytest.raises(ValueError, match="unknown optimizer"):
        trainer.make_optimizer(model.parameters(), optim="Lion")
