"""Train state, optimizer and the detector train/eval steps.

Counterpart of ``d3net_tpu/train/trainer.py``: AdamW (or Adam, SGD) with
the reference's staircase StepLR, and one mode-0 step (voxel scatter ->
sparse U-Net -> heads -> clustering -> ScoreNet -> ``detector_loss`` ->
backward -> update). The step updates the model, the optimizer and the BN
running statistics in place.

``optax.adamw`` decays every parameter, BN scales and biases included,
with no mask, and its update ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
is ``torch.optim.AdamW``'s at b1 0.9, b2 0.999, eps 1e-8: so all
parameters sit in one decayed group. The learning rate of update ``s``
(0-based) is ``lr * multiplier ** (s // (step_epoch * steps_per_epoch))``
in both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from d3net_tpu_torch import trace
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.train.losses import detector_loss


def make_optimizer(params: Iterable[nn.Parameter], lr: float = 0.002,
                   optim: str = "AdamW", weight_decay: float = 0.0001,
                   momentum: float = 0.9, step_epoch: int = 480,
                   multiplier: float = 0.5, steps_per_epoch: int = 1,
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.StepLR]:
    """AdamW/Adam/SGD and its StepLR(step_epoch, multiplier); call the
    scheduler's ``step()`` after every optimizer step."""
    params = list(params)
    if optim == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif optim == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optim == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer {optim}")
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=max(1, step_epoch * steps_per_epoch), gamma=multiplier)
    return opt, sched


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.StepLR
    step: int = 0


def create_train_state(model: nn.Module, **optimizer_kw) -> TrainState:
    """The model with a fresh ``make_optimizer(**optimizer_kw)`` over its
    parameters that require a gradient (all but a frozen submodule's), at
    step 0."""
    opt, sched = make_optimizer(
        [p for p in model.parameters() if p.requires_grad], **optimizer_kw)
    return TrainState(model, opt, sched)


def seek_schedule(state: TrainState, count: int) -> None:
    """Put ``state``'s StepLR where ``count`` updates leave it: its epoch
    count at ``count`` and each group's lr ``base · gamma ** (count //
    step_size)``, optax's staircase ``exponential_decay`` at ``count`` (a
    run resumed from another framework's state takes its schedule so)."""
    sched = state.scheduler
    sched.last_epoch = int(count)
    sched._step_count = int(count) + 1
    for g, base in zip(sched.optimizer.param_groups, sched.base_lrs):
        g["lr"] = base * sched.gamma ** (int(count) // sched.step_size)
    sched._last_lr = [g["lr"] for g in sched.optimizer.param_groups]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all entries of all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def detector_train_step(state: TrainState, batch: Dict,
                        generator: Optional[torch.Generator] = None, *,
                        loss_weight: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                        do_clustering: bool = True,
                        jitter_u: Optional[torch.Tensor] = None,
                        proposal_perm: Optional[torch.Tensor] = None,
                        sum_metrics: bool = True,
                        ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step of ``state.model`` on ``batch``.

    The cluster jitter and the proposal shuffle come from ``generator``
    unless given as tensors. Returns the state (updated in place) and the
    losses plus ``grad_norm``, as detached tensors.

    Under a process group (``parallel.mesh``) ``batch`` is this rank's rows
    of the global batch, and the step is the global batch's: the loss is
    this rank's share, the gradients are summed over the ranks before the
    update (``grad_norm`` is the global gradient's), and the losses are the
    global values, or this rank's shares with ``sum_metrics=False`` (a
    caller that sums many steps' at once).

    The step is a ``train.step`` span (id: the step) over ``train.forward``,
    ``train.loss``, ``train.backward`` and ``train.optim``.
    """
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]
    with trace.span("train.step", id=state.step):
        state.optimizer.zero_grad(set_to_none=True)
        with trace.span("train.forward"):
            out = model(batch, train=True, do_clustering=do_clustering,
                        generator=generator, jitter_u=jitter_u,
                        proposal_perm=proposal_perm)
        with trace.span("train.loss"):
            losses = detector_loss(out, batch, loss_weight=loss_weight,
                                   with_score=do_clustering)
        with trace.span("train.backward"):
            losses["total_loss"].backward()
        with trace.span("train.optim"):
            # a parameter the loss does not reach (the ScoreNet without
            # clustering) has a zero gradient in JAX, and optax still
            # decays and moments it
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            mesh.all_reduce_grads(params)
            metrics = {k: v.detach() for k, v in losses.items()}
            if sum_metrics:
                metrics = mesh.sum_metrics(metrics)
            metrics["grad_norm"] = global_norm([p.grad for p in params])
            state.optimizer.step()
            state.scheduler.step()
    state.step += 1
    return state, metrics


def detector_eval_step(state: TrainState, batch: Dict,
                       do_clustering: bool = True):
    """Eval-mode forward and losses of ``state.model``, no gradient:
    ``(out, losses)``."""
    with torch.no_grad():
        out = state.model(batch, train=False, do_clustering=do_clustering)
        losses = detector_loss(out, batch, with_score=do_clustering)
    return out, losses
