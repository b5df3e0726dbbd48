"""Train the ENet 2D encoder on synthetic frame semantics.

The port's ``scripts/train_enet.py``: it renders RGB frames and per-pixel
semantic labels from synthetic scenes (``data/frames.py``), trains
``ENetEncoder`` + a 1x1 classifier with a masked cross-entropy at 1/8
resolution (Adam, the batch indices drawn from
``np.random.default_rng(seed)`` as JAX draws them), and saves the
encoder's variables as a pickle of numpy Flax trees in
``extract_encoder_variables``' layout, which either package's
``compute_multiview_features --weights`` reads:

    python -m d3net_tpu_torch.scripts.train_enet --scenes 16 --frames 8 \\
        --steps 400 --output outputs/enet/enet_weights.pkl [--cpu]

A step's dropout masks come from a generator seeded by ``(seed + 1,
step)``; the loss and accuracy are read back only on log steps. Runs on
CUDA unless ``--cpu`` is given; without a GPU and without ``--cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from d3net_tpu_torch.device import DeviceLike, resolve_device


def build_frame_dataset(num_scenes: int, frames_per_scene: int,
                        height: int, width: int, seed: int = 0):
    """Render (N, H, W, 3) colors + (N, H/8, W/8) labels (-1 = unlabeled),
    the labels sampled at each feature cell's center pixel."""
    from d3net_tpu_torch.data.frames import (
        default_intrinsic, orbit_poses, render_frame,
    )
    from d3net_tpu_torch.data.synthetic import make_scene

    colors, labels = [], []
    for s in range(num_scenes):
        scene = make_scene(seed=seed + s, num_instances=10, density=2500.0,
                           floor_points=15000, room=6.0)
        intrinsic = default_intrinsic(width, height)
        poses = orbit_poses(scene.xyz, frames_per_scene)
        for pose in poses:
            c, _, sem = render_frame(scene, pose, intrinsic, width, height,
                                     with_semantics=True)
            colors.append(c)
            labels.append(sem[4::8, 4::8])
    return np.stack(colors).astype(np.float32), np.stack(labels)


def make_model(num_classes: int, seed: int = 0, device: DeviceLike = None):
    """``ENetSemantic`` with numpy-drawn Flax initial variables (``params.
    init_enet_flax_variables``) on ``device``."""
    from d3net_tpu_torch.models.enet import ENetSemantic
    from d3net_tpu_torch.params import (
        enet_flax_to_state_dict, init_enet_flax_variables,
    )

    model = ENetSemantic(num_classes)
    model.load_state_dict(enet_flax_to_state_dict(
        init_enet_flax_variables(model, seed), model))
    return model.to(resolve_device(device))


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, no decay."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def semantic_loss(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labelled cells (labels >= 0) and the
    pixel accuracy there."""
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         safe.reshape(-1), reduction="none").view(safe.shape)
    n = valid.sum().clamp(min=1)
    loss = torch.where(valid, ce, 0.0).sum() / n
    acc = (valid & (logits.argmax(-1) == safe)).sum() / n
    return loss, acc


def enet_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    imgs: torch.Tensor, labels: torch.Tensor, draws=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Adam step of ``model`` (train mode, BN statistics moving) on a
    batch; dropout masks from ``draws`` (a ``ListenerDraws``). Returns the
    loss and accuracy as device tensors."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, acc = semantic_loss(model(imgs, train=True, draws=draws), labels)
    loss.backward()
    optimizer.step()
    return loss.detach(), acc.detach()


def train(colors: np.ndarray, labels: np.ndarray, num_classes: int,
          steps: int, batch: int, lr: float, seed: int = 0,
          log_every: int = 20, device: DeviceLike = None):
    """Returns (model, history of {step, loss, acc} on log steps)."""
    from d3net_tpu_torch.models.listener import ListenerDraws

    dev = resolve_device(device)
    model = make_model(num_classes, seed, dev)
    optimizer = make_optimizer(model, lr)
    n = len(colors)
    rng_np = np.random.default_rng(seed)
    history = []
    t0 = time.time()
    for i in range(steps):
        idx = rng_np.integers(0, n, size=batch)
        gen = torch.Generator(device=dev).manual_seed(((seed + 1) << 32) + i)
        loss, acc = enet_train_step(
            model, optimizer, torch.from_numpy(colors[idx]).to(dev),
            torch.from_numpy(labels[idx]).to(dev), ListenerDraws(gen))
        if i % log_every == 0 or i == steps - 1:
            loss, acc = float(loss), float(acc)
            history.append({"step": i, "loss": loss, "acc": acc})
            print(f"step {i} loss {loss:.4f} pix_acc {acc:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return model, history


def extract_encoder_variables(model: torch.nn.Module) -> Dict:
    """``ENetSemantic`` -> the plain ``ENetEncoder`` variables as numpy
    Flax trees (the layout ``compute_multiview_features`` loads)."""
    from d3net_tpu_torch.params import enet_state_dict_to_flax

    return enet_state_dict_to_flax(model.ENetEncoder_0)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--frames", type=int, default=8, help="frames per scene")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=328)
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output", required=True,
                    help="encoder variables pickle for --weights")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    print(f"rendering {args.scenes} scenes x {args.frames} frames "
          f"at {args.height}x{args.width}...", flush=True)
    colors, labels = build_frame_dataset(
        args.scenes, args.frames, args.height, args.width, seed=args.seed)
    print(f"dataset: {colors.shape}, label coverage "
          f"{float((labels >= 0).mean()):.2f}")

    model, history = train(colors, labels, args.classes, args.steps,
                           args.batch, args.lr, seed=args.seed, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(extract_encoder_variables(model), f)
    print(f"saved encoder weights to {args.output} "
          f"(final pix_acc {history[-1]['acc']:.3f})")
    return history


if __name__ == "__main__":
    main()
