"""The multi-process dry run: one full detector train step and one two-phase
joint speaker-listener RL step over N ranks, at dry-run scale.

Counterpart of ``__graft_entry__.dryrun_multichip`` (with its
``_tiny_model``, ``_tiny_batch`` and ``_tiny_joint_cfg``). Each rank holds
its rows of the global batch (``parallel.mesh``); the detector uses the
gather conv form (the port has no column-resident one). Prints the JAX
function's two lines:

    python -m d3net_tpu_torch.parallel.dryrun [--ranks N] [--cpu]

On CUDA the ranks are one process a card (NCCL) and N defaults to the
visible cards; with ``--cpu`` they are gloo processes (N defaults to 2).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from d3net_tpu_torch import config as cfg_lib
from d3net_tpu_torch.parallel import mesh

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# __graft_entry__._tiny_model(m=4, blocks=(1, 2), clusters_per_pass=8,
# max_num_proposal=8) and _tiny_batch(b=N, max_points=1024,
# caps=(1024, 512))
TINY_MODEL = dict(m=4, blocks=(1, 2), cluster_blocks=(1, 2),
                  clusters_per_pass=8, max_num_proposal=8,
                  cluster_npoint_thre=30, test_npoint_thresh=30,
                  test_score_thresh=0.0, cluster_ring=1,
                  cluster_cell_size=0.03, cluster_prop_iters=4)
TINY_SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
                  floor_points=1000, room=4.0)
TINY_SPEC = dict(max_points=1024, voxel_caps=[1024, 512], max_instances=8,
                 use_multiview=False)


def tiny_joint_cfg(n: int) -> cfg_lib.Config:
    """conf/cpu/joint.yaml shrunk to dry-run scale (no pretrained weights),
    a global batch of ``n`` scenes."""
    cfg = cfg_lib.load(os.path.join(_ROOT, "conf", "cpu", "joint.yaml"))
    cfg.data["batch_size"] = n
    cfg.data["max_num_point"] = 1024
    cfg.data["num_des_per_scene"] = 2
    cfg.data["max_spk_len"] = 8
    cfg.data.synthetic["num_scenes"] = n
    cfg.data.synthetic["num_val_scenes"] = 2
    cfg.data.synthetic["num_instances"] = 3
    cfg.data.synthetic["points_per_instance"] = 300
    cfg.data.synthetic["floor_points"] = 400
    cfg.tpu["voxel_caps"] = [1024, 512]
    cfg.tpu["clusters_per_pass"] = 8
    cfg.model["blocks"] = [1, 2]
    cfg.model["cluster_blocks"] = [1, 2]
    cfg.model["m"] = 4
    cfg.model["max_num_proposal"] = 8
    cfg.model["num_graph_steps"] = 1
    cfg.model["num_locals"] = 4
    for k in ("pretrained_detector", "pretrained_speaker",
              "pretrained_listener"):
        cfg.model._data.pop(k, None)
    cfg.train["beam_size"] = 2
    cfg.train["sample_topn"] = 2
    return cfg


def detector_step(n: int, dev: torch.device) -> Dict[str, float]:
    """One detector train step of the tiny model on this rank's rows of a
    global batch of ``n`` scenes: its global metrics."""
    from d3net_tpu_torch.data.collate import (
        BatchSpec, batch_to_torch, build_batch,
    )
    from d3net_tpu_torch.data.synthetic import make_scene
    from d3net_tpu_torch.models.pointgroup import PointGroup
    from d3net_tpu_torch.train.loop import init_detector
    from d3net_tpu_torch.train.trainer import (
        create_train_state, detector_train_step,
    )

    scenes = [make_scene(seed=i, **TINY_SCENE) for i in range(n)]
    batch_np = mesh.shard_host_batch(build_batch(scenes,
                                                 BatchSpec(**TINY_SPEC)))
    in_ch = batch_np["point_feats"].shape[-1] + 3
    model = init_detector(PointGroup(in_ch, **TINY_MODEL), 0).to(dev)
    state = create_train_state(model, lr=1e-3, steps_per_epoch=10)
    gen = torch.Generator(device=dev).manual_seed(1)
    _, metrics = detector_train_step(state, batch_to_torch(batch_np, dev),
                                     gen)
    return {k: float(v) for k, v in metrics.items()}


def joint_step(n: int, dev: torch.device) -> Dict[str, float]:
    """One two-phase joint RL step (rollout, host CIDEr over the global
    batch, teacher-forced grad step) of ``tiny_joint_cfg(n)`` on this
    rank's rows, both streams on the loader's first batch: its global
    metrics."""
    from d3net_tpu_torch.data.collate import batch_to_torch
    from d3net_tpu_torch.data.language import build_lang_batch
    from d3net_tpu_torch.params import flax_to_state_dict, init_flax_variables
    from d3net_tpu_torch.train import pipeline as pl
    from d3net_tpu_torch.train.loop import make_dataloaders, spec_from_cfg
    from d3net_tpu_torch.train.trainer import create_train_state

    cfg = tiny_joint_cfg(n)
    vocab, emb = pl.build_vocab(cfg)
    model = pl.pipeline_from_cfg(cfg, vocab)
    model.load_state_dict(flax_to_state_dict(
        init_flax_variables(model, 0), model))
    model.to(dev)
    spec = spec_from_cfg(cfg)
    train_it, _ = make_dataloaders(cfg, spec, return_scenes=True)
    batch_np, scenes = next(iter(train_it))
    chunk = int(cfg.data.num_des_per_scene)
    lang_np = build_lang_batch(
        scenes, vocab, chunk, cfg.data.max_spk_len,
        np.random.default_rng(cfg.general.manual_seed), spec.max_instances,
        num_refs=int(cfg.train.get("num_caption_refs", 1) or 1))
    batch = batch_to_torch(batch_np, dev)
    lang = pl.lang_rows(mesh.shard_host_batch(lang_np), emb, dev)
    state = create_train_state(model, lr=1e-4, steps_per_epoch=10)
    t = cfg.train
    _, metrics, _ = pl.joint_rl_train_step(
        state, batch, lang, batch, lang, pl.make_caption_reward_fn(vocab),
        torch.Generator(device=dev).manual_seed(5), chunk_size=chunk,
        loss_weight=tuple(t.loss_weight[:4]), beam_size=int(t.beam_size),
        sample_topn=int(t.sample_topn),
        ref_reward_weight=t.ref_reward_weight,
        lang_reward_weight=t.lang_reward_weight,
        listener_reward_weight=t.listener_reward_weight,
        caption_reward_weight=t.caption_reward_weight,
        xe_weight=float(t.get("rl_xe_weight", 0.0) or 0.0))
    return {k: float(v) for k, v in metrics.items()}


def dryrun_rank(n: int, on_cuda: bool) -> Dict[str, Dict[str, float]]:
    """This rank's two steps (a ``mesh.spawn`` worker), on its current CUDA
    device or the CPU."""
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_cuda
           else torch.device("cpu"))
    return {"det": detector_step(n, dev), "joint": joint_step(n, dev)}


def dryrun_multichip(n: int, devices: Optional[Sequence[str]] = None,
                     backend: Optional[str] = None,
                     threads: Optional[int] = None) -> Dict[str, Dict]:
    """Both steps over ``n`` ranks, rank ``r`` on ``devices[r]`` (default:
    one card each, over NCCL; ``devices=None`` with ``backend="gloo"``:
    CPU processes); prints the JAX dry run's two lines and returns rank
    0's metrics. Raises on a non-finite loss."""
    if devices is None and backend != "gloo":
        devices = [f"cuda:{i}" for i in range(n)]
    on_cuda = devices is not None and torch.device(devices[0]).type == "cuda"
    return report(n, mesh.spawn(
        dryrun_rank, n, n, on_cuda,
        backend=backend or ("nccl" if on_cuda else "gloo"),
        devices=devices, threads=threads)[0])


def report(n: int, res: Dict[str, Dict[str, float]]
           ) -> Dict[str, Dict[str, float]]:
    """Rank 0's ``dryrun_rank`` result of ``n`` ranks: raises on a
    non-finite loss, prints the JAX dry run's two lines, returns it."""
    total = res["det"]["total_loss"]
    if not np.isfinite(total):
        raise AssertionError("non-finite loss in multichip dry-run")
    print(f"dryrun_multichip({n}) OK: total_loss={total:.4f}")
    jtotal = res["joint"]["loss"]
    if not np.isfinite(jtotal):
        raise AssertionError("non-finite loss in joint-RL multichip dry-run")
    print(f"dryrun_multichip({n}) joint-RL OK: loss={jtotal:.4f} "
          f"cap_rwd={res['joint']['cap_rwd']:.4f}")
    return res


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="gloo processes on the CPU")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("the dry run runs on CUDA cards by default and "
                           "none is available; pass --cpu")
    n = args.ranks or (2 if args.cpu else torch.cuda.device_count())
    dryrun_multichip(n, backend="gloo" if args.cpu else None,
                     threads=max(1, (os.cpu_count() or 1) // n) if args.cpu
                     else None)


if __name__ == "__main__":
    main()
