"""Faults planted under the timed path, for the tests that see
``correct`` come out false. Each is a module-level function so a spawned
rank can plant it too."""

from __future__ import annotations

import torch

from perfbench.drivers import det_train
from perfbench.harness import bench


def _rows(tree, n):
    if isinstance(tree, dict):
        return {k: _rows(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, n) for v in tree]
    return tree[:n]


def plant(monkeypatch_setattr, fault: str) -> None:
    """Plant ``fault`` in the detector driver's path
    (``monkeypatch_setattr(obj, name, value)``)."""
    real = det_train.detector_train_step
    if fault == "unchanged":
        def step(state, batch, generator=None, **kw):
            # the forward and loss run; nothing is updated
            with torch.no_grad():
                from d3net_tpu_torch.train.losses import detector_loss

                out = state.model(batch, train=True, generator=generator)
                losses = detector_loss(out, batch,
                                       loss_weight=kw.get("loss_weight",
                                                          (1.0,) * 4))
            m = {k: v.detach() for k, v in losses.items()}
            m["grad_norm"] = torch.zeros(())
            return state, m
    elif fault == "half_batch":
        def step(state, batch, generator=None, **kw):
            b = batch["point_mask"].shape[0]
            return real(state, _rows(batch, max(1, b // 2)), generator, **kw)
    elif fault == "altered_token":
        from d3net_tpu_torch.models.caption import CaptionModule

        decode = CaptionModule.greedy_decode

        def altered(self, *a, **kw):
            ids, logits = decode(self, *a, **kw)
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % logits.shape[-1]   # one token
            return ids, logits

        monkeypatch_setattr(CaptionModule, "greedy_decode", altered)
        return
    elif fault == "wrong_offsets":
        from d3net_tpu_torch.models.pointgroup import PointGroup

        heads = PointGroup.heads

        def wrong(self, *a, **kw):
            sem, off = heads(self, *a, **kw)
            return sem, off * 1.5       # an offset head that overshoots
        monkeypatch_setattr(PointGroup, "heads", wrong)
        return
    elif fault == "wrong_objectness":
        from d3net_tpu_torch.models.scorenet import ScoreNet

        score = ScoreNet.forward

        def wrong(self, *a, **kw):
            scores, pooled = score(self, *a, **kw)
            return scores + 1.0, pooled  # a biased objectness logit
        monkeypatch_setattr(ScoreNet, "forward", wrong)
        return
    elif fault == "wrong_graph":
        from d3net_tpu_torch.models.graph import GraphModule

        graph = GraphModule.forward

        def wrong(self, data):
            out = graph(self, data)
            # a graph that skips its last message
            return dict(out, bbox_feature=out["bbox_feature"] * 0.9)
        monkeypatch_setattr(GraphModule, "forward", wrong)
        return
    elif fault == "no_exchange":
        from d3net_tpu_torch.parallel import mesh

        monkeypatch_setattr(mesh, "all_reduce_grads", lambda params: None)
        return
    else:
        raise ValueError(fault)
    monkeypatch_setattr(det_train, "detector_train_step", step)


def faulty_rank(rank, world, args, port, cell, fault, device="cpu"):
    """A spawned rank with ``fault`` planted."""
    plant(setattr, fault)
    return bench.run_rank(rank, world, args, port, 0.0, cell, device)


def run_world(cell, world: int, args, fault=None, device="cpu"):
    """``cell`` over ``world`` ranks as the harness runs a multi-card cell
    (rank 0 here, the others spawned; gloo on the CPU, or with ``device``
    None one card a rank under NCCL), ``fault`` planted on every rank;
    rank 0's result."""
    import torch.multiprocessing as mp

    port = bench._free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=faulty_rank if fault else bench._rank_entry,
                         args=((r, world, args, port, cell, fault, device)
                               if fault
                               else (r, world, args, port, cell, device)))
             for r in range(1, world)]
    for p in procs:
        p.start()
    undo = []
    try:
        if fault:
            def setter(obj, name, value):
                undo.append((obj, name, getattr(obj, name)))
                setattr(obj, name, value)
            plant(setter, fault)
        return bench.run_rank(0, world, args, port, 0.0, cell, device)
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.terminate()
