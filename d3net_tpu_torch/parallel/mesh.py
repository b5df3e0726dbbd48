"""Data-parallel training across processes: the global batch over ranks.

Counterpart of ``d3net_tpu/parallel/mesh.py``. There, one ``jax.sharding.
Mesh`` shards the batch's leading axis over every device and GSPMD makes
every batch-coupled reduction global. Here each rank is one process with
one card (or one CPU process under gloo, for the tests) holding rows
``[r·B/N, (r+1)·B/N)`` of the global batch, and the same reductions are
written as collectives:

- ``all_reduce_sum``: a differentiable all-reduce (forward and backward
  are ``SUM``). A loss term on rank ``r`` is its local masked sum over the
  *global* count (``global_count``, ``global_mean``), so the ranks' terms
  add up to JAX's global loss; the gradients are then summed
  (``all_reduce_grads``), never averaged. A BatchNorm's statistics go
  through ``all_reduce_sum``, whose backward sums the ranks' upstream
  gradients, which is what the global-sum loss needs.
- Random draws are made at the global batch's shape from the same seeded
  generator on every rank, each rank keeping its rows (``draw_rows``,
  ``local_rows``), so world N draws what world 1 draws.
- ``roll_rows`` rolls the leading axis over the global batch (the
  listener's copy-paste takes the previous scene's proposals).
- Host arrays (the CIDEr reward's ids, barriers) and host objects (the
  evaluators' records, the metric dict) go through a gloo group beside
  the main one: NCCL takes only CUDA tensors.
- Evaluation splits every val batch as training does (``split_rows``).
  A short last batch the ranks cannot split evenly runs on rank 0 alone
  under ``local()`` (``eval_rows``), so no scene is dropped or repeated
  and every split batch holds as many rows on each rank (``global_mean``
  assumes it). The evaluators' per-scene records are gathered to rank 0
  in the global scene order (``gather_records``) and its metric dict
  broadcast back (``broadcast_from_main``).

The process group is process-wide state in ``torch.distributed``; the
module keeps the group of the step's collectives beside it. With no group
(one card, ``--cpu``, every path before this module existed), every
function here is the identity or the local reduction, and the models and
losses run exactly their single-process code. ``local()`` suspends the
group (validation on rank 0 while the others wait).

``spawn`` starts one process per rank, rendezvousing through a file in a
temporary directory (no fixed port, so concurrent runs do not collide);
``init_multihost`` joins a group an external launcher (``torchrun``)
describes in the environment.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
import traceback
import warnings
from typing import (
    Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from d3net_tpu_torch import trace

DEFAULT_TIMEOUT_S = 1800      # a collective that waits longer raises
BARRIER_TIMEOUT_S = 3600      # ranks waiting out rank 0's checkpoint write


class _Context:
    """The process's group for the step's collectives and its gloo twin for
    host arrays; ``suspended`` counts open ``local()`` blocks."""

    def __init__(self):
        self.group = None
        self.host = None
        self.rank = 0
        self.size = 1
        self.suspended = 0


_CTX = _Context()


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------

def setup(rank: int, world_size: int, init_method: str,
          backend: str = "gloo",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a group of ``world_size`` ranks as ``rank`` (``init_method``: a
    ``file://`` or ``tcp://`` rendezvous) and make it this process's; a
    gloo group for host arrays is made beside it. Raises if the group
    cannot be joined: nothing falls back to one process."""
    if _CTX.group is not None:
        raise RuntimeError("a process group is already set up")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    _CTX.group = dist.group.WORLD
    _CTX.host = (_CTX.group if backend == "gloo"
                 else dist.new_group(backend="gloo", timeout=timeout))
    _CTX.rank, _CTX.size = rank, world_size


def teardown() -> None:
    """Leave the group (no-op without one)."""
    if _CTX.group is None:
        return
    dist.destroy_process_group()
    _CTX.group = _CTX.host = None
    _CTX.rank, _CTX.size, _CTX.suspended = 0, 1, 0


def active() -> bool:
    """Whether the step's reductions run over a group (not inside
    ``local()``)."""
    return _CTX.group is not None and not _CTX.suspended


def world() -> int:
    """Ranks the global batch is split over (1 without an active group)."""
    return _CTX.size if active() else 1


def rank() -> int:
    """This rank's index in the active group (0 without one)."""
    return _CTX.rank if active() else 0


def is_main() -> bool:
    """Whether this process writes the run dir: rank 0, or no group."""
    return _CTX.rank == 0


@contextlib.contextmanager
def local() -> Iterator[None]:
    """Run the block on this rank's tensors alone: no collective, local
    counts and draws (a val batch rank 0 runs alone, ``eval_rows``)."""
    _CTX.suspended += 1
    try:
        yield
    finally:
        _CTX.suspended -= 1


def barrier(timeout_s: float = BARRIER_TIMEOUT_S) -> None:
    """Every rank waits here (gloo's monitored barrier: a rank that does not
    arrive within ``timeout_s`` raises on the others); no-op without a
    group."""
    if _CTX.group is not None:
        _dist("monitored_barrier", group=_CTX.host,
              timeout=datetime.timedelta(seconds=timeout_s))


def init_multihost() -> Dict[str, int]:
    """Join the group an external launcher describes (``torchrun`` sets
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``): NCCL when a card is visible, one card a process
    (``LOCAL_RANK``), else gloo. A no-op when ``WORLD_SIZE`` is unset or 1.
    Returns the JAX function's summary: process index and count, local and
    global device counts."""
    n = int(os.environ.get("WORLD_SIZE", "1") or 1)
    cuda = torch.cuda.is_available()
    if n > 1 and _CTX.group is None:
        r = int(os.environ["RANK"])
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        setup(r, n, "env://", "nccl" if cuda else "gloo")
    local_devices = torch.cuda.device_count() if cuda else 1
    return {"process_index": _CTX.rank, "process_count": _CTX.size,
            "local_devices": local_devices,
            "global_devices": _CTX.size if _CTX.size > 1 else local_devices}


def make_mesh(batch_size: int, device_count: Optional[int] = None) -> int:
    """The usable world size: the largest count of the visible cards (or
    ``device_count``) that divides ``batch_size``, as the JAX function
    clamps its mesh. Unlike JAX, it warns, naming the cards it leaves idle.
    Under a group an external launcher made, the world size is fixed: a
    batch it does not divide raises."""
    if _CTX.group is not None:
        if batch_size % _CTX.size:
            raise ValueError(
                f"data.batch_size {batch_size} does not split over the "
                f"launcher's {_CTX.size} ranks; use a multiple of "
                f"{_CTX.size} or launch fewer processes")
        return _CTX.size
    n_dev = (torch.cuda.device_count() if device_count is None
             else int(device_count))
    n = max(1, n_dev)
    while n > 1 and batch_size % n:
        n -= 1
    if n < n_dev:
        idle = ", ".join(f"cuda:{i}" for i in range(n, n_dev))
        warnings.warn(
            f"data.batch_size {batch_size} does not split over {n_dev} "
            f"cards: training on {n}, leaving {idle} idle", stacklevel=2)
    return n


def run_world(batch_size: int, dev: torch.device,
              world_size: Optional[int] = None) -> int:
    """The ranks a run (training or an eval) on ``dev`` starts: 1 inside a
    process group (this process is one of its ranks already);
    ``world_size`` where given (one that does not divide ``batch_size``
    raises); else every usable card on CUDA (``make_mesh``) and 1 on the
    CPU."""
    if active():
        return 1
    if world_size is None:
        return make_mesh(batch_size) if dev.type == "cuda" else 1
    if batch_size % world_size:
        raise ValueError(f"data.batch_size {batch_size} does not split "
                         f"over {world_size} ranks")
    return int(world_size)


def spawn_ranks(fn: Callable[..., Any], world_size: int, *args,
                dev: torch.device, threads: Optional[int] = None
                ) -> List[Any]:
    """``spawn`` of ``fn(*args)`` over ``world_size`` ranks on ``dev``'s
    kind: one NCCL process a card (``cuda:0``..) on CUDA, gloo processes
    of ``threads`` threads each on the CPU."""
    cuda = dev.type == "cuda"
    return spawn(fn, world_size, *args, backend="nccl" if cuda else "gloo",
                 devices=[f"cuda:{i}" for i in range(world_size)] if cuda
                 else None, threads=threads)


# ---------------------------------------------------------------------------
# collectives of the step
# ---------------------------------------------------------------------------

def _dist(op: str, *args, **kw):
    """``torch.distributed.<op>(*args, **kw)`` as the span ``dist.<op>``,
    counted in ``collectives`` and, by the bytes of its first tensor
    argument, ``collective_bytes``."""
    with trace.span("dist." + op):
        if trace.enabled():
            trace.count("collectives")
            t = next((a for a in args if torch.is_tensor(a)), None)
            if t is not None:
                trace.count("collective_bytes", t.numel() * t.element_size())
        return getattr(dist, op)(*args, **kw)


class _AllReduceSum(torch.autograd.Function):
    """``dist.all_reduce(SUM)``, forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _dist("all_reduce", y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist("all_reduce", g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of ``x``, differentiable: the gradient is the Σ over
    ranks of the upstream gradients. ``x`` itself without a group."""
    if not active():
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllReduceSum.apply(x, _CTX.group)
    y = x.detach().contiguous().clone()
    _dist("all_reduce", y, group=_CTX.group)
    return y


def global_count(x: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of a count (a mask's sum), no gradient."""
    return all_reduce_sum(x.detach()) if active() else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over the global batch: ``x.sum()`` over
    the global element count (every rank holds as many rows);
    ``x.mean()`` without a group."""
    if not active():
        return x.mean()
    return x.sum() / (x.numel() * _CTX.size)


def local_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``n`` rows of ``x`` when ``x`` holds the global batch's
    rows (``n``·world of them); ``x`` otherwise (already local, or a
    draw shared by every row)."""
    if not active() or x.shape[0] != n * _CTX.size:
        return x
    return x[_CTX.rank * n:(_CTX.rank + 1) * n]


def draw_rows(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``draw(rows)`` made at the global batch's row count, this rank's
    ``n`` rows kept: every rank draws the same bits from the same
    generator, as world 1 does."""
    if not active():
        return draw(n)
    return local_rows(draw(n * _CTX.size), n)


def roll_rows(x: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, 1, 0)`` over the global batch's rows: this rank's
    first row becomes the previous rank's last (differentiable)."""
    if not active():
        return torch.roll(x, 1, dims=0)
    w, r = _CTX.size, _CTX.rank
    last = x[-1:]
    pad = x.new_zeros((1,) + tuple(x.shape[1:]))
    every = all_reduce_sum(torch.cat([pad] * r + [last] + [pad] * (w - r - 1)))
    return torch.cat([every[(r - 1) % w][None], x[:-1]], dim=0)


def all_reduce_grads(params: Sequence[nn.Parameter]) -> None:
    """Sum every ``p.grad`` over the ranks in place, one collective a dtype
    and device (each rank's gradient is its share of the global loss's)."""
    if not active():
        return
    groups: Dict[Any, List[torch.Tensor]] = {}
    for p in params:
        groups.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in groups.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        _dist("all_reduce", flat, group=_CTX.group)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def sum_metrics(metrics: Dict[str, torch.Tensor],
                replicated: Sequence[str] = ("grad_norm",)
                ) -> Dict[str, torch.Tensor]:
    """The global values of a step's metrics: each rank's share summed in
    one collective; the ``replicated`` keys (equal on every rank already)
    pass through."""
    if not active():
        return metrics
    keys = [k for k in metrics if k not in replicated]
    if keys:
        vec = torch.stack([metrics[k].detach().float() for k in keys])
        _dist("all_reduce", vec, group=_CTX.group)
        metrics = dict(metrics)
        metrics.update(zip(keys, vec.unbind()))
    return metrics


def host_all_gather(a: np.ndarray) -> np.ndarray:
    """Every rank's ``a`` (same shape and dtype on each), concatenated in
    rank order along axis 0, through the gloo group; ``a`` without a
    group."""
    if not active():
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(_CTX.size)]
    _dist("all_gather", parts, t, group=_CTX.host)
    return np.concatenate([p.numpy() for p in parts], axis=0)


def _broadcast(t: torch.Tensor) -> None:
    """Rank 0's ``t`` in place on every rank; a host tensor under NCCL goes
    through the gloo group."""
    nccl = dist.get_backend(_CTX.group) == "nccl"
    _dist("broadcast", t, 0, group=_CTX.host if nccl and not t.is_cuda
          else _CTX.group)


def replicate(model: nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank
    (broadcast in place, in parameter order); no-op without a group."""
    if not active():
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            _broadcast(t.data)
        if optimizer is not None:
            for g in optimizer.param_groups:
                for p in g["params"]:
                    for v in optimizer.state.get(p, {}).values():
                        if torch.is_tensor(v):
                            _broadcast(v)


def gather_to_main(obj: Any) -> Optional[List[Any]]:
    """Every rank's picklable ``obj`` on rank 0, in rank order, through the
    gloo group; None on the other ranks; ``[obj]`` without a group."""
    if not active():
        return [obj]
    out = [None] * _CTX.size if _CTX.rank == 0 else None
    _dist("gather_object", obj, out, dst=0, group=_CTX.host)
    return out


def broadcast_from_main(obj: Any) -> Any:
    """Rank 0's picklable ``obj`` on every rank, through the gloo group;
    ``obj`` without a group."""
    if not active():
        return obj
    box = [obj]
    _dist("broadcast_object_list", box, src=0, group=_CTX.host)
    return box[0]


def merge_ordered(parts: Sequence[Sequence[Tuple[int, Any]]]) -> List[Any]:
    """The records of ``parts`` (each rank's ``(batch, record)`` pairs, in
    rank order) in the global scene order: batch by batch, rank 0's rows
    first, each rank's records in the order it added them. So a merge
    holds the records in the order one process adds them."""
    merged = [pair for part in parts for pair in part]
    merged.sort(key=lambda pair: pair[0])     # stable: rank order kept
    return [record for _, record in merged]


def gather_ordered(pairs: Sequence[Tuple[int, Any]]) -> Optional[List[Any]]:
    """This rank's ``(batch, record)`` pairs -> every rank's records on
    rank 0 in the global scene order (``merge_ordered``), None on the other
    ranks; without a group, this rank's records in that order."""
    parts = gather_to_main(list(pairs))
    return None if parts is None else merge_ordered(parts)


def gather_records(*holders: Any) -> bool:
    """Each holder's records on rank 0, in one host gather, in the global
    scene order (``merge_ordered``). A holder (an evaluator) hands its
    ``(batch, record)`` pairs over with ``records()`` and takes the merged
    records with ``load_records(records)``. Returns whether this rank holds
    every rank's records: rank 0, or any rank without a group (nothing
    moves then)."""
    if not active():
        return True
    parts = gather_to_main([h.records() for h in holders])
    if parts is None:
        return False
    for i, h in enumerate(holders):
        h.load_records(merge_ordered([p[i] for p in parts]))
    return True


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def split_rows(b: int, rank_: Optional[int] = None,
               world_size: Optional[int] = None) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a batch of ``b`` rows that rank ``rank_`` of
    ``world_size`` (default: the active group's) runs: ``[r·b/w,
    (r+1)·b/w)`` where ``w`` divides ``b``; where it does not (a short last
    val batch), all of them on rank 0 and none on the others."""
    r = rank() if rank_ is None else rank_
    w = world() if world_size is None else world_size
    if b % w == 0:
        return r * b // w, (r + 1) * b // w
    return (0, b) if r == 0 else (0, 0)


@contextlib.contextmanager
def eval_rows(split: bool) -> Iterator[bool]:
    """The context of one val batch; yields whether this rank runs any of
    it. A batch the ranks ``split`` (``split_rows``) runs on every rank's
    rows with the group active, so its losses' normalisers are global; one
    they do not runs on rank 0 alone under ``local()``. Without an active
    group every batch is this rank's."""
    if split or not active():
        yield True
    elif _CTX.rank == 0:
        with local():
            yield True
    else:
        yield False


def shard_batch(tree: Any, rank_: int, world_size: int) -> Any:
    """Rows ``[r·B/N, (r+1)·B/N)`` of every array of a batch tree (dicts,
    lists, numpy arrays or tensors with the batch leading)."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, rank_, world_size) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shard_batch(v, rank_, world_size) for v in tree]
    n = tree.shape[0] // world_size
    if n * world_size != tree.shape[0]:
        raise ValueError(f"a batch of {tree.shape[0]} rows does not split "
                         f"over {world_size} ranks")
    return tree[rank_ * n:(rank_ + 1) * n]


def shard_host_batch(tree: Any) -> Any:
    """This rank's rows of a global host batch (``shard_batch`` at the
    active group's rank and size; the tree itself without a group)."""
    if not active():
        return tree
    return shard_batch(tree, _CTX.rank, _CTX.size)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def spawn(fn: Callable[..., Any], world_size: int, *args,
          backend: str = "gloo", devices: Optional[Sequence[str]] = None,
          threads: Optional[int] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` new processes, one rank each,
    joined in one group (``backend``; rank ``r`` on ``devices[r]`` when
    given, made its current CUDA device; ``threads`` torch, OpenMP and BLAS
    threads each).
    Returns every rank's return value, in rank order. ``fn`` must be a
    module-level function of an importable module (the spawned processes
    import it). If a rank raises, the others are stopped and a
    RuntimeError here carries every failed rank's traceback, the earliest
    first."""
    # the ranks' OpenMP and BLAS pools are sized from the environment at
    # their start (idle pool threads spin, and ranks share the cores)
    pools = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in pools}
    if threads:
        os.environ.update({k: str(int(threads)) for k in pools})
    try:
        with tempfile.TemporaryDirectory(prefix="d3net_dist_") as tmp:
            try:
                torch.multiprocessing.spawn(
                    _rank_main, args=(fn, world_size, backend, devices,
                                      threads, timeout_s, tmp, args),
                    nprocs=world_size, join=True)
            except Exception as e:
                # the first rank the join saw may be one the failed rank
                # took down (a peer's closed connection): report each
                # rank's error, the earliest first
                raise RuntimeError("ranks failed:\n" + _rank_errors(tmp)) \
                    from e
            return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(world_size)]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(r: int, fn, world_size: int, backend: str, devices,
               threads, timeout_s: float, tmp: str, args) -> None:
    if threads:
        torch.set_num_threads(int(threads))
    if devices is not None:
        dev = torch.device(devices[r])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    setup(r, world_size, f"file://{os.path.join(tmp, 'rendezvous')}",
          backend, timeout_s)
    try:
        out = fn(*args)
        part = os.path.join(tmp, f"rank{r}.pt.tmp")
        torch.save(out, part)
        os.replace(part, os.path.join(tmp, f"rank{r}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{r}.txt"), "w") as f:
            f.write(f"{time.time()!r}\nrank {r}: {traceback.format_exc()}")
        raise
    finally:
        teardown()


def _rank_errors(tmp: str) -> str:
    """The tracebacks the ranks wrote, the earliest first."""
    errors = []
    for name in os.listdir(tmp):
        if name.startswith("error"):
            with open(os.path.join(tmp, name)) as f:
                stamp, text = f.read().split("\n", 1)
            errors.append((float(stamp), text))
    return "\n".join(text for _, text in sorted(errors))
