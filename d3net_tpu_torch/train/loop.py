"""Training orchestration for the detector: epochs, validation,
checkpoints, logging.

Counterpart of ``d3net_tpu/train/loop.py`` (the detector loop and its
scan trainer, ``run_detector_training_scan``), with the same run-dir
layout and semantics:

- ``config.yaml`` (the merged config), ``run_meta.json`` (git SHA, config
  hash, time; here also the framework and the conv layout that ran),
  ``metrics.jsonl`` (one ``{"step", "train/<k>" | "val/<k>"}`` record per
  log line) and, with ``log.tensorboard: true``, TensorBoard scalars under
  ``tb/`` (``torch.utils.tensorboard``, imported only then).
- ``ckpt/<step>/state.pt`` keeps the last 3 saves; ``ckpt_best/<step>/``
  pins the best by the monitor and ``ckpt_best/best.json`` carries it over
  a resume. A checkpoint is one ``torch.save`` of the model ``state_dict``
  (BN running statistics included), the optimizer and scheduler state and
  the step, read back with ``weights_only=True``.
- ``log.profile_step: k`` traces the three train steps after the k-th
  with ``torch.profiler`` into ``profile/trace.json`` (a Chrome trace).

A step's cluster jitter and proposal shuffle come from a ``torch.Generator``
seeded by ``(manual_seed + 1, step)`` (JAX folds the step into its key), so
a resumed run draws what the uninterrupted run would have drawn. As in the
JAX loop, a resumed run restarts its epoch count, and its data order, at 0.

The batch tables are always the gather layout (``conv_impl`` "gather");
the column/colres values a config may ask for are TPU tilings of the same
conv and are only recorded in ``run_meta.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from d3net_tpu_torch import trace
from d3net_tpu_torch.config import Config, save as save_cfg
from d3net_tpu_torch.data.collate import CAP_STATS, BatchSpec, batch_to_torch
from d3net_tpu_torch.data.dataset import (
    BatchIterator, MultiviewAttached, SyntheticScenes,
)
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.params import flax_to_state_dict, init_flax_variables
from d3net_tpu_torch.train.trainer import (
    TrainState, create_train_state, detector_eval_step, detector_train_step,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_fingerprint(cfg: Optional[Config] = None) -> Dict[str, str]:
    """Provenance stamp for run artifacts: git SHA + config hash + time."""
    sha = "unknown"
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=_ROOT, timeout=10).stdout.strip() or "unknown"
    except Exception:
        pass
    out = {"git_sha": sha, "time": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if cfg is not None:
        try:
            blob = json.dumps(cfg.to_dict(), sort_keys=True, default=str)
            out["config_hash"] = hashlib.sha256(blob.encode()).hexdigest()[:16]
        except Exception:
            pass
    return out


def write_run_meta(run_dir: str, cfg: Optional[Config] = None,
                   extra: Optional[Dict[str, Any]] = None) -> None:
    """``run_meta.json`` (rank 0 alone writes under a process group). A run
    dir imported from the JAX package keeps its ``imported_from`` and
    ``jax_run_meta`` through every later start."""
    if not mesh.is_main():
        return
    path = os.path.join(run_dir, "run_meta.json")
    kept = {}
    if os.path.exists(path):
        with open(path) as f:
            kept = {k: v for k, v in json.load(f).items()
                    if k in ("imported_from", "jax_run_meta")}
    with open(path, "w") as f:
        json.dump({**run_fingerprint(cfg), **kept, **(extra or {})}, f,
                  indent=2)


class MetricLogger:
    """JSONL + (optional) TensorBoard scalar logging.

    The TensorBoard writer is opt-in (``log.tensorboard: true`` in the run
    loop): ``torch.utils.tensorboard`` imports TensorFlow where it is
    installed, which takes seconds; without the package it stays off.

    One training history per file: call :meth:`begin` after checkpoint
    restore — if the existing ``metrics.jsonl`` already holds steps past the
    restored step (a divergent older history), it is rotated away instead
    of interleaved.
    """

    def __init__(self, run_dir: str, tensorboard: bool = False):
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._tb = None
        if tensorboard and mesh.is_main():
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                pass

    def begin(self, start_step: int) -> None:
        """Rotate an existing log whose history extends past start_step."""
        if not mesh.is_main() or not os.path.exists(self.path):
            return
        last = -1
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        last = max(last, int(json.loads(line).get("step", -1)))
        except Exception:
            return
        if last > start_step:
            dst = f"{self.path}.upto{last}"
            i = 0
            while os.path.exists(dst):
                i += 1
                dst = f"{self.path}.upto{last}.{i}"
            os.rename(self.path, dst)
            print(f"rotated stale metrics history (last step {last} > "
                  f"restored {start_step}) -> {os.path.basename(dst)}")

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        """One record (rank 0 alone writes under a process group)."""
        if not mesh.is_main():
            return
        rec = {"step": int(step),
               **{f"{prefix}/{k}": float(v) for k, v in scalars.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
            self._tb.flush()


class StepDir:
    """``root/<step>/state.pt`` per saved step; beyond ``max_to_keep`` the
    oldest steps are deleted. A save is written to a temporary file and
    renamed, so a step directory never holds half a checkpoint."""

    FILE = "state.pt"

    def __init__(self, root: str, max_to_keep: int):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.root) if d.isdigit()
                      and os.path.exists(os.path.join(self.root, d, self.FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> None:
        d = os.path.join(self.root, str(int(step)))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, self.FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(d, self.FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, str(old)))

    def restore(self, step: int) -> Dict[str, Any]:
        """The payload of ``step``, read onto the host: ``load_state_dict``
        copies each entry to its parameter's device, and an optimizer keeps
        its step counts where it keeps them (the host for Adam)."""
        return torch.load(os.path.join(self.root, str(int(step)), self.FILE),
                          map_location="cpu", weights_only=True)


class Checkpointer:
    """Best + last checkpoints with the reference's monitor semantics.

    ``ckpt/`` rotates the last 3 saves while ``ckpt_best/`` pins the single
    best step: it is saved only on monitor improvement and never rotated
    away by later saves. The best value survives a resume via
    ``best.json``. Under a process group every rank calls ``save``; rank 0
    alone decides the best and writes.
    """

    def __init__(self, run_dir: str, monitor: str, mode: str = "min"):
        self.restored_from: Optional[Dict] = None  # set by every restore
        root = os.path.abspath(run_dir)
        self.mgr = StepDir(os.path.join(root, "ckpt"), max_to_keep=3)
        self.best_mgr = StepDir(os.path.join(root, "ckpt_best"), max_to_keep=1)
        self._best_meta = os.path.join(root, "ckpt_best", "best.json")
        self.monitor = monitor
        self.mode = mode
        self.best = np.inf if mode == "min" else -np.inf
        self.best_step: Optional[int] = None
        if os.path.exists(self._best_meta):
            try:
                with open(self._best_meta) as f:
                    meta = json.load(f)
                self.best = float(meta["value"])
                self.best_step = int(meta["step"])
            except Exception:
                pass

    def is_better(self, value: float) -> bool:
        return value < self.best if self.mode == "min" else value > self.best

    @staticmethod
    def _payload(state: TrainState) -> Dict[str, Any]:
        return {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": int(state.step)}

    def save(self, step: int, state: TrainState, metrics: Dict[str, float]):
        """Checkpoint ``step`` and, where ``metrics`` improve the monitor,
        pin it as the best. Under a process group rank 0 alone decides and
        writes (the other ranks' ``best`` stays as restored) and every rank
        leaves once the files are on disk (a barrier). The ``ckpt.save``
        span."""
        with trace.span("ckpt.save", id=step):
            if mesh.is_main():
                value = metrics.get(self.monitor)
                payload = self._payload(state)
                self.mgr.save(step, payload)
                if value is not None and self.is_better(value):
                    self.best = float(value)
                    self.best_step = step
                    self.best_mgr.save(step, payload)
                    with open(self._best_meta, "w") as f:
                        json.dump({"step": step, "value": self.best,
                                   "monitor": self.monitor,
                                   "mode": self.mode}, f)
            mesh.barrier()

    def _restore(self, kind: str, mgr: StepDir,
                 state: TrainState) -> Optional[TrainState]:
        """The whole state of ``mgr``'s latest step, loaded into ``state``
        in place."""
        step = mgr.latest_step()
        if step is None:
            return None
        raw = mgr.restore(step)
        state.model.load_state_dict(raw["model"])
        state.optimizer.load_state_dict(raw["optimizer"])
        state.scheduler.load_state_dict(raw["scheduler"])
        state.step = int(raw["step"])
        self.restored_from = {"kind": kind, "step": int(step)}
        return state

    def restore_last(self, state: TrainState) -> Optional[TrainState]:
        return self._restore("last", self.mgr, state)

    def restore_best(self, state: TrainState) -> Optional[TrainState]:
        return self._restore("best", self.best_mgr, state)

    def restore_weights(self, state: TrainState,
                        prefer_best: bool = True) -> Optional[TrainState]:
        """Model weights, BN statistics and step only (eval paths): works
        whatever optimizer the run used."""
        mgrs = [("best", self.best_mgr), ("last", self.mgr)] \
            if prefer_best else [("last", self.mgr)]
        for kind, mgr in mgrs:
            step = mgr.latest_step()
            if step is None:
                continue
            raw = mgr.restore(step)
            state.model.load_state_dict(raw["model"])
            state.step = int(raw["step"])
            self.restored_from = {"kind": kind, "step": int(step)}
            return state
        return None


def spec_from_cfg(cfg: Config) -> BatchSpec:
    """Batch layout from config, always with gather tables."""
    return BatchSpec(
        max_points=cfg.data.max_num_point,
        voxel_caps=list(cfg.tpu.voxel_caps),
        max_instances=cfg.data.max_num_instance,
        scale=cfg.data.scale,
        full_scale=float(cfg.data.full_scale[1]) if cfg.data.get("full_scale")
        else 512.0,
        use_color=cfg.model.use_color,
        use_normal=cfg.model.use_normal,
        use_multiview=cfg.model.use_multiview,
        num_levels=len(cfg.model.blocks),
        conv_impl="gather",
    )


def detector_cfg_dict(cfg: Config) -> Dict[str, Any]:
    """``PointGroup`` keyword arguments of the config (the JAX package's
    ``pipeline_loop.detector_cfg_dict``)."""
    return dict(
        m=cfg.model.m,
        classes=cfg.data.classes,
        blocks=tuple(cfg.model.blocks),
        cluster_blocks=tuple(cfg.model.cluster_blocks),
        block_reps=cfg.model.block_reps,
        block_residual=cfg.model.block_residual,
        use_coords=cfg.model.use_coords,
        max_num_proposal=cfg.model.max_num_proposal,
        cluster_radius=cfg.cluster.cluster_radius,
        cluster_cell_size=cfg.tpu.cluster_cell_size,
        cluster_ring=cfg.tpu.cluster_ring,
        cluster_npoint_thre=cfg.cluster.cluster_npoint_thre,
        cluster_prop_iters=cfg.tpu.cluster_prop_iters,
        clusters_per_pass=cfg.tpu.clusters_per_pass,
        score_fullscale=cfg.train.score_fullscale,
        score_scale=cfg.train.score_scale,
        test_score_thresh=cfg.test.TEST_SCORE_THRESH,
        test_npoint_thresh=cfg.test.TEST_NPOINT_THRESH,
        compute_dtype=cfg.tpu.get("activation_dtype"),
    )


def train_steps_per_epoch(cfg: Config, scan: bool = False) -> int:
    """The steps an epoch the config's run loop gives StepLR: the train
    loader's whole batches (``len(make_dataloaders(cfg, spec)[0])``, at
    least 1); with ``scan``, the scan trainer's stack's batches
    (``tpu.augment_variants`` such epochs when the transform is on)."""
    per_epoch = cfg.data.synthetic.num_scenes // cfg.data.batch_size
    if not scan:
        return max(1, per_epoch)
    tr = cfg.data.transform
    aug_on = bool(tr.jitter or tr.flip or tr.rot)
    n_var = max(1, int(cfg.tpu.get("augment_variants", 4))) if aug_on else 1
    return n_var * per_epoch


def optimizer_kw(cfg: Config, scan: bool = False) -> Dict[str, Any]:
    """``create_train_state``'s optimizer and StepLR keywords in the
    config's run loop (the scan trainer's, with ``scan``, passes no
    momentum, as the JAX one)."""
    o = cfg.train.optim
    kw = dict(lr=o.lr, optim=o.classname, weight_decay=o.weight_decay,
              step_epoch=cfg.train.step_epoch,
              multiplier=cfg.train.multiplier,
              steps_per_epoch=train_steps_per_epoch(cfg, scan))
    if not scan:
        kw["momentum"] = o.momentum
    return kw


def in_channels_from_cfg(cfg: Config) -> int:
    """The detector's input width: the batch layout's features plus xyz."""
    return spec_from_cfg(cfg).feat_dim() + 3 * bool(cfg.model.use_coords)


def detector_from_cfg(cfg: Config) -> PointGroup:
    """``PointGroup`` of the config, randomly initialised."""
    return PointGroup(in_channels_from_cfg(cfg), **detector_cfg_dict(cfg))


def init_detector(model: PointGroup, seed: int) -> PointGroup:
    """Random weights for ``model`` from ``seed`` (``params.
    init_flax_variables``: Flax's initializers, drawn with numpy)."""
    model.load_state_dict(flax_to_state_dict(
        init_flax_variables(model, seed), model))
    return model


def _scene_kw(cfg: Config) -> Dict[str, Any]:
    syn = cfg.data.synthetic
    return dict(
        num_instances=syn.num_instances,
        points_per_instance=syn.get("points_per_instance", 3000),
        floor_points=syn.floor_points,
        room=syn.room,
        with_multiview=bool(cfg.model.use_multiview),
        density=syn.get("density"),
        size_range=tuple(syn.get("size_range", (0.3, 1.2))),
    )


def num_val_scenes(cfg: Config) -> int:
    """The val split's size: ``D3NET_VAL_SCENES``, else the config's."""
    syn = cfg.data.synthetic
    return int(os.environ.get("D3NET_VAL_SCENES", 0)
               or syn.get("num_val_scenes", 0)
               or max(2, syn.num_scenes // 8))


def scenes_from_cfg(cfg: Config, split: str, num_scenes: int):
    """The synthetic scenes of ``split``, with the feature store of
    ``data.multiview_hdf5`` attached when the config names one (as JAX's
    ``make_dataloaders`` attaches its HDF5)."""
    scenes = SyntheticScenes(num_scenes, split, **_scene_kw(cfg))
    store = cfg.data.get("multiview_hdf5")
    return MultiviewAttached(scenes, store) if store else scenes


def make_val_loader(cfg: Config, spec: BatchSpec,
                    return_scenes: bool = False) -> BatchIterator:
    """The val split's iterator alone (the evals need no train scenes,
    which are made when their list is). Under a process group it collates
    this rank's rows of each val batch (``BatchIterator.splits``: a short
    last batch the ranks cannot split is rank 0's alone)."""
    return BatchIterator(
        scenes_from_cfg(cfg, "val", num_val_scenes(cfg)), spec,
        cfg.data.batch_size, shuffle=False, augment=False, seed=0,
        drop_last=False, return_scenes=return_scenes,
        workers=int(cfg.data.get("num_workers", 1) or 1),
        rank=mesh.rank(), world=mesh.world(),
    )


def make_dataloaders(cfg: Config, spec: BatchSpec, return_scenes: bool = False):
    """The train and val iterators of the config; under a process group
    each collates this rank's rows of its batches."""
    tr = cfg.data.transform
    train_it = BatchIterator(
        scenes_from_cfg(cfg, "train", cfg.data.synthetic.num_scenes), spec,
        cfg.data.batch_size,
        shuffle=True, augment=bool(tr.jitter or tr.flip or tr.rot),
        elastic=bool(cfg.data.get("elastic", False)),
        seed=cfg.general.manual_seed,
        return_scenes=return_scenes,
        workers=int(cfg.data.get("num_workers", 1) or 1),
        rank=mesh.rank(), world=mesh.world(),
    )
    return train_it, make_val_loader(cfg, spec, return_scenes)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step`` (0-based, before the update)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 32) + int(step))


def _arrays(tree):
    """The numpy arrays of a collated batch (its tables are a list of
    dicts)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _arrays(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _arrays(v)
    else:
        yield tree


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StepLoop:
    """The train steps of a run loop (``run_detector_training`` and the
    pipeline's ``run_pipeline_training``), one epoch per ``run_epoch``.

    An epoch's batches come from the host loader or, with
    ``tpu.cache_batches``, stay on the device: with augmentation the first
    ``tpu.augment_variants`` epochs are kept as independent augmented
    copies (the loader is epoch-seeded) and later epochs cycle them. Around
    the steps: the ``log.profile_step`` window, the train log every
    ``train.log_every_n_steps`` steps and ``max_steps``.

    ``on_step``, if given, is called after every train step with its timings,
    the stamps of its ``data.wait``, ``data.h2d`` and ``train.step`` spans
    (``trace``; seconds of Unix time): ``t_start`` when the loop asked for
    the batch, ``data_wait_s`` blocked on the batch iterator, ``h2d_s``
    copying the batch to the device (``h2d_bytes``), ``step_s`` in the
    step, ``wall_s`` all three. With ``sync_steps`` the loop waits for the
    device around each copy and at the end of each step, so each part's
    time includes its device work; without, the steps run as they do
    without ``on_step`` and each time ends when the host got past that
    part.
    """

    def __init__(self, cfg: Config, run_dir: str, dev: torch.device,
                 augment: bool, step: int, max_steps: Optional[int] = None,
                 on_step: Optional[Callable[[Dict], None]] = None,
                 sync_steps: bool = True):
        log_cfg = cfg.get("log")
        self.logger = MetricLogger(run_dir, tensorboard=bool(
            log_cfg is not None and log_cfg.get("tensorboard", False)))
        self.logger.begin(step)
        CAP_STATS.reset()       # the first log line counts this run's builds
        self.profile_at = int((log_cfg.get("profile_step", 0)
                               if log_cfg is not None and mesh.is_main()
                               else 0) or 0)
        self.prof = None
        self.cache_batches = bool(cfg.tpu.get("cache_batches", False))
        self.n_var = 1
        if self.cache_batches and augment:
            self.n_var = max(1, int(cfg.tpu.get("augment_variants", 2)))
        self.variant_epochs: List[list] = []
        self.log_every = cfg.train.log_every_n_steps
        self.run_dir, self.dev = run_dir, dev
        self.step, self.max_steps = step, max_steps
        self.on_step, self.sync_steps = on_step, sync_steps

    @property
    def done(self) -> bool:
        """Whether ``max_steps`` is reached."""
        return bool(self.max_steps and self.step >= self.max_steps)

    def run_epoch(self, epoch: int, train_it,
                  to_device: Callable[[Any], Tuple[Any, Any]],
                  train_step: Callable[[Any, int], Dict[str, torch.Tensor]],
                  log_extra: Optional[Callable[[], Dict[str, float]]] = None,
                  ) -> None:
        """The steps of one epoch, until ``train_it`` ends or ``max_steps``.
        ``to_device(item)`` turns a loader item into (its host arrays, the
        device batch); ``train_step(batch, step)`` runs the 0-based step
        ``step`` and returns its metrics; ``log_extra()`` adds to a train
        log line."""
        dev, on_step = self.dev, self.on_step
        caching = self.cache_batches and len(self.variant_epochs) < self.n_var
        from_host = not self.cache_batches or caching
        if from_host:
            items = iter(train_it)
            if caching:
                self.variant_epochs.append([])
        else:
            items = iter(self.variant_epochs[epoch % self.n_var])
        timed = on_step is not None
        while True:
            with trace.span("data.wait", timed=timed) as wait:
                item = next(items, None)
            if item is None:
                break
            h2d_bytes = 0
            with trace.span("data.h2d", id=wait.id):
                if from_host:
                    arrays, batch = to_device(item)
                    if timed:
                        h2d_bytes = sum(a.nbytes for a in _arrays(arrays))
                    if caching:
                        self.variant_epochs[-1].append(batch)
                else:
                    batch = item
                if timed and self.sync_steps:
                    _sync(dev)
            if self.profile_at and self.step == self.profile_at:
                self.prof = _start_profile(dev)
            with trace.span("train.step", id=wait.id, timed=True) as step:
                metrics = train_step(batch, self.step)
                if timed and self.sync_steps:
                    _sync(dev)
            self.step += 1
            if self.prof is not None and self.step == self.profile_at + 3:
                self.prof = _stop_profile(self.prof, dev, self.run_dir)
            if timed:
                on_step({"step": self.step, "epoch": epoch,
                         "t_start": wait.t0 * 1e-9,
                         "data_wait_s": wait.seconds,
                         "h2d_s": (step.t0 - wait.t1) * 1e-9,
                         "h2d_bytes": h2d_bytes, "step_s": step.seconds,
                         "wall_s": (step.t1 - wait.t0) * 1e-9})
            if self.step % self.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["iter_time"] = (trace.clock_ns() - step.t0) * 1e-9
                if log_extra is not None:
                    metrics.update(log_extra())
                self.logger.log(self.step, metrics, "train")
                if mesh.is_main():
                    print(f"epoch {epoch} step {self.step} " + " ".join(
                        f"{k}={v:.4f}" for k, v in metrics.items()))
            if self.done:
                break

    def finish(self) -> None:
        """Ends a profile window the run ended inside."""
        if self.prof is not None:
            self.prof = _stop_profile(self.prof, self.dev, self.run_dir)


def _cap_counters() -> Dict[str, float]:
    """Silent-truncation telemetry: the host cap counters since the last
    train log line (the run's start, for its first), summed over the ranks
    under a process group (each counts the rows it collates)."""
    counts = {k: v for k, v in CAP_STATS.reset().items() if k != "batches"}
    if mesh.active():
        keys = sorted(counts)
        every = mesh.host_all_gather(np.array([[counts[k] for k in keys]],
                                              dtype=np.int64))
        counts = dict(zip(keys, every.sum(0).tolist()))
    return counts


def setup_run(cfg: Config, run_dir: str) -> None:
    """The run dir and its ``config.yaml`` (rank 0 alone writes under a
    process group)."""
    os.makedirs(run_dir, exist_ok=True)
    if mesh.is_main():
        save_cfg(cfg, os.path.join(run_dir, "config.yaml"))


def run_meta_extra(dev: torch.device, cfg: Config) -> Dict[str, Any]:
    """The port's keys of ``run_meta.json``: framework, device, the conv
    layout that ran and the one asked for, the ranks of the global batch."""
    return {"framework": f"torch {torch.__version__}", "device": str(dev),
            "conv_impl": "gather",
            "conv_impl_requested": cfg.tpu.get("conv_impl") or "gather",
            "world_size": mesh.world()}


def detector_val_losses(state: TrainState, batches, **kw
                        ) -> Dict[str, float]:
    """The detector's val losses over ``batches`` ((whether the ranks split
    it, this rank's device batch) a val batch), each key the mean over the
    batches of the batch's value (``detector_eval_step``). Under a process
    group each rank runs its rows of every split batch, whose losses are
    its shares of the batch's (the normalisers are global) and summed over
    the ranks; a batch they do not split runs on rank 0 alone; every rank
    returns rank 0's dict. Each batch is a ``val.batch`` span."""
    per_batch: Dict[str, list] = {}
    for split, batch in batches:
        with trace.span("val.batch"), mesh.eval_rows(split) as mine:
            if not mine:
                continue
            _, losses = detector_eval_step(state, batch, **kw)
            losses = {k: float(v)
                      for k, v in mesh.sum_metrics(losses).items()}
        for k, v in losses.items():
            per_batch.setdefault(k, []).append(v)
    return mesh.broadcast_from_main(
        {k: float(np.mean(v)) for k, v in per_batch.items()})


def device_batches(val_it: BatchIterator, dev: torch.device):
    """(whether the ranks split it, this rank's batch on ``dev``, None
    where it has no rows of it) for each batch of ``val_it``."""
    for b, item in enumerate(val_it):
        yield val_it.splits(b), (None if item is None
                                 else batch_to_torch(item, dev))


def run_detector_training(cfg: Config, run_dir: str,
                          max_steps: Optional[int] = None,
                          device: DeviceLike = None,
                          on_step: Optional[Callable[[Dict], None]] = None,
                          sync_steps: bool = True,
                          ) -> TrainState:
    """Train the detector of ``cfg`` into ``run_dir``, resuming from its
    last checkpoint; returns the train state. Runs on CUDA unless
    ``device`` says otherwise; ``on_step`` and ``sync_steps`` are
    ``StepLoop``'s. Under a process group (``parallel.mesh``) each rank
    trains and validates on its rows of every global batch, and rank 0
    alone writes the run dir.
    """
    dev = resolve_device(device)
    setup_run(cfg, run_dir)
    ckpt = Checkpointer(run_dir, cfg.general.monitor.replace("val_loss/", ""),
                        cfg.general.monitor_mode)

    spec = spec_from_cfg(cfg)
    model = init_detector(detector_from_cfg(cfg),
                          cfg.general.manual_seed).to(dev)
    train_it, val_it = make_dataloaders(cfg, spec)
    state = create_train_state(model, **optimizer_kw(cfg))
    if ckpt.restore_last(state) is not None and mesh.is_main():
        print(f"resumed from step {state.step}")
    mesh.replicate(state.model, state.optimizer)
    write_run_meta(run_dir, cfg, run_meta_extra(dev, cfg))
    loop = StepLoop(cfg, run_dir, dev, train_it.augment, state.step,
                    max_steps, on_step, sync_steps)

    lw = tuple(cfg.train.loss_weight[:4])
    # prepare_epochs: train the semantic and offset heads only (no
    # clustering, no ScoreNet) for the first N epochs
    prepare_epochs = int(cfg.cluster.get("prepare_epochs", -1) or -1)
    seed = cfg.general.manual_seed + 1
    val_batches: list = []

    for epoch in range(cfg.train.epochs):
        t_epoch = time.time()
        in_prepare = prepare_epochs > 0 and epoch < prepare_epochs
        loop.run_epoch(
            epoch, train_it, lambda item: (item, batch_to_torch(item, dev)),
            lambda batch, step: detector_train_step(
                state, batch, step_generator(seed, step, dev),
                loss_weight=lw, do_clustering=not in_prepare)[1],
            log_extra=_cap_counters)

        # validation (device-cached like the train batches)
        check_every = int(cfg.train.get("check_val_every_n_epoch", 1) or 1)
        if (epoch + 1) % check_every != 0 and not loop.done:
            if mesh.is_main():
                print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s "
                      "(val skipped)")
            continue

        if loop.cache_batches and not val_batches:
            val_batches.extend(device_batches(val_it, dev))
        agg = detector_val_losses(
            state, val_batches or device_batches(val_it, dev),
            do_clustering=not in_prepare)
        loop.logger.log(loop.step, agg, "val")
        if mesh.is_main():
            print(f"epoch {epoch} VAL "
                  + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        ckpt.save(loop.step, state, agg)
        if mesh.is_main():
            print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s")
        if loop.done:
            break
    loop.finish()
    return state


SCAN_KEYS = ("total_loss", "semantic_loss", "offset_norm_loss",
             "offset_dir_loss", "score_loss", "gt_iou_mean")


def _stack(batches: List[Any], dev: torch.device, bf16_feats: bool):
    """numpy batches of one layout -> one tree of (nb, ...) tensors on
    ``dev`` (``point_feats`` in bf16 when asked)."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in batches], dev,
                          bf16_feats and k == "point_feats")
                for k in first}
    if isinstance(first, list):
        return [_stack([b[i] for b in batches], dev, bf16_feats)
                for i in range(len(first))]
    t = torch.from_numpy(np.stack(batches)).to(dev)
    return t.to(torch.bfloat16) if bf16_feats else t


def stack_batch(tree, i: int):
    """Batch ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: stack_batch(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [stack_batch(v, i) for v in tree]
    return tree[i]


def build_scan_stack(cfg: Config, train_it: BatchIterator,
                     dev: torch.device):
    """The scan trainer's device-resident stack: ``tpu.augment_variants``
    epochs of ``train_it`` (augmented when the config's transform is on,
    each epoch seeded by its index) as one tree of (nb, ...) tensors, with
    ``point_feats`` in bf16 under ``tpu.activation_dtype: bfloat16`` (the
    model casts it at the voxel scatter anyway). Returns (stack, nb)."""
    tr = cfg.data.transform
    aug_on = bool(tr.jitter or tr.flip or tr.rot)
    n_var = max(1, int(cfg.tpu.get("augment_variants", 4))) if aug_on else 1
    train_it.augment = aug_on
    batches = []
    for e in range(n_var):
        train_it.epoch = e
        batches.extend(list(train_it))
    bf16 = str(cfg.tpu.get("activation_dtype", "")) in ("bfloat16", "bf16")
    return _stack(batches, dev, bf16), len(batches)


def run_detector_training_scan(cfg: Config, run_dir: str,
                               max_steps: Optional[int] = None,
                               device: DeviceLike = None,
                               on_dispatch: Optional[Callable[[Dict], None]]
                               = None) -> TrainState:
    """Detector training in dispatches of ``tpu.steps_per_dispatch`` steps
    (the JAX package's ``run_detector_training_scan``, whose dispatch is
    one ``lax.scan``), resuming from the run dir's last checkpoint.

    The batches of ``tpu.augment_variants`` epochs live on the device as
    one stack (:func:`build_scan_stack`); step ``i`` of a dispatch takes
    batch ``i % nb``, and StepLR counts ``nb`` steps an epoch. Inside a
    dispatch the host reads nothing back: each step's six ``SCAN_KEYS``
    metrics go into a device tensor, read once at its end. The train log
    gets the dispatch's last step with ``steps_per_sec``; then one
    resident val batch is evaluated, logged and checkpointed. Runs
    ``max_steps`` or ``train.epochs · nb`` steps, rounded up to a whole
    dispatch. Each step draws from ``step_generator(manual_seed + 1,
    step)``, as the eager loop does.

    Each dispatch, to its read-back, is a ``train.dispatch`` span; with
    ``log.profile_step: k`` the dispatch that runs step k + 1, its val batch
    and checkpoint are traced into ``profile/trace.json``, as
    :class:`StepLoop` traces its steps.

    ``on_dispatch``, if given, is called after each dispatch with its
    ``step``, ``wall_s`` (its span's, the read-back included) and,
    on CUDA, ``device_ms`` (CUDA events around its steps). Runs on CUDA
    unless ``device`` says otherwise. Under a process group each rank's
    stack holds its rows of every batch, the dispatch's metrics tensor is
    summed over the ranks once, at its read-back, each rank validates its
    rows of the val batch, and rank 0 alone writes the run dir.
    """
    dev = resolve_device(device)
    setup_run(cfg, run_dir)
    ckpt = Checkpointer(run_dir, cfg.general.monitor.replace("val_loss/", ""),
                        cfg.general.monitor_mode)
    spec = spec_from_cfg(cfg)
    model = init_detector(detector_from_cfg(cfg),
                          cfg.general.manual_seed).to(dev)
    train_it, val_it = make_dataloaders(cfg, spec)
    stack, nb = build_scan_stack(cfg, train_it, dev)
    state = create_train_state(model, **optimizer_kw(cfg, scan=True))
    if ckpt.restore_last(state) is not None and mesh.is_main():
        print(f"resumed from step {state.step}")
    mesh.replicate(state.model, state.optimizer)
    write_run_meta(run_dir, cfg, run_meta_extra(dev, cfg))
    log_cfg = cfg.get("log")
    logger = MetricLogger(run_dir, tensorboard=bool(
        log_cfg is not None and log_cfg.get("tensorboard", False)))
    logger.begin(state.step)

    lw = tuple(cfg.train.loss_weight[:4])
    spd = int(cfg.tpu.get("steps_per_dispatch", 64))
    seed = cfg.general.manual_seed + 1
    total = max_steps or cfg.train.epochs * nb
    val_batch = None
    metrics = torch.empty(spd, len(SCAN_KEYS), device=dev)
    profile_at = int((log_cfg.get("profile_step", 0)
                      if log_cfg is not None and mesh.is_main() else 0) or 0)
    while state.step < total:
        # ``log.profile_step: k`` traces the dispatch that runs step k + 1
        # (the first that StepLoop's window traces), its val batch and
        # checkpoint
        prof = (_start_profile(dev) if profile_at and
                state.step <= profile_at < state.step + spd else None)
        with trace.span("train.dispatch", id=state.step, timed=True) as disp:
            if dev.type == "cuda" and on_dispatch is not None:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            for i in range(spd):
                _, m = detector_train_step(
                    state, stack_batch(stack, i % nb),
                    step_generator(seed, state.step, dev), loss_weight=lw,
                    sum_metrics=False)
                metrics[i] = torch.stack([m[k].float() for k in SCAN_KEYS])
            if dev.type == "cuda" and on_dispatch is not None:
                events[1].record()
            last = dict(zip(SCAN_KEYS,
                            mesh.all_reduce_sum(metrics)[-1].tolist()))
        dt = disp.seconds
        last["steps_per_sec"] = spd / dt
        logger.log(state.step, last, "train")
        if mesh.is_main():
            print(f"step {state.step} "
                  + " ".join(f"{k}={v:.4f}" for k, v in last.items()))
        if on_dispatch is not None:
            rec = {"step": state.step, "wall_s": dt}
            if dev.type == "cuda":
                rec["device_ms"] = events[0].elapsed_time(events[1])
            on_dispatch(rec)

        # one resident val batch (this rank's rows of it), every dispatch
        if val_batch is None:
            val_batch = next(device_batches(val_it, dev))
        agg = detector_val_losses(state, [val_batch])
        logger.log(state.step, agg, "val")
        if mesh.is_main():
            print(f"step {state.step} VAL "
                  + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        ckpt.save(state.step, state, agg)
        if prof is not None:
            _stop_profile(prof, dev, run_dir)
    return state


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    prof.start()
    return prof


def _stop_profile(prof, dev: torch.device, run_dir: str) -> None:
    """Ends the ``log.profile_step`` trace and writes it as a Chrome trace
    under ``run_dir/profile`` (the JAX loop's directory), with the spans of
    the threads the profiler does not record merged in
    (``trace.export_chrome_trace``)."""
    _sync(dev)
    prof.stop()
    out = os.path.join(run_dir, "profile")
    os.makedirs(out, exist_ok=True)
    trace.export_chrome_trace(prof, os.path.join(out, "trace.json"))
    print(f"profile written to {out}")
