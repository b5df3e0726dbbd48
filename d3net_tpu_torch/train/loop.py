"""Training orchestration for the detector: epochs, validation,
checkpoints, logging.

Counterpart of ``d3net_tpu/train/loop.py`` (the non-scan detector loop),
with the same run-dir layout and semantics:

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

from d3net_tpu_torch.config import Config, save as save_cfg
from d3net_tpu_torch.data.collate import CAP_STATS, BatchSpec, batch_to_torch
from d3net_tpu_torch.data.dataset import BatchIterator, SyntheticScenes
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.models.pointgroup import PointGroup
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
    with open(os.path.join(run_dir, "run_meta.json"), "w") as f:
        json.dump({**run_fingerprint(cfg), **(extra or {})}, f, indent=2)


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
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                pass

    def begin(self, start_step: int) -> None:
        """Rotate an existing log whose history extends past start_step."""
        if not os.path.exists(self.path):
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
    ``best.json``.
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
        value = metrics.get(self.monitor)
        payload = self._payload(state)
        self.mgr.save(step, payload)
        if value is not None and self.is_better(value):
            self.best = float(value)
            self.best_step = step
            self.best_mgr.save(step, payload)
            with open(self._best_meta, "w") as f:
                json.dump({"step": step, "value": self.best,
                           "monitor": self.monitor, "mode": self.mode}, f)

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
    if cfg.data.get("multiview_hdf5"):
        raise NotImplementedError(
            "data.multiview_hdf5: MultiviewAttached (h5py) is not ported "
            "(ROADMAP.md, queue A item 16)")
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


def make_val_loader(cfg: Config, spec: BatchSpec,
                    return_scenes: bool = False) -> BatchIterator:
    """The val split's iterator alone (the evals need no train scenes,
    which are made when their list is)."""
    syn = cfg.data.synthetic
    n_val = int(
        os.environ.get("D3NET_VAL_SCENES", 0)
        or syn.get("num_val_scenes", 0)
        or max(2, syn.num_scenes // 8)
    )
    return BatchIterator(
        SyntheticScenes(n_val, "val", **_scene_kw(cfg)), spec,
        cfg.data.batch_size, shuffle=False, augment=False, seed=0,
        drop_last=False, return_scenes=return_scenes,
        workers=int(cfg.data.get("num_workers", 1) or 1),
    )


def make_dataloaders(cfg: Config, spec: BatchSpec, return_scenes: bool = False):
    kw = _scene_kw(cfg)
    tr = cfg.data.transform
    train_it = BatchIterator(
        SyntheticScenes(cfg.data.synthetic.num_scenes, "train", **kw), spec,
        cfg.data.batch_size,
        shuffle=True, augment=bool(tr.jitter or tr.flip or tr.rot),
        elastic=bool(cfg.data.get("elastic", False)),
        seed=cfg.general.manual_seed,
        return_scenes=return_scenes,
        workers=int(cfg.data.get("num_workers", 1) or 1),
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

    ``on_step``, if given, is called after every train step with its timings
    on the host's clock: ``t_start`` when the loop asked for the batch,
    ``data_wait_s`` blocked on the batch iterator, ``h2d_s`` copying the
    batch to the device (``h2d_bytes``), ``step_s`` in the step, ``wall_s``
    all three. With ``sync_steps`` the loop waits for the device around
    each copy and at the end of each step, so each part's time includes its
    device work; without, the steps run as they do without ``on_step`` and
    each time ends when the host got past that part.
    """

    def __init__(self, cfg: Config, run_dir: str, dev: torch.device,
                 augment: bool, step: int, max_steps: Optional[int] = None,
                 on_step: Optional[Callable[[Dict], None]] = None,
                 sync_steps: bool = True):
        log_cfg = cfg.get("log")
        self.logger = MetricLogger(run_dir, tensorboard=bool(
            log_cfg is not None and log_cfg.get("tensorboard", False)))
        self.logger.begin(step)
        self.profile_at = int((log_cfg.get("profile_step", 0)
                               if log_cfg is not None else 0) or 0)
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
        while True:
            t_wait = time.perf_counter()
            item = next(items, None)
            if item is None:
                break
            t_copy = time.perf_counter()
            h2d_bytes = 0
            if from_host:
                arrays, batch = to_device(item)
                if on_step is not None:
                    h2d_bytes = sum(a.nbytes for a in _arrays(arrays))
                if caching:
                    self.variant_epochs[-1].append(batch)
            else:
                batch = item
            if on_step is not None and self.sync_steps:
                _sync(dev)
            if self.profile_at and self.step == self.profile_at:
                self.prof = _start_profile(dev)
            t0 = time.perf_counter()
            metrics = train_step(batch, self.step)
            self.step += 1
            if self.prof is not None and self.step == self.profile_at + 3:
                self.prof = _stop_profile(self.prof, dev, self.run_dir)
            if on_step is not None:
                if self.sync_steps:
                    _sync(dev)
                t1 = time.perf_counter()
                on_step({"step": self.step, "epoch": epoch, "t_start": t_wait,
                         "data_wait_s": t_copy - t_wait, "h2d_s": t0 - t_copy,
                         "h2d_bytes": h2d_bytes, "step_s": t1 - t0,
                         "wall_s": t1 - t_wait})
            if self.step % self.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["iter_time"] = time.perf_counter() - t0
                if log_extra is not None:
                    metrics.update(log_extra())
                self.logger.log(self.step, metrics, "train")
                print(f"epoch {epoch} step {self.step} "
                      + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            if self.done:
                break

    def finish(self) -> None:
        """Ends a profile window the run ended inside."""
        if self.prof is not None:
            self.prof = _stop_profile(self.prof, self.dev, self.run_dir)


def _cap_counters() -> Dict[str, float]:
    """Silent-truncation telemetry: the host cap counters since the last
    train log line."""
    return {k: v for k, v in CAP_STATS.reset().items() if k != "batches"}


def run_detector_training(cfg: Config, run_dir: str,
                          max_steps: Optional[int] = None,
                          device: DeviceLike = None,
                          on_step: Optional[Callable[[Dict], None]] = None,
                          sync_steps: bool = True,
                          ) -> TrainState:
    """Train the detector of ``cfg`` into ``run_dir``, resuming from its
    last checkpoint; returns the train state. Runs on CUDA unless
    ``device`` says otherwise; ``on_step`` and ``sync_steps`` are
    ``StepLoop``'s.
    """
    dev = resolve_device(device)
    os.makedirs(run_dir, exist_ok=True)
    save_cfg(cfg, os.path.join(run_dir, "config.yaml"))
    ckpt = Checkpointer(run_dir, cfg.general.monitor.replace("val_loss/", ""),
                        cfg.general.monitor_mode)

    spec = spec_from_cfg(cfg)
    model = init_detector(detector_from_cfg(cfg),
                          cfg.general.manual_seed).to(dev)
    train_it, val_it = make_dataloaders(cfg, spec)
    state = create_train_state(
        model,
        lr=cfg.train.optim.lr,
        optim=cfg.train.optim.classname,
        weight_decay=cfg.train.optim.weight_decay,
        momentum=cfg.train.optim.momentum,
        step_epoch=cfg.train.step_epoch,
        multiplier=cfg.train.multiplier,
        steps_per_epoch=max(1, len(train_it)),
    )
    if ckpt.restore_last(state) is not None:
        print(f"resumed from step {state.step}")
    write_run_meta(run_dir, cfg, {
        "framework": f"torch {torch.__version__}", "device": str(dev),
        "conv_impl": "gather",
        "conv_impl_requested": cfg.tpu.get("conv_impl") or "gather"})
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
            print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s "
                  "(val skipped)")
            continue
        val_metrics: Dict[str, list] = {}
        cached_val = loop.cache_batches and bool(val_batches)
        for item in (val_batches if cached_val else val_it):
            batch = item if cached_val else batch_to_torch(item, dev)
            if loop.cache_batches and not cached_val:
                val_batches.append(batch)
            _, losses = detector_eval_step(state, batch,
                                           do_clustering=not in_prepare)
            for k, v in losses.items():
                val_metrics.setdefault(k, []).append(float(v))
        agg = {k: float(np.mean(v)) for k, v in val_metrics.items()}
        loop.logger.log(loop.step, agg, "val")
        print(f"epoch {epoch} VAL "
              + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        ckpt.save(loop.step, state, agg)

        print(f"epoch {epoch} took {time.time() - t_epoch:.1f}s")
        if loop.done:
            break
    loop.finish()
    return state


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    prof.start()
    return prof


def _stop_profile(prof, dev: torch.device, run_dir: str) -> None:
    """Ends the ``log.profile_step`` trace and writes it as a Chrome trace
    under ``run_dir/profile`` (the JAX loop's directory)."""
    _sync(dev)
    prof.stop()
    out = os.path.join(run_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    print(f"profile written to {out}")
