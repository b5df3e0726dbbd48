"""Driver: the detector's scan trainer (``train/loop.py``
``run_detector_training_scan``), one unit a dispatch.

Set-up makes the traffic's scenes, collates ``tpu.augment_variants``
augmented epochs into the device-resident stack with the program's
``BatchIterator`` and ``build_scan_stack`` (this rank's rows under a
process group), builds the model and AdamW state from the benchmark's
seeded weights, and drives the step through its first three steps with
the window's own call and feed (batches 0, 1 and 2 of the stack). A unit
is one dispatch as the scan trainer runs it: ``tpu.steps_per_dispatch``
calls of ``detector_train_step`` on stack batches ``i % nb``, each step's
metrics into one device tensor, read back once (summed over the ranks).
The per-dispatch val batch and checkpoint are left out.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any, Dict, List, Optional

import torch

from d3net_tpu_torch.config import Config
from d3net_tpu_torch.data.dataset import BatchIterator
from d3net_tpu_torch.kernels import gather
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.train import loop
from d3net_tpu_torch.train.trainer import (
    create_train_state, detector_train_step,
)
from perfbench.harness import traffic as traffic_gen
from perfbench.harness.seeds import derive
from perfbench.harness.weights import seeded_state
from perfbench.reference import compare
from perfbench.work import detector as work
from perfbench.work.gather import gather_bytes, recording

FIRST_STEPS = 3
FORWARD_KEYS = ("semantic_scores", "pt_offsets")


def _recorder(fn, sink: list):
    """``PointGroup._cluster_batch`` with its inputs and outputs kept on
    the host, one entry a call."""
    def wrapped(*args):
        out = fn(*args)
        sink.append({"inputs": [a.detach().cpu() for a in args],
                     "outputs": [o.detach().cpu() for o in out]})
        return out
    return wrapped


def _first_outputs(fn, sink: Dict[str, torch.Tensor]):
    """The model's forward, its first call's per-point outputs kept."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if not sink:
            sink.update({k: out[k].detach().float().clone()
                         for k in FORWARD_KEYS})
        return out
    return wrapped


def _global_rows(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's rows of each tensor (rank 0 holds them all)."""
    if not mesh.active():
        return t
    every = mesh.gather_to_main({k: v.cpu() for k, v in t.items()})
    if every is None:
        return {}
    return {k: torch.cat([e[k] for e in every]).to(t[k].device) for k in t}


def _cat_rows(parts: List[Dict[str, list]]) -> Dict[str, list]:
    """The ranks' records of one call, as one record of the global batch."""
    return {k: [torch.cat([p[k][i] for p in parts])
                for i in range(len(parts[0][k]))] for k in parts[0]}


def rank_gap(model: torch.nn.Module) -> float:
    """The largest relative gap of a parameter's norm between rank 0 and
    another rank (0 with one rank): data-parallel ranks apply the same
    summed gradients, so their parameters stay equal."""
    norms = torch.stack([p.detach().double().norm()
                         for p in model.parameters()]).cpu()
    every = mesh.gather_to_main(norms)
    if every is None:
        return 0.0
    gaps = [((n - every[0]).abs() / every[0].clamp(min=1e-30)).max()
            for n in every[1:]]
    return float(max(gaps)) if gaps else 0.0


def program_config(cell) -> Dict[str, Any]:
    """The configuration's ``config`` with the traffic's batch and scene
    count (the StepLR epoch counts them)."""
    cfg = copy.deepcopy(cell.config["config"])
    cfg["data"]["batch_size"] = int(cell.traffic["batch_size"])
    cfg["data"]["synthetic"]["num_scenes"] = int(cell.traffic["num_scenes"])
    return cfg


class Driver:
    def __init__(self, run):
        self.run = run
        self.dev = run.device
        cell = run.cell
        self.cfg_dict = program_config(cell)
        cfg = Config(copy.deepcopy(self.cfg_dict))
        self.batch = int(cell.traffic["batch_size"])
        self.spd = int(cfg.tpu.steps_per_dispatch)
        self.lw = tuple(cfg.train.loss_weight[:4])
        self.shuffle_seed = derive(run.seed, "shuffle")
        self.step_seed = derive(run.seed, "steps")

        marks = [("start", time.perf_counter())]
        self.scenes = traffic_gen.make_scenes(cell.traffic, run.seed)
        marks.append(("scenes", time.perf_counter()))
        spec = loop.spec_from_cfg(cfg)
        tr = cfg.data.transform
        it = BatchIterator(
            self.scenes, spec, self.batch, shuffle=True,
            augment=bool(tr.jitter or tr.flip or tr.rot),
            elastic=bool(cfg.data.get("elastic", False)),
            seed=self.shuffle_seed,
            workers=int(cell.traffic.get("workers", 1)),
            rank=mesh.rank(), world=mesh.world())
        self.stack, self.nb = loop.build_scan_stack(cfg, it, self.dev)
        self.steps_per_epoch = loop.train_steps_per_epoch(cfg, scan=True)
        marks.append(("stack", time.perf_counter()))

        model = loop.detector_from_cfg(cfg).to(self.dev)
        self.start = seeded_state(model, derive(run.seed, "weights"),
                                  self.dev)
        model.load_state_dict(self.start)
        self.state = create_train_state(
            model, **loop.optimizer_kw(cfg, scan=True))
        mesh.replicate(self.state.model, self.state.optimizer)
        self.metrics = torch.empty(self.spd, len(loop.SCAN_KEYS),
                                   device=self.dev)
        self.in_channels = loop.in_channels_from_cfg(cfg)

        marks.append(("model", time.perf_counter()))
        # the first steps, through the window's call and feed, with the
        # clustering's inputs and decisions recorded for the reference
        model = self.state.model
        self.clusters = []
        model._cluster_batch = _recorder(model._cluster_batch, self.clusters)
        first: Dict[str, torch.Tensor] = {}
        model.forward = _first_outputs(model.forward, first)
        rows = [self._steps(0, 1)]
        del model.forward
        self.prog = {"grads": {k: v.clone() for k, v in compare.first_grads(
            self.state.model, self.state.optimizer).items()}}
        rows.append(self._steps(1, FIRST_STEPS - 1))
        self.prog["changes"] = compare.changes(self.state.model, self.start)
        self.ranks = rank_gap(self.state.model)
        self.prog["forward"] = _global_rows(first)
        total = loop.SCAN_KEYS.index("total_loss")
        self.prog["losses"] = [r[total] for part in rows for r in part]
        del model._cluster_batch
        if mesh.active():
            every = mesh.gather_to_main(self.clusters)
            self.clusters = (None if every is None else
                             [_cat_rows([e[s] for e in every])
                              for s in range(FIRST_STEPS)])

        marks.append(("first_steps", time.perf_counter()))
        self.phases = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
        # work of one dispatch: the step's products on each batch it runs
        per_batch = []
        for b in range(self.nb):
            counts = work.level_counts(loop.stack_batch(self.stack, b)["tables"])
            per_batch.append(work.detector_step_flops(
                counts, self._model_keys(), self.in_channels,
                self.batch // mesh.world()))
        mine = sum(per_batch[i % self.nb] for i in range(self.spd))
        # every rank's rows: the global step's operations
        self.flops_per_unit = float(mesh.all_reduce_sum(
            torch.tensor([mine], dtype=torch.float64, device=self.dev))[0])

    def _model_keys(self) -> Dict[str, Any]:
        c = self.cfg_dict
        return dict(c["model"], classes=c["data"]["classes"],
                    clusters_per_pass=c["tpu"]["clusters_per_pass"],
                    score_fullscale=c["train"]["score_fullscale"])

    def _steps(self, start: int, n: int) -> List[List[float]]:
        """Steps ``start .. start + n - 1`` of a dispatch: the scan
        trainer's loop body, then its one read-back (every step's
        metrics, summed over the ranks)."""
        for i in range(start, start + n):
            _, m = detector_train_step(
                self.state, loop.stack_batch(self.stack, i % self.nb),
                loop.step_generator(self.step_seed, self.state.step,
                                    self.dev),
                loss_weight=self.lw, sum_metrics=False)
            self.metrics[i - start] = torch.stack(
                [m[k].float() for k in loop.SCAN_KEYS])
        return mesh.all_reduce_sum(self.metrics[:n]).tolist()

    # ------------------------------------------------------------------
    def unit(self) -> Dict[str, int]:
        rows = self._steps(0, self.spd)
        total = loop.SCAN_KEYS.index("total_loss")
        failed = sum(not math.isfinite(r[total]) for r in rows)
        return {"steps": self.spd, "scenes": self.spd * self.batch,
                "failed": failed}

    def work(self) -> Dict[str, float]:
        return {"flops_per_unit": self.flops_per_unit,
                "steps_per_unit": self.spd,
                # the peak of every card the step runs on
                "peak_flops": self.run.world
                * float(self.run.cell.config["peak_flops"]),
                "peak_bytes_per_s":
                    float(self.run.cell.config["peak_bytes_per_s"])}

    def trace_extras(self) -> Dict[str, Any]:
        """One more dispatch with every gather's bytes counted (outside
        the traced unit: the count adds work on the device)."""
        calls: list = []
        with recording(gather, calls):
            self.unit()
        # every recorded call (a non-empty one) is one kernel launch
        return {"gather_launches": len(calls),
                "gather_bytes": sum(gather_bytes(*c) for c in calls)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.state, self.stack, self.metrics
        torch.cuda.empty_cache()

    def _reference(self, **kw) -> Dict[str, Any]:
        from perfbench.reference import det_train as ref

        return ref.follow(self.cfg_dict, self.scenes, self.batch,
                          self.shuffle_seed, self.step_seed, self.start,
                          self.steps_per_epoch, self.dev, FIRST_STEPS,
                          clusters=self.clusters, **kw)

    def witness(self) -> Dict[str, Dict[str, float]]:
        """Where the program's numbers part from the float32 reference:
        the frozen model run in the configuration's own activation type
        (``tpu.activation_dtype``) against the reference
        (``witness.dtype``), the program against it (``witness.program``)
        and against a second such run (``witness.repeat``: what the
        card's reduction order alone gives); ``witness.no_dir``: the
        frozen model in that type against the reference with the offset
        direction loss's weight set to 0 on both; ``witness.offsets``: the
        first step's smallest offset norms over the instance points.
        ``calibrate.py`` prints them; the benchmark's runs do not."""
        dtype = self.cfg_dict["tpu"].get("activation_dtype") or "float32"
        if getattr(self, "_want", None) is None:
            self._want = self._reference()
        one = self._reference(compute_dtype=dtype)
        two = self._reference(compute_dtype=dtype)
        lw = list(self.lw)
        lw[2] = 0.0
        want_nd = self._reference(loss_weight=tuple(lw))
        one_nd = self._reference(compute_dtype=dtype, loss_weight=tuple(lw))
        return {"witness.dtype": compare.training_numbers(one, self._want),
                "witness.program": compare.training_numbers(self.prog, one),
                "witness.repeat": compare.training_numbers(two, one),
                "witness.no_dir": compare.training_numbers(one_nd, want_nd),
                "witness.offsets": {**{"ref." + k: v for k, v in
                                       self._want["offsets"].items()},
                                    **{"dtype." + k: v for k, v in
                                       one["offsets"].items()}}}

    def check(self, control: Optional[str] = None,
              fault: Optional[str] = None) -> Dict[str, float]:
        """The reference's first steps on the same scenes and weights, and
        the numbers compared. With ``control`` (a dtype's name: the
        products' operands and outputs rounded to it) or ``fault``
        (``"half_batch"``), as ``perfbench/calibrate.py`` asks, the
        reference so set stands in the program's place."""
        from perfbench.reference import det_train as ref

        kw = {}
        if control:
            kw["product_dtype"] = getattr(torch, control)
        if fault:
            kw["fault"] = fault
        if getattr(self, "_want", None) is None:
            self._want = self._reference()
        got = self._reference(**kw) if kw else self.prog
        numbers = compare.training_numbers(got, self._want)
        numbers["clusters"] = ref.cluster_mismatch(
            self.cfg_dict, self.clusters, self.dev)
        numbers["ranks"] = self.ranks
        self.last_detail = compare.training_detail(got, self._want)
        return numbers
