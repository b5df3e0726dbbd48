"""The run archive: a JAX package's run dir as files numpy and json read.

A run dir of the JAX package keeps its train state in orbax checkpoints
(``ckpt/<step>/``, ``ckpt_best/<step>/``: ``params``, ``batch_stats``,
``opt_state``, ``step``), which take JAX and orbax to read. The card's
machine has neither, so the JAX side writes the run as an archive
(``scripts/export_jax_run.py``) and the port reads it
(``scripts/import_jax_run.py``). An archive ``<name>`` is two files:

- ``<name>.npz``: every array, keyed ``<kind>/<collection>/<path>``:
  ``kind`` is ``last`` or ``best``, ``collection`` is ``params``,
  ``batch_stats`` or ``opt_state``, and ``path`` joins the tree's keys
  with ``/`` (a dict's key, a tuple's index, a NamedTuple's field).
- ``<name>.json``: ``format`` and ``version``; ``folder``, the run dir
  exported; ``loop``, the JAX loop that wrote it (``detector``, ``scan`` or
  ``pipeline``); ``schedule``, its optimizer (``optim``) and optax's
  staircase ``exponential_decay`` (``lr``, ``multiplier``,
  ``transition_steps``); ``labels``, a pipeline run's multi_transform label
  (``train`` or ``freeze``) of each top-level submodule, else null;
  ``steps``, ``{kind: {"step", "opt_state"}}`` with ``opt_state`` the optax
  state's structure (``{"type": "tuple", "items": [...]}``, ``{"type":
  "dict", "items": {...}}``, ``{"type": <NamedTuple class>, "fields":
  {...}}``, ``{"type": "array", "key": <path>}``, ``{"type": "none"}``), or
  ``{"step", "same_as": "last"}`` where the best step is the last one;
  ``config_yaml`` and ``metrics_jsonl`` as text, ``best_json`` and
  ``run_meta`` as objects (null where the run dir has none).

:func:`read_archive` gives the optax state back as NamedTuples with the
class names and fields of optax's (``ScaleByAdamState``, ``TraceState``,
``MaskedNode``, ...), which ``params.optax_state_to_torch`` reads as it
reads optax's own. :func:`write_archive` writes the format from numpy, and
:func:`optax_state` builds the state the JAX package's ``make_optimizer``
(wrapped by ``make_frozen_optimizer``) gives: the tests and
``chip_smoke.py`` make archives with them where there is no JAX.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

FORMAT = "d3net run archive"
VERSION = 1
COLLECTIONS = ("params", "batch_stats")

_TYPES: Dict[Tuple[str, Tuple[str, ...]], type] = {}


def node_type(name: str, fields: Sequence[str]) -> type:
    """The NamedTuple class ``name`` with ``fields`` (one class a pair)."""
    key = (name, tuple(fields))
    if key not in _TYPES:
        _TYPES[key] = collections.namedtuple(name, key[1])
    return _TYPES[key]


ScaleByAdamState = node_type("ScaleByAdamState", ("count", "mu", "nu"))
ScaleByScheduleState = node_type("ScaleByScheduleState", ("count",))
TraceState = node_type("TraceState", ("trace",))
EmptyState = node_type("EmptyState", ())
MaskedNode = node_type("MaskedNode", ())
MaskedState = node_type("MaskedState", ("inner_state",))
PartitionState = node_type("PartitionState", ("inner_states",))


def archive_paths(path: str) -> Tuple[str, str]:
    """The ``.npz`` and ``.json`` of the archive ``path`` names (either
    file, or their common stem)."""
    stem, ext = os.path.splitext(path)
    if ext not in (".npz", ".json"):
        stem = path
    return stem + ".npz", stem + ".json"


def flat_tree(tree: Mapping[str, Any], prefix: str = ""
              ) -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> ``{"a/b/c": numpy array}``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flat_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def nested_tree(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """The inverse of :func:`flat_tree`."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def describe(node: Any, arrays: Dict[str, np.ndarray],
             path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """The structure of an optax state (tuples, dicts, NamedTuples, arrays,
    None) as JSON, its arrays put into ``arrays`` by path."""
    if hasattr(node, "_fields"):
        return {"type": type(node).__name__,
                "fields": {f: describe(getattr(node, f), arrays, path + (f,))
                           for f in node._fields}}
    if isinstance(node, (tuple, list)):
        return {"type": "tuple",
                "items": [describe(v, arrays, path + (str(i),))
                          for i, v in enumerate(node)]}
    if isinstance(node, Mapping):
        return {"type": "dict",
                "items": {str(k): describe(v, arrays, path + (str(k),))
                          for k, v in node.items()}}
    if node is None:
        return {"type": "none"}
    key = "/".join(path)
    arrays[key] = np.asarray(node)
    return {"type": "array", "key": key}


def rebuild(desc: Mapping[str, Any], arrays: Mapping[str, np.ndarray]):
    """The state :func:`describe` described, its NamedTuples made by
    :func:`node_type`."""
    t = desc["type"]
    if t == "array":
        return arrays[desc["key"]]
    if t == "none":
        return None
    if t == "tuple":
        return tuple(rebuild(d, arrays) for d in desc["items"])
    if t == "dict":
        return {k: rebuild(d, arrays) for k, d in desc["items"].items()}
    fields = desc["fields"]
    return node_type(t, list(fields))(
        *(rebuild(d, arrays) for d in fields.values()))


def _masked(tree: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _masked(v) if isinstance(v, Mapping) else MaskedNode()
            for k, v in tree.items()}


def optax_state(optim: str, count: int, moments: Sequence[Mapping],
                labels: Optional[Mapping[str, str]] = None):
    """The optax state of the JAX package's ``make_optimizer(optim)`` after
    ``count`` updates, with its moment trees (``AdamW``/``Adam``: mu, nu;
    ``SGD``: the momentum trace), numpy leaves. With ``labels`` (each
    top-level submodule's ``train`` or ``freeze``) it is wrapped as
    ``make_frozen_optimizer``'s multi_transform wraps it: the ``train``
    partition's moments hold a ``MaskedNode`` at every frozen leaf."""
    c = np.asarray(count, np.int32)
    if labels is not None:
        moments = [{k: v if labels[k] == "train" else _masked(v)
                    for k, v in m.items()} for m in moments]
    sched = ScaleByScheduleState(count=c)
    if optim in ("AdamW", "Adam"):
        mu, nu = moments
        adam = ScaleByAdamState(count=c, mu=mu, nu=nu)
        inner = (adam, EmptyState(), sched) if optim == "AdamW" \
            else (adam, sched)
    elif optim == "SGD":
        (trace,) = moments
        inner = (TraceState(trace=trace), sched)
    else:
        raise ValueError(f"unknown optimizer {optim}")
    if labels is None:
        return inner
    return PartitionState(inner_states={
        "freeze": MaskedState(inner_state=EmptyState()),
        "train": MaskedState(inner_state=inner)})


@dataclass
class StepState:
    """One checkpoint of the archive."""

    step: int
    params: Dict[str, Any]
    batch_stats: Dict[str, Any]
    opt_state: Any


@dataclass
class RunArchive:
    """An archive read back: its JSON (``meta``), its checkpoints by kind
    and the sha256 of its two files (the ``.npz``'s bytes, then the
    ``.json``'s)."""

    meta: Dict[str, Any]
    steps: Dict[str, StepState]
    sha256: str


def write_archive(path: str, *, config_yaml: str, loop: str,
                  schedule: Mapping[str, Any],
                  steps: Mapping[str, Mapping[str, Any]],
                  labels: Optional[Mapping[str, str]] = None,
                  folder: str = "", best_json: Optional[Mapping] = None,
                  metrics_jsonl: str = "",
                  run_meta: Optional[Mapping] = None) -> Tuple[str, str]:
    """Write the archive ``path`` from numpy: ``steps`` maps ``last`` and
    ``best`` to ``{"step", "params", "batch_stats", "opt_state"}`` (Flax
    trees of numpy arrays, an optax-like state); a best step equal to the
    last is written once. Returns the two files' paths."""
    npz, js = archive_paths(path)
    arrays: Dict[str, np.ndarray] = {}
    meta_steps: Dict[str, Any] = {}
    for kind, st in steps.items():
        step = int(st["step"])
        if kind == "best" and "last" in steps \
                and int(steps["last"]["step"]) == step:
            meta_steps[kind] = {"step": step, "same_as": "last"}
            continue
        for coll in COLLECTIONS:
            for k, v in flat_tree(st[coll]).items():
                arrays[f"{kind}/{coll}/{k}"] = v
        opt: Dict[str, np.ndarray] = {}
        meta_steps[kind] = {"step": step,
                            "opt_state": describe(st["opt_state"], opt)}
        arrays.update({f"{kind}/opt_state/{k}": v for k, v in opt.items()})
    np.savez(npz, **arrays)
    meta = {"format": FORMAT, "version": VERSION, "folder": folder,
            "loop": loop, "schedule": dict(schedule),
            "labels": dict(labels) if labels is not None else None,
            "steps": meta_steps, "config_yaml": config_yaml,
            "metrics_jsonl": metrics_jsonl,
            "best_json": dict(best_json) if best_json is not None else None,
            "run_meta": dict(run_meta) if run_meta is not None else None}
    with open(js, "w") as f:
        json.dump(meta, f, indent=1)
    return npz, js


def read_archive(path: str) -> RunArchive:
    """The archive ``path`` (either file or their stem), with numpy and
    json alone. Raises ValueError on another format or version."""
    npz, js = archive_paths(path)
    digest = hashlib.sha256()
    for p in (npz, js):
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                digest.update(chunk)
    with open(js) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT or meta.get("version") != VERSION:
        raise ValueError(f"{js}: not a {FORMAT} of version {VERSION}")
    with np.load(npz, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    steps: Dict[str, StepState] = {}
    for kind in sorted(meta["steps"], key=lambda k: k != "last"):
        desc = meta["steps"][kind]
        src = desc.get("same_as")
        if src is not None:
            steps[kind] = steps[src]
            continue
        part = {coll: {k[len(f"{kind}/{coll}/"):]: v
                       for k, v in arrays.items()
                       if k.startswith(f"{kind}/{coll}/")}
                for coll in COLLECTIONS + ("opt_state",)}
        steps[kind] = StepState(
            step=int(desc["step"]), params=nested_tree(part["params"]),
            batch_stats=nested_tree(part["batch_stats"]),
            opt_state=rebuild(desc["opt_state"], part["opt_state"]))
    return RunArchive(meta=meta, steps=steps, sha256=digest.hexdigest())
