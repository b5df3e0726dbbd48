"""Export a run dir of this package as a run archive, for the PyTorch port.

Usage: python scripts/export_jax_run.py --folder <run dir> --out run.npz
           [--cpu]

Restores the run's last and best checkpoints as ``Checkpointer`` restores
them: the structured restore against the template the writing loop builds
(the detector loop's, the scan trainer's or the pipeline loop's, from the
run's ``config.yaml`` through ``make_optimizer`` with the loop's steps an
epoch, ``make_frozen_optimizer`` for a pipeline run and
``create_train_state``, shapes only, under ``jax.eval_shape``), else the
raw restore with ``migrate_legacy_block_names``. Then it writes the
archive that ``d3net_tpu_torch/jax_run.py`` reads with numpy and json
alone: ``<out stem>.npz`` (``params``, ``batch_stats`` and every
``opt_state`` leaf of each checkpoint, keyed ``<last|best>/<collection>/
<path>``) and ``<out stem>.json`` (each checkpoint's step and optax state
structure: ``ScaleByAdamState``, ``TraceState``, ``ScaleByScheduleState``,
``MaskedNode`` at frozen leaves, the multi_transform's partitions; the
loop, its schedule and labels; the run's ``config.yaml``,
``metrics.jsonl``, ``best.json`` and ``run_meta.json``). bfloat16 leaves
are written as float32. The port imports the archive with
``python -m d3net_tpu_torch.scripts.import_jax_run``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Mapping, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

FORMAT = "d3net run archive"   # d3net_tpu_torch/jax_run.py reads this
VERSION = 1


def loop_of(cfg) -> str:
    """The loop ``scripts/train.py`` runs ``cfg`` in."""
    mode = (int(not cfg.model.no_detection), int(not cfg.model.no_captioning),
            int(not cfg.model.no_grounding))
    if mode != (1, 0, 0):
        return "pipeline"
    return "scan" if cfg.tpu.get("steps_per_dispatch") else "detector"


def template(cfg) -> Tuple[Any, Dict[str, Any]]:
    """The abstract ``TrainState`` the loop of ``cfg`` restores into, and
    the archive's ``loop``, ``schedule`` and ``labels``."""
    import jax
    import jax.numpy as jnp

    from d3net_tpu.data.collate import build_batch
    from d3net_tpu.train.loop import (
        detector_from_cfg, make_dataloaders, spec_from_cfg,
    )
    from d3net_tpu.train.trainer import (
        TrainState, create_train_state, make_optimizer,
    )

    loop = loop_of(cfg)
    spec = spec_from_cfg(cfg)
    train_it, _ = make_dataloaders(cfg, spec)
    b = int(cfg.data.batch_size)
    scenes = [train_it.scenes[i] for i in range(b)]
    first = jax.tree.map(jnp.asarray, build_batch(scenes, spec))
    o = cfg.train.optim
    kw = dict(lr=o.lr, optim=o.classname, weight_decay=o.weight_decay,
              step_epoch=cfg.train.step_epoch, multiplier=cfg.train.multiplier)
    labels = None
    if loop == "detector":
        spe = max(1, len(train_it))
        tx = make_optimizer(momentum=o.momentum, steps_per_epoch=spe, **kw)
    elif loop == "scan":
        # the scan trainer's stack: augment_variants epochs of batches
        tr = cfg.data.transform
        aug_on = bool(tr.jitter or tr.flip or tr.rot)
        n_var = max(1, int(cfg.tpu.get("augment_variants", 4))) \
            if aug_on else 1
        spe = n_var * len(train_it)
        tx = make_optimizer(steps_per_epoch=spe, **kw)
    else:
        from d3net_tpu.data.language import build_lang_batch
        from d3net_tpu.train.pipeline_loop import (
            _RNGS, build_vocab, lang_rows, make_frozen_optimizer,
            pipeline_from_cfg,
        )

        vocab, emb = build_vocab(cfg)
        model = pipeline_from_cfg(cfg, vocab)
        chunk = int(cfg.data.num_des_per_scene)
        cap, grd = not cfg.model.no_captioning, not cfg.model.no_grounding
        mode = 3 if cap and grd else 1 if cap else 2
        spe = max(1, len(train_it))
        tx = make_optimizer(steps_per_epoch=spe, **kw)
        lang = lang_rows(build_lang_batch(
            scenes, vocab, chunk, cfg.data.max_spk_len,
            np.random.default_rng(cfg.general.manual_seed), spec.max_instances,
            apply_word_erase=bool(cfg.train.get("apply_word_erase", False)),
            num_refs=int(cfg.train.get("num_caption_refs", 1) or 1)), emb)
        freeze = {
            "detector": bool(cfg.model.freeze_detector),
            "speaker": bool(cfg.model.get("freeze_speaker", False))
            and mode != 1,
            "listener": bool(cfg.model.get("freeze_listener", False))
            and mode != 2,
        }
        rngs = {k: jax.random.key(i) for i, k in enumerate(("params",) + _RNGS)}

        def init():
            v = model.init(rngs, first, lang, train=True, chunk_size=chunk)
            ftx = make_frozen_optimizer(tx, v["params"], freeze)
            return TrainState(step=jnp.zeros((), jnp.int32),
                              params=v["params"],
                              batch_stats=v.get("batch_stats", {}),
                              opt_state=ftx.init(v["params"]), tx=ftx)

        state = jax.eval_shape(init)
        labels = {k: "freeze" if freeze.get(k, False) else "train"
                  for k in state.params}
    if loop != "pipeline":
        model = detector_from_cfg(cfg)
        state = jax.eval_shape(lambda: create_train_state(
            model, first, jax.random.key(cfg.general.manual_seed), tx))
    schedule = {"optim": o.classname, "lr": float(o.lr),
                "multiplier": float(cfg.train.multiplier),
                "transition_steps": max(1, cfg.train.step_epoch * spe)}
    return state, {"loop": loop, "schedule": schedule, "labels": labels}


def restored_states(folder: str):
    """(config, {"last"|"best": restored TrainState}, the archive's loop
    facts) of the run dir ``folder``."""
    from d3net_tpu import config as cfg_lib
    from d3net_tpu.train.loop import Checkpointer

    cfg = cfg_lib.load(os.path.join(folder, "config.yaml"))
    state, facts = template(cfg)
    ckpt = Checkpointer(folder, "none")
    states = {}
    for kind, restore in (("last", ckpt.restore_last),
                          ("best", ckpt.restore_best)):
        got = restore(state)
        if got is not None:
            states[kind] = got
    if "last" not in states:
        raise FileNotFoundError(f"no checkpoint in {folder}/ckpt")
    return cfg, states, facts


def _array(x) -> np.ndarray:
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, path) if isinstance(v, Mapping)
                   else {path: _array(v)})
    return out


def _describe(node, arrays: Dict[str, np.ndarray], path=()) -> Dict:
    """The optax state's structure as JSON (``jax_run.describe``'s)."""
    if hasattr(node, "_fields"):
        return {"type": type(node).__name__,
                "fields": {f: _describe(getattr(node, f), arrays, path + (f,))
                           for f in node._fields}}
    if isinstance(node, (tuple, list)):
        return {"type": "tuple",
                "items": [_describe(v, arrays, path + (str(i),))
                          for i, v in enumerate(node)]}
    if isinstance(node, Mapping):
        return {"type": "dict",
                "items": {str(k): _describe(v, arrays, path + (str(k),))
                          for k, v in node.items()}}
    if node is None:
        return {"type": "none"}
    key = "/".join(path)
    arrays[key] = _array(node)
    return {"type": "array", "key": key}


def _read(path: str, as_json: bool = False):
    if not os.path.exists(path):
        return None if as_json else ""
    with open(path) as f:
        return json.load(f) if as_json else f.read()


def export_run(folder: str, out: str) -> Tuple[str, str]:
    """Write the run archive of ``folder`` at ``out`` (its ``.npz`` or
    stem); returns the two files' paths."""
    _, states, facts = restored_states(folder)
    return write_archive(folder, out, states, facts)


def write_archive(folder: str, out: str, states: Mapping[str, Any],
                  facts: Mapping[str, Any]) -> Tuple[str, str]:
    """The archive of ``restored_states(folder)``'s ``states`` and
    ``facts`` at ``out``; returns the two files' paths."""
    stem, ext = os.path.splitext(out)
    stem = stem if ext in (".npz", ".json") else out
    arrays: Dict[str, np.ndarray] = {}
    steps = {}
    for kind, st in states.items():
        step = int(st.step)
        if kind == "best" and step == steps["last"]["step"]:
            steps[kind] = {"step": step, "same_as": "last"}
            continue
        for coll in ("params", "batch_stats"):
            for k, v in _flat(getattr(st, coll)).items():
                arrays[f"{kind}/{coll}/{k}"] = v
        opt: Dict[str, np.ndarray] = {}
        steps[kind] = {"step": step, "opt_state": _describe(st.opt_state, opt)}
        arrays.update({f"{kind}/opt_state/{k}": v for k, v in opt.items()})
    np.savez(stem + ".npz", **arrays)
    meta = {"format": FORMAT, "version": VERSION,
            "folder": os.path.abspath(folder), **facts, "steps": steps,
            "config_yaml": _read(os.path.join(folder, "config.yaml")),
            "metrics_jsonl": _read(os.path.join(folder, "metrics.jsonl")),
            "best_json": _read(os.path.join(folder, "ckpt_best", "best.json"),
                               True),
            "run_meta": _read(os.path.join(folder, "run_meta.json"), True)}
    with open(stem + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return stem + ".npz", stem + ".json"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--folder", required=True, help="the run dir to export")
    p.add_argument("--out", required=True, help="the archive (.npz or stem)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = p.parse_args(argv)
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    paths = export_run(args.folder, args.out)
    print(f"wrote {paths[0]} and {paths[1]}")
    return paths


if __name__ == "__main__":
    main()
