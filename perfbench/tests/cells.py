"""Tiny cells for the CPU tests: each benchmark configuration cut to a
few thousand points, and the traffic cut to match, run by the harness on
the CPU with the kernels' plain versions."""

from __future__ import annotations

import copy
import json
import os
from types import SimpleNamespace

from perfbench.harness.names import BENCH_DIR, Cell


def _json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def _merge(base, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


TINY_DET = {
    "data": {"max_num_point": 3072, "max_num_instance": 8, "elastic": False},
    "model": {"m": 8, "blocks": [1, 2, 3], "max_num_proposal": 16,
              "use_multiview": False},
    "tpu": {"voxel_caps": [3072, 1536, 768], "clusters_per_pass": 16,
            "cluster_cell_size": 0.03, "cluster_prop_iters": 4,
            "steps_per_dispatch": 2},
    "cluster": {"cluster_npoint_thre": 30},
}
TINY_DET_TRAFFIC = {
    "num_scenes": 4, "batch_size": 2, "workers": 1,
    "scene": {"num_instances": 3, "points_per_instance": 600,
              "floor_points": 1000, "room": 4.0, "with_multiview": False},
}


def tiny_det_cell(limits=None, chips: int = 1) -> Cell:
    """``flagship_det_train`` at tiny sizes (float32: the CPU has no bf16
    products worth timing, and the plain path is what the test drives)."""
    cfg = _json("configs", "d3net_flagship_det.json")
    cfg = copy.deepcopy(cfg)
    _merge(cfg["config"], copy.deepcopy(TINY_DET))
    work = dict(_json("workloads", "flagship_det_train.json"))
    if limits is not None:
        work["limits"] = limits
    return Cell(name="tiny_det_train", chips=chips,
                config_name="tiny", traffic_name="tiny", workload=work,
                config=cfg, traffic=copy.deepcopy(TINY_DET_TRAFFIC),
                end_to_end=[{"name": "train_scenes_per_s",
                             "unit": "scenes/s"},
                            {"name": "setup_s", "unit": "s"}],
                per_layer=[{"name": "idle.train", "unit": "%"},
                           {"name": "mfu.train", "unit": "%"}])


def args(seed: int = 1, seconds: float = 0.1, trace: int = 0):
    return SimpleNamespace(workload="tiny", seed=seed, seconds=seconds,
                           trace=trace)


TINY_CAPTION = {
    "data": {"max_num_point": 3072, "max_num_instance": 8,
             "max_spk_len": 10},
    "model": {"m": 8, "blocks": [1, 2, 3], "max_num_proposal": 16,
              "num_locals": 4, "use_multiview": False,
              "use_orientation": False},
    "tpu": {"voxel_caps": [3072, 1536, 768], "clusters_per_pass": 16,
            "cluster_cell_size": 0.03, "cluster_prop_iters": 4},
    "cluster": {"cluster_npoint_thre": 30},
}
TINY_CAPTION_TRAFFIC = {
    "num_scenes": 0, "num_val_scenes": 6, "batch_size": 2, "workers": 1,
    "scene": {"num_instances": 3, "points_per_instance": 600,
              "floor_points": 1000, "room": 4.0, "with_multiview": False},
}


def tiny_caption_cell(limits=None) -> Cell:
    """``caption_eval`` at tiny sizes (conf/debug/tiny_joint.yaml's)."""
    cfg = copy.deepcopy(_json("configs", "d3net_joint.json"))
    _merge(cfg["config"], copy.deepcopy(TINY_CAPTION))
    work = dict(_json("workloads", "caption_eval.json"))
    if limits is not None:
        work["limits"] = limits
    return Cell(name="tiny_caption_eval", chips=1, config_name="tiny",
                traffic_name="tiny", workload=work, config=cfg,
                traffic=copy.deepcopy(TINY_CAPTION_TRAFFIC),
                end_to_end=[{"name": "eval_scenes_per_s", "unit": "scenes/s"},
                            {"name": "eval_batch_ms_p50", "unit": "ms"},
                            {"name": "setup_s", "unit": "s"}],
                per_layer=[{"name": "idle.eval", "unit": "%"}])
