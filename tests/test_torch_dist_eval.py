"""The eval CLI's four tasks over a process group (``parallel/mesh.py``)
against world size 1, on the CPU: 2 gloo ranks, one torch thread each, at
conf/debug/ tiny widths (B=2), on run dirs holding one checkpoint of seeded
weights each, no training (``checks.seeded_run_dir``): a detector's
(conf/debug/tiny_pointgroup.yaml: ``--task detection``) and two joint
pipelines' (conf/debug/tiny_joint.yaml with ``eval.min_iou_threshold``
0.0, so that the random speaker's captions are scored: ``captioning``
and ``grounding``; ``scannet``), each seeded so that its metrics are not
0.

Here each task runs on 4 val scenes (two batches, one scene a rank each);
``test_torch_dist_eval_tail.py`` runs them on 3, whose short last batch
runs on rank 0 alone. World 2 equals world 1 (``checks.
evals_world_vs_one``): the metric dicts and ``eval_<task>.json`` with ints
and strings exact and floats within rtol 1e-5 (``checks.EVAL_RTOL``), the
same dict on both ranks, and the ``split_pred`` txt tree byte-equal.

Without a spawn: evaluators fed a rank's rows each and merged in the global
scene order (``mesh.merge_ordered``) equal one evaluator fed every scene,
bit for bit; the detector's eval forward is bit-equal run to run and in
halves of a batch (``checks.detector_repro``). A 2-rank
``Checkpointer.save`` leaves one checkpoint and one best meta, rank 0's.
"""

import json
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from d3net_tpu_torch import checks
from d3net_tpu_torch.eval.caption_eval import CaptionEvaluator
from d3net_tpu_torch.eval.detection import APCalculator
from d3net_tpu_torch.eval.grounding_eval import GroundingEvaluator
from d3net_tpu_torch.eval.segmentation import InstanceEvaluator
from d3net_tpu_torch.parallel import mesh
from d3net_tpu_torch.scripts import eval as eval_cli
from d3net_tpu_torch.scripts.train import load_task_config
from d3net_tpu_torch.train import loop as tloop

TASKS = {"detection": "det", "captioning": "joint", "grounding": "joint",
         "scannet": "seg"}
CONFIGS = {"det": "conf/debug/tiny_pointgroup.yaml",
           "joint": "conf/debug/tiny_joint.yaml",
           "seg": "conf/debug/tiny_joint.yaml"}
# seeds whose random weights score on these val scenes, so that the
# comparisons hold real numbers: the detector's mAP@0.25, the captions'
# CIDEr (the corpus metric) and the ScanNet AP@25 above 0
SEEDS = {"det": 7, "joint": 13, "seg": 2}
VAL_SCENES = 4


def run_dirs(root):
    """The detector's and the joint pipelines' seeded run dirs."""
    for name, config in CONFIGS.items():
        checks.seeded_run_dir(config, str(root / name), seed=SEEDS[name],
                              min_iou=0.0)
    return {name: str(root / name) for name in CONFIGS}


def world_report(root, val_scenes):
    """Every task on ``val_scenes`` val scenes: world 1 here, world 2 in
    one spawn."""
    dirs = run_dirs(root)
    evals = [(task, dirs[d], val_scenes) for task, d in TASKS.items()]
    return checks.evals_world_vs_one(evals, world=2, threads=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch, OpenMP and BLAS thread in this process, as in each rank:
    the test workers share the machine's cores, and idle BLAS pools spin
    (numpy's, in the world-1 evals' host metrics)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    return world_report(tmp_path_factory.mktemp("dist_eval"), VAL_SCENES)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_two_ranks_equal_one(report, task):
    rec = next(r for r in report["evals"] if r["task"] == task)
    assert rec["mismatches"] == []
    assert rec["val_batches_per_rank"] == [2, 2]


def test_metrics_are_not_trivial(report):
    """The comparisons hold real numbers: boxes matched, captions scored,
    proposals grounded, points classified and instances found."""
    got = {r["task"]: r["metrics_world2"] for r in report["evals"]}
    assert got["detection"]["mAP@0.25"] > 0
    assert got["captioning"]["cider"] > 0
    assert got["grounding"]["iou_mean"] > 0
    assert got["scannet"]["accuracy"] > 0 and got["scannet"]["AP@25"] > 0


# --------------------------------------------------------------------------
# merging without a spawn

def _boxes(rng, n):
    c = rng.uniform(-1, 1, (n, 3))
    s = rng.uniform(0.2, 0.8, (n, 3))
    from d3net_tpu_torch.utils.bbox import box_corners
    return np.stack([box_corners(ci, si) for ci, si in zip(c, s)])


def _feed(evs, rng, batches=3, rows=4):
    """Seeded scenes into ``evs`` (one evaluator set a rank; one set is
    world 1), batch by batch, each rank its ``split_rows``: a last batch of
    3 rows is rank 0's alone at world 2."""
    sizes = [rows] * (batches - 1) + [rows - 1]
    for b, n_rows in enumerate(sizes):
        scenes = []
        for i in range(n_rows):
            p, g = 6, 4
            pc, gc = _boxes(rng, p), _boxes(rng, g)
            gc[:2] = pc[:2] + rng.normal(0, 0.05, (2, 8, 3))
            words = [f"w{int(x)}" for x in rng.integers(0, 6, p)]
            caps = [f"sos {w} chair eos" for w in words]
            refs = {j: [f"w{j} chair", f"w{(j + 1) % 6} table"]
                    for j in range(g)}
            conf = rng.normal(size=(2, p))
            npts = 300
            ids = rng.integers(-1, 3, npts)
            sem = np.where(ids >= 0, ids % 2 + 1, -1)
            inst = [((ids == k) ^ (rng.random(npts) < 0.1), k % 2 + 1,
                     float(rng.random())) for k in range(3)]
            preds = [[(int(rng.integers(0, 3)), pc[k], float(rng.random()))
                      for k in range(p)]]
            gts = [[(int(rng.integers(0, 3)), gc[k]) for k in range(g)]]
            scenes.append((f"scene{b}_{i}", caps, pc, gc, refs, conf, inst,
                           ids, sem, preds, gts))
        for r, (cap, grd, ap, inst_ev) in enumerate(evs):
            lo, hi = mesh.split_rows(n_rows, r, len(evs))
            for ev in (cap, grd, ap, inst_ev):
                ev.batch = b
            for (sid, caps, pc, gc, refs, conf, inst, ids, sem, preds,
                 gts) in scenes[lo:hi]:
                cap.add_scene(sid, caps, pc, np.ones(len(pc)), gc,
                              np.ones(len(gc)), refs)
                grd.add(conf, np.stack([pc, pc]), np.ones((2, len(pc))),
                        gc[:2], np.ones(2), np.array([0, 1]),
                        np.array([17, 3]))
                ap.step(preds, gts)
                inst_ev.add_scene(inst, ids, sem)


def _set():
    return (CaptionEvaluator(0.3), GroundingEvaluator(), APCalculator(0.25),
            InstanceEvaluator(min_region_size=10))


def test_merged_evaluators_equal_one_fed_every_scene():
    one, ranks = [_set()], [_set(), _set()]
    _feed(one, np.random.default_rng(0))
    _feed(ranks, np.random.default_rng(0))
    merged = _set()
    for i, ev in enumerate(merged):
        ev.load_records(mesh.merge_ordered([r[i].records() for r in ranks]))
    want = one[0]
    assert merged[0].compute() == want[0].compute()
    assert merged[0].diagnostics() == want[0].diagnostics()
    assert list(merged[0].gts) == list(want[0].gts)
    assert merged[1].compute() == want[1].compute()
    assert merged[2].compute_metrics() == want[2].compute_metrics()
    assert merged[3].compute() == want[3].compute()
    assert want[0].compute()["bleu4"] > 0 and want[3].compute()["AP@25"] > 0
    # rank order alone (all of rank 0, then rank 1) is another corpus order
    cat = _set()[0]
    cat.load_records([rec for r in ranks for _, rec in r[0].records()])
    assert list(cat.gts) != list(want[0].gts)


def test_checkpointer_saves_once_over_two_ranks(tmp_path):
    results = mesh.spawn(checks.checkpoint_rank, 2, str(tmp_path), threads=1)
    assert [r["wrote"] for r in results] == [True, False]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["5"]
    assert sorted(os.listdir(tmp_path / "ckpt_best")) == ["5", "best.json"]
    with open(tmp_path / "ckpt_best" / "best.json") as f:
        assert json.load(f) == {"step": 5, "value": 0.5,
                                "monitor": "total_loss", "mode": "min"}
    # every rank left save() with the checkpoint on disk
    assert all(r["on_disk"] for r in results)


def test_detector_forward_reproduces_itself_in_halves(tmp_path):
    """``checks.detector_repro`` on the CPU: the eval forward is bit-equal
    run to run and for each half of a val batch against its rows of the
    whole, the property two ranks' equality with one rests on."""
    run = str(tmp_path / "det")
    checks.seeded_run_dir(CONFIGS["det"], run, seed=SEEDS["det"])
    cfg = load_task_config(os.path.join(run, "config.yaml"))
    spec = tloop.spec_from_cfg(cfg)
    state, _ = eval_cli.restore_for_eval(
        tloop.init_detector(tloop.detector_from_cfg(cfg), 0), cfg, run)
    _, scenes = next(iter(tloop.make_val_loader(cfg, spec,
                                                return_scenes=True)))
    got = checks.detector_repro(state.model.eval(), scenes, spec, "cpu")
    for settings in got.values():
        for case in settings.values():
            assert not any(case.values()), got
