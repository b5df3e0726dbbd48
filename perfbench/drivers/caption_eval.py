"""Driver: the dense-captioning eval (``scripts.eval --task captioning``:
``train/pipeline.py`` ``run_pipeline_validation`` mode 1), one unit a
pass over the val split.

Set-up makes the traffic's val scenes, the program's val loader over them
(as ``make_val_loader`` builds it: batches in order, no augmentation, the
scenes returned beside each batch), the vocabulary and embeddings
(``build_vocab``) and the ``PipelineNet`` of the configuration from the
benchmark's seeded weights, then runs one pass to warm every shape up. A
unit is one ``run_pipeline_validation`` call: each batch's detector
forward, the relational graph, the greedy decode of every proposal, the
captions decoded on the host and scored (CIDEr@kIoU). Each batch's time
runs from the loop asking the loader for it to the loop asking for the
next, its captions scored.

For the check, each batch's records are the program's own tensors (no
copy, no sync): its per-point semantic scores and offsets and its
proposals' objectness logits, its clustering inputs and decisions, its
ScoreNet's pooled features and logits, its proposal ranking and
selection, the decoder's inputs, and its caption ids and their logits. A
sample of the window's batches, drawn from the seed as they come
(reservoir sampling, so the records of the batches not kept are freed),
is compared after the window (``reference/caption_eval.py``).
"""

from __future__ import annotations

import copy
import random
import time
from typing import Any, Dict, List

import torch

import d3net_tpu_torch.models.pointgroup as pointgroup_mod
from d3net_tpu_torch.config import Config
from d3net_tpu_torch.data.collate import batch_to_torch
from d3net_tpu_torch.data.dataset import BatchIterator
from d3net_tpu_torch.kernels import gather
from d3net_tpu_torch.train import loop
from d3net_tpu_torch.train import pipeline as pipe
from perfbench.harness import traffic as traffic_gen
from perfbench.harness.seeds import derive
from perfbench.harness.weights import seeded_state
from perfbench.reference.caption_eval import DETECTOR_KEYS
from perfbench.work import detector as det_work
from perfbench.work import speaker as spk_work
from perfbench.work.gather import gather_bytes, recording

SAMPLED_BATCHES = 4


def program_config(cell) -> Dict[str, Any]:
    cfg = copy.deepcopy(cell.config["config"])
    cfg["data"]["batch_size"] = int(cell.traffic["batch_size"])
    cfg["data"]["synthetic"]["num_val_scenes"] = int(
        cell.traffic["num_val_scenes"])
    return cfg


class _Timed:
    """The val loader, each batch's latency taken from the loop's ask to
    its next ask."""

    def __init__(self, it, lat: List[float], keep=None):
        self.it, self.lat, self.keep = it, lat, keep
        self.spec = it.spec

    def splits(self, b):
        return self.it.splits(b)

    def __iter__(self):
        t = time.perf_counter()
        for item in self.it:
            if self.keep is not None:
                self.keep.append(item[0])
            yield item
            now = time.perf_counter()
            self.lat.append(now - t)
            t = now


class Driver:
    def __init__(self, run):
        self.run = run
        self.dev = run.device
        cell = run.cell
        self.cfg_dict = program_config(cell)
        self.cfg = Config(copy.deepcopy(self.cfg_dict))
        t0 = time.perf_counter()
        self.vocab, self.emb = pipe.build_vocab(self.cfg)
        self.scenes = traffic_gen.make_scenes(cell.traffic, run.seed, "val")
        t1 = time.perf_counter()
        spec = loop.spec_from_cfg(self.cfg)
        self.val_it = BatchIterator(
            self.scenes, spec, self.cfg.data.batch_size, shuffle=False,
            augment=False, seed=0, drop_last=False, return_scenes=True,
            workers=int(cell.traffic.get("workers", 1)))
        model = pipe.pipeline_from_cfg(self.cfg, self.vocab).to(self.dev)
        self.start = seeded_state(model, derive(run.seed, "weights"),
                                  self.dev)
        model.load_state_dict(self.start)
        self.model = model.eval()
        self._record = None
        self._install()
        t2 = time.perf_counter()
        batches: list = []
        self._reservoir(None)
        self.unit(batches)               # every shape, warmed up
        self.phases = {"scenes": t1 - t0, "model": t2 - t1,
                       "warm_pass": time.perf_counter() - t2}
        self._reservoir(random.Random(derive(run.seed, "sample")))
        self.flops_per_unit = self._flops(batches)

    def _reservoir(self, rng) -> None:
        """Start the sample of the window's batches (``rng`` None: keep
        nothing, as in the warm-up pass)."""
        self.rng, self.seen, self.kept = rng, 0, []

    def _offer(self, rec: Dict[str, Any]) -> None:
        """One batch's records into the seeded sample of
        ``SAMPLED_BATCHES`` (each batch of the window equally likely)."""
        if self.rng is None:
            return
        if len(self.kept) < SAMPLED_BATCHES:
            self.kept.append(rec)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < SAMPLED_BATCHES:
                self.kept[j] = rec
        self.seen += 1

    def _install(self) -> None:
        """Keep each batch's clustering, ranking and captions (references
        to the program's own tensors: no copy, no sync)."""
        model = self.model
        det = model.detector
        inner_cluster = det._cluster_batch
        inner_topk = pointgroup_mod.topk_stable
        inner_speaker = model.run_speaker
        caption = model.speaker.caption
        inner_decode = caption.greedy_decode
        inner_score = det.score_net.forward

        def cluster(*args):
            out = inner_cluster(*args)
            self._record["clusters"].append(
                {"inputs": list(args), "outputs": list(out)})
            return out

        def score(*a, **kw):
            scores, pooled = inner_score(*a, **kw)
            self._record["scorenet"].append(
                {"scores": scores, "pooled": pooled})
            return scores, pooled

        def topk(rank, k):
            out = inner_topk(rank, k)
            self._record["ranks"].append((rank, out[1]))
            return out

        def decode(embeddings, target_feat, obj_feats, valid_masks, *a,
                   **kw):
            ids, logits = inner_decode(embeddings, target_feat, obj_feats,
                                       valid_masks, *a, **kw)
            # the served tokens' logits (one small gather) and the
            # decoder's inputs
            self._record["logits"].append(
                logits.gather(-1, ids.long()[..., None])[..., 0])
            self._record["decoder"].append(
                {"target_feat": target_feat, "obj_feats": obj_feats})
            return ids, logits

        def speaker(data, *a, **kw):
            out = inner_speaker(data, *a, **kw)
            self._record["ids"].append(out["lang_cap"])
            self._record["detector"].append(
                {k: data[k] for k in DETECTOR_KEYS})
            return out

        det._cluster_batch = cluster
        det.score_net.forward = score
        pointgroup_mod.topk_stable = topk
        model.run_speaker = speaker
        caption.greedy_decode = decode
        self._uninstall = (det, inner_topk, model)

    def unit(self, keep=None) -> Dict[str, Any]:
        lat: List[float] = []
        self._record = {"clusters": [], "ranks": [], "scorenet": [],
                        "ids": [], "detector": [], "decoder": [],
                        "logits": []}
        metrics = pipe.run_pipeline_validation(
            self.cfg, self.model, _Timed(self.val_it, lat, keep), self.vocab,
            self.emb, mode=1)
        for b in range(len(self._record["ids"])):
            self._offer(dict({k: v[b] for k, v in self._record.items()},
                             batch=b))
        self._record = None
        return {"scenes": len(self.scenes), "batches": len(lat),
                "latencies": lat, "attempted": len(self.scenes),
                "failed": int(not all(v == v for v in metrics.values()))}

    def _flops(self, batches) -> float:
        """The operations of one pass: each val batch's detector forward
        (its tables' valid entries) and the speaker's graph and decode."""
        c = self.cfg_dict
        keys = dict(c["model"], classes=c["data"]["classes"],
                    clusters_per_pass=c["tpu"]["clusters_per_pass"],
                    score_fullscale=c["train"]["score_fullscale"])
        in_ch = loop.in_channels_from_cfg(self.cfg)
        props = int(c["model"]["max_num_proposal"])
        fl = 0.0
        for batch_np in batches:
            b = batch_np["point_mask"].shape[0]
            tables = batch_to_torch({"t": batch_np["tables"]}, "cpu")["t"]
            fl += det_work.detector_step_flops(
                det_work.level_counts(tables), keys, in_ch, b, train=False)
            fl += spk_work.graph_flops(
                b, props, c["model"]["m"] * c["model"]["cluster_blocks"][0],
                c["model"]["num_graph_steps"], c["model"]["num_locals"],
                bool(c["model"]["use_orientation"]))
            fl += spk_work.decode_flops(b * props, props, len(self.vocab),
                                        int(c["data"]["max_spk_len"]) + 1)
        return fl

    def trace_extras(self) -> Dict[str, Any]:
        """One more pass with every gather's bytes counted (outside the
        traced unit)."""
        calls: list = []
        with recording(gather, calls):
            self.unit()
        return {"gather_launches": len(calls),
                "gather_bytes": sum(gather_bytes(*c) for c in calls)}

    def work(self) -> Dict[str, float]:
        return {"flops_per_unit": self.flops_per_unit,
                "peak_flops": float(self.run.cell.config["peak_flops"]),
                "peak_bytes_per_s":
                    float(self.run.cell.config["peak_bytes_per_s"])}

    def release(self) -> None:
        det, inner_topk, model = self._uninstall
        del det._cluster_batch, det.score_net.forward
        pointgroup_mod.topk_stable = inner_topk
        del model.run_speaker
        del model.speaker.caption.greedy_decode
        self.sample = [_to_host(rec) for rec in self.kept]
        del self.model, self.kept
        torch.cuda.empty_cache()

    def check(self, control=None, fault=None) -> Dict[str, float]:
        """The sampled units against the reference; ``control`` (a dtype's
        name) puts the reference computed in it in the program's place."""
        from perfbench.reference import caption_eval as ref

        if fault:
            raise ValueError(f"no planted fault {fault} in this reference")
        return ref.judge_sample(self.cfg_dict, self.scenes, self.start,
                                self.sample, self.dev, control)


def _to_host(rec):
    if isinstance(rec, dict):
        return {k: _to_host(v) for k, v in rec.items()}
    if isinstance(rec, (list, tuple)):
        return type(rec)(_to_host(v) for v in rec)
    return rec.detach().cpu() if torch.is_tensor(rec) else rec
