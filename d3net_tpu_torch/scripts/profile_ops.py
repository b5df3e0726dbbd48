"""Per-op device profile of the flagship forward, train step or one level-0
conv (the JAX package's ``scripts/profile_ops.py``).

    python -m d3net_tpu_torch.scripts.profile_ops [--what fwd|train|conv0|backbone]
        [--conv gather|block|column|colres] [--top 40] [--logdir DIR] [--cpu]

Builds the flagship batch (``params.flagship_config``: 4 synthetic scenes of
16 instances with multiview features, caps 131072..2048, 32 instances,
bf16), times the first and the second call of the chosen work on the
host's clock, then records one more call (``conv0``: three) with
``torch.profiler`` and writes its Chrome trace to ``--logdir/trace.json``
(a temporary directory by default). It prints the total device time and
the number of device events, the time in each category (gather, scatter,
conv/matmul, copy/concat/slice, reduce/elementwise, other), the top
``--top`` kernels by device time with their counts, and the ``gather_rows``
launches of the recorded call (75 a forward, 216 a train step).

``--what conv0`` is one level-0 3x3x3 submanifold conv of the flagship
batch's tables at C=16, B=4, bf16; ``backbone`` profiles the forward, as
in the JAX tool. ``--conv`` takes the JAX tool's four layouts: the TPU
tilings (``block``, ``column``, ``colres``) run as the gather layout, as the
run loops run them, and the output says which was asked for.

Runs on CUDA unless ``--cpu`` is given (then the host time of each aten op
stands in for the device time); without a GPU and without ``--cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from d3net_tpu_torch.device import resolve_device
from d3net_tpu_torch.kernels import gather

CATEGORIES = ("gather", "scatter", "conv/matmul", "copy/concat/slice",
              "reduce/elementwise", "other")
_ELEMENTWISE_OPS = (
    "add|sub|rsub|mul|div|neg|abs|sign|exp|log|log2|log1p|sqrt|rsqrt|pow"
    "|reciprocal|floor|ceil|round|remainder|fmod|erf|relu|leaky_relu|prelu"
    "|gelu|sigmoid|tanh|threshold|clamp|clamp_min|clamp_max|where"
    "|masked_fill|fill|zero|lt|le|gt|ge|eq|ne|bitwise_and|bitwise_or"
    "|bitwise_not|logical_and|logical_or|logical_not|maximum|minimum|max"
    "|min|amax|amin|argmax|argmin|sum|mean|prod|cumsum|any|all|norm"
    "|linalg_vector_norm|native_layer_norm|native_batch_norm|_softmax"
    "|_log_softmax|softmax|log_softmax")
# the aten op that launched a kernel decides first (on the CPU the op is
# all there is); a kernel launched outside any aten op (``gather_rows``,
# an autograd node's own) or under an op not named here goes by its name
_OP_CATS = [(c, re.compile(rf"^aten::(?:{rx})_?$")) for c, rx in [
    ("gather", r"index_select|gather|index|take|take_along_dim|embedding"),
    ("scatter", r"index_add|scatter|scatter_add|scatter_reduce|index_put"
                r"|_index_put_impl"),
    ("conv/matmul", r"mm|addmm|bmm|baddbmm|matmul|linear|convolution"
                    r"|_convolution|cudnn_convolution|conv\w*"),
    ("copy/concat/slice", r"copy|cat|slice|narrow|constant_pad_nd|pad"
                          r"|contiguous|clone|_to_copy|flip|stack|repeat"
                          r"|roll"),
    ("reduce/elementwise", _ELEMENTWISE_OPS),
]]
_KERNEL_CATS = [(c, re.compile(rx, re.I)) for c, rx in [
    ("gather", r"gather_rows|indexSelect|index_select|index_elementwise"),
    ("scatter", r"indexFunc|index_add|scatter|index_put"),
    ("conv/matmul", r"gemm|xmma|cutlass|cublas|cudnn|conv|wgmma|nvjet"
                    r"|^sm\d+_"),
    ("copy/concat/slice", r"memcpy|memset|copy|CatArray|concat|slice|pad"
                          r"|transpose|roll"),
    ("reduce/elementwise", r"reduce|elementwise|softmax|norm"),
]]


def categorize(kernel: str, op: str = "") -> str:
    """The category of device work ``kernel`` (a CUDA kernel's name, or on
    the CPU an aten op's) launched by the aten op ``op`` ("" for none);
    "other" where neither names one (a sort, an arange)."""
    for cat, rx in _OP_CATS:
        if rx.search(op):
            return cat
    for cat, rx in _KERNEL_CATS:
        if rx.search(kernel):
            return cat
    return "other"


def profile_rows(prof, device: torch.device) -> List[Dict]:
    """One row per device event of ``prof`` (a finished ``torch.profiler``
    profile): ``name`` (the kernel's), ``op`` (the aten op that launched
    it, or ""), ``ms``. On the CPU every aten op's own host time stands in
    (``name`` and ``op`` both the op's)."""
    from torch.autograd import DeviceType

    events = prof.events()
    if device.type == "cpu":
        return [{"name": e.name, "op": e.name,
                 "ms": e.self_cpu_time_total / 1e3}
                for e in events
                if e.device_type == DeviceType.CPU and not e.is_async
                and e.name.startswith("aten::") and e.self_cpu_time_total > 0]
    ops = {e.id: e.name for e in events if e.device_type == DeviceType.CPU}
    return [{"name": e.name,
             "op": ops.get(getattr(e, "linked_correlation_id", 0), ""),
             "ms": (e.time_range.end - e.time_range.start) / 1e3}
            for e in events if e.device_type == DeviceType.CUDA]


def summarize(rows: Sequence[Dict], top: int = 40,
              label: str = "device") -> Dict:
    """Total time and event count, time by category and the top ``top``
    names by time with their counts, printed and returned."""
    per_name: Dict[str, float] = {}
    per_name_n: Dict[str, int] = {}
    cats = {c: 0.0 for c in CATEGORIES}
    for r in rows:
        per_name[r["name"]] = per_name.get(r["name"], 0.0) + r["ms"]
        per_name_n[r["name"]] = per_name_n.get(r["name"], 0) + 1
        cats[categorize(r["name"], r["op"])] += r["ms"]
    total = sum(per_name.values())
    print(f"\n== {label} time: {total:.1f} ms over {len(rows)} events ==")
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:<22} {ms:9.1f} ms  {100 * ms / max(total, 1e-9):5.1f}%")
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    print(f"\n== top {top} ops ==")
    for name, ms in ranked:
        print(f"  {ms:9.2f} ms  x{per_name_n[name]:<5} {name[:110]}")
    return {"total_ms": total, "events": len(rows), "categories": cats,
            "top": [[name, ms, per_name_n[name]] for name, ms in ranked]}


def build_flagship(device: torch.device, multiview: bool = True):
    """The flagship batch on ``device`` and its bf16 detector with seeded
    weights (``multiview=False``: the scenes without features, as the JAX
    tool's ``conv0`` makes them)."""
    from d3net_tpu_torch.data.collate import batch_to_torch, build_batch
    from d3net_tpu_torch.data.synthetic import make_scene
    from d3net_tpu_torch.models.pointgroup import PointGroup
    from d3net_tpu_torch.params import (
        flagship_config, init_flax_variables, load_detector,
    )

    flag = flagship_config()
    kw = dict(flag.scene_kwargs, with_multiview=multiview)
    scenes = [make_scene(seed=i, **kw) for i in range(flag.batch_size)]
    batch = batch_to_torch(build_batch(scenes, flag.spec), device)
    if not multiview:
        return None, batch
    in_ch = flag.spec.feat_dim() + 3
    variables = init_flax_variables(PointGroup(in_ch, **flag.model), seed=0)
    return load_detector(variables, flag.model, device=device), batch


def work(what: str, device: torch.device):
    """The call to profile (it returns a scalar tensor) and how many calls
    the profile records."""
    if what == "conv0":
        from d3net_tpu_torch.models.blocks import fold_tables
        from d3net_tpu_torch.ops.sparse_conv import sparse_conv_t

        _, batch = build_flagship(device, multiview=False)
        nbr = fold_tables(batch["tables"])[0]["nbr"]
        g = torch.Generator(device=device)
        x = torch.randn(nbr.shape[0], 16, generator=g.manual_seed(1),
                        device=device).bfloat16()
        w = torch.randn(27, 16, 16, generator=g.manual_seed(2), device=device)

        def conv0():
            with torch.no_grad():
                return sparse_conv_t(x, nbr, nbr, w, flip_t=True).sum()
        return conv0, 3
    model, batch = build_flagship(device)
    if what in ("fwd", "backbone"):
        def fwd():
            with torch.no_grad():
                return model(batch)["proposal_scores_all"].sum()
        return fwd, 1
    from d3net_tpu_torch.train.trainer import (
        create_train_state, detector_train_step,
    )

    state = create_train_state(model, lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(1)

    def train():
        return detector_train_step(state, batch, gen)[1]["total_loss"]
    return train, 1


def profile(what: str = "fwd", conv: str = "colres", top: int = 40,
            logdir: Optional[str] = None, device=None) -> Dict:
    """Time and profile ``what`` on ``device``; returns the summary with
    ``first_s``, ``second_s``, ``gather_launches`` (of the recorded calls),
    ``calls`` and ``trace``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = resolve_device(device)
    if conv != "gather":
        print(f"conv: {conv} asked for; the port runs it as the gather layout")
    logdir = logdir or tempfile.mkdtemp(prefix="d3net_prof_")
    fn, calls = work(what, dev)
    walls = []
    for _ in range(2):
        t0 = time.time()
        float(fn())
        walls.append(time.time() - t0)
    print(f"first call: {walls[0]:.2f}s")
    print(f"second call wall: {walls[1]:.2f}s")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    gather.gather_rows.launches = 0
    with torch_profile(activities=activities) as prof:
        for _ in range(calls):
            float(fn())
    launches = gather.gather_rows.launches
    os.makedirs(logdir, exist_ok=True)
    trace = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(trace)
    print(f"trace: {trace}")
    out = summarize(profile_rows(prof, dev), top,
                    "device" if dev.type == "cuda" else "host op")
    print(f"\ngather_rows launches: {launches} in {calls} call(s)")
    out.update(what=what, conv=conv, calls=calls, first_s=walls[0],
               second_s=walls[1], gather_launches=launches, trace=trace)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="fwd",
                    choices=["fwd", "train", "conv0", "backbone"])
    ap.add_argument("--conv", default="colres",
                    choices=["gather", "block", "column", "colres"])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--logdir", default=None,
                    help="where torch.profiler's Chrome trace goes")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    args = ap.parse_args(argv)
    return profile(args.what, args.conv, args.top, args.logdir,
                   "cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
