"""The comparisons that decide ``correct``.

A training cell compares, against the reference's run of the same first
steps from the same weights and inputs:

- ``loss``: the largest relative gap of a step's total loss;
- ``grad``: the first gradient as the optimizer got it (AdamW's first
  moment after one step, over ``1 - beta1``), by the worst leaf: the gap
  between the program's and the reference's norm of the leaf over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change``: the same measure of each leaf's change over the first steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf the loss barely reaches, such as a bias
  that only shifts a BatchNorm's input, moves under Adam by round-off).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

BETA1 = 0.9
SMALL_GRAD = 1e-3
BIG_LEAF = 4096      # elements: a kernel, not a BatchNorm vector


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's L2 norm (float64 on the host), read in one transfer."""
    keys = list(tensors)
    if not keys:
        return {}
    vals = torch.stack([tensors[k].detach().double().norm() for k in keys])
    return dict(zip(keys, vals.tolist()))


def first_grads(model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> Dict[str, torch.Tensor]:
    """The first step's gradients, worked out from Adam's state (copies)."""
    state = optimizer.state
    return {n: state[p]["exp_avg"] / (1.0 - BETA1)
            for n, p in model.named_parameters()
            if p in state and "exp_avg" in state[p]}


def changes(model: torch.nn.Module,
            start: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's change from ``start``."""
    return {n: p.detach() - start[n] for n, p in model.named_parameters()}


def worst_leaf_gap(got: Mapping[str, float], want: Mapping[str, float],
                   keys: Optional[Sequence[str]] = None
                   ) -> Tuple[float, str]:
    """(largest gap, its leaf) over ``keys`` (default: all of ``want``'s);
    a leaf the program lacks or reads as not finite gives ``inf``."""
    keys = list(want if keys is None else keys)
    med = statistics.median([want[k] for k in want]) if want else 0.0
    worst, where = 0.0, ""
    for k in keys:
        g = got.get(k, float("nan"))
        den = max(want[k], med, 1e-30)
        gap = abs(g - want[k]) / den if math.isfinite(g) else math.inf
        if gap > worst or not math.isfinite(gap):
            worst, where = gap, k
            if not math.isfinite(gap):
                break
    return worst, where


def moved_leaves(grads: Mapping[str, float]) -> List[str]:
    """The leaves whose gradient is at least ``SMALL_GRAD`` of the median
    leaf's: the others move by round-off alone."""
    med = statistics.median(grads.values())
    return [k for k, v in grads.items() if v >= SMALL_GRAD * med]


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    gaps = [abs(g - w) / max(abs(w), 1e-30) if math.isfinite(g) else math.inf
            for g, w in zip(got, want)]
    return max(gaps) if len(got) == len(want) else math.inf


def leaf_gaps(got: Mapping[str, float], want: Mapping[str, float],
              keys: Sequence[str]) -> List[float]:
    med = statistics.median(want.values())
    return [abs(got.get(k, math.inf) - want[k]) / max(want[k], med, 1e-30)
            for k in keys]


def diff_norms(got: Mapping[str, torch.Tensor],
               want: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's ``|got - want| / |want|`` (``inf`` where ``got`` lacks
    the leaf or its shape)."""
    keys = [k for k in want if k in got and got[k].shape == want[k].shape]
    out = dict.fromkeys(want, math.inf)
    if keys:
        num = leaf_norms({k: got[k] - want[k] for k in keys})
        den = leaf_norms({k: want[k] for k in keys})
        out.update({k: num[k] / max(den[k], 1e-30) for k in keys})
    return out


def global_diff(got: Mapping[str, torch.Tensor],
                want: Mapping[str, torch.Tensor]) -> float:
    """``|got - want| / |want|`` over all the leaves at once."""
    if any(k not in got or got[k].shape != want[k].shape for k in want):
        return math.inf
    num = sum(float((got[k].double() - want[k].double()).pow(2).sum())
              for k in want)
    den = sum(float(want[k].double().pow(2).sum()) for k in want)
    return math.sqrt(num / max(den, 1e-300))


def training_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """The numbers of a training cell; each reading is a dict with
    ``losses`` and the tensors ``grads`` and ``changes``. Beside the
    three of the module docstring: ``loss.first`` (the first step's loss
    alone), the median leaf's ``grad.median`` and ``change.median`` (the
    same gaps of norms), and the median leaf's ``grad.diff`` and
    ``change.diff``: the norm of the difference over the reference's norm
    (rounding that leaves a leaf's norm alone moves these); ``grad.big``,
    the same over the leaves of at least ``BIG_LEAF`` elements, and
    ``grad.global`` over all leaves at once; ``forward``: the first step's
    forward outputs (``forward`` of each reading: semantic scores and
    offsets of every point), the larger relative difference of the two."""
    pg, rg = leaf_norms(prog["grads"]), leaf_norms(ref["grads"])
    pc, rc = leaf_norms(prog["changes"]), leaf_norms(ref["changes"])
    moved = moved_leaves(rg)
    g = leaf_gaps(pg, rg, list(rg))
    c = leaf_gaps(pc, rc, moved)
    gd = diff_norms(prog["grads"], ref["grads"])
    cd = diff_norms(prog["changes"], ref["changes"])
    big = [k for k, v in ref["grads"].items() if v.numel() >= BIG_LEAF]
    return {
        "loss": loss_gap(prog["losses"], ref["losses"]),
        "grad": worst_leaf_gap(pg, rg)[0],
        "change": worst_leaf_gap(pc, rc, moved)[0],
        "loss.first": loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad.median": statistics.median(g) if g else math.inf,
        "change.median": statistics.median(c) if c else math.inf,
        "grad.diff": statistics.median(gd.values()) if gd else math.inf,
        "change.diff": (statistics.median(cd[k] for k in moved)
                        if moved else math.inf),
        "grad.big": (statistics.median(gd[k] for k in big)
                     if big else math.inf),
        "grad.global": global_diff(prog["grads"], ref["grads"]),
        "forward": max((global_diff({k: prog["forward"][k]},
                                    {k: ref["forward"][k]})
                        for k in ref.get("forward", {})), default=math.inf),
    }


def training_detail(prog: Mapping, ref: Mapping) -> Dict[str, object]:
    """Where the worst leaves are: each worst-leaf number's leaf, its
    size and its reference norm (for the look a limit needs)."""
    pg, rg = leaf_norms(prog["grads"]), leaf_norms(ref["grads"])
    pc, rc = leaf_norms(prog["changes"]), leaf_norms(ref["changes"])
    gv, gk = worst_leaf_gap(pg, rg)
    cv, ck = worst_leaf_gap(pc, rc, moved_leaves(rg))
    gd = diff_norms(prog["grads"], ref["grads"])
    top = sorted(gd.items(), key=lambda kv: -kv[1])[:3]
    def leaf(k, tensors, norms):
        return [k, tensors[k].numel(), norms[k]] if k else None

    return {"grad_leaf": leaf(gk, ref["grads"], rg),
            "change_leaf": leaf(ck, ref["changes"], rc),
            "grad_diff_top": [[k, v] for k, v in top],
            "grad_median_norm": statistics.median(rg.values())}


def judge(numbers: Mapping[str, float],
          limits: Mapping[str, float]) -> List[Tuple[str, float, float, bool]]:
    """(name, value, limit, within) per limited number; a number with no
    limit is not compared."""
    out = []
    for k, lim in limits.items():
        v = numbers.get(k, math.inf)
        out.append((k, v, float(lim), math.isfinite(v) and v <= lim))
    return out
