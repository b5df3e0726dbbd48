"""Port the reference's pretrained ENet checkpoint to the port's encoder.

The port's ``scripts/port_enet_weights.py``. The reference extracts frozen
128-d multiview features with a torch7-converted ENet loaded from
``scannetv2_enet.pth`` (``create_enet_for_3d`` keeps everything but the
final 1x1 classifier). That checkpoint is a positional ``state_dict`` over
a deeply nested ``nn.Sequential``; this script maps it onto the Flax tree
of ``ENetEncoder(full=True)`` (22 bottlenecks, the reference's padding
grid, (1,5)+(5,1) asymmetric order) and writes the JAX script's pickle:
``{"params", "batch_stats", "full": True}`` as numpy trees, which
``params.load_enet_pickle`` and ``compute_multiview_features --weights``
of either package read (the full layout is picked by ``Bottleneck_21``).

    python -m d3net_tpu_torch.scripts.port_enet_weights \
        --checkpoint scannetv2_enet.pth --output pretrained/enet_scannet.pkl
    python -m d3net_tpu_torch.scripts.port_enet_weights --selftest [--cpu]

``--selftest`` needs no checkpoint: it maps a random state_dict with the
real file's keys and shapes (``synth_state_dict``) and checks every key
consumed, every leaf of the port's ``ENetEncoder(full=True)`` written with
its shape, and a forward of a seeded (1, 64, 64, 3) image to a finite
(1, 8, 8, 128). It runs on CUDA unless ``--cpu`` is given; without a GPU
and without ``--cpu`` it raises. The conversion itself runs on the host.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from d3net_tpu_torch.device import DeviceLike, resolve_device

# ---------------------------------------------------------------------------
# torch-side layout (derived from the literal nn.Sequential in the
# reference's model/enet.py:130-589; entries 0-3 initial block, 4..25
# bottlenecks, 26 classifier — dropped)
# ---------------------------------------------------------------------------

# (mid, out, kind) per bottleneck; kind in {"down", "reg", "asym"}
_BOTTLENECKS = (
    [(16, 64, "down")] + [(16, 64, "reg")] * 4
    + [(32, 128, "down")]
    + [(32, 128, k) for k in ("reg", "reg", "asym", "reg",
                              "reg", "reg", "asym", "reg")] * 2
)


def _conv(o, i, kh, kw, bias):
    d = {"weight": (o, i, kh, kw)}
    if bias:
        d["bias"] = (o,)
    return d


def _bn(c):
    return {"weight": (c,), "bias": (c,), "running_mean": (c,),
            "running_var": (c,)}


def expected_torch_keys() -> Dict[str, Tuple[int, ...]]:
    """Every key of the reference encoder's state_dict -> shape."""
    keys: Dict[str, Tuple[int, ...]] = {}

    def put(prefix, d):
        for k, shp in d.items():
            keys[f"{prefix}.{k}"] = shp

    put("0.0", _conv(13, 3, 3, 3, bias=True))      # initial conv
    put("2", _bn(16))                              # initial BN
    keys["3.weight"] = (16,)                       # initial PReLU
    for bi, (mid, out, kind) in enumerate(_BOTTLENECKS):
        top = 4 + bi
        inp = {0: 16, 5: 64}.get(bi, out)          # in-channels
        br = f"{top}.0.0"
        if kind == "down":
            put(f"{br}.0", _conv(mid, inp, 2, 2, bias=False))
        else:
            put(f"{br}.0", _conv(mid, inp, 1, 1, bias=False))
        put(f"{br}.1", _bn(mid))
        keys[f"{br}.2.weight"] = (mid,)
        if kind == "asym":
            put(f"{br}.3", _conv(mid, mid, 1, 5, bias=False))
            put(f"{br}.4", _conv(mid, mid, 5, 1, bias=True))
            put(f"{br}.5", _bn(mid))
            keys[f"{br}.6.weight"] = (mid,)
            put(f"{br}.7", _conv(out, mid, 1, 1, bias=False))
            put(f"{br}.8", _bn(out))
        else:
            put(f"{br}.3", _conv(mid, mid, 3, 3, bias=True))
            put(f"{br}.4", _bn(mid))
            keys[f"{br}.5.weight"] = (mid,)
            put(f"{br}.6", _conv(out, mid, 1, 1, bias=False))
            put(f"{br}.7", _bn(out))
        keys[f"{top}.2.weight"] = (out,)           # final PReLU
    return keys


# ---------------------------------------------------------------------------
# mapping to the Flax tree
# ---------------------------------------------------------------------------

def _t(w):
    """torch conv (O, I, KH, KW) -> flax (KH, KW, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def port_enet_state_dict(sd: Dict[str, np.ndarray]):
    """Positional torch state_dict -> (params, batch_stats) for
    ENetEncoder(full=True).  Raises on missing keys; reports leftovers."""
    sd = dict(sd)
    used = set()

    def take(k):
        used.add(k)
        return np.asarray(sd[k], dtype=np.float32)

    def conv(prefix, bias):
        out = {"kernel": _t(take(f"{prefix}.weight"))}
        if bias:
            out["bias"] = take(f"{prefix}.bias")
        return out

    def bn(prefix):
        p = {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}
        s = {"mean": take(f"{prefix}.running_mean"),
             "var": take(f"{prefix}.running_var")}
        return p, s

    params: Dict = {}
    stats: Dict = {}

    ib_bn_p, ib_bn_s = bn("2")
    params["InitialBlock_0"] = {
        "Conv_0": conv("0.0", bias=True),
        "BatchNorm_0": ib_bn_p,
        "PReLU_0": {"alpha": take("3.weight")},
    }
    stats["InitialBlock_0"] = {"BatchNorm_0": ib_bn_s}

    for bi, (_mid, _out, kind) in enumerate(_BOTTLENECKS):
        top = 4 + bi
        br = f"{top}.0.0"
        p: Dict = {}
        s: Dict = {}
        p["Conv_0"] = conv(f"{br}.0", bias=False)
        p["BatchNorm_0"], s["BatchNorm_0"] = bn(f"{br}.1")
        p["PReLU_0"] = {"alpha": take(f"{br}.2.weight")}
        if kind == "asym":
            p["Conv_1"] = conv(f"{br}.3", bias=False)   # (1,5)
            p["Conv_2"] = conv(f"{br}.4", bias=True)    # (5,1)
            p["BatchNorm_1"], s["BatchNorm_1"] = bn(f"{br}.5")
            p["PReLU_1"] = {"alpha": take(f"{br}.6.weight")}
            p["Conv_3"] = conv(f"{br}.7", bias=False)
            p["BatchNorm_2"], s["BatchNorm_2"] = bn(f"{br}.8")
        else:
            p["Conv_1"] = conv(f"{br}.3", bias=True)
            p["BatchNorm_1"], s["BatchNorm_1"] = bn(f"{br}.4")
            p["PReLU_1"] = {"alpha": take(f"{br}.5.weight")}
            p["Conv_2"] = conv(f"{br}.6", bias=False)
            p["BatchNorm_2"], s["BatchNorm_2"] = bn(f"{br}.7")
        p["PReLU_2"] = {"alpha": take(f"{top}.2.weight")}
        params[f"Bottleneck_{bi}"] = p
        stats[f"Bottleneck_{bi}"] = s

    leftovers = sorted(
        k for k in sd
        if k not in used
        and not k.startswith("26.")                 # classifier — dropped
        and not k.endswith("num_batches_tracked")
    )
    if leftovers:
        raise ValueError(f"unmapped checkpoint keys: {leftovers[:8]} "
                         f"(+{max(0, len(leftovers) - 8)} more)")
    return params, stats


def synth_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random state_dict with the real checkpoint's exact keys/shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in expected_torch_keys().items():
        if k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 1.5, shp).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.1, shp).astype(np.float32)
    return out


def selftest(device: DeviceLike = None) -> np.ndarray:
    """Map ``synth_state_dict()`` and hold it to the port's
    ``ENetEncoder(full=True)``: every leaf written with its shape, and a
    finite (1, 8, 8, 128) forward of a seeded image on ``device``, which
    it returns."""
    import torch

    from d3net_tpu_torch.models.enet import ENetEncoder
    from d3net_tpu_torch.params import (
        enet_flax_to_state_dict, enet_state_dict_to_flax, flatten,
    )

    dev = resolve_device(device)
    params, stats = port_enet_state_dict(synth_state_dict())
    model = ENetEncoder(full=True)
    ref_shapes = {k: v.shape for k, v in flatten(
        enet_state_dict_to_flax(model)).items()}
    got_shapes = {k: v.shape for k, v in flatten(
        {"params": params, "batch_stats": stats}).items()}
    missing = sorted(set(ref_shapes) - set(got_shapes))
    extra = sorted(set(got_shapes) - set(ref_shapes))
    bad = [(k, ref_shapes[k], got_shapes[k]) for k in ref_shapes
           if k in got_shapes and ref_shapes[k] != got_shapes[k]]
    if missing or extra or bad:
        raise AssertionError(f"missing leaves: {missing[:6]}, extra leaves: "
                             f"{extra[:6]}, shape mismatches: {bad[:4]}")

    model.load_state_dict(enet_flax_to_state_dict(
        {"params": params, "batch_stats": stats}, model))
    model.to(dev).eval()
    x = np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        y = model(torch.from_numpy(x).to(dev)).cpu().numpy()
    if y.shape != (1, 8, 8, 128) or not np.isfinite(y).all():
        raise AssertionError(f"selftest forward: shape {y.shape}, finite "
                             f"{bool(np.isfinite(y).all())}")
    print(f"selftest OK: {len(ref_shapes)} leaves mapped, output {y.shape}")
    return y


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", help="scannetv2_enet.pth (torch)")
    ap.add_argument("--output", default="pretrained/enet_scannet.pkl")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the selftest's forward on the CPU")
    args = ap.parse_args(argv)

    if args.selftest:
        selftest("cpu" if args.cpu else None)
        return
    if not args.checkpoint:
        ap.error("--checkpoint required (or use --selftest)")

    import torch

    sd = torch.load(args.checkpoint, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    params, stats = port_enet_state_dict(sd)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats,
                     "full": True}, f)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
