"""Flax variables of ``PointGroup`` <-> the port's ``state_dict``, optax
Adam moments -> the torch optimizer's state, and the ``load_detector``
entry point.

The Flax tree (``{"params": ..., "batch_stats": ...}`` as nested dicts of
numpy arrays) and the port's modules share names, so a variable path maps
to a ``state_dict`` key by joining with dots. Layout changes:

- ``nn.Dense`` kernel ``(in, out)``      -> ``Linear.weight (out, in)``
- ``nn.Conv`` kernel DHWIO               -> ``Conv.weight`` OIDHW
- ``nn.ConvTranspose`` kernel DHWIO      -> ``ConvTranspose.weight`` IODHW,
  flipped in D, H and W (Flax's ``transpose_kernel=False`` applies the
  kernel unflipped over the dilated input; ``conv_transpose3d`` is the
  adjoint of a correlation, which flips it)
- sparse-conv ``kernel (K, Cin, Cout)`` and ``MaskedBatchNorm``
  ``scale/bias`` (params) and ``mean/var`` (batch_stats) stay as they are.
- ``nn.GRUCell``'s six Dense layers -> the port's ``GRUCell``: the kernels
  of ``ir/iz/in`` and of ``hr/hz/hn`` transposed and stacked into
  ``weight_ih``/``weight_hh`` (3H, ·), the biases of ``ir/iz/in`` into
  ``bias_ih``, ``hn``'s bias into ``bias_hn``.
- the listener's Flax ``BatchNorm`` (``scale``/``bias`` params,
  ``mean``/``var`` batch_stats), ``LayerNorm`` (``scale``/``bias``) and
  ``PReLU`` (``alpha``) stay as they are; the port's modules carry the
  same names (``listener.match.self_attn_0.LayerNorm_0.scale``).

The conversion fails if any Flax leaf is left unused or any port
parameter or buffer is left unset. It covers the detector alone
(``load_detector``) and the pipeline's whole ``{detector, speaker,
listener}`` tree (``load_pipeline``). ``state_dict_to_flax`` is its inverse
(also for a mapping of gradients), and ``optax_adam_state_to_torch``
carries optax's ``mu``/``nu``/``count`` into ``exp_avg``/``exp_avg_sq``/
``step``, so a run can move between the frameworks in either direction.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from d3net_tpu_torch.data.collate import BatchSpec
from d3net_tpu_torch.device import DeviceLike, resolve_device
from d3net_tpu_torch.models.blocks import MaskedBatchNorm, SubmConv
from d3net_tpu_torch.models.caption import GRUCell
from d3net_tpu_torch.models.match import BatchNorm, PReLU
from d3net_tpu_torch.models.pointgroup import PointGroup
from d3net_tpu_torch.models.scorenet import Conv, ConvTranspose
from d3net_tpu_torch.models.transformer import LayerNorm


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested variable tree -> ``{dotted path: numpy array}``."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# per module kind: (collection, flax leaf, torch key, flax->torch,
# torch->flax); a tuple of flax leaves maps to one torch entry, its
# functions taking the list of leaves and giving it back
_T = lambda a: a.T                                          # noqa: E731
_CONV = lambda a: a.transpose(4, 3, 0, 1, 2)                # noqa: E731
_CONV_INV = lambda a: a.transpose(2, 3, 4, 1, 0)            # noqa: E731
_CONVT = lambda a: a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)    # noqa: E731
_CONVT_INV = lambda a: a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]  # noqa: E731
_SAME = lambda a: a                                         # noqa: E731
_STACK_T = lambda arrs: np.concatenate([a.T for a in arrs])  # noqa: E731
_SPLIT_T = lambda a: [p.T for p in np.split(a, 3)]          # noqa: E731
_GATES_I = tuple(f"{g}.kernel" for g in ("ir", "iz", "in"))
_GATES_H = tuple(f"{g}.kernel" for g in ("hr", "hz", "hn"))

_LEAVES = {
    nn.Linear: [("params", "kernel", "weight", _T, _T),
                ("params", "bias", "bias", _SAME, _SAME)],
    Conv: [("params", "kernel", "weight", _CONV, _CONV_INV)],
    ConvTranspose: [("params", "kernel", "weight", _CONVT, _CONVT_INV)],
    SubmConv: [("params", "kernel", "kernel", _SAME, _SAME)],
    MaskedBatchNorm: [("params", "scale", "scale", _SAME, _SAME),
                      ("params", "bias", "bias", _SAME, _SAME),
                      ("batch_stats", "mean", "mean", _SAME, _SAME),
                      ("batch_stats", "var", "var", _SAME, _SAME)],
    LayerNorm: [("params", "scale", "scale", _SAME, _SAME),
                ("params", "bias", "bias", _SAME, _SAME)],
    PReLU: [("params", "alpha", "alpha", _SAME, _SAME)],
    GRUCell: [("params", _GATES_I, "weight_ih", _STACK_T, _SPLIT_T),
              ("params", ("ir.bias", "iz.bias", "in.bias"), "bias_ih",
               np.concatenate, lambda a: np.split(a, 3)),
              ("params", _GATES_H, "weight_hh", _STACK_T, _SPLIT_T),
              ("params", "hn.bias", "bias_hn", _SAME, _SAME)],
}
# the listener's Flax BatchNorm has MaskedBatchNorm's leaves
_LEAVES[BatchNorm] = _LEAVES[MaskedBatchNorm]


def _leaf_modules(model: nn.Module):
    """(dotted prefix, module, leaf spec) of every module holding leaves;
    each spec's flax leaves as a tuple, its functions over lists."""
    for name, mod in model.named_modules():
        spec = _LEAVES.get(type(mod))
        if spec is not None:
            out = []
            for coll, leaf, key, fwd, inv in spec:
                # a Dense without bias (the box head's) has no bias leaf
                if getattr(mod, key) is None:
                    continue
                if isinstance(leaf, str):
                    out.append((coll, (leaf,), key,
                                lambda arrs, f=fwd: f(arrs[0]),
                                lambda a, f=inv: [f(a)]))
                else:
                    out.append((coll, leaf, key, fwd, inv))
            yield (f"{name}." if name else ""), mod, out


def flax_to_state_dict(variables: Mapping[str, Any],
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a Flax variable tree into ``model``'s state_dict.

    Raises ValueError if a Flax leaf is unused or a model entry unset.
    """
    flat = {c: flatten(variables.get(c, {})) for c in ("params", "batch_stats")}
    extra = set(variables) - set(flat)
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    used = {c: set() for c in flat}
    sd: Dict[str, torch.Tensor] = {}
    for name, mod, spec in _leaf_modules(model):
        for coll, leaves, key, fwd, _ in spec:
            paths = [f"{name}{leaf}" for leaf in leaves]
            for path in paths:
                if path not in flat[coll]:
                    raise ValueError(f"Flax {coll} has no {path} for {key}")
                if path in used[coll]:
                    raise ValueError(f"Flax {coll} leaf {path} consumed twice")
                used[coll].add(path)
            target = getattr(mod, key)
            value = np.ascontiguousarray(fwd([flat[coll][p] for p in paths]))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{paths}: converted shape {value.shape} != port "
                    f"{tuple(target.shape)}")
            sd[f"{name}{key}"] = torch.from_numpy(value).to(target.dtype)
    for coll in flat:
        left = set(flat[coll]) - used[coll]
        if left:
            raise ValueError(f"unused Flax {coll} leaves: {sorted(left)}")
    unset = set(model.state_dict()) - set(sd)
    if unset:
        raise ValueError(f"port entries not set by the conversion: {sorted(unset)}")
    return sd


def state_dict_to_flax(model: nn.Module,
                       tensors: Optional[Mapping[str, torch.Tensor]] = None,
                       ) -> Dict[str, Any]:
    """``model``'s state_dict (or ``tensors``, a mapping keyed like it, such
    as ``{name: p.grad}``) -> Flax ``{"params", "batch_stats"}`` as numpy.

    With ``tensors`` given, only the collections its keys reach appear;
    raises ValueError if one of its keys is not a converted leaf.
    """
    full = tensors is None
    tensors = model.state_dict() if full else tensors
    flat: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    used = set()
    for name, _, spec in _leaf_modules(model):
        for coll, leaves, key, _, inv in spec:
            k = f"{name}{key}"
            if k not in tensors:
                if full:
                    raise ValueError(f"state_dict has no {k}")
                continue
            used.add(k)
            value = tensors[k].detach().to("cpu", torch.float32).numpy()
            for leaf, part in zip(leaves, inv(value)):
                flat[coll][f"{name}{leaf}"] = np.ascontiguousarray(part)
    left = set(tensors) - used
    if left:
        raise ValueError(f"entries with no Flax leaf: {sorted(left)}")
    return {c: _unflatten(f) for c, f in flat.items() if f or full}


def _params_to_tensors(tree: Mapping[str, Any],
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """A Flax ``params``-shaped tree (weights, or optax moments of them) ->
    ``{state_dict key: tensor}`` over the model's parameters."""
    flat = flatten(tree)
    out: Dict[str, torch.Tensor] = {}
    for name, _, spec in _leaf_modules(model):
        for coll, leaves, key, fwd, _ in spec:
            if coll == "params":
                v = np.ascontiguousarray(fwd(
                    [flat.pop(f"{name}{leaf}") for leaf in leaves]))
                out[f"{name}{key}"] = torch.from_numpy(v.astype(np.float32))
    if flat:
        raise ValueError(f"unused leaves: {sorted(flat)}")
    return out


def optax_adam_state_to_torch(opt_state: Any, model: nn.Module,
                              optimizer: torch.optim.Optimizer) -> None:
    """Load optax ``scale_by_adam`` state into a torch Adam/AdamW over
    ``model.parameters()``: ``mu -> exp_avg``, ``nu -> exp_avg_sq``,
    ``count -> step``. ``opt_state`` is the optax chain's state tuple as
    ``optax.adam``/``adamw`` leave it (one ``ScaleByAdamState`` in it), with
    numpy or JAX arrays as leaves."""
    found = [s for s in opt_state if hasattr(s, "mu")]
    if len(found) != 1:
        raise ValueError("opt_state holds no single scale_by_adam state")
    adam = found[0]
    mu = _params_to_tensors(adam.mu, model)
    nu = _params_to_tensors(adam.nu, model)
    step = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype),
        }


def init_flax_variables(model: nn.Module, seed: int) -> Dict[str, Any]:
    """Random Flax-layout variables for ``model``, made with numpy.

    Kernels are He-normal for the sparse and dense convs, LeCun-normal for
    the Dense layers and a GRU's input gates, orthogonal for its recurrent
    gates (Flax's initializers, untruncated); biases and BN shifts 0, BN
    and LayerNorm scales 1, running mean 0 and var 1, PReLU slopes 0.25 —
    what ``model.init`` gives. Feed the result through
    :func:`flax_to_state_dict`.
    """
    rng = np.random.default_rng(seed)
    flat: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "batch_stats": {}}
    for name, mod, spec in _leaf_modules(model):
        for coll, leaves, key, _, inv in spec:
            parts = inv(np.empty(tuple(getattr(mod, key).shape)))
            for leaf, part in zip(leaves, parts):
                shape = part.shape
                if isinstance(mod, GRUCell) and leaf in _GATES_H:
                    q, r = np.linalg.qr(rng.normal(0.0, 1.0, shape))
                    v = q * np.sign(np.diag(r))
                elif leaf.endswith("kernel"):
                    fan_in = math.prod(shape[:-1])
                    gain = 1.0 if isinstance(mod, (nn.Linear, GRUCell)) \
                        else 2.0
                    v = rng.normal(0.0, math.sqrt(gain / fan_in), shape)
                elif leaf in ("scale", "var"):
                    v = np.ones(shape)
                elif leaf == "alpha":
                    v = np.full(shape, 0.25)
                else:
                    v = np.zeros(shape)
                flat[coll][f"{name}{leaf}"] = v.astype(np.float32)
    return {c: _unflatten(f) for c, f in flat.items()}


def load_detector(variables: Mapping[str, Any], cfg: Mapping[str, Any],
                  device: DeviceLike = None) -> PointGroup:
    """``PointGroup(**cfg)`` with Flax ``variables`` loaded, in eval mode.

    Runs on CUDA unless ``device`` says otherwise; raises without a GPU
    when no device is given. The input width comes from the input conv.
    """
    dev = resolve_device(device)
    in_channels = int(np.shape(variables["params"]["input_conv"]["kernel"])[1])
    model = PointGroup(in_channels, **cfg)
    model.load_state_dict(flax_to_state_dict(variables, model))
    return model.to(dev).eval()


def load_pipeline(variables: Mapping[str, Any], cfg, vocab,
                  device: DeviceLike = None) -> nn.Module:
    """The config's ``PipelineNet`` (``train.pipeline.pipeline_from_cfg``)
    with Flax ``variables`` of the whole ``{detector, speaker, listener}``
    tree (the submodules the config names) loaded, in eval mode. Runs on
    CUDA unless ``device`` says otherwise; raises without a GPU when no
    device is given."""
    from d3net_tpu_torch.train.pipeline import pipeline_from_cfg

    dev = resolve_device(device)
    model = pipeline_from_cfg(cfg, vocab)
    model.load_state_dict(flax_to_state_dict(variables, model))
    return model.to(dev).eval()


class Flagship(NamedTuple):
    """The flagship detector workload of the JAX package's ``bench.py``."""

    batch_size: int
    scene_kwargs: Dict[str, Any]   # make_scene(seed=i, **scene_kwargs)
    spec: BatchSpec
    model: Dict[str, Any]          # PointGroup kwargs beyond its defaults


def flagship_config() -> Flagship:
    """B=4 synthetic ScanNet-sized scenes, 7 levels of 131072..2048 voxel
    caps, 134 input channels (normal + 128 multiview + xyz), m=16, 128
    clusters per pass, bf16 compute — ``bench.py`` with ``conv_impl="gather"``."""
    spec = BatchSpec(
        max_points=131072,
        voxel_caps=[131072, 65536, 32768, 16384, 8192, 4096, 2048],
        max_instances=32,
        use_multiview=True,
        use_normal=True,
        conv_impl="gather",
    )
    scene_kwargs = dict(num_instances=16, density=2500.0, floor_points=30000,
                        room=8.0, with_multiview=True)
    return Flagship(4, scene_kwargs, spec, dict(compute_dtype="bfloat16"))
