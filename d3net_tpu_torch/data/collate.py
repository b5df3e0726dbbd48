"""Static-shape batch assembly, gather mode (numpy, host side).

A copy of the ``conv_impl="gather"`` path of ``d3net_tpu/data/collate.py``:
scales and quantizes coords, voxelizes, builds per-level kernel maps,
computes per-point instance supervision and pads everything to the
configured capacities. The batch is byte-identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from d3net_tpu_torch import trace
from d3net_tpu_torch.data.synthetic import Scene
from d3net_tpu_torch.ops.voxelize import build_unet_maps, voxelize
from d3net_tpu_torch.trace import CapStats


@dataclass
class BatchSpec:
    """Static capacities for one batch layout."""

    max_points: int = 250000            # data.max_num_point
    voxel_caps: Sequence[int] = ()      # per U-Net level; len = len(blocks)
    max_instances: int = 128            # data.max_num_instance
    scale: float = 50.0                 # data.scale (1/voxel_size)
    full_scale: float = 512.0           # data.full_scale[1] (crop window)
    use_color: bool = False
    use_normal: bool = True
    use_multiview: bool = True
    multiview_dim: int = 128
    num_levels: int = 7
    # only "gather" (per-voxel 27-neighbor tables) is ported; the JAX
    # package's block/column/colres layouts are TPU tilings of the same conv
    conv_impl: str = "gather"

    def feat_dim(self) -> int:
        return (
            3 * self.use_color
            + 3 * self.use_normal
            + self.multiview_dim * self.use_multiview
        )

    def caps(self) -> List[int]:
        if self.voxel_caps:
            return list(self.voxel_caps)
        # default: halve per level, floor 1024
        caps, c = [], self.max_points
        for _ in range(self.num_levels):
            caps.append(max(1024, c))
            c = c // 2
        return caps


# silent-truncation telemetry: ``build_batch`` adds to it, loops take and
# reset it per log interval; the keys are the JAX package's, so
# ``metrics.jsonl`` keeps one schema
CAP_STATS = CapStats((
    "cap_points_truncated",    # points beyond max_points
    "cap_voxel_overflow",      # voxels past caps[0] (p2v -> pad)
    "cap_level_overflow",      # block/column voxels past caps
    "cap_dropped_phantoms",    # phantom columns past col cap
    "batches",
))


def write_scene_features(scene: Scene, spec: BatchSpec, dst: np.ndarray,
                         n: int) -> None:
    """Write the [color|normal|multiview] feature block into ``dst[:n]``."""
    off = 0
    if spec.use_color:
        dst[:n, off:off + 3] = scene.rgb[:n]
        off += 3
    if spec.use_normal:
        dst[:n, off:off + 3] = scene.normal[:n]
        off += 3
    if spec.use_multiview:
        if scene.multiview is not None:
            dst[:n, off:off + spec.multiview_dim] = scene.multiview[:n]
        off += spec.multiview_dim


def instance_info(xyz: np.ndarray, sem_labels: np.ndarray,
                  instance_ids: np.ndarray, max_instances: int):
    """Per-point instance mean xyz + per-instance point counts and boxes."""
    n = len(xyz)
    mean_xyz = np.zeros((n, 3), np.float32)
    num_point = np.zeros(max_instances, np.float32)
    centers = np.zeros((max_instances, 3), np.float32)
    sizes = np.zeros((max_instances, 3), np.float32)
    sem = np.zeros(max_instances, np.int32)
    mask = np.zeros(max_instances, bool)
    valid = (instance_ids >= 0) & (instance_ids < max_instances)
    ids = instance_ids[valid]
    if ids.size:
        order = np.argsort(ids, kind="stable")
        pts_s = xyz[valid][order]
        ids_s = ids[order]
        uniq, starts, counts = np.unique(
            ids_s, return_index=True, return_counts=True
        )
        sums = np.add.reduceat(pts_s, starts, axis=0)
        mins = np.minimum.reduceat(pts_s, starts, axis=0)
        maxs = np.maximum.reduceat(pts_s, starts, axis=0)
        means = (sums / counts[:, None]).astype(np.float32)
        num_point[uniq] = counts
        centers[uniq] = (mins + maxs) / 2
        sizes[uniq] = maxs - mins
        sem[uniq] = sem_labels[valid][order][starts]
        mask[uniq] = True
        means_full = np.zeros((max_instances, 3), np.float32)
        means_full[uniq] = means
        mean_xyz[valid] = means_full[ids]
    return mean_xyz, num_point, centers, sizes, sem, mask


def build_batch(scenes: List[Scene], spec: BatchSpec) -> Dict[str, np.ndarray]:
    """Assemble a fully padded batch dict of numpy arrays.

    ``tables`` is a list (one per U-Net level) of dicts of stacked arrays:
    ``nbr (B, M_l, 27)``, ``mask (B, M_l)``, and on all but the last level
    ``down (B, M_{l+1}, 8)`` and ``up (B, M_l, 8)``.
    """
    if spec.conv_impl != "gather":
        raise NotImplementedError(
            f"conv_impl={spec.conv_impl!r}: only 'gather' tables are ported; "
            "the block/column/colres layouts are TPU tilings of the same conv "
            "(ROADMAP.md, queue A item 17 keeps them unported)")
    caps = spec.caps()
    np_cap = spec.max_points
    b = len(scenes)

    keys = ["nbr", "mask", "down", "up"]
    per_level: List[Dict[str, List[np.ndarray]]] = [
        {k: [] for k in keys} for _ in caps
    ]

    def zeros(shape, dtype=np.float32):
        return np.zeros((b,) + shape, dtype)

    out: Dict[str, np.ndarray] = {}
    out["point_xyz"] = zeros((np_cap, 3))
    out["point_feats"] = zeros((np_cap, spec.feat_dim()))
    out["point_mask"] = zeros((np_cap,), bool)
    out["p2v"] = np.full((b, np_cap), caps[0], np.int32)
    out["sem_labels"] = np.full((b, np_cap), -1, np.int32)
    out["instance_ids"] = np.full((b, np_cap), -1, np.int32)
    out["instance_mean_xyz"] = zeros((np_cap, 3))
    out["instance_num_point"] = zeros((spec.max_instances,))
    out["center_label"] = zeros((spec.max_instances, 3))
    out["size_label"] = zeros((spec.max_instances, 3))
    out["sem_cls_label"] = zeros((spec.max_instances,), np.int32)
    out["gt_box_mask"] = zeros((spec.max_instances,), bool)

    for s_i, scene in enumerate(scenes):
        n = min(len(scene.xyz), np_cap)
        if len(scene.xyz) > np_cap:
            CAP_STATS.add(cap_points_truncated=len(scene.xyz) - np_cap)
        xyz = scene.xyz[:n]
        # quantize: shift to non-negative, scale, floor (reference scales x50)
        scaled = (xyz - xyz.min(0)) * spec.scale
        coords_int = np.floor(scaled).astype(np.int32)
        vc, p2v, _counts = voxelize(coords_int)
        # truncate voxels beyond cap; orphaned points -> INVALID
        n_over = int((p2v >= caps[0]).sum())
        if n_over:
            CAP_STATS.add(cap_voxel_overflow=n_over)
        p2v = np.where(p2v >= caps[0], caps[0], p2v).astype(np.int32)
        levels = build_unet_maps(vc, caps)

        out["point_xyz"][s_i, :n] = xyz
        write_scene_features(scene, spec, out["point_feats"][s_i], n)
        out["point_mask"][s_i, :n] = True
        out["p2v"][s_i, :n] = p2v
        out["sem_labels"][s_i, :n] = scene.sem_labels[:n]
        out["instance_ids"][s_i, :n] = np.where(
            scene.instance_ids[:n] >= spec.max_instances, -1,
            scene.instance_ids[:n]
        )
        mean_xyz, num_point, centers, sizes, sem, mask = instance_info(
            xyz, scene.sem_labels[:n], scene.instance_ids[:n],
            spec.max_instances,
        )
        out["instance_mean_xyz"][s_i, :n] = mean_xyz
        out["instance_num_point"][s_i] = num_point
        out["center_label"][s_i] = centers
        out["size_label"][s_i] = sizes
        out["sem_cls_label"][s_i] = sem
        out["gt_box_mask"][s_i] = mask

        for li, lv in enumerate(levels):
            lvl_mask = np.zeros(caps[li], np.float32)
            lvl_mask[: lv.num_voxels] = 1.0
            per_level[li]["mask"].append(lvl_mask)
            per_level[li]["nbr"].append(lv.nbr)
            if lv.down is not None:
                per_level[li]["down"].append(lv.down)
                per_level[li]["up"].append(lv.up)

    out["tables"] = [
        {k: np.stack(v) for k, v in per_level[li].items() if v}
        for li in range(len(caps))
    ]
    CAP_STATS.add(batches=1)
    return out


def batch_to_torch(batch: Mapping[str, Any], device) -> Dict[str, Any]:
    """numpy batch (``build_batch`` output) -> tensors on ``device``: the
    ``data.h2d`` span, its bytes counted as ``h2d_bytes``."""
    dev = torch.device(device)
    nbytes = [0]

    def conv(v):
        if isinstance(v, list):
            return [conv(x) for x in v]
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        v = np.ascontiguousarray(v)
        nbytes[0] += v.nbytes
        return torch.from_numpy(v).to(dev)

    with trace.span("data.h2d"):
        out = {k: conv(v) for k, v in batch.items()}
        trace.count("h2d_bytes", nbytes[0])
    return out
