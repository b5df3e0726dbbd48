"""Multiview 2D-feature back-projection and the per-scene feature store.

Counterpart of ``d3net_tpu/data/multiview.py`` (parity: reference
``lib/utils/projection.py`` + ``data/scannet/project_multiview_features.py``).
``ProjectionHelper`` and ``project_multiview_features`` are numpy
counterparts of JAX's whose outputs equal them byte for byte: for each
RGB-D frame, scene points are projected
into the frame (world -> camera via the inverse pose, camera -> pixel via
the intrinsics), kept when inside the image, in the depth range and
depth-consistent (|point depth - depth map| <= accuracy), take the ENet
feature at their pixel (feature-map stride 8) and are max-pooled over
frames.

The feature store takes the place of JAX's ``enet_feats_maxpool.hdf5``
(h5py is not on the card's machine): a directory of ``<scene_id>.npy``
files, one (N, 128) array each. The config key ``data.multiview_hdf5``
names it: the key's path with ``.hdf5`` replaced by ``.mvstore``
(:func:`store_dir`). An HDF5 file at the key's path with no store beside
it raises, naming ``scripts/convert_multiview_hdf5.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


class ProjectionHelper:
    def __init__(self, intrinsic: np.ndarray, depth_min: float = 0.1,
                 depth_max: float = 4.0, image_dims: Tuple[int, int] = (328, 256),
                 accuracy: float = 0.05, feat_stride: int = 8):
        self.intrinsic = np.asarray(intrinsic, np.float64)
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.image_dims = image_dims  # (W, H)
        self.accuracy = accuracy
        self.feat_stride = feat_stride

    def project(self, xyz: np.ndarray, camera_to_world: np.ndarray,
                depth_map: Optional[np.ndarray]):
        """Project world points into one frame.

        Args:
            xyz: (N, 3) world coords.
            camera_to_world: (4, 4) pose.
            depth_map: (H, W) metric depth or None (skips consistency).

        Returns:
            (valid (N,) bool, px (N,) int, py (N,) int) pixel coords.
        """
        w2c = np.linalg.inv(camera_to_world)
        cam = xyz @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam[:, 2]
        fx, fy = self.intrinsic[0, 0], self.intrinsic[1, 1]
        cx, cy = self.intrinsic[0, 2], self.intrinsic[1, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            px = np.round(cam[:, 0] * fx / z + cx).astype(np.int64)
            py = np.round(cam[:, 1] * fy / z + cy).astype(np.int64)
        wdim, hdim = self.image_dims
        valid = (
            (z >= self.depth_min) & (z <= self.depth_max)
            & (px >= 0) & (px < wdim) & (py >= 0) & (py < hdim)
        )
        if depth_map is not None:
            pxc = np.clip(px, 0, wdim - 1)
            pyc = np.clip(py, 0, hdim - 1)
            d = depth_map[pyc, pxc]
            valid &= (d > 0) & (np.abs(d - z) <= self.accuracy)
        return valid, np.clip(px, 0, wdim - 1), np.clip(py, 0, hdim - 1)

    def lift_features(self, xyz: np.ndarray, feat_map: np.ndarray,
                      camera_to_world: np.ndarray,
                      depth_map: Optional[np.ndarray]):
        """(N,3) points + (Hf, Wf, C) frame features -> (N, C) feats + valid."""
        valid, px, py = self.project(xyz, camera_to_world, depth_map)
        fx = np.clip(px // self.feat_stride, 0, feat_map.shape[1] - 1)
        fy = np.clip(py // self.feat_stride, 0, feat_map.shape[0] - 1)
        feats = feat_map[fy, fx]
        return np.where(valid[:, None], feats, -np.inf), valid


def project_multiview_features(
    xyz: np.ndarray,
    frames: Iterable[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
    helper: ProjectionHelper,
    feat_dim: int = 128,
    return_seen: bool = False,
):
    """Max-pool per-point features over frames (ref ``project_multiview_
    features.py:126-212``). frames yields (feat_map, pose, depth_map).
    With ``return_seen``: (features, (N,) bool seen in some frame).

    JAX's loop takes the maximum with every point's lifted row, -inf where
    the point is not visible; here only the visible rows are gathered and
    maxed, in place, which gives the same array with a fraction of the
    memory traffic (the flagship's ~200k points x 128 features a frame)."""
    agg = np.full((len(xyz), feat_dim), -np.inf, np.float32)
    seen = np.zeros(len(xyz), bool)
    for feat_map, pose, depth in frames:
        valid, px, py = helper.project(xyz, pose, depth)
        rows = np.flatnonzero(valid)
        fx = np.clip(px[rows] // helper.feat_stride, 0, feat_map.shape[1] - 1)
        fy = np.clip(py[rows] // helper.feat_stride, 0, feat_map.shape[0] - 1)
        agg[rows] = np.maximum(agg[rows], feat_map[fy, fx].astype(np.float32))
        seen |= valid
    agg[~seen] = 0.0
    return (agg, seen) if return_seen else agg


STORE_SUFFIX = ".mvstore"
_HDF5_SIGNATURE = b"\x89HDF"


def store_dir(key: str) -> str:
    """The feature store a ``data.multiview_hdf5`` value names: the path
    itself when it is a store (a directory), else the path with its
    ``.hdf5``/``.h5`` suffix replaced by ``.mvstore``."""
    if os.path.isdir(key):
        return key
    root, ext = os.path.splitext(key)
    return (root if ext in (".hdf5", ".h5") else key) + STORE_SUFFIX


def write_multiview_store(path: str, scene_feats: Dict[str, np.ndarray]):
    """{scene_id: (N, 128)} -> ``path/<scene_id>.npy`` (dtype kept), each
    written whole or not at all."""
    os.makedirs(path, exist_ok=True)
    for scene_id, feats in scene_feats.items():
        dst = os.path.join(path, f"{scene_id}.npy")
        tmp = dst + ".tmp.npy"
        np.save(tmp, np.asarray(feats))
        os.replace(tmp, dst)


def open_multiview_store(key: str) -> str:
    """The store directory of ``key``; raises when there is none (an HDF5
    file in its place names the converter)."""
    path = store_dir(key)
    if os.path.isdir(path):
        return path
    if os.path.isfile(key):
        with open(key, "rb") as f:
            if f.read(4) == _HDF5_SIGNATURE:
                raise FileNotFoundError(
                    f"{key} is an HDF5 feature file and there is no feature "
                    f"store {path}; convert it once (where h5py is "
                    f"installed): python -m d3net_tpu_torch.scripts."
                    f"convert_multiview_hdf5 {key}")
    raise FileNotFoundError(
        f"no multiview feature store {path} (data.multiview_hdf5: {key}); "
        "make it with python -m d3net_tpu_torch.scripts."
        f"compute_multiview_features --output {path}")


def read_multiview_store(path: str, scene_id: str) -> np.ndarray:
    """One scene's (N, 128) features from the store at ``path``."""
    f = os.path.join(path, f"{scene_id}.npy")
    if not os.path.exists(f):
        raise KeyError(f"scene {scene_id} is not in the feature store {path}")
    return np.load(f)
