"""RGB-D frame sources for the multiview feature pipeline.

A copy of ``d3net_tpu/data/frames.py`` (the port never imports the JAX
package); the same scene and camera give the same frames byte for byte on
both sides, so the two files change together.

- :class:`ScanNetFrames` reads the reference's extracted-sens layout
  (``<scans>/<scene_id>/{color,depth,pose}/<fid>.*``); it needs PIL,
  imported when a frame is read.
- :func:`render_scene_frames` renders synthetic RGB-D frames from a
  :class:`~d3net_tpu_torch.data.synthetic.Scene` by z-buffered point
  splatting (no ScanNet on disk).

Camera convention matches ScanNet: ``pose`` is camera-to-world, camera space
has +z forward and +y image-down, pixels via ``px = fx*x/z + cx``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from d3net_tpu_torch.data.synthetic import Scene


def default_intrinsic(width: int, height: int) -> np.ndarray:
    """Pinhole intrinsics with a ~58deg horizontal FOV (ScanNet-like)."""
    f = 0.9 * width
    k = np.eye(4)
    k[0, 0] = k[1, 1] = f
    k[0, 2] = width / 2 - 0.5
    k[1, 2] = height / 2 - 0.5
    return k


def look_at_pose(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world 4x4 with +z toward ``target`` and image-y down."""
    f = target - position
    f = f / (np.linalg.norm(f) + 1e-12)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(f, up)
    n = np.linalg.norm(x)
    if n < 1e-6:  # looking straight up/down
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / n
    y = np.cross(f, x)
    pose = np.eye(4)
    pose[:3, 0] = x
    pose[:3, 1] = y
    pose[:3, 2] = f
    pose[:3, 3] = position
    return pose


def orbit_poses(scene_xyz: np.ndarray, n_frames: int,
                height: float = 2.2, radius_pad: float = 1.5) -> List[np.ndarray]:
    """Cameras on a circle around the scene center, looking inward."""
    center = (scene_xyz.min(0) + scene_xyz.max(0)) / 2
    radius = float(np.linalg.norm((scene_xyz.max(0) - scene_xyz.min(0))[:2]) / 2
                   + radius_pad)
    poses = []
    for i in range(n_frames):
        t = 2 * np.pi * i / max(n_frames, 1)
        pos = center + np.array([radius * np.cos(t), radius * np.sin(t),
                                 height - center[2]])
        look = center.copy()
        look[2] = min(center[2], 1.0)
        poses.append(look_at_pose(pos, look))
    return poses


def render_frame(scene: Scene, pose: np.ndarray, intrinsic: np.ndarray,
                 width: int, height: int,
                 depth_range: Tuple[float, float] = (0.1, 8.0),
                 with_semantics: bool = False):
    """Z-buffered point-splat render -> (color (H,W,3) in [0,1], depth (H,W)).

    With ``with_semantics=True`` also returns the per-pixel semantic label
    image (H, W) int32 — the winning splat's ``scene.sem_labels`` entry,
    -1 where no point projects.  This is the 2D supervision signal for
    training the ENet encoder (the reference's ``scannetv2_enet.pth`` was
    trained on ScanNet 2D semantic frames the same way).
    """
    w2c = np.linalg.inv(pose)
    cam = scene.xyz @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        px = np.round(cam[:, 0] * fx / z + cx).astype(np.int64)
        py = np.round(cam[:, 1] * fy / z + cy).astype(np.int64)
    ok = (
        (z > depth_range[0]) & (z < depth_range[1])
        & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    )
    idx = py[ok] * width + px[ok]
    zs = z[ok]
    # z-buffer: per-pixel argmin depth via lexsort over (pixel, depth)
    order = np.lexsort((zs, idx))
    idx_s, z_s = idx[order], zs[order]
    first = np.ones(len(idx_s), bool)
    first[1:] = idx_s[1:] != idx_s[:-1]
    win_pix = idx_s[first]
    win_pt = np.where(ok)[0][order][first]

    depth = np.zeros(height * width, np.float32)
    depth[win_pix] = z_s[first]
    color = np.zeros((height * width, 3), np.float32)
    color[win_pix] = (scene.rgb[win_pt] + 1.0) / 2.0  # rgb stored in [-1,1]
    if not with_semantics:
        return color.reshape(height, width, 3), depth.reshape(height, width)
    sem = np.full(height * width, -1, np.int32)
    sem[win_pix] = scene.sem_labels[win_pt]
    return (color.reshape(height, width, 3), depth.reshape(height, width),
            sem.reshape(height, width))


def render_scene_frames(scene: Scene, n_frames: int, width: int, height: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(colors (F,H,W,3), depths (F,H,W), poses (F,4,4)) for one scene."""
    intrinsic = default_intrinsic(width, height)
    poses = orbit_poses(scene.xyz, n_frames)
    colors, depths = [], []
    for pose in poses:
        c, d = render_frame(scene, pose, intrinsic, width, height)
        colors.append(c)
        depths.append(d)
    return np.stack(colors), np.stack(depths), np.stack(poses)


@dataclass
class ScanNetFrames:
    """Extracted-sens frame reader (color/depth/pose files per scene).

    Layout (reference ``compute_multiview_features.py:84-124``):
    ``<root>/<scene_id>/color/<fid>.jpg``, ``depth/<fid>.png`` (millimeters,
    uint16), ``pose/<fid>.txt`` (4x4 camera-to-world).
    """

    root: str
    scene_id: str
    max_frames: Optional[int] = None

    def frame_ids(self) -> List[str]:
        d = os.path.join(self.root, self.scene_id, "color")
        ids = sorted(
            os.path.splitext(f)[0] for f in os.listdir(d)
            if f.endswith((".jpg", ".png"))
        )
        return ids[: self.max_frames] if self.max_frames else ids

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (color float (H,W,3) in [0,1], depth meters (H,W), pose)."""
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "ScanNetFrames reads jpg/png frames with PIL (Pillow), "
                "which is not installed") from e

        base = os.path.join(self.root, self.scene_id)
        for fid in self.frame_ids():
            color = np.asarray(
                Image.open(os.path.join(base, "color", f"{fid}.jpg"))
            ).astype(np.float32) / 255.0
            depth = np.asarray(
                Image.open(os.path.join(base, "depth", f"{fid}.png"))
            ).astype(np.float32) / 1000.0
            pose = np.loadtxt(os.path.join(base, "pose", f"{fid}.txt"))
            yield color, depth, pose
