"""Offline multiview feature extraction: frames -> ENet -> back-projection
-> per-point 128-d max-pooled features -> the feature store.

The port's ``scripts/compute_multiview_features.py``:

    # the exact train+val synthetic scenes of a training config, into the
    # store its data.multiview_hdf5 key names (.hdf5 -> .mvstore):
    python -m d3net_tpu_torch.scripts.compute_multiview_features \\
        --config conf/flagship_converge.yaml \\
        --weights outputs/enet/enet_weights.pkl [--cpu]

    # ScanNet layout (extracted .sens frames + prepare_scannet npz scenes):
    python -m d3net_tpu_torch.scripts.compute_multiview_features \\
        --frames <frames_root> --scenes <npz_dir>/*.npz --output feats.hdf5

    # N synthetic scenes (seeds 0..N-1):
    python -m d3net_tpu_torch.scripts.compute_multiview_features \\
        --synthetic 4 --output feats.hdf5

``--output`` names the store as the config key does (a ``.hdf5`` path
stands for the ``.mvstore`` directory beside it); with ``--config`` it
defaults to the config's key. ``--weights`` reads the JAX package's pickle
(``jax.Array`` leaves, loaded without JAX) or the port's own; without it
the encoder is a fixed-seed random one (a random-projection feature
extractor, as in JAX's script). Frames are rendered and back-projected
with numpy on the host; ENet runs on the card in batches of 8 frames, in
eval mode, read back once a batch. Runs on
CUDA unless ``--cpu`` is given; without a GPU and without ``--cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from d3net_tpu_torch.device import DeviceLike, resolve_device


def make_encoder(weights_path: Optional[str] = None, seed: int = 0,
                 device: DeviceLike = None):
    """(apply_fn: (F, H, W, 3) float32 numpy -> (F, H/8, W/8, 128) numpy,
    the eval-mode ``ENetEncoder`` on ``device``)."""
    from d3net_tpu_torch.models.enet import ENetEncoder
    from d3net_tpu_torch.params import (
        enet_flax_to_state_dict, init_enet_flax_variables, load_enet_pickle,
    )

    dev = resolve_device(device)
    if weights_path:
        # port_enet_weights' pickle also holds a "full": True flag
        variables = {c: v for c, v in load_enet_pickle(weights_path).items()
                     if c in ("params", "batch_stats")}
        model = ENetEncoder(full="Bottleneck_21" in variables["params"])
        print(f"loaded ENet weights from {weights_path}")
    else:
        model = ENetEncoder()
        variables = init_enet_flax_variables(model, seed)
        print("no --weights given: fixed-seed ENet (random-projection "
              "features)")
    model.load_state_dict(enet_flax_to_state_dict(variables, model))
    model.to(dev).eval()

    def apply_fn(frames: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return model(torch.from_numpy(frames).to(dev)).cpu().numpy()

    return apply_fn, model


def features_for_scene(xyz, frames, apply_fn, image_wh, intrinsic,
                       batch_frames: int = 8, accuracy: float = 0.05,
                       depth_max: float = 4.0,
                       times: Optional[Dict[str, float]] = None):
    """frames iterable of (color, depth, pose) -> ((N, 128) max-pooled
    features, (N,) seen). ``depth_max`` 4.0 m matches the reference's
    ScanNet frames; the synthetic orbit cameras sit farther out, so that
    path widens it to the renderer's far plane (8 m). ``times``, if
    given, gains ``enet_s`` (the encoder, its read-back included) and
    ``project_s`` (the rest)."""
    from d3net_tpu_torch.data.multiview import (
        ProjectionHelper, project_multiview_features,
    )

    helper = ProjectionHelper(
        intrinsic, image_dims=image_wh, accuracy=accuracy, feat_stride=8,
        depth_max=depth_max,
    )
    enet_s = [0.0]

    def featurized():
        buf = []
        for color, depth, pose in frames:
            buf.append((color, depth, pose))
            if len(buf) == batch_frames:
                yield from _flush(buf)
                buf = []
        if buf:
            yield from _flush(buf)

    def _flush(buf):
        t0 = time.perf_counter()
        stack = np.stack([c for c, _, _ in buf]).astype(np.float32)
        maps = apply_fn(stack)
        enet_s[0] += time.perf_counter() - t0
        for m, (_, depth, pose) in zip(maps, buf):
            yield m, pose, depth

    t0 = time.perf_counter()
    out = project_multiview_features(xyz, featurized(), helper, feat_dim=128,
                                     return_seen=True)
    if times is not None:
        times["enet_s"] = times.get("enet_s", 0.0) + enet_s[0]
        times["project_s"] = times.get("project_s", 0.0) + (
            time.perf_counter() - t0 - enet_s[0])
    return out


def config_scenes(cfg) -> list:
    """Exactly the train+val synthetic scenes a training config's loaders
    build (the same geometry and split seeds), so scene ids and point
    counts line up with ``MultiviewAttached``'s lookups."""
    from d3net_tpu_torch.data.dataset import SyntheticScenes

    syn = cfg.data.synthetic
    kw = dict(
        num_instances=syn.num_instances,
        points_per_instance=syn.get("points_per_instance", 3000),
        floor_points=syn.floor_points, room=syn.room,
        density=syn.get("density"),
        size_range=tuple(syn.get("size_range", (0.3, 1.2))),
    )
    n_val = int(syn.get("num_val_scenes", 0) or max(2, syn.num_scenes // 8))
    return (list(SyntheticScenes(syn.num_scenes, "train", **kw).scenes)
            + list(SyntheticScenes(n_val, "val", **kw).scenes))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Returns, by scene id, the features' shape, the share of points seen
    and the seconds spent rendering (or reading), in ENet and projecting."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", help="extracted-sens root (scene_id subdirs)")
    ap.add_argument("--scenes", nargs="*", default=[],
                    help="prepare_scannet npz files (xyz source)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="render N synthetic scenes instead of reading data")
    ap.add_argument("--config",
                    help="training config: render features for exactly the "
                         "train+val synthetic scenes that config uses")
    ap.add_argument("--output",
                    help="the store (or the .hdf5 path it stands for); "
                         "default: the config's data.multiview_hdf5")
    ap.add_argument("--weights", help="pickled Flax ENet variables")
    ap.add_argument("--max-frames", type=int, default=50)
    ap.add_argument("--width", type=int, default=328)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="run ENet on the CPU (the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    from d3net_tpu_torch.data.frames import (
        ScanNetFrames, default_intrinsic, render_scene_frames,
    )
    from d3net_tpu_torch.data.multiview import (
        store_dir, write_multiview_store,
    )

    cfg = None
    if args.config:
        from d3net_tpu_torch.scripts.train import load_task_config

        cfg = load_task_config(args.config)
    output = args.output or (cfg.data.get("multiview_hdf5") if cfg else None)
    if not output:
        ap.error("need --output (or a --config with data.multiview_hdf5)")
    store = store_dir(output)
    apply_fn, _ = make_encoder(args.weights, device=device)
    intrinsic = default_intrinsic(args.width, args.height)
    wh = (args.width, args.height)
    report: Dict[str, dict] = {}

    def finish(scene_id, feats, seen, times):
        write_multiview_store(store, {scene_id: feats})
        report[scene_id] = {"shape": list(feats.shape),
                            "seen": float(seen.mean()), **times}
        print(f"{scene_id}: {feats.shape} seen {seen.mean():.3f}", flush=True)

    if args.synthetic or args.config:
        if cfg is not None:
            scene_list = config_scenes(cfg)
        else:
            from d3net_tpu_torch.data.synthetic import make_scene

            scene_list = [make_scene(seed=i) for i in range(args.synthetic)]
        for scene in scene_list:
            t0 = time.perf_counter()
            colors, depths, poses = render_scene_frames(
                scene, n_frames=min(args.max_frames, 8),
                width=args.width, height=args.height,
            )
            times = {"render_s": time.perf_counter() - t0}
            feats, seen = features_for_scene(
                scene.xyz, list(zip(colors, depths, poses)), apply_fn, wh,
                intrinsic, depth_max=8.0, times=times)
            finish(scene.scene_id, feats, seen, times)
    else:
        paths = [p for pat in args.scenes for p in sorted(glob.glob(pat))]
        if not paths or not args.frames:
            ap.error("need --frames and --scenes (or --synthetic N)")
        for path in paths:
            d = np.load(path)
            scene_id = str(d.get("scene_id", os.path.basename(path)[:-4]))
            reader = ScanNetFrames(args.frames, scene_id, args.max_frames)
            intr_file = os.path.join(
                args.frames, scene_id, "intrinsic", "intrinsic_color.txt")
            intr = np.loadtxt(intr_file) if os.path.exists(intr_file) \
                else intrinsic
            times: Dict[str, float] = {}
            feats, seen = features_for_scene(
                d["xyz"], reader, apply_fn, wh, intr, times=times)
            # reading the frames happens inside the projection's loop
            times["render_s"] = 0.0
            finish(scene_id, feats, seen, times)
    print(f"wrote {len(report)} scenes to {store}")
    return report


if __name__ == "__main__":
    main()
