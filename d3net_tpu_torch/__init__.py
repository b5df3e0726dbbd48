"""d3net_tpu_torch — the PyTorch/CUDA port of ``d3net_tpu`` for NVIDIA Hopper.

The JAX package ``d3net_tpu`` is the reference this package is held against;
this package never imports it (nor JAX). Module layout and names follow the
JAX package so each counterpart is easy to find:

- ``data``     — numpy host pipeline: synthetic scenes, static-shape
                 collate, augmentation and the threaded ``BatchIterator``;
                 rendered frames, back-projection and the multiview
                 feature store.
- ``ops``      — voxelization tables (the C++ host library), segment
                 reductions, sparse conv, on-device clustering.
- ``kernels``  — hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions and ctypes bindings.
- ``models``   — sparse U-Net blocks, dense ScoreNet, PointGroup detector,
                 the speaker, the listener and the ENet 2D encoder.
- ``train``    — losses, train/eval steps, the run loop and checkpoints.
- ``eval``     — detection mAP/AR, captioning, grounding and the ScanNet
                 benchmark (mIoU, instance AP).
- ``scripts``  — the entry points (``python -m``): train, eval,
                 prepare_weights, train_enet, compute_multiview_features
                 and convert_multiview_hdf5.
- ``utils``    — box geometry, NMS, transforms, nearest-neighbour assignment.
- ``config``   — YAML configs (its own reader), merge, interpolation.
- ``params``   — Flax variable tree -> ``state_dict`` converter and the
                 ``load_detector`` entry point.
"""

__version__ = "0.1.0"
