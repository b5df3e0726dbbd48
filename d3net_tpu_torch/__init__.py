"""d3net_tpu_torch — the PyTorch/CUDA port of ``d3net_tpu`` for NVIDIA Hopper.

The JAX package ``d3net_tpu`` is the reference this package is held against;
this package never imports it (nor JAX). Module layout and names follow the
JAX package so each counterpart is easy to find:

- ``data``     — numpy host pipeline: synthetic scenes, static-shape collate.
- ``ops``      — voxelization tables, segment reductions, sparse conv,
                 on-device clustering.
- ``kernels``  — hand-written CUDA kernels (``csrc/``) with their plain
                 PyTorch versions and ctypes bindings.
- ``models``   — sparse U-Net blocks, dense ScoreNet, PointGroup detector.
- ``utils``    — box geometry and nearest-neighbour assignment.
- ``params``   — Flax variable tree -> ``state_dict`` converter and the
                 ``load_detector`` entry point.
"""

__version__ = "0.1.0"
