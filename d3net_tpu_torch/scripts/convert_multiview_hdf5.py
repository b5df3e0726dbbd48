"""Convert a multiview HDF5 file (JAX's ``enet_feats_maxpool.hdf5``
layout: one (N, 128) dataset per scene id) into the port's feature store,
array for array:

    python -m d3net_tpu_torch.scripts.convert_multiview_hdf5 \\
        outputs/enet/multiview_flagship.hdf5 [--output DIR]

The store goes where the config key that names the HDF5 file points
(``.hdf5`` -> ``.mvstore``) unless ``--output`` says otherwise. It is an
offline step: it needs h5py, which the card's machine lacks.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from d3net_tpu_torch.data.multiview import store_dir, write_multiview_store


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("hdf5", help="the HDF5 feature file")
    ap.add_argument("--output", help="the store directory (default: the "
                                     "file's path with .mvstore)")
    args = ap.parse_args(argv)
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "convert_multiview_hdf5 reads HDF5 with h5py, which is not "
            "installed here; convert where it is, then copy the store") from e
    out = args.output or store_dir(args.hdf5)
    with h5py.File(args.hdf5, "r") as f:
        for scene_id in f:
            write_multiview_store(out, {scene_id: np.asarray(f[scene_id])})
        n = len(f)
    print(f"wrote {n} scenes to {out}")
    return out


if __name__ == "__main__":
    main()
