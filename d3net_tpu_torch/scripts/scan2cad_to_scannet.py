"""Scan2CAD alignment -> per-instance rotation matrices, the port's copy of
the JAX package's ``scripts/scan2cad_to_scannet.py`` (parity: reference
``scripts/Scan2CAD_to_ScanNet.py``).

Reads Scan2CAD ``full_annotations.json`` (per scene: trs quaternions for the
scan and each aligned CAD model) and writes a JSON mapping
{scene_id: {object_id: 3x3 rotation (row-major list)}} used as orientation
labels by the speaker's relational graph loss.

Usage: python -m d3net_tpu_torch.scripts.scan2cad_to_scannet \
           --annotations <json> --out <json>
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def quat_to_matrix(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = np.sqrt(w * w + x * x + y * y + z * z) + 1e-12
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--annotations", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    data = json.load(open(args.annotations))
    out = {}
    for scan in data:
        scene_id = scan["id_scan"]
        scene_rot = quat_to_matrix(scan["trs"]["rotation"])
        rotations = {}
        for i, model in enumerate(scan.get("aligned_models", [])):
            rot = quat_to_matrix(model["trs"]["rotation"])
            # rotation relative to the scan frame
            rotations[str(i)] = (scene_rot.T @ rot).tolist()
        out[scene_id] = rotations
    json.dump(out, open(args.out, "w"))
    print(f"wrote {len(out)} scenes to {args.out}")


if __name__ == "__main__":
    main()
