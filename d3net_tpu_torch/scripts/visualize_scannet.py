"""ScanNet visualization toolchain: colored PLY dumps + HTML gallery.

The port's ``scripts/visualize_scannet.py`` (numpy only, over the port's
scenes and PLY writer): the same scenes and predictions give the same
PLYs and ``index.html``, byte for byte.

    python -m d3net_tpu_torch.scripts.visualize_scannet \
        (--npz <dir> | --synthetic N) [--pred <dir>] --output <dir>

Parity: ``visualize/scannet/generate_ply.py`` (rgb / GT-semantic /
pred-semantic / instance colored point clouds with the ScanNet NYU40 color
map) and ``generate_html.py`` (a browsable index over the per-scene
artifacts; the reference embeds pre-rendered mp4s — this environment has no
renderer, so the gallery links the PLYs and inlines scene stats instead).

Sources: ``--npz <dir>`` (scenes preprocessed by scripts/prepare_scannet.py)
or ``--synthetic N``.  Predictions: ``--pred <dir>`` with per-scene
``<scene_id>.npz`` holding ``sem_pred`` (N,) and/or ``inst_pred`` (N,)
(written by ``scripts/eval.py --task scannet``-style dumps or any caller).
"""

from __future__ import annotations

import argparse
import glob
import html
import os
from typing import Optional, Sequence

import numpy as np

from d3net_tpu_torch.utils.ply import write_ply_points

# ScanNet benchmark color map (NYU40 ids), reference
# data/scannet/model_util_scannet.py:19-59
SCANNET_COLOR_MAP = {
    0: (0, 0, 0), 1: (174, 199, 232), 2: (152, 223, 138), 3: (31, 119, 180),
    4: (255, 187, 120), 5: (188, 189, 34), 6: (140, 86, 75),
    7: (255, 152, 150), 8: (214, 39, 40), 9: (197, 176, 213),
    10: (148, 103, 189), 11: (196, 156, 148), 12: (23, 190, 207),
    14: (247, 182, 210), 15: (66, 188, 102), 16: (219, 219, 141),
    17: (140, 57, 197), 18: (202, 185, 52), 19: (51, 176, 203),
    20: (200, 54, 131), 21: (92, 193, 61), 22: (78, 71, 183),
    23: (172, 114, 82), 24: (255, 127, 14), 25: (91, 163, 138),
    26: (153, 98, 156), 27: (140, 153, 101), 28: (158, 218, 229),
    29: (100, 125, 154), 30: (178, 127, 135), 32: (146, 111, 194),
    33: (44, 160, 44), 34: (112, 128, 144), 35: (96, 207, 209),
    36: (227, 119, 194), 37: (213, 92, 176), 38: (94, 106, 211),
    39: (82, 84, 163), 40: (100, 85, 144),
}
# NYU20 (remapped 0..19) -> NYU40 id (reference VALID_CLASS_IDS; our class 0
# is wall=1 ... 19 otherfurniture=39)
VALID_CLASS_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                   34, 36, 39]


def sem_colors(sem_labels: np.ndarray) -> np.ndarray:
    """(N,) NYU20 ids (-1 = unannotated) -> (N, 3) uint8 colors."""
    lut = np.zeros((21, 3), np.uint8)
    for i, cid in enumerate(VALID_CLASS_IDS):
        lut[i] = SCANNET_COLOR_MAP[cid]
    idx = np.where((sem_labels >= 0) & (sem_labels < 20), sem_labels, 20)
    return lut[idx]


def inst_colors(instance_ids: np.ndarray, seed: int = 0) -> np.ndarray:
    """(N,) instance ids (-1 = none) -> distinct random colors."""
    rng = np.random.default_rng(seed)
    n = int(instance_ids.max()) + 1 if instance_ids.size else 0
    palette = rng.integers(40, 255, (max(n, 1), 3), dtype=np.uint8)
    out = np.zeros((len(instance_ids), 3), np.uint8)
    ok = instance_ids >= 0
    out[ok] = palette[instance_ids[ok]]
    return out


def load_scenes(args):
    if args.synthetic:
        from d3net_tpu_torch.data.synthetic import make_scene

        return [make_scene(seed=i) for i in range(args.synthetic)]
    from d3net_tpu_torch.data.dataset import NpzScenes

    paths = sorted(glob.glob(os.path.join(args.npz, "*.npz")))
    src = NpzScenes(paths)
    return [src[i] for i in range(len(src))]


def write_scene_plys(scene, out_dir: str, pred: dict | None) -> dict:
    """Writes the task plys for one scene; returns {task: relpath}."""
    os.makedirs(out_dir, exist_ok=True)
    sid = scene.scene_id
    rel = {}

    rgb255 = np.clip((scene.rgb + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)
    jobs = {
        "rgb": rgb255,
        "gt_sem": sem_colors(scene.sem_labels),
        "gt_inst": inst_colors(scene.instance_ids),
    }
    if pred is not None and "sem_pred" in pred:
        jobs["pred_sem"] = sem_colors(np.asarray(pred["sem_pred"]))
    if pred is not None and "inst_pred" in pred:
        jobs["pred_inst"] = inst_colors(np.asarray(pred["inst_pred"]), seed=1)
    for task, colors in jobs.items():
        path = os.path.join(out_dir, f"{sid}_{task}.ply")
        write_ply_points(path, scene.xyz, colors)
        rel[task] = os.path.basename(path)
    return rel


def generate_html(index_path: str, rows: list):
    """Gallery table: scene id, stats, links per task ply (parity:
    generate_html.py's paginated table, minus the mp4 embeds)."""
    cells = []
    for sid, stats, links in rows:
        link_html = " | ".join(
            f'<a href="{html.escape(p)}">{html.escape(t)}</a>'
            for t, p in sorted(links.items())
        )
        cells.append(
            f"<tr><td>{html.escape(sid)}</td><td>{html.escape(stats)}</td>"
            f"<td>{link_html}</td></tr>"
        )
    doc = (
        "<html><head><title>d3net_tpu scannet viz</title>"
        "<style>table{border-collapse:collapse}td,th{border:1px solid #999;"
        "padding:4px 8px;font-family:monospace}</style></head><body>"
        "<h2>Scene gallery</h2><table><tr><th>scene</th><th>stats</th>"
        "<th>plys</th></tr>" + "\n".join(cells) + "</table></body></html>"
    )
    with open(index_path, "w") as f:
        f.write(doc)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", help="directory of prepare_scannet npz scenes")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--pred", help="directory of per-scene prediction npz")
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    if not args.npz and not args.synthetic:
        ap.error("need --npz or --synthetic N")

    os.makedirs(args.output, exist_ok=True)
    rows = []
    for scene in load_scenes(args):
        pred = None
        if args.pred:
            p = os.path.join(args.pred, f"{scene.scene_id}.npz")
            if os.path.exists(p):
                with np.load(p) as z:
                    pred = dict(z)
        links = write_scene_plys(scene, args.output, pred)
        n_inst = int((np.unique(scene.instance_ids) >= 0).sum())
        stats = f"{len(scene.xyz)} pts, {n_inst} instances"
        rows.append((scene.scene_id, stats, links))
        print(f"{scene.scene_id}: {sorted(links)}")
    generate_html(os.path.join(args.output, "index.html"), rows)
    print(f"wrote {os.path.join(args.output, 'index.html')}")


if __name__ == "__main__":
    main()
