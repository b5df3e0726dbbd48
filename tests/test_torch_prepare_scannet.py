"""The port's ScanNet data preparation against the JAX package's scripts.

``d3net_tpu_torch.scripts.prepare_scannet`` and ``scripts/prepare_scannet.py``
read the same raw scans in ScanNet's layout (``data.raw_scans``: binary mesh
and label PLYs with faces, segs.json, aggregation.json, the meta txt), made
from a seed, and must write the same npz arrays exactly (dtype, shape,
value, ``scene_id``), byte-equal instance-GT text files, and scenes that
the two packages' ``NpzScenes`` read alike. ``scan2cad_to_scannet`` must
write the same JSON.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import prepare_scannet as jax_prep  # noqa: E402  scripts/prepare_scannet.py
import scan2cad_to_scannet as jax_s2c  # noqa: E402

from d3net_tpu.data.dataset import NpzScenes as JaxNpzScenes  # noqa: E402
from d3net_tpu_torch.data.dataset import NpzScenes  # noqa: E402
from d3net_tpu_torch.data.raw_scans import write_raw_scan  # noqa: E402
from d3net_tpu_torch.scripts import prepare_scannet as prep  # noqa: E402
from d3net_tpu_torch.scripts import scan2cad_to_scannet as s2c  # noqa: E402

# a non-rigid alignment too: normals go through its inverse transpose
SHEARED = np.array([[0.8, -0.6, 0.1, 2.5], [0.6, 0.8, 0.0, -1.25],
                    [0.05, 0.0, 1.2, 0.3], [0, 0, 0, 1]])
CASES = {
    "aligned_quirks": dict(align=SHEARED, quirks=True),
    "rigid_alignment": dict(),
    "no_meta": dict(meta=False, quirks=True),
    "no_aggregation": dict(aggregation=False),
}


def _scan(tmp_path, case, seed=0):
    scans = tmp_path / "scans"
    scan = f"scene{seed:04d}_00"
    write_raw_scan(str(scans), scan, seed, vertices=3000, objects=4,
                   **CASES[case])
    return str(scans), scan


def _assert_npz_equal(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_scan_matches_jax(tmp_path, case):
    scans, scan = _scan(tmp_path, case)
    prep.process_scan(scans, scan, str(tmp_path / "port"))
    jax_prep.process_scan(scans, scan, str(tmp_path / "jax"))
    port_npz = str(tmp_path / "port" / f"{scan}.npz")
    jax_npz = str(tmp_path / "jax" / f"{scan}.npz")
    _assert_npz_equal(port_npz, jax_npz)
    d = np.load(port_npz)
    assert str(d["scene_id"]) == scan
    if case == "no_aggregation":
        assert (d["sem_labels"] == -1).all() and (d["instance_ids"] == -1).all()
        assert d["instance_bboxes"].shape == (0, 8)
    else:
        assert len(d["instance_bboxes"]) > 0
    if CASES[case].get("quirks"):
        # labels above 149 clip to 149, which remaps to -1
        raw = prep.read_ply(os.path.join(
            scans, scan, f"{scan}_vh_clean_2.labels.ply"))["vertex"]["label"]
        assert (raw > 149).any()
        assert (d["sem_labels"][raw > 149] == -1).all()

    prep.write_instance_gt(port_npz, str(tmp_path / "gt_port"))
    jax_prep.write_instance_gt(jax_npz, str(tmp_path / "gt_jax"))
    with open(tmp_path / "gt_port" / f"{scan}.txt", "rb") as f:
        got = f.read()
    with open(tmp_path / "gt_jax" / f"{scan}.txt", "rb") as f:
        assert got == f.read()

    port_scene = NpzScenes([port_npz])[0]
    jax_scene = JaxNpzScenes([jax_npz])[0]
    for field in ("xyz", "rgb", "normal", "sem_labels", "instance_ids",
                  "instance_bboxes"):
        a, b = getattr(port_scene, field), getattr(jax_scene, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert port_scene.scene_id == jax_scene.scene_id == scan
    assert port_scene.multiview is None and jax_scene.multiview is None


def test_quirks_are_kept(tmp_path):
    """The reference's quirks, on the port's npz: wall/floor/ceiling groups
    give no instances, a do-not-care first vertex keeps its group's
    instance ids but no box, an empty group is dropped, and the normals
    are the raw mesh's under the inverse transpose of the alignment."""
    scans, scan = _scan(tmp_path, "aligned_quirks")
    prep.process_scan(scans, scan, str(tmp_path / "out"))
    d = np.load(tmp_path / "out" / f"{scan}.npz")
    base = os.path.join(scans, scan)
    with open(os.path.join(base, f"{scan}.aggregation.json")) as f:
        groups = json.load(f)["segGroups"]
    with open(os.path.join(base, f"{scan}_vh_clean_2.0.010000.segs.json")) as f:
        segs = set(json.load(f)["segIndices"])
    ids = set(d["instance_ids"].tolist())
    objects = [g for g in groups
               if g["label"] not in ("wall", "floor", "ceiling")]
    filled = [g for g in objects if segs & set(g["segments"])]
    assert len(objects) - len(filled) == 1        # the empty group
    assert {g["objectId"] for g in filled} == ids - {-1}
    # one filled group (the do-not-care first vertex) has ids, no box
    boxed = set(d["instance_bboxes"][:, 7].astype(int).tolist())
    assert boxed < ids and len(boxed) == len(filled) - 1
    assert not ({g["objectId"] for g in groups if g["label"] in
                 ("wall", "floor", "ceiling")} & ids)
    mesh = prep.read_ply(os.path.join(base, f"{scan}_vh_clean_2.ply"))
    v = mesh["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    n = prep.compute_normals(xyz, mesh["face"])
    want = (n @ np.linalg.inv(SHEARED[:3, :3]).T).astype(np.float32)
    np.testing.assert_array_equal(d["normal"], want)
    assert prep.read_axis_align_matrix(os.path.join(base, f"{scan}.txt")) \
        is not None


def _run(args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_main_with_split_and_workers_matches_jax(tmp_path):
    scans = tmp_path / "scans"
    for seed, case in enumerate(("aligned_quirks", "no_meta",
                                 "no_aggregation")):
        write_raw_scan(str(scans), f"scene{seed:04d}_00", seed,
                       vertices=2000, objects=3, **CASES[case])
    split = tmp_path / "split.txt"
    split.write_text("scene0000_00\n\nscene0002_00\n")
    outs = {}
    for name, cmd in (("port", ["-m", "d3net_tpu_torch.scripts.prepare_"
                                      "scannet"]),
                      ("jax", [os.path.join(ROOT, "scripts",
                                            "prepare_scannet.py")])):
        out, gt = tmp_path / f"out_{name}", tmp_path / f"gt_{name}"
        printed = _run(cmd + ["--scans", str(scans), "--out", str(out),
                              "--split", str(split), "--workers", "2",
                              "--write-inst-gt", str(gt)])
        assert printed.split() == ["scene0000_00", "scene0002_00"]
        outs[name] = (sorted(os.listdir(out)), sorted(os.listdir(gt)))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == ["scene0000_00.npz", "scene0002_00.npz"]
    for f in outs["port"][0]:
        _assert_npz_equal(tmp_path / "out_port" / f, tmp_path / "out_jax" / f)
    for f in outs["port"][1]:
        assert ((tmp_path / "gt_port" / f).read_bytes()
                == (tmp_path / "gt_jax" / f).read_bytes())
    # without --split: every scan directory, sorted
    _run(["-m", "d3net_tpu_torch.scripts.prepare_scannet", "--scans",
          str(scans), "--out", str(tmp_path / "all"), "--workers", "2"])
    assert sorted(os.listdir(tmp_path / "all")) == [
        f"scene{i:04d}_00.npz" for i in range(3)]


def _scan2cad_annotations(rng):
    scans = []
    for s in range(4):
        models = [{"id_cad": f"cad{m}", "catid_cad": "03001627",
                   "trs": {"translation": rng.normal(0, 2, 3).tolist(),
                           "rotation": (rng.normal(0, 1, 4)
                                        * rng.uniform(0.2, 5)).tolist(),
                           "scale": rng.uniform(0.5, 2, 3).tolist()}}
                  for m in range(s * 2)]
        scan = {"id_scan": f"scene{s:04d}_00",
                "trs": {"translation": rng.normal(0, 1, 3).tolist(),
                        "rotation": (rng.normal(0, 1, 4) * 3).tolist(),
                        "scale": [1.0, 1.0, 1.0]}}
        if models:
            scan["aligned_models"] = models
        scans.append(scan)
    return scans


def test_scan2cad_matches_jax(tmp_path, monkeypatch):
    ann = tmp_path / "full_annotations.json"
    ann.write_text(json.dumps(_scan2cad_annotations(
        np.random.default_rng(7))))
    s2c.main(["--annotations", str(ann), "--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["scan2cad_to_scannet.py",
                                      "--annotations", str(ann), "--out",
                                      str(tmp_path / "jax.json")])
    jax_s2c.main()
    port = (tmp_path / "port.json").read_text()
    assert port == (tmp_path / "jax.json").read_text()
    out = json.loads(port)
    assert sorted(out) == [f"scene{s:04d}_00" for s in range(4)]
    assert out["scene0000_00"] == {}
    assert len(out["scene0003_00"]) == 6
    for rot in out["scene0003_00"].values():
        r = np.asarray(rot)
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-9)
    q = [2.0, 0.0, 0.0, 2.0]          # unnormalised: 90 degrees about z
    np.testing.assert_array_equal(s2c.quat_to_matrix(q),
                                  jax_s2c.quat_to_matrix(q))
    np.testing.assert_allclose(s2c.quat_to_matrix(q),
                               [[0, -1, 0], [1, 0, 0], [0, 0, 1]], atol=1e-12)
