"""The inspection tools as users run them, on the CPU, against the JAX
package's: ``utils/ply.py``, ``scripts/visualize_scannet.py`` (numpy only)
and ``scripts/visualize_captioning.py`` / ``visualize_grounding.py`` (the
pipeline's forward).

- ``utils/ply``: the same points write the same bytes; ascii and binary
  files (vertices and triangle faces) read to equal arrays.
- ``visualize_scannet``: colours, every PLY and ``index.html`` byte-equal,
  through its functions and through its CLI on ``--synthetic 2`` with a
  ``--pred`` dir.
- ``visualize_captioning`` / ``_grounding`` on conf/debug/tiny_captioning.yaml
  / tiny_grounding.yaml with one set of seeded weights
  (tests/test_torch_benchmark.py's run dirs and patched JAX ``_setup``):
  ``captions.txt`` and ``queries.txt`` equal, ``scene.ply`` byte-equal,
  the box PLYs' vertices within the detector's rtol 1e-4 / atol 1e-5 and
  their colours equal.
"""

import os

import numpy as np
import pytest
import torch

from d3net_tpu_torch.utils import ply as tply
from test_torch_benchmark import (
    ATOL, RTOL, TINY_CAPTION, TINY_GROUNDING, make_runs, patch_jax_setup,
    run_jax_script,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = _bytes(p)
    return out


@pytest.mark.parametrize("with_rgb", [True, False], ids=["rgb", "xyz"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_ply_points_same_bytes(tmp_path, with_rgb, dtype):
    from d3net_tpu.utils import ply as jply

    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(50, 3)).astype(dtype)
    rgb = rng.uniform(0, 255, (50, 3)) if with_rgb else None
    jply.write_ply_points(str(tmp_path / "jax.ply"), xyz, rgb)
    tply.write_ply_points(str(tmp_path / "port.ply"), xyz, rgb)
    want = _bytes(tmp_path / "jax.ply")
    assert _bytes(tmp_path / "port.ply") == want
    assert want.count(b"\n") == 50 + (10 if with_rgb else 7)


def _mesh_ply(path, fmt: str):
    """A PLY of 6 vertices (xyz float, rgb uchar, label ushort) and 3
    triangle faces, in ``fmt`` (ascii or binary_little_endian)."""
    rng = np.random.default_rng(1)
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
                    ("green", "u1"), ("blue", "u1"), ("label", "<u2")])
    v = np.zeros(6, vdt)
    for k in ("x", "y", "z"):
        v[k] = rng.normal(size=6)
    for k in ("red", "green", "blue"):
        v[k] = rng.integers(0, 256, 6)
    v["label"] = rng.integers(0, 40, 6)
    faces = np.array([[0, 1, 2], [2, 3, 4], [3, 4, 5]], np.int32)
    header = (
        f"ply\nformat {fmt} 1.0\ncomment made by a test\n"
        "element vertex 6\nproperty float x\nproperty float y\n"
        "property float z\nproperty uchar red\nproperty uchar green\n"
        "property uchar blue\nproperty ushort label\n"
        "element face 3\nproperty list uchar int vertex_indices\n"
        "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for r in v:
                f.write((" ".join(str(x) for x in r.tolist()) + "\n").encode())
            for t in faces:
                f.write(("3 " + " ".join(map(str, t)) + "\n").encode())
        else:
            f.write(v.tobytes())
            fdt = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
            fa = np.zeros(3, fdt)
            fa["n"], fa["v"] = 3, faces
            f.write(fa.tobytes())
    return v, faces


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_read_ply_matches_jax(tmp_path, fmt):
    from d3net_tpu.utils import ply as jply

    path = str(tmp_path / "mesh.ply")
    v, faces = _mesh_ply(path, fmt)
    got, want = tply.read_ply(path), jply.read_ply(path)
    assert set(got) == set(want) == {"vertex", "face"}
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["face"], faces)
    for k in v.dtype.names:
        np.testing.assert_allclose(got["vertex"][k], v[k], rtol=1e-6,
                                   err_msg=k)


def test_scannet_colours_match_jax():
    from scripts import visualize_scannet as jvis

    from d3net_tpu_torch.scripts import visualize_scannet as tvis

    sem = np.array([-1, 0, 4, 19, 20, 7])
    np.testing.assert_array_equal(tvis.sem_colors(sem), jvis.sem_colors(sem))
    ids = np.random.default_rng(0).integers(-1, 12, 200)
    for seed in (0, 1):
        got = tvis.inst_colors(ids, seed=seed)
        np.testing.assert_array_equal(got, jvis.inst_colors(ids, seed=seed))
        assert got.dtype == np.uint8
    assert tvis.inst_colors(np.zeros(0, np.int64)).shape == (0, 3)


def test_scannet_plys_and_html_same_bytes(tmp_path):
    from scripts import visualize_scannet as jvis

    from d3net_tpu.data.synthetic import make_scene as jmake
    from d3net_tpu_torch.data.synthetic import make_scene
    from d3net_tpu_torch.scripts import visualize_scannet as tvis

    kw = dict(seed=3, num_instances=3, points_per_instance=200,
              floor_points=500)
    scene, jscene = make_scene(**kw), jmake(**kw)
    pred = {"sem_pred": scene.sem_labels[::-1].copy(),
            "inst_pred": scene.instance_ids}
    links = tvis.write_scene_plys(scene, str(tmp_path / "port"), pred)
    jlinks = jvis.write_scene_plys(jscene, str(tmp_path / "jax"), pred)
    assert links == jlinks
    assert set(links) == {"rgb", "gt_sem", "gt_inst", "pred_sem",
                          "pred_inst"}
    rows = [(scene.scene_id, "3 <instances> & stats", links)]
    tvis.generate_html(str(tmp_path / "port" / "index.html"), rows)
    jvis.generate_html(str(tmp_path / "jax" / "index.html"), rows)
    want = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == want and len(want) == 6
    v = tply.read_ply(str(tmp_path / "port" / links["pred_sem"]))["vertex"]
    np.testing.assert_array_equal(
        np.stack([v["red"], v["green"], v["blue"]], 1),
        tvis.sem_colors(pred["sem_pred"]))


def test_scannet_cli_same_tree(tmp_path, monkeypatch, capsys):
    from d3net_tpu_torch.data.synthetic import make_scene
    from d3net_tpu_torch.scripts import visualize_scannet as tvis

    pred = tmp_path / "pred"
    pred.mkdir()
    scene = make_scene(seed=0)
    np.savez(pred / f"{scene.scene_id}.npz", sem_pred=scene.sem_labels,
             inst_pred=scene.instance_ids)
    args = ["--synthetic", "2", "--pred", str(pred), "--output"]
    run_jax_script(monkeypatch, "scripts/visualize_scannet.py", *args,
                   str(tmp_path / "jax"))
    want_out = capsys.readouterr().out
    tvis.main(args + [str(tmp_path / "port")])
    got_out = capsys.readouterr().out
    assert got_out == want_out.replace("/jax/", "/port/")
    want = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == want
    # scene 0 with its predictions (5 plys), scene 1 without (3), the html
    assert len(want) == 5 + 3 + 1


@pytest.fixture(scope="module")
def captioning_dumps(tmp_path_factory):
    from d3net_tpu_torch.scripts import visualize_captioning

    runs = make_runs(tmp_path_factory.mktemp("vis_cap"), TINY_CAPTION)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_setup(mp, runs.variables)
        run_jax_script(mp, "scripts/visualize_captioning.py", "--folder",
                       runs.jax, "--cpu", "--scenes", "1")
    out = visualize_captioning.main(["--folder", runs.port, "--cpu",
                                     "--scenes", "1"])
    assert out == os.path.join(runs.port, "vis_captioning")
    return (os.path.join(runs.port, "vis_captioning"),
            os.path.join(runs.jax, "vis_captioning"))


@pytest.fixture(scope="module")
def grounding_dumps(tmp_path_factory):
    from d3net_tpu_torch.scripts import visualize_grounding

    runs = make_runs(tmp_path_factory.mktemp("vis_grd"), TINY_GROUNDING)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_setup(mp, runs.variables)
        run_jax_script(mp, "scripts/visualize_grounding.py", "--folder",
                       runs.jax, "--cpu")
    visualize_grounding.main(["--folder", runs.port, "--cpu"])
    return (os.path.join(runs.port, "vis_grounding"),
            os.path.join(runs.jax, "vis_grounding"))


def _assert_box_ply_close(got_path, want_path):
    got, want = tply.read_ply(got_path), tply.read_ply(want_path)
    g, w = got["vertex"], want["vertex"]
    assert g.dtype == w.dtype and len(g) == len(w) > 0
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{got_path} {k}")
    for k in ("red", "green", "blue"):
        np.testing.assert_array_equal(g[k], w[k])


def test_visualize_captioning_matches_jax(captioning_dumps):
    got_dir, want_dir = captioning_dumps
    got, want = _tree(got_dir), _tree(want_dir)
    assert sorted(got) == sorted(want) == [
        "synthetic_10000/captions.txt", "synthetic_10000/pred_boxes.ply",
        "synthetic_10000/scene.ply"]
    assert got["synthetic_10000/scene.ply"] == want["synthetic_10000/scene.ply"]
    caps = got["synthetic_10000/captions.txt"].decode()
    assert caps == want["synthetic_10000/captions.txt"].decode()
    n_kept = len(caps.splitlines())
    assert n_kept > 1 and caps.startswith("proposal ")
    _assert_box_ply_close(os.path.join(got_dir, "synthetic_10000",
                                       "pred_boxes.ply"),
                          os.path.join(want_dir, "synthetic_10000",
                                       "pred_boxes.ply"))
    # 12 edges of 20 points for each kept proposal
    v = tply.read_ply(os.path.join(got_dir, "synthetic_10000",
                                   "pred_boxes.ply"))["vertex"]
    assert len(v) == n_kept * 12 * 20


def test_visualize_grounding_matches_jax(grounding_dumps):
    got_dir, want_dir = grounding_dumps
    got, want = _tree(got_dir), _tree(want_dir)
    assert sorted(got) == sorted(want)
    scenes = sorted({p.split(os.sep)[0] for p in got})
    assert scenes == ["synthetic_10000", "synthetic_10001"]
    n_pred = 0
    for name in got:
        if name.endswith(("queries.txt", "scene.ply")):
            assert got[name] == want[name], name
        else:
            _assert_box_ply_close(os.path.join(got_dir, name),
                                  os.path.join(want_dir, name))
            n_pred += name.endswith("_pred.ply")
    queries = got["synthetic_10000/queries.txt"].decode().splitlines()
    assert n_pred == len(queries) + len(
        got["synthetic_10001/queries.txt"].decode().splitlines()) > 0
    assert all(" -> proposal " in q for q in queries)
