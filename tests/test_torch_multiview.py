"""The port's multiview pipeline against the JAX package on the CPU:

- ``data/frames.py`` (``default_intrinsic``, ``look_at_pose``,
  ``orbit_poses``, ``render_frame`` with its depth and semantics,
  ``render_scene_frames``) and ``train_enet.build_frame_dataset`` equal
  JAX's byte for byte;
- ``data/multiview.py``'s ``ProjectionHelper.project`` and
  ``lift_features`` (with and without a depth map) and
  ``project_multiview_features`` on given maps, byte for byte;
- ``compute_multiview_features --config <tiny config> --cpu`` against the
  JAX script on the same weights (``outputs/enet/enet_weights.pkl``):
  scene ids and seen masks equal, features within rtol 1e-4 / atol 1e-5;
- ``convert_multiview_hdf5`` turns JAX's HDF5 into a store whose arrays
  equal it, and ``MultiviewAttached`` batches equal JAX's byte for byte;
- an HDF5 file where the store should be raises, naming the converter,
  and so do the run loop's loaders.
"""

import contextlib
import os
import sys

import numpy as np
import pytest

from d3net_tpu.data import frames as jframes
from d3net_tpu.data import multiview as jmv
from d3net_tpu.data.synthetic import make_scene as jax_make_scene
from d3net_tpu_torch import config as tcfg
from d3net_tpu_torch.data import frames as tframes
from d3net_tpu_torch.data import multiview as tmv
from d3net_tpu_torch.data.synthetic import make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "outputs", "enet", "enet_weights.pkl")
TINY = os.path.join(ROOT, "conf", "debug", "tiny_pointgroup.yaml")
SCENE = dict(num_instances=3, points_per_instance=600, floor_points=1000,
             room=4.0)
RTOL, ATOL = 1e-4, 1e-5


def _same(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


@contextlib.contextmanager
def _jax_script(name):
    """A JAX script module from scripts/, imported without its cache-dir
    setup leaking into this process's JAX configuration."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        mod = __import__(name)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
        jax.config.update("jax_compilation_cache_dir", before)
    yield mod


def test_cameras_and_renders_equal_jax():
    scene = make_scene(seed=3, **SCENE)
    jscene = jax_make_scene(seed=3, **SCENE)
    _same(tframes.default_intrinsic(80, 64), jframes.default_intrinsic(80, 64))
    for pos, tgt in (([3.0, -2.0, 2.2], [1.0, 1.0, 0.5]),
                     ([0.0, 0.0, 5.0], [0.0, 0.0, 0.0])):   # straight down
        pos, tgt = np.array(pos), np.array(tgt)
        _same(tframes.look_at_pose(pos, tgt), jframes.look_at_pose(pos, tgt))
    for n in (1, 5):
        for g, w in zip(tframes.orbit_poses(scene.xyz, n),
                        jframes.orbit_poses(jscene.xyz, n)):
            _same(g, w, "orbit")
    pose = tframes.orbit_poses(scene.xyz, 4)[1]
    intr = tframes.default_intrinsic(80, 64)
    got = tframes.render_frame(scene, pose, intr, 80, 64, with_semantics=True)
    want = jframes.render_frame(jscene, pose, intr, 80, 64,
                                with_semantics=True)
    for g, w, what in zip(got, want, ("color", "depth", "semantics")):
        _same(g, w, what)
    assert (got[2] >= 0).mean() > 0.2 and got[1].max() > 0
    for g, w in zip(tframes.render_scene_frames(scene, 3, 80, 64),
                    jframes.render_scene_frames(jscene, 3, 80, 64)):
        _same(g, w, "scene frames")


def test_build_frame_dataset_equals_jax():
    from d3net_tpu_torch.scripts import train_enet

    with _jax_script("train_enet") as jte:
        want = jte.build_frame_dataset(2, 3, 48, 64, seed=1)
    got = train_enet.build_frame_dataset(2, 3, 48, 64, seed=1)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0].shape == (6, 48, 64, 3) and got[1].shape == (6, 6, 8)


def _helpers():
    intr = tframes.default_intrinsic(80, 64)
    kw = dict(depth_max=8.0, image_dims=(80, 64), accuracy=0.05)
    return tmv.ProjectionHelper(intr, **kw), jmv.ProjectionHelper(intr, **kw)


def test_projection_and_lift_equal_jax():
    scene = make_scene(seed=4, **SCENE)
    th, jh = _helpers()
    rng = np.random.default_rng(0)
    feat_map = rng.normal(size=(8, 10, 16)).astype(np.float32)
    for pose in tframes.orbit_poses(scene.xyz, 3):
        _, depth = tframes.render_frame(scene, pose, th.intrinsic, 80, 64)
        for d in (depth, None):
            for g, w in zip(th.project(scene.xyz, pose, d),
                            jh.project(scene.xyz, pose, d)):
                _same(g, w, "project")
            got = th.lift_features(scene.xyz, feat_map, pose, d)
            want = jh.lift_features(scene.xyz, feat_map, pose, d)
            _same(got[0], want[0], "lifted")
            _same(got[1], want[1], "valid")
        assert 0 < got[1].mean() < 1


def test_project_multiview_features_equals_jax():
    scene = make_scene(seed=5, **SCENE)
    th, jh = _helpers()
    rng = np.random.default_rng(1)
    frames = []
    for pose in tframes.orbit_poses(scene.xyz, 4):
        _, depth = tframes.render_frame(scene, pose, th.intrinsic, 80, 64)
        frames.append((rng.normal(size=(8, 10, 16)).astype(np.float32), pose,
                       depth))
    got, seen = tmv.project_multiview_features(scene.xyz, frames, th, 16,
                                               return_seen=True)
    want = jmv.project_multiview_features(scene.xyz, frames, jh, 16)
    _same(got, want)
    _same(tmv.project_multiview_features(scene.xyz, frames, th, 16), want)
    assert 0 < seen.mean() < 1 and not got[~seen].any()


def test_compute_multiview_features_matches_jax_script(tmp_path, monkeypatch):
    import h5py

    from d3net_tpu_torch.scripts import compute_multiview_features as tcmf

    args = ["--config", TINY, "--weights", WEIGHTS, "--width", "80",
            "--height", "64", "--cpu"]
    jout = str(tmp_path / "jax.hdf5")
    with _jax_script("compute_multiview_features") as jcmf:
        monkeypatch.setattr(sys, "argv", ["cmf"] + args + ["--output", jout])
        jcmf.main()
    report = tcmf.main(args + ["--output", str(tmp_path / "port.hdf5")])
    store = str(tmp_path / "port.mvstore")
    with h5py.File(jout, "r") as f:
        want = {k: np.asarray(f[k]) for k in f}
    assert sorted(os.listdir(store)) == sorted(f"{k}.npy" for k in want)
    assert sorted(report) == sorted(want) and len(want) == 8 + 2
    for scene_id, w in want.items():
        g = tmv.read_multiview_store(store, scene_id)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        seen = np.any(w != 0, axis=1)
        _same(np.any(g != 0, axis=1), seen, scene_id)
        assert report[scene_id]["seen"] == pytest.approx(seen.mean())
        assert 0.2 < seen.mean() < 1
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=scene_id)
        assert min(report[scene_id][k] for k in
                   ("render_s", "enet_s", "project_s")) >= 0


def _features(scenes):
    rng = np.random.default_rng(2)
    return {s.scene_id: rng.normal(size=(len(s.xyz), 128)).astype(np.float32)
            for s in scenes}


def test_converter_and_multiview_attached_equal_jax(tmp_path):
    from d3net_tpu.data import collate as jcollate
    from d3net_tpu.data import dataset as jds
    from d3net_tpu_torch.data import collate as tcollate
    from d3net_tpu_torch.data import dataset as tds
    from d3net_tpu_torch.scripts import convert_multiview_hdf5

    scenes = [make_scene(seed=i, **SCENE) for i in range(3)]
    jscenes = [jax_make_scene(seed=i, **SCENE) for i in range(3)]
    feats = _features(scenes)
    h5 = str(tmp_path / "feats.hdf5")
    jmv.write_multiview_hdf5(h5, feats)
    with pytest.raises(FileNotFoundError, match="convert_multiview_hdf5"):
        tds.MultiviewAttached(scenes, h5)
    assert convert_multiview_hdf5.main([h5]) == str(tmp_path / "feats.mvstore")
    for scene_id, f in feats.items():
        _same(tmv.read_multiview_store(str(tmp_path / "feats.mvstore"),
                                       scene_id), jmv.read_multiview_hdf5(
                                           h5, scene_id), scene_id)

    spec = dict(max_points=2500, voxel_caps=[2560, 1280, 640],
                max_instances=8, use_multiview=True, use_normal=True)
    kw = dict(shuffle=True, augment=True, elastic=False, seed=3, workers=1,
              return_scenes=True)
    got_it = tds.BatchIterator(tds.MultiviewAttached(scenes, h5),
                               tcollate.BatchSpec(**spec), 2, **kw)
    want_it = jds.BatchIterator(jds.MultiviewAttached(jscenes, h5),
                                jcollate.BatchSpec(**spec), 2, **kw)
    got, want = list(got_it), list(want_it)
    assert len(got) == len(want) == 1
    for (gb, gs), (wb, ws) in zip(got, want):
        _same(gb, wb, "batch")
        assert gb["point_feats"].shape[-1] == 3 + 128
        for g, w in zip(gs, ws):
            _same(g.multiview, w.multiview, g.scene_id)

    # the npz source takes the store's features in place of its own
    npz = str(tmp_path / "scene.npz")
    s = scenes[1]
    np.savez(npz, xyz=s.xyz, rgb=s.rgb, normal=s.normal,
             sem_labels=s.sem_labels, instance_ids=s.instance_ids,
             instance_bboxes=s.instance_bboxes, scene_id=s.scene_id,
             multiview=np.zeros_like(feats[s.scene_id]))
    got = tds.NpzScenes([npz], multiview_store=h5)[0]
    want = jds.NpzScenes([npz], multiview_hdf5=h5)[0]
    _same(got.multiview, want.multiview)
    _same(got.multiview, feats[s.scene_id])


def test_store_errors(tmp_path):
    from d3net_tpu_torch.train import loop as tloop

    key = str(tmp_path / "mv.hdf5")
    with pytest.raises(FileNotFoundError, match="compute_multiview_features"):
        tmv.open_multiview_store(key)
    with open(key, "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
    with pytest.raises(FileNotFoundError, match="convert_multiview_hdf5"):
        tmv.open_multiview_store(key)

    cfg = tcfg.load(TINY)
    cfg.model.use_multiview = True
    cfg.data.multiview_hdf5 = key
    spec = tloop.spec_from_cfg(cfg)
    with pytest.raises(FileNotFoundError, match="convert_multiview_hdf5"):
        tloop.make_dataloaders(cfg, spec)
    # a store of the config's scenes attaches; one scene short raises
    scenes = tloop.scenes_from_cfg(
        tcfg.load(TINY), "val", tloop.num_val_scenes(cfg)).scenes
    tmv.write_multiview_store(str(tmp_path / "mv.mvstore"),
                              _features(scenes[:1]))
    val = tloop.make_val_loader(cfg, spec)
    assert val.scenes[0].multiview.shape == (len(scenes[0].xyz), 128)
    with pytest.raises(KeyError, match=scenes[1].scene_id):
        val.scenes[1]
    assert tmv.store_dir(str(tmp_path / "mv.mvstore")) == str(
        tmp_path / "mv.mvstore")
