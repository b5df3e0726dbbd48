"""Each stage of the port's detector forward fed with the JAX package's own
inputs, so a threshold flip is pinned to the stage where it happens:
backbone + heads, dual-pass clustering, cluster stats + 14^3 grids, and
the ScoreNet. f32 on the CPU, at the tests/test_detector.py config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3net_tpu.data.collate import BatchSpec, build_batch
from d3net_tpu.models.pointgroup import PointGroup as JaxPointGroup
from d3net_tpu.models.pointgroup import voxelize_feats
from d3net_tpu_torch import params
from d3net_tpu_torch.data.collate import batch_to_torch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.models.blocks import fold_tables
from d3net_tpu_torch.models.pointgroup import PointGroup

CFG = dict(m=8, blocks=(1, 2, 3), cluster_blocks=(1, 2), clusters_per_pass=16,
           max_num_proposal=8, cluster_npoint_thre=30, test_npoint_thresh=30,
           test_score_thresh=0.0, cluster_ring=1, cluster_cell_size=0.03,
           cluster_prop_iters=4)
SCENE = dict(num_instances=3, density=3000.0, size_range=(0.25, 0.5),
             floor_points=1000, room=4.0)
SPEC = dict(max_points=3072, voxel_caps=[3072, 1536, 768], max_instances=8,
            use_multiview=False, use_normal=True)
RTOL, ATOL = 1e-4, 1e-5


def _randomize(tree, rng):
    for k, val in tree.items():
        if isinstance(val, dict):
            _randomize(val, rng)
        elif k in ("bias", "mean"):
            tree[k] = rng.normal(0.0, 0.1, val.shape).astype(np.float32)
        elif k in ("scale", "var"):
            tree[k] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)


@pytest.fixture(scope="module")
def env():
    scenes = [make_scene(seed=i, **SCENE) for i in range(2)]
    batch_np = build_batch(scenes, BatchSpec(**SPEC))
    in_ch = batch_np["point_feats"].shape[-1] + 3
    variables = params.init_flax_variables(PointGroup(in_ch, **CFG), seed=0)
    _randomize(variables, np.random.default_rng(0))
    return dict(jmodel=JaxPointGroup(**CFG),
                jvars=jax.tree.map(jnp.asarray, variables),
                jbatch=jax.tree.map(jnp.asarray, batch_np),
                model=params.load_detector(variables, CFG, device="cpu"),
                batch=batch_to_torch(batch_np, "cpu"))


def _jax_stage(env, method, *args, static=()):
    """One jitted JAX stage; ``static`` are trailing python arguments."""
    fn = jax.jit(lambda v, *a: env["jmodel"].apply(v, *a, *static,
                                                   method=method))
    return fn(env["jvars"], *args)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_stage_backbone_and_heads(env):
    """JAX's voxel feats -> port U-Net; JAX's U-Net output -> port heads."""
    jb = env["jbatch"]
    m0 = jb["tables"][0]["mask"].shape[1]
    pf = jnp.concatenate([jb["point_feats"], jb["point_xyz"]], -1)
    vox = jax.vmap(voxelize_feats, in_axes=(0, 0, None, 0))(
        pf, jb["p2v"], m0, jb["point_mask"])
    vfeats = _jax_stage(env, JaxPointGroup.backbone, vox, jb["tables"],
                        static=(False,))
    sem, off = _jax_stage(env, JaxPointGroup.heads, vfeats,
                          jb["tables"][0]["mask"], static=(False,))
    model, b = env["model"], env["batch"]
    with torch.no_grad():
        tv = model.backbone(_t(vox), fold_tables(b["tables"]), False)
        tsem, toff = model.heads(_t(vfeats), b["tables"][0]["mask"], False)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vfeats), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tsem.numpy(), np.asarray(sem), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(toff.numpy(), np.asarray(off), rtol=1e-5,
                               atol=1e-5)


def test_stage_clustering(env):
    """JAX's voxel coords + given labels/offsets -> dual-pass clustering."""
    rng = np.random.default_rng(1)
    jb = env["jbatch"]
    b, m = jb["tables"][0]["mask"].shape
    vxyz = np.asarray(jax.vmap(voxelize_feats, in_axes=(0, 0, None, 0))(
        jb["point_xyz"], jb["p2v"], m, jb["point_mask"]))
    shift = rng.normal(0.0, 0.01, vxyz.shape).astype(np.float32)
    vxyz2 = np.stack([vxyz, vxyz + shift], axis=1)
    vsem = rng.integers(0, 4, size=(b, m)).astype(np.int32)
    vvalid = (np.asarray(jb["tables"][0]["mask"]) > 0) & (vsem > 0)
    vweight = rng.integers(1, 4, size=(b, m)).astype(np.float32)
    want = _jax_stage(env, JaxPointGroup._cluster_batch, jnp.asarray(vxyz2),
                      jnp.asarray(vsem), jnp.asarray(vvalid),
                      jnp.asarray(vweight))
    got = env["model"]._cluster_batch(_t(vxyz2), _t(vsem), _t(vvalid),
                                      _t(vweight))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[1]).sum() >= 4


def test_stage_stats_grids_scorenet(env):
    """GT-instance membership -> cluster stats -> 14^3 grids -> ScoreNet."""
    rng = np.random.default_rng(2)
    jb, jm, jv = env["jbatch"], env["jmodel"], env["jvars"]
    inst = np.asarray(jb["instance_ids"])
    member = np.stack([inst, np.where(inst >= 0, inst + 16, -1)], axis=1)
    member = jnp.asarray(member.astype(np.int32))
    pt_feats = jnp.asarray(rng.standard_normal(
        inst.shape + (CFG["m"],)).astype(np.float32))
    stats = jax.jit(jax.vmap(lambda mm, x, pm: jm.apply(
        jv, mm, x, pm, method=JaxPointGroup._cluster_stats)))(
            member, jb["point_xyz"], jb["point_mask"])
    p = 2 * CFG["clusters_per_pass"]
    jit = jnp.full((member.shape[0], p, 3), 0.5)
    grids, occ = jax.jit(jax.vmap(lambda mm, x, f, pm, st, u: jm.apply(
        jv, mm, x, f, pm, st, u, method=JaxPointGroup._build_grids)))(
            member, jb["point_xyz"], pt_feats, jb["point_mask"], stats, jit)
    model, b = env["model"], env["batch"]
    with torch.no_grad():
        tstats = model._cluster_stats(_t(member), b["point_xyz"],
                                      b["point_mask"])
        tgrids, tocc = model._build_grids(_t(member), b["point_xyz"],
                                          _t(pt_feats), b["point_mask"],
                                          tstats, _t(jit))
    for k in ("mean", "min", "max", "npoint", "center", "size"):
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(stats[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(occ))
    assert np.asarray(occ).sum() > 100
    np.testing.assert_allclose(tgrids.numpy(), np.asarray(grids), rtol=1e-5,
                               atol=1e-6)
    g = grids.shape[2]
    flat_g = np.array(grids).reshape(-1, g, g, g, grids.shape[-1])
    flat_o = np.array(occ).reshape(-1, g, g, g)
    ws, wp = jax.jit(lambda v, x, o: jm.apply(
        v, x, o, method=lambda mod, x, o: mod.score_net(x, o, False)))(
            jv, jnp.asarray(flat_g), jnp.asarray(flat_o))
    with torch.no_grad():
        ts, tp = model.score_net(_t(flat_g), _t(flat_o))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(wp), rtol=RTOL, atol=ATOL)
