"""``d3net_tpu_torch/parallel/mesh.py`` against ``d3net_tpu/parallel/
mesh.py``: the usable world size clamps as JAX's ``make_mesh`` does (and
warns), a rank's rows of the global batch, ``replicate`` and the two ways
into a group (``spawn``'s file rendezvous, ``init_multihost`` under a
launcher's environment), on gloo processes."""

import socket
import warnings

import jax
import numpy as np
import pytest
import torch

from d3net_tpu.parallel.mesh import make_mesh as jax_make_mesh
from d3net_tpu_torch import checks
from d3net_tpu_torch.data.collate import BatchSpec, build_batch
from d3net_tpu_torch.data.synthetic import make_scene
from d3net_tpu_torch.parallel import mesh


@pytest.mark.parametrize("batch_size", range(1, 9))
def test_usable_world_is_jax_mesh_size(batch_size):
    devices = jax.devices()
    assert len(devices) == 8
    want = jax_make_mesh(devices, batch_size=batch_size).devices.size
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = mesh.make_mesh(batch_size, device_count=8)
    assert got == want
    idle = [str(w.message) for w in caught]
    if got < 8:
        assert len(idle) == 1 and f"training on {got}" in idle[0]
        assert f"cuda:{got}" in idle[0] and "cuda:7" in idle[0]
    else:
        assert idle == []


def test_shard_batch_rows_concatenate_to_the_global_batch():
    scenes = [make_scene(seed=i, **checks.DP_SCENE) for i in range(4)]
    batch = build_batch(scenes, BatchSpec(**checks.DP_SPEC))
    for world in (1, 2, 4):
        parts = [mesh.shard_batch(batch, r, world) for r in range(world)]
        for k, v in batch.items():
            if k == "tables":
                for li, level in enumerate(v):
                    for tk, tv in level.items():
                        np.testing.assert_array_equal(np.concatenate(
                            [p[k][li][tk] for p in parts]), tv)
            else:
                np.testing.assert_array_equal(
                    np.concatenate([p[k] for p in parts]), v, err_msg=k)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 3)


@pytest.fixture(scope="module")
def ranks():
    return mesh.spawn(checks.mesh_rank, 2, 3, threads=1)


def test_replicate_gives_every_rank_rank0s_params_and_adam_state(ranks):
    r0, r1 = ranks
    assert (r0["rank"], r1["rank"], r0["world"], r1["world"]) == (0, 1, 2, 2)
    for k, v in r0["model"].items():
        np.testing.assert_array_equal(r1["model"][k], v, err_msg=k)
    for a, b in zip(r0["adam"], r1["adam"]):
        assert set(a) == set(b) == {"step", "exp_avg", "exp_avg_sq"}
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    torch.manual_seed(2)     # rank 1's own draw differed before replicate
    assert not np.array_equal(torch.nn.Linear(3, 2).weight.detach().numpy(),
                              r0["model"]["weight"])


def test_launcher_world_that_does_not_split_the_batch_raises(ranks):
    for r in ranks:
        assert "batch_size 3 does not split over the launcher's 2 ranks" \
            in r["error"]


def test_init_multihost_is_a_no_op_without_a_launcher(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    info = mesh.init_multihost()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert not mesh.active() and mesh.world() == 1 and mesh.is_main()


def test_init_multihost_joins_a_launcher_group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(checks.launcher_rank, args=(2, port),
                                nprocs=2, join=True)


def test_local_suspends_the_group_for_the_block():
    """``local()`` is what rank 0's validation runs under: no collective,
    world 1, while the process stays rank 0 of its group."""
    with mesh.local():
        assert not mesh.active() and mesh.world() == 1 and mesh.rank() == 0
    x = torch.arange(4.0)
    assert mesh.all_reduce_sum(x) is x
    assert mesh.local_rows(x, 2) is x
    assert torch.equal(mesh.roll_rows(x), torch.roll(x, 1, 0))


def test_a_failed_rank_brings_the_others_down_with_its_error():
    """Rank 1 raises while rank 0 waits in an all-reduce: the spawn ends
    (rank 0 is stopped by its peer's closed connection) and reports rank
    1's error first."""
    with pytest.raises(RuntimeError, match="(?s)ranks failed:\n"
                       "rank 1: .*rank 1 failed before its all-reduce"):
        mesh.spawn(checks.failing_rank, 2, threads=1, timeout_s=120)


def test_a_ranks_batch_rows_equal_the_global_batchs():
    """``BatchIterator`` at rank r of 2 (every scene augmented, elastic on,
    its rows collated) builds byte for byte rows [r·B/2, (r+1)·B/2) of the
    batch world size 1 builds, and returns the global batch's scenes."""
    from d3net_tpu_torch.data.dataset import BatchIterator
    from d3net_tpu_torch.scripts.train import load_task_config
    from d3net_tpu_torch.train.loop import scenes_from_cfg, spec_from_cfg

    cfg = load_task_config("conf/debug/tiny_pointgroup.yaml")
    spec = spec_from_cfg(cfg)
    scenes = scenes_from_cfg(cfg, "train", 4)

    def build(rank, world):
        it = BatchIterator(scenes, spec, 4, elastic=True, seed=3,
                           return_scenes=True, rank=rank, world=world)
        return it._build_one(it._order(), 0)

    whole, whole_scenes = build(0, 1)
    for r in range(2):
        part, part_scenes = build(r, 2)
        want = mesh.shard_batch(whole, r, 2)
        for k, v in want.items():
            if k == "tables":
                for li, level in enumerate(v):
                    for tk, tv in level.items():
                        np.testing.assert_array_equal(part[k][li][tk], tv)
            else:
                np.testing.assert_array_equal(part[k], v, err_msg=k)
        assert [s.xyz.tobytes() for s in part_scenes] == [
            s.xyz.tobytes() for s in whole_scenes]
    with pytest.raises(ValueError, match="does not split"):
        BatchIterator(scenes, spec, 4, world=3)
