"""The four model-running tools over a process group against world size 1,
on the CPU: ``benchmark_captioning``, ``benchmark_grounding``,
``visualize_captioning`` and ``visualize_grounding`` on a run dir of seeded
weights at conf/debug/tiny_joint.yaml's widths (``checks.seeded_run_dir``,
B=2), each at world 1 in this process and all four in one spawn of 2 gloo
ranks of one torch thread each (``checks.tools_world_vs_one``).

The val split is 5 scenes: two batches of 2, one scene a rank, and a short
last batch of 1, which rank 0 runs alone. The visualize tools dump the
first 3 scenes: the third is rank 0's row of the second batch, so rank 1
writes one scene and rank 0 two. Every file the tools write (the
submission JSONs, each dumped scene's PLYs and txt files) is byte-equal
at world 2 and world 1, which holds the JSONs' scene order too; the
visualize tools wrote exactly the first 3 val scenes.
"""

import json

import pytest
import torch
from threadpoolctl import threadpool_limits

from d3net_tpu_torch import checks
from d3net_tpu_torch.parallel import mesh

TINY_JOINT = "conf/debug/tiny_joint.yaml"
VAL_SCENES = 5
SHOWN = 3
TOOLS = ("benchmark_captioning", "benchmark_grounding",
         "visualize_captioning", "visualize_grounding")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch, OpenMP and BLAS thread in this process, as in each rank:
    the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The four tools at world 1 and in one 2-rank spawn."""
    run = str(tmp_path_factory.mktemp("tools") / "run")
    checks.seeded_run_dir(TINY_JOINT, run, seed=13)
    runs = [(tool, run, VAL_SCENES, False) if tool.startswith("benchmark")
            else (tool, run, VAL_SCENES, False, {"scenes": SHOWN})
            for tool in TOOLS]
    one = [checks.rank_calls(checks.tool_calls([r]))[0] for r in runs]
    res = checks.tools_world_vs_one(runs, world=2, one=one, threads=1)
    return res, dict(zip(TOOLS, one))


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_world2_files_equal_world1(report, tool):
    res, one = report
    rec = res["tools"][TOOLS.index(tool)]
    assert rec["mismatches"] == []
    assert rec["files"] > 0
    # batches [2, 2, 1]: rank 1 has no row of the last, and the dumps of
    # the first 3 scenes end with the second batch
    assert rec["val_batches_per_rank"] == (
        [3, 2] if tool.startswith("benchmark") else [2, 2])
    files = one[tool]["files"]
    if tool == "benchmark_captioning":
        scenes = list(json.loads(files["benchmark_captioning.json"]))
        assert scenes == [f"synthetic_{10_000 + i}" for i in range(5)]
    elif tool == "benchmark_grounding":
        entries = json.loads(files["benchmark_grounding.json"])
        order = [e["scene_id"] for e in entries]
        assert order == sorted(order) and len(set(order)) == VAL_SCENES
    else:
        dumped = {path.split("/")[1] for path in files}
        assert dumped == {f"synthetic_{10_000 + i}" for i in range(SHOWN)}
        assert any(p.endswith(".ply") for p in files)


def test_gather_ordered_without_a_group_keeps_the_global_order():
    pairs = [(2, "c"), (0, "a"), (2, "d"), (1, "b")]
    assert mesh.gather_ordered(pairs) == ["a", "b", "c", "d"]
    assert mesh.merge_ordered([[(0, "r0"), (2, "r0b")], [(1, "r1")]]) \
        == ["r0", "r1", "r0b"]
