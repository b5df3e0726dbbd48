"""The port's per-op profiler (``d3net_tpu_torch.scripts.profile_ops``) on
the CPU: the categorizer on a table of CUDA kernel and aten op names, the
summarizer on known rows and on a profile of a small port function, the
CLI's arguments against the JAX tool's, ``--cpu --what conv0`` end to end,
and the refusal to run without a GPU unless ``--cpu`` is given."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from d3net_tpu_torch.ops import segment, sparse_conv
from d3net_tpu_torch.scripts import profile_ops as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kernel, launching aten op, category): names as the card's profiler
# reports them (torch 2.11, H100), and the CPU's aten ops
NAMES = [
    ("void (anonymous namespace)::gather_rows_kernel<uint4>(uint4 const*, "
     "int const*, uint4*, long, long, int, int)", "", "gather"),
    ("void (anonymous namespace)::gather_rows_kernel<unsigned int>(unsigned "
     "int const*, int const*, unsigned int*, long, long, int, int)",
     "autograd::engine::evaluate_function: _SparseConvTBackward", "gather"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2>", "aten::index_select", "gather"),
    ("void at::native::index_elementwise_kernel<128, 4>", "aten::index",
     "gather"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>",
     "aten::gather", "gather"),
    ("void at::native::indexFuncLargeIndex<float, long, unsigned int, 1, 1, "
     "-2, true>", "aten::index_add_", "scatter"),
    ("void at::native::indexFuncLargeIndex<float, long, unsigned int, 1, 1, "
     "-2, true>", "", "scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>",
     "aten::scatter_add_", "scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>", "",
     "scatter"),
    ("nvjet_tst_32x512_64x3_1x2_h_bz_NNN", "aten::mm", "conv/matmul"),
    ("nvjet_tst_32x512_64x3_1x2_h_bz_NNN", "", "conv/matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "aten::addmm", "conv/matmul"),
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize256x32x32_stage4", "aten::cudnn_convolution", "conv/matmul"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_"
     "16x16_128x2_tn_align8>", "", "conv/matmul"),
    ("Memcpy HtoD (Pageable -> Device)", "aten::copy_", "copy/concat/slice"),
    ("Memset (Device)", "", "copy/concat/slice"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
     "unsigned int, 2, 128, 1>", "aten::cat", "copy/concat/slice"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda(at::TensorIteratorBase&)>", "", "copy/concat/slice"),
    ("void at::native::roll_cuda_kernel<int>(int const*, int*, long)",
     "aten::roll", "copy/concat/slice"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>", "aten::add_", "reduce/elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float>>>>",
     "aten::sum", "reduce/elementwise"),
    ("void at::native::elementwise_kernel<128, 4, at::native::BinaryFunctor"
     "<float, float, float, at::native::binary_internal::MulFunctor<float>>>",
     "", "reduce/elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>", "aten::fill_", "reduce/elementwise"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>",
     "aten::_softmax", "reduce/elementwise"),
    ("void cub::DeviceRadixSortOnesweepKernel<>", "aten::sort", "other"),
    ("void at::native::(anonymous namespace)::randperm_handle_duplicate_"
     "keys_kernel<int, unsigned long>", "aten::randperm", "other"),
    ("aten::index", "aten::index", "gather"),
    ("aten::index_add_", "aten::index_add_", "scatter"),
    ("aten::mm", "aten::mm", "conv/matmul"),
    ("aten::copy_", "aten::copy_", "copy/concat/slice"),
    ("aten::where", "aten::where", "reduce/elementwise"),
    ("aten::lt", "aten::lt", "reduce/elementwise"),
    ("aten::empty", "aten::empty", "other"),
]


@pytest.mark.parametrize("kernel,op,cat", NAMES)
def test_categorize(kernel, op, cat):
    assert P.categorize(kernel, op) == cat


def test_summarize_known_rows(capsys):
    rows = [{"name": "gather_rows_kernel<uint4>", "op": "", "ms": 3.0},
            {"name": "gemm_a", "op": "aten::mm", "ms": 2.5},
            {"name": "gather_rows_kernel<uint4>", "op": "", "ms": 1.0},
            {"name": "indexFuncLargeIndex", "op": "aten::index_add_",
             "ms": 0.5},
            {"name": "sortKernel", "op": "aten::sort", "ms": 0.25}]
    out = P.summarize(rows, top=2)
    assert out["total_ms"] == 7.25 and out["events"] == 5
    assert out["categories"] == {
        "gather": 4.0, "scatter": 0.5, "conv/matmul": 2.5,
        "copy/concat/slice": 0.0, "reduce/elementwise": 0.0, "other": 0.25}
    assert out["top"] == [["gather_rows_kernel<uint4>", 4.0, 2],
                          ["gemm_a", 2.5, 1]]
    text = capsys.readouterr().out
    assert "== device time: 7.2 ms over 5 events ==" in text
    assert "== top 2 ops ==" in text
    assert all(c in text for c in P.CATEGORIES)


def test_summarize_a_profile_of_port_ops(capsys):
    """A sparse conv and a row gather to points through the port's ops on
    the CPU, profiled: the plain gathers count as gather, the product as
    conv/matmul, and the categories add up to the total."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    nbr = torch.from_numpy(rng.integers(0, 301, (300, 27)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((27, 8, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 300, 500).astype(np.int32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = sparse_conv.sparse_conv(feats, nbr, w)
        (out.sum() + segment.gather_padded(out, idx).sum()).item()
    rows = P.profile_rows(prof, torch.device("cpu"))
    assert rows and all(r["name"].startswith("aten::") for r in rows)
    res = P.summarize(rows, top=5, label="host op")
    assert set(res["categories"]) == set(P.CATEGORIES)
    assert res["categories"]["gather"] > 0
    assert res["categories"]["conv/matmul"] > 0
    assert np.isclose(sum(res["categories"].values()), res["total_ms"])
    assert res["events"] == len(rows)
    tops = [t[1] for t in res["top"]]
    assert tops == sorted(tops, reverse=True) and len(tops) <= 5
    assert "== host op time:" in capsys.readouterr().out


def _jax_tool():
    """The JAX tool's arguments ({flag: {default, choices}}) and category
    names, read from its source (importing it would set up a TPU
    runtime)."""
    with open(os.path.join(ROOT, "scripts", "profile_ops.py")) as f:
        tree = ast.parse(f.read())
    args, cats = {}, None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            args[node.args[0].value] = {
                k.arg: ast.literal_eval(k.value) for k in node.keywords
                if k.arg in ("default", "choices")}
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_CATS"):
            cats = [e.elts[0].value for e in node.value.elts]
    return args, cats


def test_arguments_and_categories_match_the_jax_tool(monkeypatch):
    import argparse

    jax_args, jax_cats = _jax_tool()
    args = {}

    def capture(parser, argv=None, namespace=None):
        for a in parser._actions:
            if a.option_strings and a.dest != "help":
                args[a.option_strings[0]] = {"default": a.default, **(
                    {"choices": a.choices} if a.choices else {})}
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        P.main([])
    assert args.pop("--cpu") == {"default": False}
    assert args == jax_args
    assert list(P.CATEGORIES) == jax_cats + ["other"]


def test_cli_conv0_on_cpu(tmp_path, capsys):
    res = P.main(["--cpu", "--what", "conv0", "--top", "5", "--logdir",
                  str(tmp_path)])
    text = capsys.readouterr().out
    assert "conv: colres asked for; the port runs it as the gather layout" \
        in text
    assert "first call:" in text and "second call wall:" in text
    assert "gather_rows launches: 0 in 3 call(s)" in text
    assert res["calls"] == 3 and res["gather_launches"] == 0
    assert res["categories"]["gather"] > 0
    assert res["categories"]["conv/matmul"] > 0
    assert res["first_s"] > 0 and res["second_s"] > 0
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cli_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.main(["--what", "conv0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        P.profile("fwd")
