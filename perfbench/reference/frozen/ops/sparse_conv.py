"""Sparse 3D convolution as a neighbor-table gather plus one matmul.

Counterpart of ``d3net_tpu/ops/sparse_conv.py``:

    out[i] = sum_k feats[nbr[i, k]] @ W[k]
           = reshape(gather(feats, nbr), (M, K*Cin)) @ reshape(W, (K*Cin, Cout))

The gather is the ``gather_rows`` kernel (INVALID entries read its zero
row, so no padded copy of ``feats`` is made); the product is one
``torch.matmul``, accumulated in f32 by cuBLAS and returned in the
activation dtype, as the JAX package leaves it to XLA. The whole batch is
one flat row domain (``fold_index``), so each conv is one gather launch.
The gathered operand is not chunked: at the flagship width the largest,
the input conv's, is 4*131072 x 27*134 bf16 = 3.8 GB, which the card holds.

``sparse_conv_t`` is the counterpart of the JAX ``sparse_conv_t`` custom
VJP: its backward routes ``dx`` through the transpose gather table and
re-gathers the inputs for ``dW``, so the only tensors saved for the
backward are ``feats``, the two tables and the weight — never the
gathered ``(M, K*Cin)`` operand.
"""

from __future__ import annotations

import torch

from perfbench.reference.frozen.kernels import gather
from perfbench.reference.precision import q


def _check(feats, nbr, weight):
    k, cin, _ = weight.shape
    if nbr.shape[1] != k or feats.shape[1] != cin:
        raise ValueError(
            f"sparse_conv: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}"
            f", weight {tuple(weight.shape)} disagree")


def _gathered(feats: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """``(M_out, K*Cin)`` operand rows; INVALID reads zeros."""
    rows = gather.gather_rows(feats.contiguous(),
                              nbr.reshape(-1).to(torch.int32).contiguous())
    return rows.reshape(nbr.shape[0], -1)


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """feats (M_in, Cin); nbr (M_out, K) int32 with INVALID == M_in;
    weight (K, Cin, Cout) -> (M_out, Cout) in ``feats.dtype``."""
    _check(feats, nbr, weight)
    k, cin, cout = weight.shape
    wflat = weight.reshape(k * cin, cout).to(feats.dtype)
    return q(torch.matmul(q(_gathered(feats, nbr)), q(wflat)))


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32 (JAX's
    ``preferred_element_type=float32``): a bf16-output product would round
    a sum over every row of the level, and cuBLAS may reduce bf16 splits
    in bf16."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _SparseConvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, nbr, nbr_t, weight, flip_t):
        ctx.save_for_backward(feats, nbr, nbr_t, weight)
        ctx.flip_t = flip_t
        return sparse_conv(feats, nbr, weight)

    @staticmethod
    def backward(ctx, g):
        feats, nbr, nbr_t, weight = ctx.saved_tensors
        g = g.contiguous()
        dfeats = dweight = None
        if ctx.needs_input_grad[0]:
            wt = weight.flip(0) if ctx.flip_t else weight
            dfeats = sparse_conv(g, nbr_t, wt.transpose(1, 2))
        if ctx.needs_input_grad[3]:
            dweight = _mm_f32(q(_gathered(feats, nbr)).t(), q(g))
            dweight = dweight.reshape(weight.shape).to(weight.dtype)
        return dfeats, None, None, dweight, None


def sparse_conv_t(feats: torch.Tensor, nbr: torch.Tensor,
                  nbr_t: torch.Tensor, weight: torch.Tensor,
                  flip_t: bool = False) -> torch.Tensor:
    """``sparse_conv`` with the gather-only backward of the JAX package.

    ``nbr_t (M_in, K)`` is the transpose table (INVALID == M_out):
    submanifold convs pass ``nbr`` itself with ``flip_t=True`` (kernel
    mirrored, ``W[::-1]^T``); the stride-2 down conv passes the sibling
    ``up`` table and the up conv the ``down`` table, with ``flip_t=False``
    (``W^T``). ``dW = gather(feats, nbr)^T @ g`` in f32, returned in the
    weight's dtype; ``dx`` is skipped when ``feats`` needs no gradient.
    """
    if nbr_t.shape != (feats.shape[0], nbr.shape[1]):
        raise ValueError(
            f"sparse_conv_t: nbr_t {tuple(nbr_t.shape)} is not the transpose "
            f"of nbr {tuple(nbr.shape)} over {feats.shape[0]} input rows")
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weight.requires_grad):
        return _SparseConvT.apply(feats, nbr, nbr_t, weight, flip_t)
    return sparse_conv(feats, nbr, weight)
