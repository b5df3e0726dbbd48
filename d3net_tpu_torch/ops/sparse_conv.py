"""Sparse 3D convolution as a neighbor-table gather plus one matmul.

Counterpart of the forward of ``d3net_tpu/ops/sparse_conv.py``:

    out[i] = sum_k feats[nbr[i, k]] @ W[k]
           = reshape(gather(feats, nbr), (M, K*Cin)) @ reshape(W, (K*Cin, Cout))

The gather is the ``gather_rows`` kernel (INVALID entries read its zero
row, so no padded copy of ``feats`` is made); the product is one
``torch.matmul``, accumulated in f32 by cuBLAS and returned in the
activation dtype, as the JAX package leaves it to XLA. The whole batch is
one flat row domain (``fold_index``), so each conv is one gather launch.
The gathered operand is not chunked: at the flagship width the largest,
the input conv's, is 4*131072 x 27*134 bf16 = 3.8 GB, which the card holds.
"""

from __future__ import annotations

import torch

from d3net_tpu_torch.kernels import gather


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """feats (M_in, Cin); nbr (M_out, K) int32 with INVALID == M_in;
    weight (K, Cin, Cout) -> (M_out, Cout) in ``feats.dtype``."""
    k, cin, cout = weight.shape
    m_out = nbr.shape[0]
    if nbr.shape[1] != k or feats.shape[1] != cin:
        raise ValueError(
            f"sparse_conv: feats {tuple(feats.shape)}, nbr {tuple(nbr.shape)}"
            f", weight {tuple(weight.shape)} disagree")
    rows = gather.gather_rows(feats.contiguous(),
                              nbr.reshape(-1).to(torch.int32).contiguous())
    wflat = weight.reshape(k * cin, cout).to(feats.dtype)
    return torch.matmul(rows.reshape(m_out, k * cin), wflat)
