"""Operations the detector's step needs, counted from its shapes.

Rules (the yardstick, never taken from the port's code):

- a sparse convolution counts ``2 * pairs * Cin * Cout``, ``pairs`` the
  valid (site, offset) entries of the table it runs over;
- ScoreNet's dense 3D convolutions and the dense heads count at their
  dense shapes (every cluster slot's grid, as the step runs them);
- a trained product counts three times its forward (forward, input
  gradient, weight gradient), the input conv twice (its input needs no
  gradient); a product run without a gradient counts once.

Element-wise work, reductions, clustering and the gathers count nothing
here: the gathers have a byte count of their own (``work/gather.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def level_counts(tables: List[Dict[str, "torch.Tensor"]]) -> List[Dict[str, int]]:
    """Valid entries of a collated batch's per-level tables (the program's
    layout: ``nbr (B, M_l, 27)``, ``down (B, M_{l+1}, 8)``, ``up (B, M_l,
    8)``, ``mask (B, M_l)``, INVALID the target level's cap), read once
    from the device: ``[{voxels, nbr, rows, down, up}]`` per level
    (``rows`` the padded rows, valid or not)."""
    import torch

    parts = []
    for li, t in enumerate(tables):
        m = t["mask"].shape[1]
        row = [t["mask"].bool().sum(), ((t["nbr"] >= 0) & (t["nbr"] < m)).sum(),
               torch.tensor(t["mask"].numel(), device=t["mask"].device)]
        if "down" in t:
            m_next = tables[li + 1]["mask"].shape[1]
            row += [((t["down"] >= 0) & (t["down"] < m)).sum(),
                    ((t["up"] >= 0) & (t["up"] < m_next)).sum()]
        else:
            row += [torch.zeros((), device=t["mask"].device, dtype=torch.long)] * 2
        parts.append(torch.stack([r.long() for r in row]))
    vals = torch.stack(parts).tolist()
    return [dict(zip(("voxels", "nbr", "rows", "down", "up"), v))
            for v in vals]


def unet_flops(counts: List[Dict[str, int]], in_channels: int, m: int,
               blocks: Sequence[int], block_reps: int, classes: int,
               train: bool) -> float:
    """The sparse U-Net's convolutions (input conv, residual blocks, the
    stride-2 pair and the tails' 1x1 projections) plus the dense heads
    over every padded voxel row."""
    planes = [m * c for c in blocks]
    t = 3.0 if train else 1.0
    fl = 2.0 * counts[0]["nbr"] * in_channels * m * (2.0 if train else 1.0)
    for li, p in enumerate(planes):
        c = counts[li]
        # block_reps residual blocks of two p x p convs each
        fl += t * block_reps * 2 * 2.0 * c["nbr"] * p * p
        if li + 1 < len(planes):
            q = planes[li + 1]
            fl += t * 2.0 * c["down"] * p * q        # down conv, 8 taps
            fl += t * 2.0 * c["up"] * q * p          # up conv, 8 taps
            # tail 0: (2p -> p) and (p -> p) convs, 1x1 projection 2p -> p
            fl += t * 2.0 * c["nbr"] * (2 * p * p + p * p)
            fl += t * 2.0 * c["voxels"] * 2 * p * p
            # the other tails: two p x p convs each
            fl += t * (block_reps - 1) * 2 * 2.0 * c["nbr"] * p * p
    fl += t * 2.0 * counts[0]["rows"] * (m * classes + m * m + m * 3)
    return fl


def _conv(g: int, cin: int, cout: int, k: int) -> float:
    """A same-padded dense k^3 conv on a g^3 grid."""
    return 2.0 * g ** 3 * k ** 3 * cin * cout


def scorenet_flops(grids: int, g: int, m: int, cluster_blocks: Sequence[int],
                   block_reps: int, train: bool) -> float:
    """ScoreNet's GridUNet over ``grids`` dense ``g^3`` grids of ``m``
    channels, at its dense shapes (odd extents pad one ghost cell before
    the stride-2 conv, as the program does)."""
    planes = [m * c for c in cluster_blocks]

    def unet(cin: int, level: int, g: int) -> float:
        p = planes[level]
        fl = 0.0
        for i in range(block_reps):
            ci = cin if i == 0 else p
            fl += _conv(g, ci, p, 3) + _conv(g, p, p, 3)
            if ci != p:
                fl += _conv(g, ci, p, 1)
        if level + 1 < len(planes) and g >= 2:
            q = planes[level + 1]
            gh = (g + 1) // 2
            fl += 2.0 * gh ** 3 * 8 * p * q          # stride-2 conv
            fl += unet(q, level + 1, gh)
            fl += 2.0 * gh ** 3 * 8 * q * p          # transposed conv
            for i in range(block_reps):
                ci = 2 * p if i == 0 else p
                fl += _conv(g, ci, p, 3) + _conv(g, p, p, 3)
                if ci != p:
                    fl += _conv(g, ci, p, 1)
        return fl

    fl = unet(m, 0, g) + 2.0 * planes[0]          # + the score Dense
    return grids * fl * (3.0 if train else 1.0)


def detector_step_flops(counts: List[Dict[str, int]], model: Dict,
                        in_channels: int, batch: int,
                        train: bool = True) -> float:
    """One detector step (forward, and backward with ``train``) on a
    batch whose table counts are ``counts``; ``model`` the config's
    ``model``/``tpu``/``train`` keys merged."""
    fl = unet_flops(counts, in_channels, model["m"], model["blocks"],
                    model["block_reps"], model["classes"], train)
    grids = batch * 2 * model["clusters_per_pass"]
    fl += scorenet_flops(grids, model["score_fullscale"], model["m"],
                         model["cluster_blocks"], model["block_reps"], train)
    return fl
