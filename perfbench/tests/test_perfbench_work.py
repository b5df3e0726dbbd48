"""The yardstick's operation and byte counts against hand counts."""

import torch

from perfbench.work import detector as work
from perfbench.work import gather as gwork


def test_scorenet_flops_by_hand():
    # one 2^3 grid, m = 1, planes (1, 2), one block a level
    g, m = 2, 1
    conv = lambda c_in, c_out, k: 2 * g ** 3 * k ** 3 * c_in * c_out  # noqa: E731
    lvl0 = conv(1, 1, 3) + conv(1, 1, 3)
    down = 2 * 1 * 8 * 1 * 2            # gh = 1: 1 cell, 8 taps, 1 -> 2
    lvl1 = 2 * (2 * 1 * 27 * 2 * 2)     # its input has 2 channels: two 2 -> 2
    up = 2 * 1 * 8 * 2 * 1
    tail = conv(2, 1, 3) + conv(1, 1, 3) + conv(2, 1, 1)
    want = lvl0 + down + lvl1 + up + tail + 2 * 1
    got = work.scorenet_flops(1, g, m, (1, 2), 1, train=False)
    assert got == want
    assert work.scorenet_flops(3, g, m, (1, 2), 1, train=True) == 9 * want


def test_unet_flops_by_hand():
    counts = [{"voxels": 5, "nbr": 40, "rows": 8, "down": 6, "up": 5},
              {"voxels": 2, "nbr": 10, "rows": 4, "down": 0, "up": 0}]
    m, cin, cls = 2, 3, 4
    p0, p1 = 2, 4
    fwd = (2 * 40 * cin * m                         # input conv
           + 2 * 2 * 40 * p0 * p0                   # level 0 block
           + 2 * 6 * p0 * p1 + 2 * 5 * p1 * p0      # down, up
           + 2 * 40 * (2 * p0 * p0 + p0 * p0) + 2 * 5 * 2 * p0 * p0  # tail
           + 2 * 2 * 10 * p1 * p1                   # level 1 block
           + 2 * 8 * (m * cls + m * m + m * 3))     # heads, padded rows
    got = work.unet_flops(counts, cin, m, (1, 2), 1, cls, train=False)
    assert got == fwd
    train = work.unet_flops(counts, cin, m, (1, 2), 1, cls, train=True)
    assert train == 3 * fwd - 2 * 40 * cin * m


def test_level_counts_reads_valid_entries():
    t0 = {"mask": torch.tensor([[1, 1, 0]]),
          "nbr": torch.tensor([[[0, 3], [1, 2], [3, 3]]]),
          "down": torch.tensor([[[0, 3], [3, 3]]]),
          "up": torch.tensor([[[0, 2], [1, 2], [2, 2]]])}
    t1 = {"mask": torch.tensor([[1, 0]]),
          "nbr": torch.tensor([[[0, 2], [2, 2]]])}
    got = work.level_counts([t0, t1])
    assert got[0] == {"voxels": 2, "nbr": 3, "rows": 3, "down": 1, "up": 2}
    assert got[1] == {"voxels": 1, "nbr": 1, "rows": 2, "down": 0, "up": 0}


def test_gather_bytes_read_each_source_row_once():
    class Mod:
        @staticmethod
        def gather_rows(src, idx):
            return src[idx.clamp(0, src.shape[0] - 1).long()]

    Mod.gather_rows.launches = 0
    calls = []
    src = torch.zeros(10, 4)
    idx = torch.tensor([1, 1, 1, 2, 10, -1], dtype=torch.int32)
    with gwork.recording(Mod, calls):
        Mod.gather_rows(src, idx)
    assert calls == [(6, 2, 16)]
    assert gwork.gather_bytes(*calls[0]) == 6 * 16 + 2 * 16 + 6 * 4
