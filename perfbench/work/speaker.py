"""Operations the speaker's eval forward needs: the relational graph over
each scene's proposals and the greedy decode of every proposal, counted
at their dense shapes (every proposal slot, every pair the graph forms,
every decode step; the rules of ``work/detector.py``).

The widths are D3Net's captioner's: 300-wide word embeddings (GloVe),
a 512-wide hidden state, 128-wide graph features.
"""

from __future__ import annotations

EMB, HIDDEN, FEAT = 300, 512, 128


def graph_flops(batch: int, props: int, in_size: int, layers: int,
                locals_: int, orientation: bool, bins: int = 6,
                out: int = FEAT) -> float:
    pairs = batch * props * props
    fl = 2.0 * batch * props * in_size * out               # map_input
    edge = 2.0 * (2 * out) * out + 2.0 * out * out           # EdgeMLP a pair
    fl += layers * (pairs * edge + 2.0 * pairs * out)        # + the einsum
    if orientation:
        kept = batch * props * locals_
        fl += kept * (edge + 2.0 * out * (bins + 1))
    return fl


def decode_flops(rows: int, props: int, vocab: int, steps: int) -> float:
    """``steps`` greedy steps over ``rows`` decoder rows, each attending
    over ``props`` proposals."""
    e, h, f = EMB, HIDDEN, FEAT
    gru = 2.0 * e * 3 * h + 2.0 * h * 3 * h
    step = (2.0 * (e + h + f) * e + gru + 2.0 * h * h + 2.0 * props * h
            + 2.0 * props * f + 2.0 * (f + h) * e + gru + 2.0 * h * h
            + 2.0 * h * vocab)
    return rows * (steps * step + 2.0 * props * f * h)      # + map_feat once
