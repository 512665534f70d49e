#!/usr/bin/env python3
"""Time the grouped dW kernel (``segment_matmul_dw``) of one or more
checkouts of ``het_tpu_torch`` on one NVIDIA GPU, in turns.

    python3 scripts/bench_dw.py [ROOT ...]

Each ROOT is a directory that holds ``het_tpu_torch`` (default: this
checkout); the turns (A, B, B, A), the timing and the table are
``bench_turns.py``'s.  The shapes are the dW launches of the training
paths in ``chip_smoke.py`` (row counts of the synthetic ogbn-mag at 0.1,
rank 0's shard in the data-parallel runs) over S = 4 segments of fixed
shares, and the general K = O = 64 shapes at S = 4 and 535.
"""

import sys

import bench_turns

# label, launches a step on its path, rows, S, H, Hx, K, O
SHAPES = [
    ("plain l0 attn, edge rows", 2, 2112384, 4, 4, 4, 16, 1),
    ("plain l1 attn, edge rows", 2, 2112384, 4, 4, 4, 2, 1),
    ("compact l0 attn_l, src rows", 1, 674176, 4, 4, 4, 16, 1),
    ("compact l0 attn_r, dst rows", 1, 622976, 4, 4, 4, 16, 1),
    ("compact l1 attn_l, src rows", 1, 674176, 4, 4, 4, 2, 1),
    ("compact l1 attn_r, dst rows", 1, 622976, 4, 4, 4, 2, 1),
    ("union l0 attn, union rows", 2, 746496, 4, 4, 4, 16, 1),
    ("union l1 attn, union rows", 2, 746496, 4, 4, 4, 2, 1),
    ("DP compact l0 src [W.a_l | W]", 1, 527360, 4, 4, 1, 64, 17),
    ("DP compact l1 src [W.a_l | W]", 1, 527360, 4, 4, 1, 64, 3),
    ("DP compact l0/l1 dst W.a_r", 2, 312064, 4, 4, 1, 64, 1),
    ("DP plain l0 edge W", 2, 1056896, 4, 4, 1, 64, 16),
    ("DP plain l1 edge W", 2, 1056896, 4, 4, 1, 64, 2),
    ("DP plain l0 attn", 2, 1056896, 4, 4, 4, 16, 1),
    ("DP plain l1 attn", 2, 1056896, 4, 4, 4, 2, 1),
    ("general S=4", 0, 1000192, 4, 1, 1, 64, 64),
    ("general S=535", 0, 1034496, 535, 1, 1, 64, 64),
    ("no rows (the fixed cost of a call)", 0, 0, 4, 4, 4, 2, 1),
]


def make(shape, dev, gen):
    """The dW call of one shape, on inputs made on the card."""
    import torch
    from het_tpu_torch.ops.kernels import segment_matmul_dw

    _, _, rows, S, H, Hx, K, O = shape
    seg = bench_turns.segments(rows, S, dev)
    x = torch.randn(rows, Hx * K, device=dev, generator=gen)
    ct = torch.randn(rows, H * O, device=dev, generator=gen)
    return lambda: segment_matmul_dw(x, ct, (S, H, K, O), seg)


if __name__ == "__main__":
    sys.exit(bench_turns.cli(__file__, SHAPES, make, "segment_mm"))
