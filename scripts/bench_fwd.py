#!/usr/bin/env python3
"""Time the segment-matmul forward kernel (``segment_matmul_fwd``) of one
or more checkouts of ``het_tpu_torch`` on one NVIDIA GPU, in turns.

    python3 scripts/bench_fwd.py [ROOT ...]

Each ROOT is a directory that holds ``het_tpu_torch`` (default: this
checkout); the turns (A, B, B, A), the timing and the table are
``bench_turns.py``'s.  The shapes are the forward launches that the
data-parallel runs of ``chip_smoke.py`` give rank 0's shard (synthetic
ogbn-mag at 0.1) over S = 4 segments of fixed shares, offsets on the
device only as on a shard, and the general K = O = 64 shapes at S = 4 and
535 (W 8.8 MB).
"""

import sys

import bench_turns

# label, launches a step on its path, rows, S, H, Hx, K, O
SHAPES = [
    ("DP compact l0 src [W.a_l | W]", 1, 527360, 4, 4, 1, 64, 17),
    ("DP compact l1 src [W.a_l | W]", 1, 527360, 4, 4, 1, 64, 3),
    ("DP compact l0/l1 dst W.a_r", 2, 312064, 4, 4, 1, 64, 1),
    ("DP plain l0 edge W", 2, 1056896, 4, 4, 1, 64, 16),
    ("DP plain l1 edge W", 2, 1056896, 4, 4, 1, 64, 2),
    ("general S=4", 0, 1000192, 4, 1, 1, 64, 64),
    ("general S=535", 0, 1034496, 535, 1, 1, 64, 64),
    ("one tile (the fixed cost of a call)", 0, 64, 4, 4, 1, 64, 1),
]


def make(shape, dev, gen):
    """The forward call of one shape, on inputs made on the card."""
    import math

    import torch
    from het_tpu_torch.ops.kernels import segment_matmul_fwd

    _, _, rows, S, H, Hx, K, O = shape
    seg = bench_turns.segments(rows, S, dev)
    x = torch.randn(rows, Hx * K, device=dev, generator=gen)
    w = torch.randn(S, H, K, O, device=dev, generator=gen) / math.sqrt(K)
    return lambda: segment_matmul_fwd(x, w, seg)


if __name__ == "__main__":
    sys.exit(bench_turns.cli(__file__, SHAPES, make, "segment_mm"))
