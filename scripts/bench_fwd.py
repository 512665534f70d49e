#!/usr/bin/env python3
"""Time the segment-matmul forward and dX kernels (``segment_matmul_fwd``,
``segment_matmul_dx``) of one or more checkouts of ``het_tpu_torch`` on one
NVIDIA GPU, in turns.

    python3 scripts/bench_fwd.py [ROOT ...]

Each ROOT is a directory that holds ``het_tpu_torch`` (default: this
checkout); the turns (A, B, B, A), the timing and the table are
``bench_turns.py``'s.  The shapes are the forward and dX launches that the
data-parallel runs of ``chip_smoke.py`` give rank 0's shard (synthetic
ogbn-mag at 0.1) over S = 4 segments of fixed shares, offsets on the
device only as on a shard, the general K = O = 64 shapes at S = 4 and 535
(W 8.8 MB), and a call of one tile.  A dX shape's label starts with "dX";
its H*O columns of ct meet dx's Hx*K.  The last shape is no kernel of the
port: ``Tensor.zero_`` of the DP plain layer-1 dX's output, the rate at
which PyTorch's own fill writes the card's memory, beside the dX whose
bytes are nearly all that write.
"""

import sys

import bench_turns

# label, launches a step on its path, rows, S, H, Hx, K, O
FWD_SHAPES = [
    ("DP compact l0 src [W.a_l | W]", 1, 527360, 4, 4, 1, 64, 17),
    ("DP compact l1 src [W.a_l | W]", 1, 527360, 4, 4, 1, 64, 3),
    ("DP compact l0/l1 dst W.a_r", 2, 312064, 4, 4, 1, 64, 1),
    ("DP plain l0 edge W", 2, 1056896, 4, 4, 1, 64, 16),
    ("DP plain l1 edge W", 2, 1056896, 4, 4, 1, 64, 2),
    ("general S=4", 0, 1000192, 4, 1, 1, 64, 64),
    ("general S=535", 0, 1034496, 535, 1, 1, 64, 64),
    ("one tile (the fixed cost of a call)", 0, 64, 4, 4, 1, 64, 1),
]
DX_SHAPES = [
    ("dX DP compact l1 src [W.a_l | W]", 1, 527360, 4, 4, 1, 64, 3),
    ("dX DP compact l1 dst W.a_r", 1, 312064, 4, 4, 1, 64, 1),
    ("dX DP plain l1 edge W", 2, 1056896, 4, 4, 1, 64, 2),
    ("dX general S=4", 0, 1000192, 4, 1, 1, 64, 64),
    ("dX general S=535", 0, 1034496, 535, 1, 1, 64, 64),
    ("dX one tile (the fixed cost of a call)", 0, 64, 4, 4, 1, 64, 1),
]
# (rows, K): zero_() of an (rows, K) f32 tensor, written once (bound: its
# bytes; the shape's H = O = 0)
FILL_SHAPES = [
    ("zero_ of the DP plain l1 dX output (no kernel of the port)", 0,
     1056896, 1, 0, 1, 64, 0),
]
SHAPES = FWD_SHAPES + DX_SHAPES + FILL_SHAPES


def make(shape, dev, gen):
    """The forward or dX call of one shape, on inputs made on the card."""
    import math

    import torch
    from het_tpu_torch.ops.kernels import (segment_matmul_dx,
                                           segment_matmul_fwd)

    _, _, rows, S, H, Hx, K, O = shape
    if shape in FILL_SHAPES:
        out = torch.empty(rows, Hx * K, device=dev)
        return out.zero_
    seg = bench_turns.segments(rows, S, dev)
    w = torch.randn(S, H, K, O, device=dev, generator=gen) / math.sqrt(K)
    if shape in DX_SHAPES:
        ct = torch.randn(rows, H * O, device=dev, generator=gen)
        return lambda: segment_matmul_dx(ct, w, seg, Hx)
    x = torch.randn(rows, Hx * K, device=dev, generator=gen)
    return lambda: segment_matmul_fwd(x, w, seg)


if __name__ == "__main__":
    sys.exit(bench_turns.cli(__file__, SHAPES, make, "segment_mm"))
