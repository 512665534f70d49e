#!/usr/bin/env python3
"""Time the grouped dW kernel (``segment_matmul_dw``) of one or more
checkouts of ``het_tpu_torch`` on one NVIDIA GPU, in turns.

    python3 scripts/bench_dw.py [ROOT ...]

Each ROOT is a directory that holds ``het_tpu_torch`` (default: this
checkout).  The roots run in the order given and then in reverse (A, B,
B, A), each turn in a process of its own, so two versions of the package
meet on one card in one call.  The shapes are the dW launches of the
training paths in ``chip_smoke.py`` (row counts of the synthetic ogbn-mag
at 0.1, rank 0's shard in the data-parallel runs) over S = 4 segments of
fixed shares, and the general K = O = 64 shapes at S = 4 and 535.  Every
launch reads its inputs from device memory (a buffer larger than the L2
cache is overwritten before it) and is timed with CUDA events that a spin
on the card keeps clear of the host's latency; the median of 20 launches
is printed
beside the bound (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s,
whichever is larger) and the card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SHARES = (0.4, 0.3, 0.2, 0.1)

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


def _sizes(rows, S):
    if S == len(SHARES):
        sizes = [int(rows * f) for f in SHARES]
    else:  # a few large relations and a long tail
        w = [1.0 / (1 + i) for i in range(S)]
        sizes = [int(rows * v / sum(w)) for v in w]
    sizes[0] += rows - sum(sizes)
    return sizes


def _bound_ms(rows, S, H, Hx, K, O):
    nbytes = rows * (Hx * K + H * O) * 4 + S * H * K * O * 4 + (S + 1) * 4
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     2 * rows * H * K * O / F32_FLOP_PER_S)


def run_turn():
    """One turn in this process: the package on sys.path first, every
    shape, one JSON line of {label: ms}."""
    import numpy as np
    import torch
    from het_tpu_torch.graph.build import build_segments
    from het_tpu_torch.ops.kernels import segment_matmul_dw
    from het_tpu_torch.ops.kernels._build import build_all

    build_all(("segment_mm",))
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for label, _, rows, S, H, Hx, K, O in SHAPES:
        sizes = _sizes(rows, S)
        seg = build_segments(np.repeat(np.arange(S), sizes), S, 1).to(dev)
        x = torch.randn(rows, Hx * K, device=dev, generator=gen)
        ct = torch.randn(rows, H * O, device=dev, generator=gen)
        w_shape = (S, H, K, O)
        for _ in range(2):
            segment_matmul_dw(x, ct, w_shape, seg)
        times = []
        for _ in range(20):
            flush.zero_()
            # a spin of ~0.1 ms on the card, so that the host has enqueued
            # the call before the card reaches t0: the time is the card's
            torch.cuda._sleep(200_000)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            segment_matmul_dw(x, ct, w_shape, seg)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        out[label] = statistics.median(times)
        del x, ct
    print(json.dumps(out))


def main(roots):
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    turns = list(roots) + list(reversed(roots))
    results = {r: [] for r in roots}
    for root in turns:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn"], env=env, cwd=root,
                              capture_output=True, text=True)
        if done.returncode:
            print(done.stdout, done.stderr, file=sys.stderr)
            return 1
        results[root].append(json.loads(done.stdout.strip().splitlines()[-1]))
    print("shape | a step | bound ms | " + " | ".join(
        f"{r} ms (turns)" for r in roots))
    totals = {r: {} for r in roots}
    for label, per_step, rows, S, H, Hx, K, O in SHAPES:
        bound = _bound_ms(rows, S, H, Hx, K, O)
        cells = []
        for r in roots:
            ts = [t[label] for t in results[r]]
            cells.append(" / ".join(f"{t:.4f}" for t in ts))
            path = label.rsplit(" l", 1)[0] if per_step else label
            totals[r][path] = totals[r].get(path, 0.0) + per_step * min(ts)
        print(f"{label} | {per_step} | {bound:.4f} | " + " | ".join(cells))
    print("a step, the better turn of each shape (ms):", json.dumps(totals))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--turn"]:
        run_turn()
    else:
        sys.exit(main(sys.argv[1:] or [os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))]))
