"""Turn-taking for the kernel benches (``bench_dw.py``, ``bench_fwd.py``):
time one kernel of several checkouts of ``het_tpu_torch`` on one NVIDIA
GPU, in turns.

Each ROOT is a directory that holds ``het_tpu_torch``.  The roots run in
the order given and then in reverse (A, B, B, A), each turn in a process
of its own with the root first on ``PYTHONPATH``, so two versions of the
package meet on one card in one call.  A shape is (label, launches a step
on its path, rows, S, H, Hx, K, O) over S segments of fixed shares (S = 4)
or a few large and a long tail (other S).  Every launch reads its inputs
from device memory (a buffer larger than the L2 cache is overwritten
before it) and is timed with CUDA events that a spin on the card keeps
clear of the host's latency; the median of 20 launches is printed beside
the bound (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s, whichever
is larger) and the card's name and power limit.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys


def _peaks():
    """The H100 SXM row of this checkout's ``het_tpu_torch/utils/
    profiling.py``, loaded by its path: a turn's process puts another
    checkout's package first on the path."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "het_tpu_torch", "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("_port_profiling", path)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.H100_SXM


_PEAKS = _peaks()
HBM_BYTES_PER_S = _PEAKS["hbm_gbps"] * 1e9
F32_FLOP_PER_S = _PEAKS["f32_tflops"] * 1e12
SHARES = (0.4, 0.3, 0.2, 0.1)
REPS = 20


def sizes(rows, S):
    """Rows a segment: SHARES at S = 4, else 1 / (1 + s) shares."""
    if S == len(SHARES):
        out = [int(rows * f) for f in SHARES]
    else:  # a few large relations and a long tail
        w = [1.0 / (1 + i) for i in range(S)]
        out = [int(rows * v / sum(w)) for v in w]
    out[0] += rows - sum(out)
    return out


def bound_ms(rows, S, H, Hx, K, O):
    nbytes = rows * (Hx * K + H * O) * 4 + S * H * K * O * 4 + (S + 1) * 4
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     2 * rows * H * K * O / F32_FLOP_PER_S)


def segments(rows, S, dev):
    """Segments of ``sizes(rows, S)`` rows, offsets on the device only."""
    import dataclasses

    import numpy as np
    from het_tpu_torch.graph.build import build_segments

    seg = build_segments(np.repeat(np.arange(S), sizes(rows, S)), S, 1)
    return dataclasses.replace(seg, seg_ptrs_static=None).to(dev)


def time_ms(fn, flush):
    """Median ms of ``fn`` over REPS launches, each after ``flush.zero_()``
    and a spin on the card."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        # a spin of ~0.1 ms on the card, so that the host has enqueued the
        # call before the card reaches t0: the time is the card's
        torch.cuda._sleep(200_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def run_turn(shapes, make, build):
    """One turn in this process: build the kernel library ``build``, then
    for every shape time ``make(shape, dev, gen)``, the call to time;
    prints one JSON line of {label: ms}."""
    import torch
    from het_tpu_torch.ops.kernels._build import build_all

    build_all((build,))
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for shape in shapes:
        fn = make(shape, dev, gen)
        out[shape[0]] = time_ms(fn, flush)
        del fn
    print(json.dumps(out))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def compare(script, roots, shapes):
    """Run ``script --turn`` for each root in turns (A, B, B, A) and print
    the table and the totals a step of each path (the better turn of each
    shape); a shape's path is its label up to its last " l" (layer)."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    turns = list(roots) + list(reversed(roots))
    results = {r: [] for r in roots}
    for root in turns:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        done = subprocess.run([sys.executable, os.path.abspath(script),
                               "--turn"], env=env, cwd=root,
                              capture_output=True, text=True)
        if done.returncode:
            print(done.stdout, done.stderr, file=sys.stderr)
            return 1
        results[root].append(json.loads(done.stdout.strip().splitlines()[-1]))
    print("shape | a step | bound ms | " + " | ".join(
        f"{r} ms (turns)" for r in roots))
    totals = {r: {} for r in roots}
    for label, per_step, rows, S, H, Hx, K, O in shapes:
        bound = bound_ms(rows, S, H, Hx, K, O)
        cells = []
        for r in roots:
            ts = [t[label] for t in results[r]]
            cells.append(" / ".join(f"{t:.4f}" for t in ts))
            path = label.rsplit(" l", 1)[0] if per_step else label
            totals[r][path] = totals[r].get(path, 0.0) + per_step * min(ts)
        print(f"{label} | {per_step} | {bound:.4f} | " + " | ".join(cells))
    print("a step, the better turn of each shape (ms):", json.dumps(totals))
    return 0


def cli(script, shapes, make, build):
    """The bench's command line: ``--turn`` runs one turn, else the
    arguments are the roots (default: the checkout that holds
    ``script``)."""
    if sys.argv[1:] == ["--turn"]:
        run_turn(shapes, make, build)
        return 0
    return compare(script, sys.argv[1:] or [os.path.dirname(
        os.path.dirname(os.path.abspath(script)))], shapes)
