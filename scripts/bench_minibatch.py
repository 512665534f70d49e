"""Host and device time of minibatch training for several checkouts of
``het_tpu_torch`` on one NVIDIA GPU, in turns.

    python3 scripts/bench_minibatch.py ROOT [ROOT ...] [--scale S]
        [--batches N]

(``--turn --device cpu`` runs one turn on the CPU, to try the script.)

Each ROOT is a directory that holds ``het_tpu_torch``.  The roots run in
the order given and then in reverse (A, B, B, A), each turn in a process
of its own with the root first on ``PYTHONPATH``.  A turn trains compact
multiply-first RGAT (``train_minibatch``: 2 layers, 4 heads, in 64,
hidden 64, 8 classes, 1024 seeds a batch, fanout 10, 2 hops, dropout 0)
for N batches on the synthetic ogbn-mag stand-in at scale S (built in the
turn, its time printed) and reports each batch's host times (draw, build,
copy, on the host clock) and device step (CUDA events); the accuracy
passes after the batches read one test batch only.  Printed a turn: the
medians past the first batch, the host share of a batch and seeds/s end
to end, beside the card's name and power limit.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time


def run_turn(scale, batches, device):
    """One turn in this process: prints one JSON line."""
    import torch
    from het_tpu_torch.data.loaders import load_dataset
    from het_tpu_torch.train import TrainConfig
    from het_tpu_torch.train.minibatch import train_minibatch

    t0 = time.perf_counter()
    data = load_dataset("mag", scale=scale, num_classes=8, seed=0,
                        build_compact=False, data_roots=())
    load_s = time.perf_counter() - t0
    cfg = TrainConfig(
        model="RGAT", dataset="mag", dataset_scale=scale, n_infeat=64,
        hidden=64, num_classes=8, num_heads=4, num_layers=2, compact=True,
        multiply_first=True, dropout=0.0, num_epochs=10,
        max_batches=batches, batch_size=1024, fanout=10, num_hops=2,
        full_graph_training=False, device=device)
    data = dataclasses.replace(data, test_idx=data.test_idx[:1024])
    m = train_minibatch(cfg, data, log=lambda s: None)
    tail = slice(1, None)
    host = [a + b + c for a, b, c in zip(
        m["sample_ms_list"], m["build_ms_list"], m["copy_ms_list"])]
    med = {k: statistics.median(m[k][tail]) for k in (
        "sample_ms_list", "build_ms_list", "copy_ms_list", "step_ms_list")}
    host_ms = statistics.median(host[tail])
    step = med["step_ms_list"]
    print(json.dumps({
        "load_s": load_s, "draw_ms": med["sample_ms_list"],
        "build_ms": med["build_ms_list"], "copy_ms": med["copy_ms_list"],
        "step_ms": step, "host_ms": host_ms,
        "host_share": host_ms / (host_ms + step),
        "seeds_per_s": 1024 / ((host_ms + step) / 1e3),
        "losses": m["loss_list"],
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if device == "cuda" else None)}))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("roots", nargs="*")
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--turn", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.turn:
        run_turn(args.scale, args.batches, args.device)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    for root in list(args.roots) + list(reversed(args.roots)):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", "--scale",
             str(args.scale), "--batches", str(args.batches)],
            env=env, cwd=root, capture_output=True, text=True)
        if done.returncode:
            print(done.stdout, done.stderr, file=sys.stderr)
            return 1
        print(f"{root} scale {args.scale}:",
              done.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
