#!/usr/bin/env python3
"""Time the sorted segment sum (``seg_sum_sorted``) of one or more
checkouts of ``het_tpu_torch`` on one NVIDIA GPU, in turns, and check
that their f32 results agree bit for bit.

    python3 scripts/bench_seg_sum.py [ROOT ...]

Each ROOT is a directory that holds ``het_tpu_torch`` (default: this
checkout); the roots run in turns (A, B, B, A), each turn in a process of
its own with the root first on ``PYTHONPATH`` (``bench_turns.py``).  The
shapes are the segment sums of a compact multiply-first step of the
2-layer RGAT (heads 4, hidden 64, 8 classes) on the synthetic ogbn-mag
at 0.1: each f32 (rows -> sums), and where the checkout has them the
bf16 instantiations at the same shapes (the pair a bf16 step takes
there: bf16 rows into f32 sums forward and for the gathers, into bf16
sums for the backward's source-side and (dst, rel)-run reduces).  Each
time is the median of 20 launches from device memory beside its bound
(bytes at 3.35 TB/s: 4 bytes an f32 element, 2 a bf16 one); each turn
also prints a digest of every f32 result, and the table says whether the
roots' digests agree.
"""

import hashlib
import json
import os
import subprocess
import sys

import bench_turns

SCALE = 0.1
HEADS, HIDDEN, IN_FEAT, CLASSES = 4, 64, 64, 8


def shapes(g):
    """(label, C, row_ptr, perm, bf16 out) of every sum of a compact
    multiply-first step on ``g``."""
    S, D = g.compact_src, g.compact_dst
    out = []
    for layer, (width, k) in enumerate(((HIDDEN, IN_FEAT), (CLASSES,
                                                            HIDDEN))):
        out += [
            (f"l{layer} fwd z", HEADS, g.in_row_ptr, None, False),
            (f"l{layer} fwd z*feat", width, g.in_row_ptr, None, False),
            (f"l{layer} (dst,rel) draw", HEADS, D.canon_ptr, None, True),
            (f"l{layer} src-compact draw", HEADS, S.edge_row_ptr,
             S.edge_sort_perm, True),
            (f"l{layer} src-compact dfeat", width, S.edge_row_ptr,
             S.edge_sort_perm, True),
            (f"l{layer} src gather", k, S.node_row_ptr, S.node_sort_perm,
             False),
            (f"l{layer} dst gather", k, D.node_row_ptr, D.node_sort_perm,
             False),
        ]
    return out


def run_turn():
    import torch
    from het_tpu_torch.data.loaders import load_dataset
    from het_tpu_torch.ops.kernels import _build, seg_reduce, seg_sum_sorted

    _build.build_all(("seg_reduce",))
    dev = torch.device("cuda")
    g = load_dataset("mag", scale=SCALE, num_classes=CLASSES, seed=0,
                     data_roots=()).graph.to(dev)
    bf16 = hasattr(seg_reduce, "SUM_DTYPES")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    times, digests = {}, {}
    for label, C, ptr, perm, bf16_out in shapes(g):
        rows = perm.numel() if perm is not None else g.num_padded_edges
        gen = torch.Generator(device=dev).manual_seed(C)
        vals = torch.randn(rows, C, device=dev, generator=gen)
        out = seg_sum_sorted(vals, ptr, perm)
        digests[label] = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()
        times[label] = bench_turns.time_ms(
            lambda: seg_sum_sorted(vals, ptr, perm), flush)
        if bf16:
            vb = vals.bfloat16()
            od = torch.bfloat16 if bf16_out else torch.float32
            times[label + " bf16"] = bench_turns.time_ms(
                lambda: seg_sum_sorted(vb, ptr, perm, out_dtype=od), flush)
        n = ptr.numel() - 1
        read = int(ptr[-1]) - int(ptr[0])
        for suffix, es, os_ in (("", 4, 4), (" bf16", 2,
                                             2 if bf16_out else 4)):
            nbytes = (read * C * es + (4 * read if perm is not None else 0)
                      + (n + 1) * 4 + n * C * os_)
            times.setdefault("bound " + label + suffix,
                             1e3 * nbytes / bench_turns.HBM_BYTES_PER_S)
    print(json.dumps({"times": times, "digests": digests}))


def main():
    import torch

    if sys.argv[1:] == ["--turn"]:
        run_turn()
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    roots = sys.argv[1:] or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    print(bench_turns.card_line())
    results = {r: [] for r in roots}
    for root in list(roots) + list(reversed(roots)):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn"], env=env, cwd=root,
                              capture_output=True, text=True)
        if done.returncode:
            print(done.stdout, done.stderr, file=sys.stderr)
            return 1
        results[root].append(json.loads(done.stdout.strip().splitlines()[-1]))
    labels = [k for k in results[roots[-1]][0]["times"]
              if not k.startswith("bound ")]
    print("shape | bound ms | " + " | ".join(f"{r} ms (turns)"
                                             for r in roots))
    totals = {r: {} for r in roots}
    for label in labels:
        bound = results[roots[-1]][0]["times"]["bound " + label]
        cells = []
        for r in roots:
            ts = [t["times"][label] for t in results[r]
                  if label in t["times"]]
            cells.append(" / ".join(f"{t:.4f}" for t in ts) or "-")
            if ts:
                key = "bf16" if label.endswith(" bf16") else "f32"
                totals[r][key] = totals[r].get(key, 0.0) + min(ts)
        print(f"{label} | {bound:.4f} | " + " | ".join(cells))
    digests = {json.dumps(t["digests"], sort_keys=True)
               for r in roots for t in results[r]}
    print("a step, the better turn of each shape (ms):", json.dumps(totals))
    print("f32 results bit for bit across roots and turns:",
          len(digests) == 1)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
