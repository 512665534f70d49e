#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``het_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``het_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once);
3. each kernel against its plain PyTorch version at every shape the
   training step gives it, on the synthetic ogbn-mag stand-in at scale 0.1,
   plus edge cases; timed with CUDA events beside its bound and a
   PyTorch library call computing the same function;
4. five training steps of the 2-layer compact multiply-first RGAT (heads
   4, in 64, hidden 64, 8 classes, clip softmax, f32, TF32 off), once
   through the kernels and once through their plain versions, from the
   same seeded parameters: finite losses that fall, per-step agreement,
   and every kernel's launch count on the kernel run.

The last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

import json
import math
import statistics
import subprocess
import sys
import time

# the training configuration (het_tpu's widths, 2 layers)
HEADS, IN_FEAT, HIDDEN, CLASSES, LAYERS = 4, 64, 64, 8, 2
STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TOL_RTOL = 1e-5  # f32 sums in another order
TRAIN_RTOL = 1e-4


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def _time_ms(fn, reps, flush):
    """Median ms of ``fn`` over ``reps`` launches, each timed with CUDA
    events after overwriting a buffer larger than the L2 cache, so every
    launch reads its inputs from device memory."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _main_path_shapes(g):
    """(label, launches per step, rows of vals, C, row_ptr, perm) of every
    seg_sum_sorted launch of one training step."""
    S, D = g.compact_src, g.compact_dst
    EP = g.num_padded_edges
    dims = [IN_FEAT] + [HIDDEN] * (LAYERS - 1) + [CLASSES]
    shapes = []
    for layer in range(LAYERS):
        width = HEADS + dims[layer + 1]  # [z | z*feat], [draw | dfeat]
        shapes += [
            (f"l{layer} fwd dst [z|z*feat]", 1, EP, width,
             g.in_row_ptr, None),
            (f"l{layer} bwd (dst,rel) runs draw", 1, EP, HEADS,
             D.canon_ptr, None),
            (f"l{layer} bwd src-compact [draw|dfeat]", 1, EP, width,
             S.edge_row_ptr, S.edge_sort_perm),
            (f"l{layer} bwd src gather", 1, S.seg.n_rows, dims[layer],
             S.node_row_ptr, S.node_sort_perm),
            (f"l{layer} bwd dst gather", 1, D.seg.n_rows, dims[layer],
             D.node_row_ptr, D.node_sort_perm),
        ]
    return shapes


def _edge_cases(dev):
    import torch

    i32 = dict(dtype=torch.int32, device=dev)
    perm = torch.randperm(40, device=dev).to(torch.int32)
    return [
        ("empty segments", 40, 12, torch.tensor([0, 0, 5, 5, 12, 30, 30],
                                                **i32), None),
        ("all empty", 40, 4, torch.zeros(5, **i32), None),
        ("one segment", 40, 68, torch.tensor([0, 40], **i32), None),
        ("C=1", 40, 1, torch.tensor([0, 7, 7, 40], **i32), None),
        ("C=3 scalar loads", 40, 3, torch.tensor([0, 9, 40], **i32), None),
        ("perm, padding past ptr[n]", 40, 4,
         torch.tensor([0, 4, 9, 20], **i32), perm),
    ]


def _compare(vals, ptr, perm, label):
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted, seg_sum_sorted_plain

    got = seg_sum_sorted(vals, ptr, perm)
    torch.cuda.synchronize()
    want = seg_sum_sorted_plain(vals, ptr, perm)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    scale = want.abs().max().item() if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=TOL_RTOL,
                               atol=TOL_RTOL * max(scale, 1e-30),
                               msg=lambda m: f"{label}: {m}")
    return (got - want).abs().max().item() if want.numel() else 0.0


def check_kernels(g, dev):
    """Phase 3: kernel against plain at every main-path shape and at the
    edge cases; per-shape times.  Returns the kernel's JSON entry."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted, seg_sum_sorted_plain

    print(f"kernel vs plain tolerance: rtol {TOL_RTOL}, "
          f"atol {TOL_RTOL} * max|plain|")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, rows, C, ptr, perm in _edge_cases(dev):
        vals = torch.randn(rows, C, device=dev, generator=gen)
        if perm is not None:  # rows past ptr[n] must never be read
            vals[perm[int(ptr[-1]):].long()] = float("nan")
        _compare(vals, ptr, perm, label)
        print(f"edge case ok: {label}")

    flush = torch.empty(256 * 2**20 // 4, device=dev)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    bytes_ms = ops_ms = 0.0
    max_err = 0.0
    print("shape | n | rows read | C | perm | kernel ms | bound ms | "
          "plain ms | segment_reduce ms")
    for label, per_step, rows, C, ptr, perm in _main_path_shapes(g):
        vals = torch.randn(rows, C, device=dev, generator=gen)
        max_err = max(max_err, _compare(vals, ptr, perm, label))
        n = ptr.numel() - 1
        lo, hi = int(ptr[0]), int(ptr[-1])
        read = hi - lo
        nbytes = (read * C * 4 + (4 * read if perm is not None else 0)
                  + (n + 1) * 4 + n * C * 4)
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, read * C / F32_FLOP_PER_S
        bound = max(bytes_s, ops_s)
        bytes_ms += per_step * bytes_s * 1e3
        ops_ms += per_step * ops_s * 1e3
        ms = _time_ms(lambda: seg_sum_sorted(vals, ptr, perm), 20, flush)
        plain = _time_ms(lambda: seg_sum_sorted_plain(vals, ptr, perm), 5,
                         flush)
        off64 = ptr.long()
        idx = (perm[lo:hi].long() if perm is not None
               else torch.arange(lo, hi, device=dev))

        def library():
            # the yardstick: one PyTorch segment reduction over the rows
            # the kernel reads (the port never calls it)
            return torch.segment_reduce(vals[idx], "sum",
                                        offsets=off64 - lo)

        torch.testing.assert_close(library(), seg_sum_sorted_plain(
            vals, ptr, perm), rtol=1e-4, atol=1e-4)
        lib = _time_ms(library, 5, flush)
        print(f"{label} | {n} | {read} | {C} | {perm is not None} | "
              f"{ms:.4f} | {bound * 1e3:.4f} | {plain:.4f} | {lib:.4f}")
        total["ms"] += per_step * ms
        total["plain_ms"] += per_step * plain
        total["bound_ms"] += per_step * bound * 1e3
        total["library_ms"] += per_step * lib
    print("per-step totals (ms):", json.dumps(total))
    return {
        "name": "seg_sum_sorted",
        "route": "cuda",
        "source": "het_tpu_torch/csrc/seg_reduce.cu",
        "replaces": "het_tpu/ops/pallas/seg_reduce.py:360",
        "launches": None,  # filled from the training run
        "max_abs_err": max_err,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": total["library_ms"],
    }


def _initial_state(net, seed=0):
    """Initial parameters from a numpy seed: embeddings uniform on [0, 1),
    weights Glorot-uniform (flax's fan convention), biases zero."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    state = {}
    for name, p in net.state_dict().items():
        shape = tuple(p.shape)
        if name == "embed.embed":
            a = rng.uniform(0.0, 1.0, shape)
        elif name.endswith("h_bias"):
            a = np.zeros(shape)
        else:
            rf = math.prod(shape[:-2])
            lim = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * rf))
            a = rng.uniform(-lim, lim, shape)
        state[name] = torch.from_numpy(a.astype(np.float32))
    return state


def check_training(data, dev, card):
    """Phase 4: five steps through the kernels and through the plain
    versions from the same parameters.  Returns the kernel-run launches
    and the step time."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted
    from het_tpu_torch.train import TrainConfig, build_model, train

    cfg = TrainConfig(
        model="RGAT", dataset="mag", dataset_scale=0.1, n_infeat=IN_FEAT,
        hidden=HIDDEN, num_classes=CLASSES, num_heads=HEADS,
        num_layers=LAYERS, compact=True, multiply_first=True, dropout=0.0,
        stable_softmax="clip", num_epochs=STEPS, device=str(dev),
    )
    state = _initial_state(build_model(cfg, data))
    runs = {}
    for impl in ("kernel", "plain"):
        torch.cuda.reset_peak_memory_stats(dev)
        seg_sum_sorted.launches = 0
        m = train(cfg, data, state=state, seg_sum_impl=impl,
                  log=lambda s, i=impl: print(f"[{i}] {s}"))
        launches = seg_sum_sorted.launches
        m["launches"] = launches
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        runs[impl] = m
    k, p = runs["kernel"], runs["plain"]
    for impl, m in runs.items():
        losses = m["loss_list"]
        if len(losses) != STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{impl}: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{impl}: loss did not fall: {losses}")
    for step, (a, b) in enumerate(zip(k["loss_list"], p["loss_list"])):
        if abs(a - b) > TRAIN_RTOL * abs(b):
            raise AssertionError(
                f"step {step}: kernel loss {a} vs plain {b} "
                f"(rtol {TRAIN_RTOL})")
    if k["launches"] != 10 * STEPS:
        raise AssertionError(
            f"kernel run launched seg_sum_sorted {k['launches']} times, "
            f"expected {10 * STEPS}")
    if p["launches"] != 0:
        raise AssertionError(f"plain run launched {p['launches']} kernels")
    E = data.graph.num_edges
    summary = {}
    for impl, m in runs.items():
        warm = statistics.median(m["step_ms_list"][1:])
        summary[impl] = {
            "losses": m["loss_list"], "step_ms": m["step_ms_list"],
            "median_warm_step_ms": warm,
            "edges_per_s": E / (warm / 1e3),
            "launches": m["launches"], "peak_mem_gb": m["peak_mem_gb"],
        }
    print("training (" + card + "):", json.dumps(summary))
    return k["launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    # the package is imported only now: without it the run fails here
    from het_tpu_torch.data.loaders import load_dataset
    from het_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    print(card)  # nvidia-smi's "name, power.limit"
    print(f"device: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    for log in _build.build_all():
        print(log)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    data = load_dataset("mag", scale=0.1, num_classes=CLASSES, seed=0,
                        data_roots=())  # the synthetic stand-in
    g = data.graph
    print(f"graph built in {time.perf_counter() - t0:.1f} s: "
          f"{g.describe()}, compact rows src {g.compact_src.seg.n_rows} "
          f"dst {g.compact_dst.seg.n_rows}, (dst, rel) runs "
          f"{g.compact_dst.canon_ptr.numel() - 1}")
    gd = g.to(dev)

    entry = check_kernels(gd, dev)
    entry["launches"] = check_training(data, dev, card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
