#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``het_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``het_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once);
3. each kernel against its plain PyTorch version, timed with CUDA events
   beside its bound and a PyTorch yardstick, on the synthetic ogbn-mag
   stand-in at scale 0.1:
   * ``seg_sum_sorted`` at every shape the compact multiply-first and the
     plain RGAT steps give it, plus edge cases;
   * ``segment_matmul_dw`` at every shape the plain RGAT and the compact
     steps give it, at the general segment-matmul shapes (Hx = 1,
     K = O = 64, S = 4 and S = 535, about 1e6 rows), plus edge cases, with
     a control that a dW from inputs rounded to TF32 fails the tolerance;
4. training runs of the 2-layer RGAT (heads 4, in 64, hidden 64, 8
   classes, clip softmax, f32, TF32 off, dropout 0), each once through the
   kernels and once through their plain versions from the same seeded
   parameters: five steps of the compact multiply-first and of the plain
   (per-edge) branch, with finite losses that fall, per-step agreement and
   every kernel's launch count; two steps each of the plain multiply-first
   and the compact branch, with agreement and launch counts.

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
STEPS, SHORT_STEPS = 5, 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TOL_RTOL = 1e-5  # f32 sums in another order
# segment_matmul_dw: |kernel - plain| <= DW_TOL * sum |x| |ct| per output.
# f32 sums in another order stay far inside it; products of inputs rounded
# to TF32 (10-bit mantissa) do not
DW_TOL = 1e-6
TRAIN_RTOL = 1e-4
# training runs: name -> (compact, multiply_first, steps, seg_sum launches
# a step, segment_matmul_dw launches a step).  Per layer: the compact
# branches reduce 5 times (forward aggregation, the (dst, rel) and the
# src-compact backward reductions, two compact-gather backwards), the
# plain ones 3 times (forward aggregation, two edge-gather backwards; the
# per-edge fused backward is gathers only); every branch without
# multiply-first takes two attention-vector dW a layer.
RUNS = {
    "compact_multiply_first": (True, True, STEPS, 10, 0),
    "plain": (False, False, STEPS, 6, 4),
    "plain_multiply_first": (False, True, SHORT_STEPS, 6, 0),
    "compact": (True, False, SHORT_STEPS, 10, 4),
}
MAIN = "plain"  # this slice's main path


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


def _dims():
    return [IN_FEAT] + [HIDDEN] * (LAYERS - 1) + [CLASSES]


# ------------------------------------------------------------ seg_sum_sorted


def _seg_sum_shapes(g):
    """{run: [(label, launches per step, rows of vals, C, row_ptr, perm)]}
    of every seg_sum_sorted launch of one training step."""
    S, D = g.compact_src, g.compact_dst
    E = g.edge_rel_seg
    EP = g.num_padded_edges
    dims = _dims()
    src_perm = E.inv.index_select(0, g.out_perm)  # rows -> src order
    compact, plain = [], []
    for layer in range(LAYERS):
        width = HEADS + dims[layer + 1]  # [z | z*feat], [draw | dfeat]
        fwd = (f"l{layer} fwd dst [z|z*feat]", 1, EP, width,
               g.in_row_ptr, None)
        compact += [
            fwd,
            (f"l{layer} bwd (dst,rel) runs draw", 1, EP, HEADS,
             D.canon_ptr, None),
            (f"l{layer} bwd src-compact [draw|dfeat]", 1, EP, width,
             S.edge_row_ptr, S.edge_sort_perm),
            (f"l{layer} bwd src gather", 1, S.seg.n_rows, dims[layer],
             S.node_row_ptr, S.node_sort_perm),
            (f"l{layer} bwd dst gather", 1, D.seg.n_rows, dims[layer],
             D.node_row_ptr, D.node_sort_perm),
        ]
        plain += [
            fwd,
            (f"l{layer} bwd src edge gather", 1, E.n_rows, dims[layer],
             g.out_row_ptr, src_perm),
            (f"l{layer} bwd dst edge gather", 1, E.n_rows, dims[layer],
             g.in_row_ptr, E.inv),
        ]
    return {"compact_multiply_first": compact, MAIN: plain}


def _seg_sum_edge_cases(dev):
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


def _compare_seg_sum(vals, ptr, perm, label):
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


def check_seg_sum(g, dev, flush):
    """Kernel against plain at every main-path shape of both 5-step runs
    and at the edge cases; per-shape times.  Returns the kernel's JSON
    entry (per-step totals of this slice's main path)."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted, seg_sum_sorted_plain

    print(f"seg_sum_sorted vs plain tolerance: rtol {TOL_RTOL}, "
          f"atol {TOL_RTOL} * max|plain|")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, rows, C, ptr, perm in _seg_sum_edge_cases(dev):
        vals = torch.randn(rows, C, device=dev, generator=gen)
        if perm is not None:  # rows past ptr[n] must never be read
            vals[perm[int(ptr[-1]):].long()] = float("nan")
        _compare_seg_sum(vals, ptr, perm, label)
        print(f"seg_sum edge case ok: {label}")

    totals = {}
    max_err = 0.0
    for run, shapes in _seg_sum_shapes(g).items():
        total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                     bytes_ms=0.0, ops_ms=0.0)
        print(f"[{run}] shape | n | rows read | C | perm | kernel ms | "
              "bound ms | plain ms | segment_reduce ms")
        for label, per_step, rows, C, ptr, perm in shapes:
            vals = torch.randn(rows, C, device=dev, generator=gen)
            max_err = max(max_err, _compare_seg_sum(vals, ptr, perm, label))
            n = ptr.numel() - 1
            lo, hi = int(ptr[0]), int(ptr[-1])
            read = hi - lo
            nbytes = (read * C * 4 + (4 * read if perm is not None else 0)
                      + (n + 1) * 4 + n * C * 4)
            bytes_s = nbytes / HBM_BYTES_PER_S
            ops_s = read * C / F32_FLOP_PER_S
            bound = max(bytes_s, ops_s)
            ms = _time_ms(lambda: seg_sum_sorted(vals, ptr, perm), 20, flush)
            plain = _time_ms(lambda: seg_sum_sorted_plain(vals, ptr, perm), 5,
                             flush)
            off64 = ptr.long()
            idx = (perm[lo:hi].long() if perm is not None
                   else torch.arange(lo, hi, device=dev))

            def library():
                # the yardstick: one PyTorch segment reduction over the
                # rows the kernel reads (the port never calls it)
                return torch.segment_reduce(vals[idx], "sum",
                                            offsets=off64 - lo)

            torch.testing.assert_close(library(), seg_sum_sorted_plain(
                vals, ptr, perm), rtol=1e-4, atol=1e-4)
            lib = _time_ms(library, 5, flush)
            print(f"{label} | {n} | {read} | {C} | {perm is not None} | "
                  f"{ms:.4f} | {bound * 1e3:.4f} | {plain:.4f} | {lib:.4f}")
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("bound_ms", bound * 1e3), ("library_ms", lib),
                           ("bytes_ms", bytes_s * 1e3),
                           ("ops_ms", ops_s * 1e3)):
                total[key] += per_step * v
        print(f"[{run}] per-step totals (ms):", json.dumps(total))
        totals[run] = total
    t = totals[MAIN]
    return {
        "name": "seg_sum_sorted",
        "route": "cuda",
        "source": "het_tpu_torch/csrc/seg_reduce.cu",
        "replaces": "het_tpu/ops/pallas/seg_reduce.py:360",
        "launches": None,  # filled from the training run
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
        "library_ms": t["library_ms"],
        "per_run": totals,
    }


# --------------------------------------------------------- segment_matmul_dw


def _segments(sizes, tile, dev):
    import numpy as np
    from het_tpu_torch.graph.build import build_segments

    seg_of_row = np.repeat(np.arange(len(sizes)), sizes)
    return build_segments(seg_of_row, len(sizes), tile).to(dev)


def _dw_shapes(g, dev):
    """(label, run or None, launches per step, seg, H, Hx, K, O, zero ct
    on invalid rows): the attention-vector dW of the plain RGAT step (two a
    layer over the relation-sorted edge rows) and of the compact step (per
    layer, attn_l over the source and attn_r over the destination compact
    rows), the general segment-matmul dW and edge cases."""
    import numpy as np

    E = g.edge_rel_seg
    dims = _dims()
    rng = np.random.default_rng(0)
    big = 1_000_000
    skew = 1.0 / (1.0 + np.arange(535))  # a few large relations, a long tail
    shapes = []
    for layer in range(LAYERS):
        K = dims[layer + 1] // HEADS
        shapes += [
            (f"l{layer} attn_l/attn_r dW, edge rows", MAIN, 2, E, HEADS,
             HEADS, K, 1, True),
            (f"l{layer} attn_l dW, src compact rows", "compact", 1,
             g.compact_src.seg, HEADS, HEADS, K, 1, True),
            (f"l{layer} attn_r dW, dst compact rows", "compact", 1,
             g.compact_dst.seg, HEADS, HEADS, K, 1, True),
        ]
    shapes += [
        ("general S=4", None, 0, _segments(rng.multinomial(
            big, [0.4, 0.3, 0.2, 0.1]), 128, dev), 1, 1, 64, 64, False),
        ("general S=535", None, 0, _segments(rng.multinomial(
            big, skew / skew.sum()), 128, dev), 1, 1, 64, 64, False),
        ("edge: empty segments", None, 0, _segments((40, 0, 17, 0), 8, dev),
         2, 2, 8, 1, False),
        ("edge: all empty", None, 0, _segments((0, 0, 0), 8, dev), 2, 2, 4,
         3, False),
        ("edge: one segment", None, 0, _segments((300,), 8, dev), 1, 1, 64,
         64, False),
        ("edge: K=1", None, 0, _segments((50, 0, 900), 8, dev), 1, 1, 1, 64,
         False),
        ("edge: O=1", None, 0, _segments((50, 0, 900), 8, dev), 2, 1, 8, 1,
         False),
    ]
    assert g.num_rels == E.n_segments
    return shapes


def _tf32(t):
    """``t`` rounded to TF32 (10-bit mantissa, to nearest, ties away from
    zero), as a tensor-core load would round it."""
    import torch

    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _worst_share(diff, limit):
    """max of diff / limit (0 where both are 0; inf where only the limit
    is)."""
    import torch

    share = torch.where(limit > 0, diff / limit,
                        torch.where(diff > 0, float("inf"), 0.0))
    return share.max().item() if share.numel() else 0.0


def check_dw(g, dev, flush):
    """segment_matmul_dw against its plain version at every shape, within
    |kernel - plain| <= DW_TOL * sum |x| |ct| (the plain version on
    absolute values), and a control: the plain version on inputs rounded to
    TF32 must fail that limit at every shape that has rows, so the check
    tells an f32 kernel from a TF32 one.  Per-shape times.  Returns the
    kernel's JSON entry: per-step totals of this slice's main path, and of
    every run under ``per_run``."""
    import torch
    from het_tpu_torch.ops.kernels import (segment_matmul_dw,
                                           segment_matmul_dw_plain)

    print(f"segment_matmul_dw vs plain tolerance: |kernel - plain| <= "
          f"{DW_TOL} * sum|x|*|ct|; 'share' is the largest |diff| / limit")
    gen = torch.Generator(device=dev).manual_seed(1)
    totals = {}
    max_err = 0.0
    print("shape | run | S | rows | H | Hx | K | O | kernel share | TF32 "
          "control share | kernel ms | bound ms | plain ms | per-relation "
          "torch.matmul ms")
    for label, run, per_step, seg, H, Hx, K, O, mask in _dw_shapes(g, dev):
        S, n = seg.n_segments, seg.n_rows
        w_shape = (S, H, K, O)
        x = torch.randn(n, Hx * K, device=dev, generator=gen)
        ct = torch.randn(n, H * O, device=dev, generator=gen)
        if mask:  # as _RelInner's backward: no cotangent on padding rows
            ct = torch.where(seg.row_valid[:, None], ct, 0.0)
        got = segment_matmul_dw(x, ct, w_shape, seg)
        torch.cuda.synchronize()
        want = segment_matmul_dw_plain(x, ct, w_shape, seg)
        limit = DW_TOL * segment_matmul_dw_plain(x.abs(), ct.abs(), w_shape,
                                                 seg)
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        err = (got - want).abs()
        share = _worst_share(err, limit)
        if share > 1.0:
            raise AssertionError(
                f"{label}: kernel differs from plain by {err.max().item()}"
                f", {share} times the limit {DW_TOL} * sum|x||ct|")
        control = _worst_share((segment_matmul_dw_plain(
            _tf32(x), _tf32(ct), w_shape, seg) - want).abs(), limit)
        if limit.max().item() > 0 and not control > 1.0:
            raise AssertionError(
                f"{label}: a TF32-input dW stays within the limit ({control}"
                f" of it), so the check cannot tell it from f32")
        max_err = max(max_err, err.max().item() if err.numel() else 0.0)
        ptrs = seg.seg_ptrs_static

        def yardstick():
            # the per-relation torch.matmul loop of _SegmentMatmul's
            # backward (batched over heads when x is per head); the port's
            # dW never calls it
            out = torch.zeros(w_shape, device=dev)
            for s in range(S):
                lo, hi = ptrs[s], ptrs[s + 1]
                if hi == lo:
                    continue
                if Hx == 1:
                    out[s] = (x[lo:hi].t() @ ct[lo:hi]).view(
                        K, H, O).permute(1, 0, 2)
                else:
                    out[s] = torch.matmul(
                        x[lo:hi].view(-1, H, K).permute(1, 2, 0),
                        ct[lo:hi].view(-1, H, O).permute(1, 0, 2))
            return out

        if (yardstick() - want).abs().max().item() > 1e-4 * max(
                limit.max().item() / DW_TOL, 1.0):
            raise AssertionError(f"{label}: yardstick disagrees")
        rows = ptrs[-1] - ptrs[0]
        nbytes = rows * (Hx * K + H * O) * 4 + S * H * K * O * 4 + (S + 1) * 4
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = 2 * rows * H * K * O / F32_FLOP_PER_S
        bound = max(bytes_s, ops_s)
        ms = _time_ms(lambda: segment_matmul_dw(x, ct, w_shape, seg), 20,
                      flush)
        plain = _time_ms(
            lambda: segment_matmul_dw_plain(x, ct, w_shape, seg), 5, flush)
        yard = _time_ms(yardstick, 5, flush)
        print(f"{label} | {run} | {S} | {rows} | {H} | {Hx} | {K} | {O} | "
              f"{share:.4g} | {control:.4g} | {ms:.4f} | {bound * 1e3:.4f} "
              f"({'bytes' if bytes_s >= ops_s else 'operations'}) | "
              f"{plain:.4f} | {yard:.4f}")
        if run is None:
            continue
        total = totals.setdefault(run, dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0, yardstick_ms=0.0,
            bytes_ms=0.0, ops_ms=0.0))
        for key, v in (("ms", ms), ("plain_ms", plain),
                       ("bound_ms", bound * 1e3), ("yardstick_ms", yard),
                       ("bytes_ms", bytes_s * 1e3), ("ops_ms", ops_s * 1e3)):
            total[key] += per_step * v
    for run, total in totals.items():
        print(f"[{run}] segment_matmul_dw per-step totals (ms):",
              json.dumps(total))
    total = totals[MAIN]
    return {
        "name": "segment_matmul_dw",
        "route": "cuda",
        "source": "het_tpu_torch/csrc/segment_mm.cu",
        "replaces": "het_tpu/ops/pallas/segment_mm.py:400,568",
        "launches": None,  # filled from the training run
        "max_abs_err": max_err,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                     else "operations"),
        "library_ms": None,  # no single PyTorch call computes a grouped dW
        "yardstick_ms": total["yardstick_ms"],
        "yardstick": "per-relation torch.matmul loop",
        "per_run": totals,
    }


# ------------------------------------------------------------------ training


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


def check_training(data, dev, card, run):
    """One ``RUNS`` entry through the kernels and through the plain
    versions from the same parameters.  Returns the kernel run's launches
    of each kernel and the summary printed."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted, segment_matmul_dw
    from het_tpu_torch.train import TrainConfig, build_model, train

    compact, multiply_first, steps, want_seg, want_dw = RUNS[run]
    cfg = TrainConfig(
        model="RGAT", dataset="mag", dataset_scale=0.1, n_infeat=IN_FEAT,
        hidden=HIDDEN, num_classes=CLASSES, num_heads=HEADS,
        num_layers=LAYERS, compact=compact, multiply_first=multiply_first,
        dropout=0.0, stable_softmax="clip", num_epochs=steps, device=str(dev),
    )
    state = _initial_state(build_model(cfg, data))
    runs = {}
    for impl in ("kernel", "plain"):
        torch.cuda.reset_peak_memory_stats(dev)
        seg_sum_sorted.launches = segment_matmul_dw.launches = 0
        m = train(cfg, data, state=state, impl=impl,
                  log=lambda s, i=impl: print(f"[{run} {i}] {s}"))
        m["launches"] = {"seg_sum_sorted": seg_sum_sorted.launches,
                         "segment_matmul_dw": segment_matmul_dw.launches}
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        runs[impl] = m
    k, p = runs["kernel"], runs["plain"]
    for impl, m in runs.items():
        losses = m["loss_list"]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{run} {impl}: losses {losses}")
        if steps == STEPS and not losses[-1] < losses[0]:
            raise AssertionError(f"{run} {impl}: loss did not fall: {losses}")
    for step, (a, b) in enumerate(zip(k["loss_list"], p["loss_list"])):
        if abs(a - b) > TRAIN_RTOL * abs(b):
            raise AssertionError(
                f"{run} step {step}: kernel loss {a} vs plain {b} "
                f"(rtol {TRAIN_RTOL})")
    want = {"seg_sum_sorted": want_seg * steps,
            "segment_matmul_dw": want_dw * steps}
    if k["launches"] != want:
        raise AssertionError(f"{run}: kernel run launched {k['launches']},"
                             f" expected {want}")
    if any(p["launches"].values()):
        raise AssertionError(f"{run}: plain run launched {p['launches']}")
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
    print(f"training {run} ({card}):", json.dumps(summary))
    return k["launches"], summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    # the package is imported only now: without it the run fails here
    from het_tpu_torch.data.loaders import load_dataset
    from het_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
          f"{g.compact_dst.canon_ptr.numel() - 1}, relation-sorted edge "
          f"rows {g.edge_rel_seg.n_rows} {g.edge_rel_seg.seg_ptrs_static}")
    gd = g.to(dev)

    flush = torch.empty(256 * 2**20 // 4, device=dev)
    entries = [check_seg_sum(gd, dev, flush), check_dw(gd, dev, flush)]
    del flush, gd
    torch.cuda.empty_cache()

    launches, summaries = {}, {}
    for run in RUNS:
        launches[run], summaries[run] = check_training(data, dev, card, run)
    ratio = (summaries[MAIN]["kernel"]["median_warm_step_ms"]
             / summaries["compact_multiply_first"]["kernel"]
             ["median_warm_step_ms"])
    print(f"plain / compact multiply-first step time, kernels ({card}): "
          f"{ratio:.3f}")
    for entry in entries:
        entry["launches"] = launches[MAIN][entry["name"]]
        entry["launches_by_run"] = {r: launches[r][entry["name"]]
                                    for r in RUNS}
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
