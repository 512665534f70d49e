"""Segment-matmul routes across relation counts (counterpart of
``scripts/bench_segmm_strategies.py``).

    python -m het_tpu_torch.bench.segmm_strategies
        [--cases mag_like wikikg2_like fb15k_like] [--reps 20]
        [--scale 1.0] [--device cuda|cpu] [--out FILE]

``bench_segmm_strategies.py``'s three cases, with its zipf-skewed
relation sizes (``make_case``, the segments built by the port's
``build_segments``, tile 128): mag-like (R = 6, H = 4, K = 64, O = 16,
345,172 rows), wikikg2-like (R = 535, H = 1, K = O = 128, 1,000,000 rows)
and fb15k-like (R = 474, K = O = 128, 544,230 rows); ``--scale`` takes
that share of the rows (the CPU tests run a small one).  The routes are the
port's own ways to compute ``y = x[rows of s] W[s]``:

* ``kernel``: the segment-matmul kernels on offsets that live on the
  device (kernels 4/5 forward, 6/8 dX, 7/9 dW), one launch each over all
  relations, as a shard's typed linears run;
* ``static_mix``: one ``torch.matmul`` a relation on the host's offsets,
  as every single-card typed linear runs (het_tpu's static mix);
* ``gathered_w``: W gathered to every row tile, ``W[tile_seg]``, and one
  batched matmul (het_tpu's ``xla_gather`` row);
* ``plain``: the kernels' plain versions.

``jax.lax.ragged_dot`` has no PyTorch counterpart, so its row is not
here.  Each route is timed forward alone and forward + dX + dW (autograd
on x and W against a fixed cotangent), each call on its own between CUDA
events after an L2 flush.  The kernel route's y, dx and dW are held to
the plain versions' within PERF.md §2's limits (1e-5 of
``sum |x| |W|`` and ``sum |ct| |W|``, 1e-6 of ``sum |x| |ct|``); a
disagreement raises.  Each row carries both bounds (``OpCost`` of
``utils/profiling.py``: bytes at the HBM rate against f32 operations),
every route's share of them and the card line.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph.build import build_segments
from ..ops.kernels import (segment_matmul_dw_plain, segment_matmul_dx_plain,
                           segment_matmul_fwd_plain)
from ..ops.linear import segment_matmul
from ..utils.profiling import OpCost
from . import common

# name -> (R, rows, K, O, H)
CASES = {
    "mag_like": (6, 345172, 64, 16, 4),
    "wikikg2_like": (535, 1_000_000, 128, 128, 1),
    "fb15k_like": (474, 544_230, 128, 128, 1),
}
MM_TOL, DW_TOL = 1e-5, 1e-6


def make_case(R, n_real, K, O, H=1, tile=128, seed=0, skew=1.1, dev="cpu"):
    """``bench_segmm_strategies.py``'s case: zipf-skewed relation sizes,
    tile-padded segments, standard normal x (n_rows, K) and W (R, H, K,
    O) from a numpy seed."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, R + 1) ** skew
    p /= p.sum()
    seg_of_row = np.sort(rng.choice(R, size=n_real, p=p))
    seg = build_segments(seg_of_row, R, tile)
    x = torch.from_numpy(
        rng.standard_normal((seg.n_rows, K)).astype(np.float32)).to(dev)
    w = torch.from_numpy(
        rng.standard_normal((R, H, K, O)).astype(np.float32)).to(dev)
    return seg.to(dev), x, w


def _gathered_w(x, w, seg):
    """W gathered to each row tile and one batched matmul."""
    T = seg.tile
    wt = w.index_select(0, seg.tile_seg.long())  # (tiles, H, K, O)
    xt = x.view(-1, T, x.shape[1])
    return torch.einsum("ntk,nhko->ntho", xt, wt).reshape(
        x.shape[0], w.shape[1], w.shape[3])


def routes(seg):
    """route -> ``f(x, w)`` -> (n_rows, H, O)."""
    dev_seg = dataclasses.replace(seg, seg_ptrs_static=None)
    return {
        "kernel": lambda x, w: segment_matmul(x, w, dev_seg, impl="kernel"),
        "static_mix": lambda x, w: segment_matmul(x, w, seg, impl="kernel"),
        "gathered_w": lambda x, w: _gathered_w(x, w, seg),
        "plain": lambda x, w: segment_matmul(x, w, dev_seg, impl="plain"),
    }


def _fwd_bwd(f, x, w, ct):
    xg = x.detach().requires_grad_()
    wg = w.detach().requires_grad_()
    y = f(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), ct)
    return y.detach(), dx, dw


def check_kernel(f_kernel, f_plain, x, w, ct, seg) -> Dict[str, float]:
    """The kernel route's y, dx and dW against the plain versions', each
    as the worst share of its limit."""
    yk, dxk, dwk = _fwd_bwd(f_kernel, x, w, ct)
    yp, dxp, dwp = _fwd_bwd(f_plain, x, w, ct)
    xa, wa, ca = x.abs(), w.abs(), ct.abs()
    return {
        "y": common.within("y", yk, yp, MM_TOL * segment_matmul_fwd_plain(xa, wa,
                                                                 seg)),
        "dx": common.within("dx", dxk, dxp, MM_TOL * segment_matmul_dx_plain(
            ca.reshape(ca.shape[0], -1), wa, seg, 1)),
        "dw": common.within("dw", dwk, dwp, DW_TOL * segment_matmul_dw_plain(
            xa, ca.reshape(ca.shape[0], -1), tuple(w.shape), seg)),
    }


def case_bounds(rows, R, K, O, H, peaks) -> Dict[str, float]:
    """Least ms forward (x and W read, y written; 2 rows H K O
    operations) and forward + dX + dW (each operand read and each result
    written once a pass; three times the operations)."""
    xb, wb, yb = rows * K * 4, R * H * K * O * 4, rows * H * O * 4
    flops = 2.0 * rows * H * K * O
    fwd = OpCost("fwd", flops, xb + wb + yb)
    both = OpCost("fwd_dx_dw", 3 * flops,
                  (xb + wb + yb) + (yb + wb + xb) + (xb + yb + wb))
    return {"fwd": fwd.time_ms(peaks), "fwd_dx_dw": both.time_ms(peaks)}


def bench_case(name: str, dev: torch.device, *, reps: int,
               peaks: Dict[str, float], scale: float = 1.0
               ) -> Dict[str, Any]:
    R, n_real, K, O, H = CASES[name]
    seg, x, w = make_case(R, max(int(n_real * scale), R), K, O, H=H,
                          dev=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    ct = torch.randn(seg.n_rows, H, O, generator=gen, device=dev)
    fs = routes(seg)
    row: Dict[str, Any] = {"case": name, "R": R, "rows": seg.n_rows,
                           "K": K, "O": O, "H": H}
    row["kernel_vs_plain_share_of_limit"] = check_kernel(
        fs["kernel"], fs["plain"], x, w, ct, seg)
    b = case_bounds(seg.n_rows, R, K, O, H, peaks)
    row["bound_ms"] = b
    common.reset_peak(dev)
    for route, f in fs.items():
        fwd_ms = common.time_call_ms(lambda: f(x, w), dev, reps)
        both_ms = common.time_call_ms(lambda: _fwd_bwd(f, x, w, ct), dev,
                                      reps)
        row[f"{route}_fwd_ms"] = fwd_ms
        row[f"{route}_fwd_dx_dw_ms"] = both_ms
        row[f"{route}_pct_of_bound"] = {
            "fwd": common.share_pct(b["fwd"], fwd_ms, f"{name} {route}"),
            "fwd_dx_dw": common.share_pct(b["fwd_dx_dw"], both_ms,
                                          f"{name} {route}")}
    row["peak_mem_mb"] = common.peak_mb(dev)
    del x, w, ct, fs, seg
    common.free(dev)
    return row


def run(device: str = "cuda", *, cases: Sequence[str] = tuple(CASES),
        reps: int = 20, scale: float = 1.0,
        peaks: Optional[Dict[str, float]] = None,
        out=None) -> List[Dict[str, Any]]:
    dev = common.setup(device)
    card, clock = common.card_line(dev), common.clock_name(dev)
    rows = []
    for name in cases:
        row = dict(bench_case(name, dev, reps=reps,
                              peaks=common.peaks_of(dev, peaks), scale=scale),
                   scale=scale, card=card, clock=clock)
        common.emit(row, out)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.segmm_strategies",
        description="Segment-matmul routes across relation counts "
                    "(bench_segmm_strategies.py's).")
    p.add_argument("--cases", nargs="+", default=list(CASES),
                   choices=list(CASES))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--scale", type=float, default=1.0)
    args = common.parse(p, argv)
    run(args.device, cases=args.cases, reps=args.reps, scale=args.scale,
        out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
