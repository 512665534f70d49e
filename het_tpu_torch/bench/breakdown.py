"""Per-op breakdown of bench.py's RGAT step and HGT's plain attention,
each op against its analytic bound (counterpart of
``scripts/breakdown.py``).

    python -m het_tpu_torch.bench.breakdown [--scale 0.018] [--quick]
        [--device cuda|cpu] [--out FILE]

On synthetic ogbn-mag at ``--scale`` (``bench.step``'s graph: 379,998
edges at 0.018) with 4 heads, 64 input features and D = 16 a head, every
component op of the step breakdown.py times, forward and gradient, is
timed with ``common.time_call`` (single calls between CUDA events,
each after an L2 flush and a spin on the card that outlasts the host's
enqueue of the call, so that a row of many launches reads the card's
time and not the host's; the host clock on the CPU), once through the
hand-written kernels (``impl="kernel"``, the rows ``[kernel] ...``,
breakdown.py's ``[pallas] ...``) and once through their
plain versions (``[plain] ...``, its ``[xla] ...``).  A "grad" row times
the forward and the gradient of ``sum(out ** 2)`` with respect to its
first operand; the two dW rows take ``(x, w)`` and differentiate ``w``,
as breakdown.py's ``grad_w_of`` does.  Each row carries breakdown.py's
byte and operation model, its bound (the larger of the bytes at the
card's memory rate and the operations at its f32 rate,
``common.peaks_of``), its share of that bound (``common.share_pct``:
past 100% raises), the kernels it launches a call and the host's
enqueue of a call beside the spin that hid it (``host_ms``,
``spin_ms``, ``host_hidden``).  Before any time is
kept, each kernel row's output is held to its plain row's within PERF.md
§2's limit (rtol 1e-4 of the largest magnitude); a disagreement raises.

Then the end-to-end rows, ``bench.step``'s model (1 layer, 8 classes)
timed the same way: compact + multiply-first on the kernels (the
headline), its forward alone, the plain model on the kernels and on the
plain versions, each kernel row held at its first call to the plain
versions' on the same parameters.

``--quick`` times the kernel rows only (their plain outputs are still
computed for the hold), 8 calls a row in place of 14, and the first two
end-to-end rows, as breakdown.py's ``--quick`` does.  Prints one JSON
line a row and a closing line; writes a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from .. import ops
from ..ops import kernels
from . import common, step

HEADS, F_IN, HIDDEN = step.HEADS, step.F_IN, 64
D = HIDDEN // HEADS
C = HEADS * D
SLOPE = 0.2
IT = 4  # f32
REPS, QUICK_REPS = 14, 8
IMPLS = ("kernel", "plain")
# label -> (impl, compact + multiply-first, forward only); breakdown.py's
# "pallas" and "xla" read "kernel" and "plain"
E2E = {
    "kernel compact+multfirst (headline)": ("kernel", True, False),
    "kernel compact+multfirst fwd only": ("kernel", True, True),
    "kernel plain": ("kernel", False, False),
    "plain plain": ("plain", False, False),
}
QUICK_E2E = 2
# the kernels a call of each kernel row launches (none: no kernel runs;
# the host-offset typed linears multiply with torch.matmul): the sorted
# segment sum in every gather's backward, the fused ops' z and z*feat,
# the packed sum; the grouped dW in the plain model's attention gradients
# (edge_rel_inner); the packed compact op's three walks and its d_er sum
# in the compact multiply-first rows.  The end-to-end rows' inputs take no
# gradient, as in bench.step
LAUNCHES_A_CALL = {
    "compact_typed_linear src grad": {"seg_sum_sorted": 1},
    "edge_typed_linear src grad": {"seg_sum_sorted": 1},
    "expand_compact el (EP,H) fwd+grad": {"seg_sum_sorted": 2},
    "expand_compact grad (scatter into compact)": {"seg_sum_sorted": 1},
    "relational_fused_gat fwd": {"seg_sum_sorted": 2},
    "relational_fused_gat grad": {"seg_sum_sorted": 2},
    "hgt_plain_attention fwd": {"seg_sum_sorted": 2},
    "hgt_plain_attention grad": {"seg_sum_sorted": 2},
    "scatter_sum_dst packed (EP,H+HD)": {"seg_sum_sorted": 1},
    "kernel compact+multfirst (headline)": {
        "seg_sum_sorted": 1, "compact_gat_packed_fwd": 1,
        "compact_gat_packed_bwd_dst": 1, "compact_gat_packed_bwd_src": 1},
    "kernel compact+multfirst fwd only": {"compact_gat_packed_fwd": 1},
    "kernel plain": {"seg_sum_sorted": 2, "segment_matmul_dw": 2},
}


class Row(NamedTuple):
    label: str
    call: Callable[[], torch.Tensor]
    bytes: float
    flops: float


def sizes(g) -> Dict[str, int]:
    """The graph's sizes the byte and operation models read."""
    return {"EP": g.num_padded_edges, "E": g.num_edges, "N": g.num_nodes,
            "R": g.num_rels, "UCs": g.compact_src.seg.n_rows,
            "UCd": g.compact_dst.seg.n_rows}


def _normal(seed: int, dev: torch.device, *shape) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dev)


def hgt_inputs(g, dev: torch.device,
               msg: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """HGT's plain attention operands on ``g``, each from its own
    ``torch.Generator``: the messages ``msg`` (EP, H, D) (a standard
    normal where not given), q on the nodes and k on the source space
    (0.5 a standard normal), W_att (0.3) and mu (0.5)."""
    R = g.num_rels
    return {"msg": (_normal(7, dev, g.num_padded_edges, HEADS, D)
                    if msg is None else msg),
            "q": _normal(4, dev, g.num_nodes, HEADS, D) * 0.5,
            "k": _normal(5, dev, g.src_space, HEADS, D) * 0.5,
            "watt": _normal(6, dev, R, HEADS, D, D) * 0.3,
            "mu": torch.full((R, HEADS), 0.5, device=dev)}


def inputs(g, x: torch.Tensor, dev: torch.device) -> Dict[str, torch.Tensor]:
    """breakdown.py's operands, each from its own ``torch.Generator``:
    the typed linear's weight and attention (0.1 a standard normal), wa
    their product, the per-edge logits, the intermediates it materializes
    once (the compact projection, its per-edge expansion, the packed
    ``[el | feat]``) and :func:`hgt_inputs` with the expansion as the
    messages."""
    s = sizes(g)
    EP, R = s["EP"], s["R"]
    w = _normal(0, dev, R, HEADS, F_IN, D) * 0.1
    attn = _normal(1, dev, R, HEADS, D) * 0.1
    t = {"x": x, "w": w, "wa": torch.einsum("rhkd,rhd->rhk", w, attn),
         "el": _normal(2, dev, EP, HEADS) * 0.1,
         "er": _normal(3, dev, EP, HEADS) * 0.1}
    with torch.no_grad():
        t["feat_c"] = ops.compact_typed_linear(g, x, w, "src", impl="plain")
        t["feat_e"] = ops.expand_compact(g, t["feat_c"], "src", impl="plain")
        t["packed"] = torch.cat([t["el"], t["feat_e"].reshape(EP, C)], 1)
    t.update(hgt_inputs(g, dev, msg=t["feat_e"]))
    return t


def _grad(fn, a):
    """The gradient of ``sum(fn(a) ** 2)`` with respect to ``a``."""
    def run():
        a_ = a.detach().requires_grad_()
        return torch.autograd.grad(fn(a_).square().sum(), a_)[0]
    return run


def _grad_w(fn, x, w):
    """The gradient of ``sum(fn(x, w) ** 2)`` with respect to ``w``."""
    def run():
        w_ = w.detach().requires_grad_()
        return torch.autograd.grad(fn(x, w_).square().sum(), w_)[0]
    return run


def op_rows(g, t: Dict[str, torch.Tensor], impl: str) -> List[Row]:
    """breakdown.py's 16 op rows on ``impl``, in its order, each with its
    byte and operation model."""
    s = sizes(g)
    EP, N, UCs = s["EP"], s["N"], s["UCs"]
    H = HEADS
    x, w, wa = t["x"], t["w"], t["wa"]
    el, er, fc, fe = t["el"], t["er"], t["feat_c"], t["feat_e"]
    kw = dict(impl=impl)

    def ctl(xx, ww=w):
        return ops.compact_typed_linear(g, xx, ww, "src", **kw)

    def etl(xx):
        return ops.edge_typed_linear(g, xx, w, "src", **kw)

    def logit(xx, ww=wa):
        return ops.compact_typed_linear(g, xx, ww[..., None], "src", **kw)

    def expand(c):
        return ops.expand_compact(g, c, "src", **kw)

    def gat(f):
        return ops.relational_fused_gat(g, f, el, er, SLOPE, **kw)

    def hgt(m):
        return ops.hgt_plain_attention(g, m, t["q"], t["k"], t["watt"],
                                       t["mu"], stable="clip", **kw)

    gat_bytes = (EP * C + 2 * EP * H + N * C + N * H) * IT
    hgt_bytes = (2 * N * C + 2 * EP * C + EP * C + N * C + N * H) * IT
    return [
        Row("compact_typed_linear src fwd", lambda: ctl(x),
            (N * F_IN + UCs * F_IN + UCs * C) * IT, 2.0 * UCs * H * F_IN * D),
        Row("compact_typed_linear src grad", _grad(ctl, x),
            (N * F_IN + 3 * UCs * F_IN + 3 * UCs * C) * IT,
            6.0 * UCs * H * F_IN * D),
        Row("edge_typed_linear src fwd", lambda: etl(x),
            (N * F_IN + EP * F_IN + EP * C) * IT, 2.0 * EP * H * F_IN * D),
        Row("edge_typed_linear src grad", _grad(etl, x),
            (N * F_IN + 3 * EP * F_IN + 3 * EP * C) * IT,
            6.0 * EP * H * F_IN * D),
        Row("compact_typed_linear dW (wrt w)", _grad_w(ctl, x, w),
            (N * F_IN + UCs * F_IN + 2 * UCs * C) * IT,
            4.0 * UCs * H * F_IN * D),
        Row("compact wa-logit dW (wrt wa)", _grad_w(logit, x, wa),
            (N * F_IN + UCs * F_IN + 2 * UCs * H) * IT,
            4.0 * UCs * H * F_IN),
        Row("compact wa-logit fwd (el_c)", lambda: logit(x),
            (N * F_IN + UCs * F_IN + UCs * H) * IT, 2.0 * UCs * H * F_IN),
        Row("expand_compact el (EP,H) fwd+grad",
            _grad(lambda xx: expand(logit(xx)[..., 0]), x),
            (N * F_IN + 3 * UCs * F_IN + 4 * EP * H) * IT, 0.0),
        Row("expand_compact (UC,H,D)->(EP,H,D) fwd", lambda: expand(fc),
            (UCs * C + EP * C) * IT, 0.0),
        Row("expand_compact grad (scatter into compact)", _grad(expand, fc),
            (UCs * C * 3 + EP * C * 2) * IT, 0.0),
        Row("relational_fused_gat fwd", lambda: gat(fe), gat_bytes, 0.0),
        Row("relational_fused_gat grad", _grad(gat, fe), 3 * gat_bytes,
            0.0),
        Row("hgt_plain_attention fwd", lambda: hgt(t["msg"]), hgt_bytes,
            2.0 * EP * H * D * D + 2.0 * EP * C),
        Row("hgt_plain_attention grad", _grad(hgt, t["msg"]), 3 * hgt_bytes,
            6.0 * EP * H * D * D),
        Row("scatter_sum_dst packed (EP,H+HD)",
            lambda: ops.scatter_sum_dst(g, t["packed"], **kw),
            (EP * (C + H) + N * (C + H)) * IT, 0.0),
        Row("gather x[src] (EP,F_IN)", lambda: ops.gather_src(g, x, **kw),
            (N * F_IN + EP * F_IN) * IT, 0.0),
    ]


def bound_ms(nbytes: float, flops: float, peaks: Dict[str, float]):
    """``(bound ms, what bounds it)``: the larger of ``nbytes`` at the
    memory rate and ``flops`` at the f32 rate (breakdown.py's
    ``ideal_ms``)."""
    t_mem = nbytes / (peaks["hbm_gbps"] * 1e9)
    t_ops = flops / (peaks["f32_tflops"] * 1e12)
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def _timed(fn, dev, reps, flush, label, impl) -> Dict[str, Any]:
    """``common.time_call`` of ``fn`` over ``reps`` calls (after two
    untimed ones) and, for a kernel row, the kernels it launched a
    call."""
    before = kernels.launch_counts()
    timing = common.time_call(fn, dev, reps, flush)
    launches = (common.launches_between(before, 2 + reps, label)
                if impl == "kernel" else {})
    return {**timing, "launches_a_call": launches}


def e2e_call(data, g, x, labels, dev, impl: str, compact_multfirst: bool,
             fwd_only: bool):
    """bench.step's model (seeded) and its call: the forward alone (no
    gradient kept) or the forward and backward into the parameters.
    Returns ``(model, call)``."""
    net = step.model(data, impl, compact_multfirst).to(dev).train()
    if not fwd_only:
        return net, common.make_step(net, g, x, labels)

    def forward():
        with torch.no_grad():
            return net(g, x)
    return net, forward


def _hold_e2e(label, kernel, plain, fwd_only: bool) -> float:
    """A kernel end-to-end row's first call against the plain versions'
    (``(model, call)`` each): the logits, or the loss and gradients."""
    if fwd_only:
        return common.check_close(label, kernel[1](), plain[1](),
                                  common.TRAIN_RTOL)
    return common.hold(label, common.first_step(*kernel),
                       common.first_step(*plain), "float32")


def run(scale: float = step.DEFAULT_SCALE, device: str = "cuda", *,
        quick: bool = False, out: Optional[str] = None,
        peaks: Optional[Dict[str, float]] = None) -> List[Dict[str, Any]]:
    """Every row (printed as it is measured), then the closing line."""
    t_start = time.perf_counter()
    dev = common.setup(device)
    peaks = common.peaks_of(dev, peaks)
    card, clock = common.card_line(dev), common.clock_name(dev)
    data, g, x, labels = step.load(scale, dev)
    reps = QUICK_REPS if quick else REPS
    flush = (torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
             if dev.type == "cuda" else None)
    start = kernels.launch_counts()
    t = inputs(g, x, dev)
    rows_of = {impl: op_rows(g, t, impl) for impl in IMPLS}
    rows: List[Dict[str, Any]] = []

    def emit(row):
        row.update(card=card, clock=clock)
        common.emit(row, out)
        rows.append(row)

    for impl in (("kernel",) if quick else IMPLS):
        for i, r in enumerate(rows_of[impl]):
            label = f"[{impl}] {r.label}"
            gap = None
            if impl == "kernel":
                want = rows_of["plain"][i].call()
                gap = common.check_close(label, r.call(), want,
                                         common.TRAIN_RTOL)
                del want
            b, by = bound_ms(r.bytes, r.flops, peaks)
            m = _timed(r.call, dev, reps, flush, label, impl)
            emit({"op": label, "impl": impl, **m, "bound_ms": b,
                  "bound_by": by, "share_pct": common.share_pct(
                      b, m["ms"], label),
                  "bytes": r.bytes, "flops": r.flops,
                  "kernel_vs_plain_max_rel": gap})
        common.free(dev)

    E = data.graph.num_edges
    for label in list(E2E)[:QUICK_E2E] if quick else E2E:
        impl, cmf, fwd_only = E2E[label]
        call = e2e_call(data, g, x, labels, dev, impl, cmf, fwd_only)
        gap = None
        if impl == "kernel":
            gap = _hold_e2e(label, call, e2e_call(
                data, g, x, labels, dev, "plain", cmf, fwd_only), fwd_only)
        m = _timed(call[1], dev, reps, flush, label, impl)
        emit({"config": label, "impl": impl, **m,
              "medges_per_s": E / m["ms"] / 1e3,
              "kernel_vs_plain_max_rel": gap})
        del call
        common.free(dev)

    total = {k: n - start[k] for k, n in kernels.launch_counts().items()}
    summary = {
        "rows": len(rows), "quick": quick, "scale": scale, **sizes(g),
        "config": {"H": HEADS, "f_in": F_IN, "D": D, "slope": SLOPE,
                   "hgt_stable": "clip", "reps": reps, "dtype": "float32"},
        "peaks": peaks, "launches": total,
        "seconds": time.perf_counter() - t_start, "card": card,
        "clock": clock}
    common.emit(summary, out)
    return rows + [summary]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.breakdown",
        description="Per-op times against their bounds (breakdown.py's).")
    p.add_argument("--scale", type=float, default=step.DEFAULT_SCALE)
    p.add_argument("--quick", action="store_true",
                   help="kernel rows only, fewer calls, two end-to-end rows")
    args = common.parse(p, argv)
    run(args.scale, args.device, quick=args.quick, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
