"""One segment sum or two for the fused attention ops' ``[narrow |
wide]`` payloads, measured on one NVIDIA GPU.

    python3 scripts/bench_gat.py [--scale 0.1]

On the synthetic ogbn-mag stand-in (scale 0.1: 2,111,100 edges), on the
same inputs:

1. the segment sum of GAT layer 0's ``[z | z*feat]`` (C = H + H*D = 260
   at 4 heads of 64) as one call against two (``z``, C = 4, then
   ``z*feat``, C = 256: 64 float4 columns, one column pass), over
   ``in_row_ptr`` (the forward) and over ``out_row_ptr`` through
   ``out_perm`` (the backward's source side), each beside its bound
   (bytes at 3.35 TB/s); the two agree within the segment sum's limit
   (rtol 1e-5, atol 1e-5 * max |out|);
2. the whole of that work at every (heads, head width) the port's
   models give it: ``[n | a*b]`` per head, built from ``n``, ``a`` (EP,
   H) and ``b`` (EP, H*D) and summed, either into one (EP, H + H*D)
   buffer and one call or as ``n`` and ``a*b`` in two calls, in both
   directions.  Each form is timed in turns (one, two, two, one, and
   again), each turn the median of 20 launches; printed are the mean of
   the turns, their spread (max - min over the mean) and the ratio of
   the two means.

Prints the card's name and power limit first and one JSON object last.
"""

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench_turns  # noqa: E402
import torch  # noqa: E402

from het_tpu_torch.bench.common import card_line  # noqa: E402
from het_tpu_torch.ops.kernels import seg_sum_sorted  # noqa: E402

HEADS, HIDDEN = 4, 64
SUM_RTOL = 1e-5  # the segment sum's limit against its plain version
# (label, H, D): GAT's layers (4 heads of 64; one head of mag's 8 and of
# arxiv's 40 classes), RGAT's and HGT's (4 heads of 16, then of 2)
WIDTHS = (("GAT l0", 4, 64), ("GAT l1 mag", 1, 8), ("GAT l1 arxiv", 1, 40),
          ("RGAT/HGT l0", 4, 16), ("RGAT/HGT l1", 4, 2))
TURNS = 2  # of (one, two, two, one)


def _directions(g):
    return (("fwd in_row_ptr", g.in_row_ptr, None),
            ("bwd out_row_ptr + out_perm", g.out_row_ptr, g.out_perm))


def _bound_ms(n, read, c, perm):
    nbytes = (read * c * 4 + (4 * read if perm is not None else 0)
              + (n + 1) * 4 + n * c * 4)
    return 1e3 * nbytes / bench_turns.HBM_BYTES_PER_S


def seg_sum_split(g, dev, flush):
    """Part 1: one 260-lane call against the pair, forward and backward
    source side.  Returns {label: {form: ms, bound_ms: ...}}."""
    C, H = HEADS * (1 + HIDDEN), HEADS
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn(g.num_padded_edges, C, device=dev, generator=gen)
    narrow, wide = vals[:, :H].contiguous(), vals[:, H:].contiguous()
    out = {}
    for label, ptr, perm in _directions(g):
        one = seg_sum_sorted(vals, ptr, perm)
        two = torch.cat([seg_sum_sorted(narrow, ptr, perm),
                         seg_sum_sorted(wide, ptr, perm)], dim=1)
        # the kernel's lanes, and so its order of f32 adds, follow C
        torch.testing.assert_close(
            one, two, rtol=SUM_RTOL,
            atol=SUM_RTOL * two.abs().max().item(),
            msg=lambda m: f"{label}: one call and the pair differ: {m}")
        n, read = ptr.numel() - 1, g.num_edges

        def bound(c):
            return _bound_ms(n, read, c, perm)

        t_one = bench_turns.time_ms(lambda: seg_sum_sorted(vals, ptr, perm),
                                    flush)
        t_narrow = bench_turns.time_ms(
            lambda: seg_sum_sorted(narrow, ptr, perm), flush)
        t_wide = bench_turns.time_ms(lambda: seg_sum_sorted(wide, ptr, perm),
                                     flush)
        out[label] = dict(one_call_260_ms=t_one, pair_ms=t_narrow + t_wide,
                          c4_ms=t_narrow, c256_ms=t_wide,
                          bound_260_ms=bound(C),
                          bound_pair_ms=bound(H) + bound(C - H))
        print(f"seg_sum {label}: one call C=260 {t_one:.4f} ms (bound "
              f"{bound(C):.4f}); pair {t_narrow + t_wide:.4f} ms = C=4 "
              f"{t_narrow:.4f} + C=256 {t_wide:.4f} (bounds "
              f"{bound(H):.4f} + {bound(C - H):.4f})")
    return out


def _one_call(n, a, b, ptr, perm):
    EP, H = n.shape
    pay = n.new_empty(EP, H + b.shape[1])
    pay[:, :H] = n
    torch.mul(a[..., None], b.view(EP, H, -1), out=pay[:, H:].view(EP, H, -1))
    red = seg_sum_sorted(pay, ptr, perm)
    return red[:, :H], red[:, H:]


def _two_calls(n, a, b, ptr, perm):
    EP, H = n.shape
    return (seg_sum_sorted(n, ptr, perm),
            seg_sum_sorted((a[..., None] * b.view(EP, H, -1)).view(EP, -1),
                           ptr, perm))


FORMS = {"one": _one_call, "two": _two_calls}


def payload_widths(g, dev, flush):
    """Part 2: the payload's build and sum in one call and in two, at every
    width of ``WIDTHS``, both directions, in turns."""
    EP = g.num_padded_edges
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for label, H, D in WIDTHS:
        n = torch.randn(EP, H, device=dev, generator=gen)
        a = torch.rand(EP, H, device=dev, generator=gen)
        b = torch.randn(EP, H * D, device=dev, generator=gen)
        for direction, ptr, perm in _directions(g):
            key = f"{label} C={H + H * D} {direction}"
            got = {f: FORMS[f](n, a, b, ptr, perm) for f in FORMS}
            for x, y in zip(got["one"], got["two"]):
                torch.testing.assert_close(
                    x, y, rtol=SUM_RTOL, atol=SUM_RTOL * y.abs().max().item(),
                    msg=lambda m: f"{key}: the forms differ: {m}")
            del got
            turns = {f: [] for f in FORMS}
            for f in ("one", "two", "two", "one") * TURNS:
                turns[f].append(bench_turns.time_ms(
                    lambda f=f: FORMS[f](n, a, b, ptr, perm), flush))
            r = {}
            for f, ts in turns.items():
                mean = statistics.mean(ts)
                r[f] = dict(turns_ms=ts, mean_ms=mean,
                            spread=(max(ts) - min(ts)) / mean)
            r["two_over_one"] = r["two"]["mean_ms"] / r["one"]["mean_ms"]
            r["bound_ms"] = _bound_ms(ptr.numel() - 1, g.num_edges,
                                      H + H * D, perm)
            out[key] = r
            print(f"{key}: one call {r['one']['mean_ms']:.4f} ms (spread "
                  f"{100 * r['one']['spread']:.2f}%), two "
                  f"{r['two']['mean_ms']:.4f} (spread "
                  f"{100 * r['two']['spread']:.2f}%), two / one "
                  f"{r['two_over_one']:.4f}; sum bound {r['bound_ms']:.4f}")
        del n, a, b
    return out


def main() -> int:
    parser = argparse.ArgumentParser("one segment sum or two")
    parser.add_argument("--scale", type=float, default=0.1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_gat: no CUDA device", file=sys.stderr)
        return 2
    from het_tpu_torch.data.loaders import load_dataset

    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    data = load_dataset("mag", scale=args.scale, num_classes=8, seed=0,
                        data_roots=())
    g = data.graph.to(dev)
    print(f"graph: {g.describe()}")
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    result = {"card": card, "edges": g.num_edges,
              "seg_sum": seg_sum_split(g, dev, flush),
              "payload_widths": payload_widths(g, dev, flush)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
