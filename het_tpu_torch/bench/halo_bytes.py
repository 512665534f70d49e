"""Bytes a layer's source exchange moves, boundary against all-gather
(counterpart of ``scripts/halo_bytes_report.py``).  Host only: partition
quality is a property of the graph, so this runs without a card.

    python -m het_tpu_torch.bench.halo_bytes [--scale 0.1]
        [--data_dir DIR] [--chips_per_host 4] [--out FILE]

For P in (2, 4, 8) destination ranges, balanced on nodes and on edges,
partitioned with ``halo="boundary"`` (``tile=128``), rank 0's shard gives
a row: its own sources (``b_self``), the rows it receives from each peer
(``b_off``), the MB a rank receives a layer at F = 64 f32 over the
boundary all-to-all and over the all-gather, their ratio, and the
boundary MB split by link class (``parallel.dp.halo_bytes``) when ranks
fill hosts of ``min(--chips_per_host, P)``: NVLink within a host, the
network between hosts.  The graph is the synthetic ogbn-mag stand-in at
``--scale``, or reference-format ``.npy`` COO shards in ``--data_dir``
(``data.loaders.load_npy_shards``).  Prints one JSON line a row and the
report; writes a file only where ``--out`` names one.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

from ..data.loaders import load_dataset, load_npy_shards
from ..parallel import halo_bytes, partition_by_dst
from . import common

PARTS, BALANCES = (2, 4, 8), ("nodes", "edges")
FEAT, ITEMSIZE, TILE = 64, 4, 128


def load_coo(scale: float = 0.1, data_dir: Optional[str] = None):
    """(src, dst, rel, num_nodes, num_rels, description) of the graph."""
    if data_dir:
        g = load_npy_shards(data_dir, tile=TILE, build_compact=False)
        if g is None:
            raise FileNotFoundError(f"no .npy COO shards in {data_dir}")
        what = f"npy shards {data_dir}"
    else:
        g = load_dataset("mag", scale=scale, seed=0, build_compact=False,
                         data_roots=()).graph
        what = f"synthetic mag at {scale}"
    E = g.num_edges
    src, dst, rel = (t[:E].numpy() for t in (g.src, g.dst, g.rel))
    return src, dst, rel, g.num_nodes, g.num_rels, what


def rows(src, dst, rel, n, r, chips_per_host: int = 4):
    """Yields one row a (P, balance)."""
    for p in PARTS:
        c = min(chips_per_host, p)
        for balance in BALANCES:
            t0 = time.perf_counter()
            shards, _ = partition_by_dst(src, dst, rel, n, r, p, tile=TILE,
                                         balance=balance, halo="boundary")
            seconds = time.perf_counter() - t0
            g0 = shards[0]
            hb = halo_bytes(g0, p, FEAT, ITEMSIZE,
                            chips_per_host=c if p % c == 0 else 0)
            row = dict(parts=p, balance=balance,
                       b_self=int(g0.halo_self_idx.shape[0]),
                       b_off=int(g0.halo_send_idx.shape[-1]),
                       boundary_mb=hb["bytes"] / 1e6,
                       gather_mb=hb["gather_bytes"] / 1e6,
                       ratio=hb["gather_bytes"] / max(hb["bytes"], 1),
                       partition_s=seconds)
            if "intra_host_bytes" in hb:
                row.update(chips_per_host=c,
                           intra_host_mb=hb["intra_host_bytes"] / 1e6,
                           inter_host_mb=hb["inter_host_bytes"] / 1e6)
            yield row


def run(scale: float = 0.1, *, data_dir: Optional[str] = None,
        chips_per_host: int = 4, out: Optional[str] = None
        ) -> Dict[str, Any]:
    src, dst, rel, n, r, what = load_coo(scale, data_dir)
    report = []
    for row in rows(src, dst, rel, n, r, chips_per_host):
        report.append(row)
        common.emit(row, out)
    summary = {"graph": f"{what}: n={n} e={len(src)} r={r}",
               "feat_width": FEAT, "itemsize": ITEMSIZE,
               "chips_per_host": chips_per_host, "rows": report}
    common.emit(summary, out)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.halo_bytes",
        description="Boundary against all-gather bytes a layer "
                    "(halo_bytes_report.py's), host only.")
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--chips_per_host", type=int, default=4)
    p.add_argument("--out", default=None,
                   help="append each JSON line to this file as well")
    args = p.parse_args(argv)
    run(args.scale, data_dir=args.data_dir,
        chips_per_host=args.chips_per_host, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
