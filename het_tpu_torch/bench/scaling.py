"""Data-parallel step time at several world sizes (counterpart of
``scripts/bench_scaling.py``).

    python -m het_tpu_torch.bench.scaling [--ranks 1 2] [--scale 0.05]
        [--n_infeat 32] [--steps 10] [--device cuda|cpu] [--out FILE]

Uniform random ogbn-mag at ``--scale`` (its published nodes, edges and 4
relations times the scale, from ``np.random.default_rng(0)``), one
``RGATLayer`` from ``--n_infeat`` to as many features with 4 heads and the
exact max softmax (het_tpu's ``stable_softmax=True``), partitioned into
as many destination ranges as ranks (``tile=128``, the all-gather halo).
A step: loss ``sum(out²)·1e-6`` over every rank's rows, its gradients
summed over the ranks, Adam at 1e-3; one settling step, then ``--steps``
timed ones with CUDA events on rank 0 (the host clock on the CPU).  Each
world gives its step ms (its timed steps' sum over their count), edges/s and
``scaling_efficiency`` (edges/s over the first world's times the world
size), with the median step and the spread beside them, and its first
timed loss through the kernels is held to the plain versions' run from
the same parameters within ``TRAIN_RTOL``.

All worlds run in one spawn of the largest world's ranks: a world of ``w``
trains over the group of ranks ``0 .. w-1`` while the others wait.  A
world past the machine's CPU cores (a process a rank) is skipped.  Ranks
that outnumber the cards share ``cuda:0`` over gloo
(``parallel.dp.setup_rank``), and then the closing JSON says that its
figures are not scaling figures, as het_tpu's note tells virtual devices
from hardware; only one card a rank over NCCL gives one.
"""

from __future__ import annotations

import argparse
import os
import statistics
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.loaders import SYNTH_SCALES
from ..models import RGATLayer
from ..parallel import DPGNN, partition_by_dst, sum_grads
from ..parallel.launch import spawn_ranks
from ..train.loop import train_steps
from . import common

HEADS, LR, SETTLE = 4, 1e-3, 1
SHARED = "ranks share one card over gloo: not a scaling figure"
OWN = "one card a rank over NCCL"
HOST = "ranks share the host's CPU over gloo: not a scaling figure"


def _layer(f: int, r: int, impl: str) -> RGATLayer:
    return RGATLayer(f, f, r, HEADS, dropout=0.0, stable_softmax="max",
                     impl=impl)


def scaling_job(rank: int, dev: torch.device, job: Dict) -> Dict:
    """One world's training on ranks ``0 .. world-1`` (every rank makes
    the world's group; the rest wait for them)."""
    w = job["world"]
    group = dist.new_group(list(range(w)))
    out: Dict[str, Any] = {}
    if rank < w:
        per = job["nodes_per_part"]
        shard = job["shards"][rank].to(dev)
        x_loc = torch.as_tensor(
            job["x"][rank * per:(rank + 1) * per]).to(dev)
        dp = DPGNN([_layer(job["f"], job["r"], job["impl"])],
                   impl=job["impl"], group=group)
        dp.load_state_dict(job["state"])
        dp = dp.to(dev).train()

        def step_loss():
            local = dp(shard, x_loc).square().sum() * 1e-6
            value = local.detach().clone()
            dist.all_reduce(value, group=group)
            return local, value

        out = train_steps(dp, step_loss, steps=job["steps"], lr=LR,
                          warmup=SETTLE, device=dev,
                          after_backward=lambda: sum_grads(dp, group))
    dist.barrier()
    return out


def scaling_jobs(ranks: Sequence[int] = (1, 2), scale: float = 0.05, *,
                 n_infeat: int = 32, steps: int = 10
                 ) -> Tuple[List[Dict], Dict[str, Any]]:
    """The jobs of every world in ``ranks`` that fits the machine's cores,
    a plain one (one step) and a kernel one (``steps`` timed) each, run by
    :func:`scaling_job` (the jobs name it, so they may share a spawn of at
    least the largest world's ranks with other jobs), and what
    :func:`summarize` needs of them."""
    n, e, r = SYNTH_SCALES["mag"]
    n, e = int(n * scale), int(e * scale)
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    f = n_infeat
    worlds = [w for w in ranks if w <= (os.cpu_count() or 1)]
    skipped = [w for w in ranks if w not in worlds]
    if not worlds:
        raise common.BenchFailure(f"no world of {list(ranks)} fits "
                                  f"{os.cpu_count()} cores")
    state = common.seeded_state(DPGNN([_layer(f, r, "plain")]))
    jobs: List[Dict] = []
    for w in worlds:
        shards, info = partition_by_dst(src, dst, rel, n, r, w, tile=128)
        x = info.pad_node_data(
            rng.standard_normal((n, f), dtype=np.float32))
        for impl, k in (("plain", 1), ("kernel", steps)):
            jobs.append(dict(world=w, impl=impl, steps=k, shards=shards,
                             nodes_per_part=info.nodes_per_part, x=x, f=f,
                             r=r, state=state, job_fn=scaling_job))
    meta = dict(edges=e, nodes=n, scale=scale, n_infeat=f,
                skipped_worlds=skipped, world=max(worlds))
    return jobs, meta


def summarize(jobs: List[Dict], results: List[Dict], meta: Dict[str, Any],
              dev: torch.device, out: Optional[str] = None
              ) -> Dict[str, Any]:
    """Rank 0's results of :func:`scaling_jobs`' jobs (``results[i]`` for
    ``jobs[i]``) as rows and the closing JSON, each emitted.  A world's
    ``step_ms`` is its timed steps' sum over their count, the whole
    window as ``bench_scaling.py`` times it, and its edges/s and
    ``scaling_efficiency`` follow from it; the median and the spread
    ((max - min) / median) are extra fields."""
    card = common.card_line(dev)
    e = meta["edges"]
    rows, base = [], None
    for i in range(0, len(jobs), 2):
        w = jobs[i]["world"]
        plain, kern = results[i], results[i + 1]
        gap = common.check_close(f"world {w} loss",
                                 torch.tensor(kern["loss_list"][0]),
                                 torch.tensor(plain["loss_list"][0]),
                                 common.TRAIN_RTOL)
        times = kern["step_ms_list"]
        ms = sum(times) / len(times)
        median = statistics.median(times)
        eps = e / (ms / 1e3)
        base = base or eps
        row = {"world": w, "step_ms": ms, "median_step_ms": median,
               "spread": (max(times) - min(times)) / median,
               "step_ms_list": times, "edges_per_s": eps,
               "scaling_efficiency": eps / (base * w),
               "kernel_vs_plain_max_rel": gap,
               "plain_step_ms": plain["step_ms_list"][0],
               "backend": kern["backend"], "device": kern["device"],
               "card": card, "clock": common.clock_name(dev)}
        rows.append(row)
        common.emit(row, out)
    note = (HOST if dev.type != "cuda" else
            OWN if all(r["backend"] == "nccl" for r in rows) else SHARED)
    summary = {"note": note, "edges": e, "nodes": meta["nodes"],
               "scale": meta["scale"], "n_infeat": meta["n_infeat"],
               "skipped_worlds": meta["skipped_worlds"], "card": card,
               "clock": common.clock_name(dev), "results": rows}
    common.emit(summary, out)
    return summary


def run(ranks: Sequence[int] = (1, 2), scale: float = 0.05,
        device: str = "cuda", *, n_infeat: int = 32, steps: int = 10,
        out: Optional[str] = None) -> Dict[str, Any]:
    dev = common.setup(device)
    jobs, meta = scaling_jobs(ranks, scale, n_infeat=n_infeat, steps=steps)
    with tempfile.TemporaryDirectory() as workdir:
        results = spawn_ranks(meta["world"], jobs, workdir=workdir,
                              device=device)
    return summarize(jobs, results[0], meta, dev, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.scaling",
        description="Data-parallel RGAT step time at several world sizes "
                    "(bench_scaling.py's).")
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--n_infeat", type=int, default=32)
    p.add_argument("--steps", type=int, default=10)
    args = common.parse(p, argv)
    run(args.ranks, args.scale, args.device, n_infeat=args.n_infeat,
        steps=args.steps, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
