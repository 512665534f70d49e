"""The counterparts of ``__graft_entry__.py``: the flagship model's forward
(:func:`entry`) and data-parallel training of a stack of every model
family (:func:`dryrun_multichip`).

    python -m het_tpu_torch.entry [--ranks 4] [--device cuda|cpu]

Prints the forward's output shape, then the dry run's line.  On the card
every rank of the dry run sits on ``cuda:0`` over gloo unless there are as
many cards as ranks (``parallel.dp.setup_rank``'s rule); without a card
``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import math
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .bench.common import TRAIN_RTOL, seeded_state
from .graph import random_heterograph
from .models import RGATModel
from .parallel import DPGNN, halo_bytes, partition_by_dst
from .parallel.launch import job_layers, spawn_ranks
from .utils.misc import resolve_device

# the flagship: 2 layers from 32 features through 32 to 8 classes, 2 heads,
# on 256 nodes and 2048 edges of 4 relations
N_NODES, N_EDGES, N_RELS, F_IN, HIDDEN, CLASSES, HEADS = (256, 2048, 4, 32,
                                                          32, 8, 2)
# the dry run: a graph of 64 nodes and 512 edges a rank, 3 relations, 16
# features, 4 label classes, 80% of the sources in the destination's block
DRY_RELS, DRY_FEAT, DRY_CLASSES, DRY_LOCAL, DRY_LR = 3, 16, 4, 0.8, 1e-2
# het_tpu's one Adam step, and a second whose loss is the one after it
DRY_STEPS = 2


def entry(device: str = "cuda") -> Tuple[Callable, Tuple[Dict, torch.Tensor]]:
    """``(fn, (params, x))``: ``fn(params, x)`` is the flagship
    ``RGATModel``'s forward on ``random_heterograph(256, 2048, 4 relations,
    seed 0, tile 128)`` with the parameters ``params`` (a dict of the
    model's parameter names), as het_tpu's ``entry()`` applies its flax
    model.  ``params`` are the model's own (drawn from a generator seeded
    1), ``x`` standard normal from a generator seeded 0."""
    dev = resolve_device(device)
    g = random_heterograph(N_NODES, N_EDGES, N_RELS, seed=0,
                           tile=128).to(dev)
    model = RGATModel(F_IN, HIDDEN, CLASSES, N_RELS, HEADS, 2, dropout=0.0,
                      generator=torch.Generator().manual_seed(1))
    model = model.to(dev).eval()
    x = torch.randn((g.num_nodes, F_IN),
                    generator=torch.Generator().manual_seed(0)).to(dev)

    def fn(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(model, params, (g, x))

    return fn, (dict(model.named_parameters()), x)


def dryrun_layers(r: int = DRY_RELS, f: int = DRY_FEAT) -> List[Tuple]:
    """het_tpu's dry-run stack as a job's ``layers``: ``RGCNLayer`` (ReLU)
    -> ``HGTLayer`` (one node type, 2 heads) -> compact ``RGATLayer`` (2
    heads, the label classes out)."""
    return [
        ("RGCN", dict(in_feat=f, out_feat=16, num_rels=r,
                      activation="relu")),
        ("HGT", dict(in_dim=16, out_dim=16, num_ntypes=1, num_rels=r,
                     num_heads=2, dropout=0.0)),
        ("RGAT", dict(in_feat=16, out_feat=DRY_CLASSES, num_rels=r,
                      num_heads=2, dropout=0.0, compact=True)),
    ]


def dryrun_mesh(n_ranks: int) -> Optional[Tuple[int, int]]:
    """het_tpu's layout: two hosts of ``n_ranks // 2`` for an even count of
    at least 4, else the flat world (None)."""
    return (2, n_ranks // 2) if n_ranks >= 4 and n_ranks % 2 == 0 else None


def dryrun_jobs(n_ranks: int, *, state: Optional[Dict] = None,
                steps: int = DRY_STEPS, impls=("kernel", "plain"),
                seed: int = 0) -> Tuple[List[Dict], Dict[str, Any]]:
    """The dry run's jobs (one an ``impl``, for ``parallel.launch``) and
    what they share: het_tpu's graph from ``np.random.default_rng(seed)``
    (``n = 64·n_ranks`` nodes, ``512·n_ranks`` edges), partitioned with
    ``tile=8, build_compact=True, halo="auto"``, its padded features and
    labels from the same generator, in het_tpu's order of draws; the
    stack's parameters ``state`` (``seeded_state`` of the stack when
    None).  Returns ``(jobs, meta)``: ``meta`` holds the COO, the
    partition's ``info``, the mesh and the halo's bytes a layer (16
    wide)."""
    rng = np.random.default_rng(seed)
    n, e, r, f = 64 * n_ranks, 512 * n_ranks, DRY_RELS, DRY_FEAT
    dst = rng.integers(0, n, e)
    per_blk = n // n_ranks
    src = np.where(rng.random(e) < DRY_LOCAL,
                   (dst // per_blk) * per_blk + rng.integers(0, per_blk, e),
                   rng.integers(0, n, e))
    rel = rng.integers(0, r, e)
    mesh = dryrun_mesh(n_ranks)
    shards, info = partition_by_dst(src, dst, rel, n, r, n_ranks, tile=8,
                                    build_compact=True, halo="auto")
    hb = halo_bytes(shards[0], n_ranks, f,
                    chips_per_host=mesh[1] if mesh else 0)
    x = info.pad_node_data(rng.standard_normal((n, f), dtype=np.float32))
    labels = info.pad_node_data(
        rng.integers(0, DRY_CLASSES, n).astype(np.int32), fill=-1)
    layers = dryrun_layers(r, f)
    if state is None:
        state = seeded_state(DPGNN(job_layers(dict(layers=layers,
                                                   impl="plain"))))
    base = dict(shards=shards, nodes_per_part=info.nodes_per_part, x=x,
                labels=labels, layers=layers, state=state, steps=steps,
                lr=DRY_LR)
    if mesh is not None:
        base["mesh2"] = mesh
    jobs = [dict(base, impl=impl) for impl in impls]
    meta = dict(src=src, dst=dst, rel=rel, n=n, r=r, info=info, mesh=mesh,
                halo=hb)
    return jobs, meta


def dryrun_check(n_ranks: int, jobs: List[Dict], meta: Dict[str, Any],
                 results: List[List[Dict]]) -> Dict[str, Any]:
    """Hold the dry run's results (``results[rank][i]`` for ``jobs[i]``)
    and print het_tpu's line: every rank's losses finite, one a step, and
    the kernels' within ``TRAIN_RTOL`` of the plain versions' at every
    step, the loss after the first Adam step among them, so that the
    backward's kernels are held too.  Returns the losses, each rank's
    launches and coordinates, the mesh and the halo's bytes."""
    by_impl = {job["impl"]: [results[rank][i] for rank in range(n_ranks)]
               for i, job in enumerate(jobs)}
    steps = jobs[0]["steps"]
    for impl, ranks in by_impl.items():
        for rank, m in enumerate(ranks):
            losses = m["loss_list"]
            if len(losses) != steps or not all(map(math.isfinite, losses)):
                raise AssertionError(f"dryrun_multichip({n_ranks}) {impl} "
                                     f"rank {rank}: losses {losses}")
            if impl == "plain":
                continue
            for step, (a, b) in enumerate(zip(
                    losses, by_impl["plain"][rank]["loss_list"])):
                if abs(a - b) > TRAIN_RTOL * abs(b):
                    raise AssertionError(
                        f"dryrun_multichip({n_ranks}) rank {rank} step "
                        f"{step}: kernel loss {a} against plain {b} (rtol "
                        f"{TRAIN_RTOL})")
    ranks = by_impl["kernel"]
    losses = ranks[0]["loss_list"]
    mesh, hb = meta["mesh"], meta["halo"]
    layout = (f"(host {mesh[0]}, chip {mesh[1]})" if mesh
              else f"(dp {n_ranks})")
    links = (f"intra_host {hb['intra_host_bytes']} B/layer/device, "
             f"inter_host {hb['inter_host_bytes']} B" if mesh
             else f"{hb['bytes']} B/layer/device")
    print(f"dryrun_multichip({n_ranks}): ok, loss={losses[0]:.4f}, mesh="
          f"{layout}, halo={hb['mode']} ({links} vs all-gather "
          f"{hb['gather_bytes']} B)")
    return {"loss": losses[0], "losses": losses,
            "plain_losses": by_impl["plain"][0]["loss_list"], "mesh": mesh,
            "halo": hb, "launches": [m["launches"] for m in ranks],
            "coords": [m.get("coords") for m in ranks],
            "backend": ranks[0]["backend"], "device": ranks[0]["device"]}


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> Dict[str, Any]:
    """Data-parallel Adam steps (lr 1e-2, het_tpu's masked NLL) of
    :func:`dryrun_layers` on ``n_ranks`` spawned ranks, through the
    kernels and through the plain versions from the same parameters:
    het_tpu's one step, and a second whose loss is the one after it.
    :func:`dryrun_check` holds and prints them (it raises unless every
    loss is finite and the two runs agree within ``TRAIN_RTOL``)."""
    resolve_device(device)
    jobs, meta = dryrun_jobs(n_ranks)
    with tempfile.TemporaryDirectory() as workdir:
        results = spawn_ranks(n_ranks, jobs, workdir=workdir, device=device)
    return dryrun_check(n_ranks, jobs, meta, results)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.entry",
        description="The flagship RGAT forward and a data-parallel step of "
                    "the RGCN -> HGT -> RGAT stack (__graft_entry__.py's).")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fn, fargs = entry(args.device)
    with torch.no_grad():
        print("entry() output:", tuple(fn(*fargs).shape))
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
