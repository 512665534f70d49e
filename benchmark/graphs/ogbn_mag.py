"""A heterograph with the shape of OGB's ogbn-mag (Hu et al.,
arXiv:2005.00687).

The traffic file gives the node types (name and count, laid out one type
after another in id order), the relations (name, source type, destination
type, edge count), the training nodes (a type and a count) and the number
of classes comes from the configuration.  Within its type each
destination is drawn with weight ``1 / sqrt(1 + rank)`` over a seeded
permutation of the type's nodes (the law of the port's synthetic
stand-in), sources uniformly over their type; labels are uniform over the
classes.  Every draw comes from one ``torch.Generator`` on ``device``, so
the same seed on the same device gives the same graph; every seed gives
the same counts.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def generate(params: Mapping[str, Any], num_classes: int, seed: int,
             device: torch.device) -> Dict[str, Any]:
    """The COO ``(src, dst, rel)`` (int64 on ``device``), the node-type
    offsets, the relation names, the labels of every node and the
    training nodes (int64 on ``device``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    types = [(name, int(n)) for name, n in params["node_types"]]
    offsets = [0]
    for _, n in types:
        offsets.append(offsets[-1] + n)
    where = {name: (offsets[i], n) for i, (name, n) in enumerate(types)}
    # one degree law a destination type, shared by its relations
    cdf = {}
    for name, n in types:
        w = 1.0 / torch.sqrt(1.0 + torch.randperm(
            n, generator=gen, device=device).double())
        c = torch.cumsum(w, 0)
        cdf[name] = c / c[-1]
    srcs, dsts, rels = [], [], []
    for r, (_, s_type, d_type, count) in enumerate(params["relations"]):
        s_off, s_n = where[s_type]
        d_off, d_n = where[d_type]
        u = torch.rand(int(count), generator=gen, device=device,
                       dtype=torch.float64)
        dst = torch.searchsorted(cdf[d_type], u).clamp_max_(d_n - 1)
        src = torch.randint(0, s_n, (int(count),), generator=gen,
                            device=device)
        srcs.append(src + s_off)
        dsts.append(dst + d_off)
        rels.append(torch.full((int(count),), r, dtype=torch.int64,
                               device=device))
    num_nodes = offsets[-1]
    labels = torch.randint(0, num_classes, (num_nodes,), generator=gen,
                           device=device)
    t_off, t_n = where[params["train_nodes"]["type"]]
    train = torch.randperm(t_n, generator=gen, device=device)
    train_idx = train[: int(params["train_nodes"]["count"])] + t_off
    return {
        "src": torch.cat(srcs), "dst": torch.cat(dsts),
        "rel": torch.cat(rels), "num_nodes": num_nodes,
        "num_rels": len(params["relations"]),
        "ntype_offsets": tuple(offsets),
        "rel_names": tuple(r[0] for r in params["relations"]),
        "labels": labels, "train_idx": train_idx,
    }
