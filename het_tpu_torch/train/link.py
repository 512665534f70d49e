"""Link prediction: an RGAT encoder and a DistMult decoder (counterpart of
``het_tpu/train/link.py``).

A tenth of the edges (the first ``max(E // 10, 1)`` of the seeded
permutation) are the supervision triples; the message graph is built
from the rest.  Learned node embeddings feed the RGAT encoder
(``num_classes = hidden``, at least one layer, no dropout: het_tpu's
``apply`` is deterministic there); a triple ``(s, r, o)`` scores
``<e_s, w_r * e_o>`` and the loss is ``mean softplus(-pos) + mean
softplus(neg)`` over ``neg_ratio`` uniformly corrupted objects a triple.
One Adam step an epoch.

The decoder's gathers send their gradients through the sorted segment
sum, not an atomic scatter: the entity rows of all four index vectors
are one ``sorted_gather`` an epoch, its ``ptr`` / ``perm`` from a stable
sort on the device; the relation rows one ``sorted_gather`` whose
``ptr`` / ``perm`` are built once on the host.  MRR and Hits@10 rank each
triple's object among 100 uniform candidates (counting strictly greater
scores), in chunks of triples so that the candidates' rows never take
more than ``EVAL_CHUNK_BYTES``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.loaders import Dataset, load_dataset
from ..graph.build import build_heterograph
from ..models import NodeEmbed, RGATModel
from ..ops.common import sorted_gather
from ..utils.misc import resolve_device
from .config import TrainConfig
from .loop import _Clock

NEG_RATIO = 4  # corrupted objects a supervision triple
NUM_CANDIDATES = 100
# the candidates' gathered rows a chunk of triples may take in evaluation
EVAL_CHUNK_BYTES = 256 * 2**20


class LinkPredictor(nn.Module):
    """Node embeddings (``embed``), the RGAT encoder (``model``) and the
    DistMult relation vectors (``w_rel``, R x hidden)."""

    def __init__(self, cfg: TrainConfig, num_nodes: int, num_rels: int, *,
                 impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = NodeEmbed(num_nodes, cfg.n_infeat, generator=generator)
        self.model = RGATModel(
            cfg.n_infeat, cfg.hidden, cfg.hidden, num_rels, cfg.num_heads,
            max(cfg.num_layers, 1), compact=cfg.compact,
            multiply_first=cfg.multiply_first, dropout=0.0,
            stable_softmax=cfg.stable_softmax, impl=impl,
            generator=generator)
        self.w_rel = nn.Parameter(
            0.1 * torch.randn(num_rels, cfg.hidden, generator=generator))

    def forward(self, g) -> torch.Tensor:
        return self.model(g, self.embed())


def sort_ptr(idx: torch.Tensor, num_rows: int):
    """``(ptr, perm)`` of a gather of rows ``idx``: the gathered rows
    stably sorted by row and the start of each row's group, int32."""
    perm = torch.sort(idx, stable=True).indices
    ptr = torch.zeros(num_rows + 1, dtype=torch.long, device=idx.device)
    torch.cumsum(torch.bincount(idx, minlength=num_rows), 0, out=ptr[1:])
    return ptr.to(torch.int32), perm.to(torch.int32)


def message_graph(data: Dataset, cfg: TrainConfig):
    """The message graph (on the host) and the supervision triples
    ``(s, r, o)`` (numpy): the first ``max(E // 10, 1)`` edges of
    ``default_rng(cfg.seed)``'s permutation supervise, the rest carry
    messages."""
    g_full = data.graph
    E = g_full.num_edges
    perm = np.random.default_rng(cfg.seed).permutation(E)
    n_sup = max(E // 10, 1)
    sup_idx, msg_idx = perm[:n_sup], perm[n_sup:]
    src, dst, rel = (t[:E].numpy() for t in (g_full.src, g_full.dst,
                                             g_full.rel))
    g = build_heterograph(src[msg_idx], dst[msg_idx], rel[msg_idx],
                          g_full.num_nodes, g_full.num_rels, tile=cfg.tile,
                          build_compact=cfg.compact)
    return g, (src[sup_idx], rel[sup_idx], dst[sup_idx])


def rank_metrics(emb: torch.Tensor, w_rel: torch.Tensor, s: torch.Tensor,
                 r: torch.Tensor, o: torch.Tensor, cand: torch.Tensor):
    """MRR and Hits@10 of the triples ``(s, r, o)`` against candidate
    objects ``cand`` (triples x candidates): a triple's rank is one plus
    the candidates that score strictly above its object.  Computed in
    chunks of triples."""
    rr = hits = 0.0
    step = max(1, EVAL_CHUNK_BYTES // (cand.shape[1] * emb.shape[1]
                                       * emb.element_size()))
    with torch.no_grad():
        for i in range(0, s.shape[0], step):
            sl = slice(i, i + step)
            w = w_rel[r[sl]]
            pos = (emb[s[sl]] * w * emb[o[sl]]).sum(-1)
            e_s = emb[s[sl]] * w
            scores = torch.einsum("bd,bcd->bc", e_s, emb[cand[sl]])
            rank = 1 + (scores > pos[:, None]).sum(1)
            rr += (1.0 / rank.double()).sum().item()
            hits += (rank <= 10).sum().item()
    n = max(s.shape[0], 1)
    return rr / n, hits / n


def check_link_config(cfg: TrainConfig) -> None:
    """Raise for what the link trainer does not take (het_tpu's builds an
    RGAT whatever ``--model`` says and drops the rest silently)."""
    bad = [name for name, on in (
        (f"--model {cfg.model}", cfg.model.upper() != "RGAT"),
        ("--dtype bfloat16", cfg.dtype != "float32"),
        ("--save_every", cfg.save_every > 0), ("--resume", cfg.resume),
        ("--patience", cfg.patience > 0),
        ("--use_compiler", cfg.use_compiler),
        ("--compact_union_flag", cfg.compact_union)) if on]
    if bad:
        raise ValueError(f"--task link does not take {', '.join(bad)}")


def train_link(
    cfg: TrainConfig,
    data: Optional[Dataset] = None,
    *,
    neg_ratio: int = NEG_RATIO,
    negatives: Optional[Callable[[int], Any]] = None,
    state: Optional[Mapping[str, Any]] = None,
    impl: str = "kernel",
    return_state: bool = False,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Train ``cfg.num_epochs`` full-graph Adam steps of link prediction,
    then rank the supervision triples.

    ``negatives(epoch)``, where given, is that epoch's corrupted objects
    (``neg_ratio`` a triple, each triple's together); else a generator on
    the device seeded with ``cfg.seed`` draws them.  ``state`` (a state
    dict of ``embed.embed``, ``model.*`` and ``w_rel``) replaces the
    seeded initial parameters; ``impl="plain"`` runs every kernel's plain
    PyTorch version on the card instead of the kernel.

    Returns het_tpu's metrics (``task`` "link_prediction", the losses,
    ``mrr``, ``hits@10``, ``epochs``, ``wall_s``,
    ``num_supervision_edges``) and the port's own: ``device``,
    ``step_ms_list`` (CUDA events on the card), ``timer`` and the peak
    device memory in MB (``None`` on the CPU).  ``return_state`` adds
    ``_state``: the final encoder output, ``w_rel`` and the triples, as
    numpy arrays."""
    check_link_config(cfg)
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if data is None:
        data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                            seed=cfg.seed, tile=cfg.tile,
                            build_compact=False)
    N, R = data.graph.num_nodes, data.graph.num_rels
    g, triples = message_graph(data, cfg)
    g = g.to(dev)
    sup_s, sup_r, sup_o = (torch.from_numpy(a.astype(np.int64)).to(dev)
                           for a in triples)
    n_sup = sup_s.numel()
    neg_s = sup_s.repeat_interleave(neg_ratio)
    # every triple's relation rows, positive then negative: one sorted
    # gather whose order never changes
    rel_idx = torch.cat([sup_r, sup_r.repeat_interleave(neg_ratio)])
    rel_ptr, rel_perm = sort_ptr(rel_idx.cpu(), R)
    rel_ptr, rel_perm = rel_ptr.to(dev), rel_perm.to(dev)

    net = LinkPredictor(cfg, N, R, impl=impl,
                        generator=torch.Generator().manual_seed(cfg.seed))
    if state is not None:
        net.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    net.to(dev).train()
    neg_gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def step_loss(neg_o: torch.Tensor) -> torch.Tensor:
        emb = net(g)
        ent_idx = torch.cat([sup_s, sup_o, neg_s, neg_o])
        rows = sorted_gather(emb, ent_idx, *sort_ptr(ent_idx, N),
                             impl=impl, sentinel=False)
        w = sorted_gather(net.w_rel, rel_idx, rel_ptr, rel_perm, impl=impl,
                          sentinel=False)
        e_s, e_o, e_ns, e_no = rows.split([n_sup, n_sup, n_sup * neg_ratio,
                                           n_sup * neg_ratio])
        pos = (e_s * w[:n_sup] * e_o).sum(-1)
        neg = (e_ns * w[n_sup:] * e_no).sum(-1)
        return F.softplus(-pos).mean() + F.softplus(neg).mean()

    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr)
    losses, step_ms = [], []
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for ep in range(cfg.num_epochs):
        if negatives is not None:
            neg_o = torch.as_tensor(np.asarray(negatives(ep)),
                                    dtype=torch.int64).to(dev)
        else:
            neg_o = torch.randint(0, N, (n_sup * neg_ratio,), device=dev,
                                  generator=neg_gen)
        clock = _Clock(on_card)
        clock.mark()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(neg_o)
        loss.backward()
        opt.step()
        clock.mark()
        losses.append(loss.item())
        step_ms.append(clock.intervals_ms()[0])
        log(f"epoch {ep} loss {losses[-1]:.6f} step_ms {step_ms[-1]:.3f}")
    wall = time.perf_counter() - t0
    peak_mb = (torch.cuda.max_memory_allocated(dev) / 1e6 if on_card
               else None)
    with torch.no_grad():
        emb = net(g)
    cand = torch.randint(0, N, (n_sup, NUM_CANDIDATES), device=dev,
                         generator=neg_gen)
    mrr, hits10 = rank_metrics(emb, net.w_rel.detach(), sup_s, sup_r, sup_o,
                               cand)
    extra = {}
    if return_state:
        extra["_state"] = {
            "emb": emb.cpu().numpy(),
            "w_rel": net.w_rel.detach().cpu().numpy(),
            "sup": tuple(t.cpu().numpy() for t in (sup_s, sup_r, sup_o)),
        }
    return {
        **extra,
        "task": "link_prediction",
        "dataset": data.name,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "loss_list": losses,
        "mrr": mrr,
        "hits@10": hits10,
        "epochs": cfg.num_epochs,
        "wall_s": wall,
        "num_supervision_edges": int(n_sup),
        "step_ms_list": step_ms,
        "timer": "cuda_events" if on_card else "host_clock",
        "max_memory_usage (mb)": peak_mb,
        "flags": {"compact": cfg.compact,
                  "multiply_first": cfg.multiply_first,
                  "stable_softmax": cfg.stable_softmax, "impl": impl},
        "synthetic_data": data.meta.get("synthetic", False),
    }
