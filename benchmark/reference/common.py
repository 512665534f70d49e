"""What the plain references share: the edge blocks, the edge softmax
aggregation, the loss, Adam and the three training steps whose readings
the program's are held to.

Plain PyTorch only, from the layer equations; nothing here reads the
program under test.  The per-edge work runs in blocks of edges of one
relation, each under ``torch.utils.checkpoint``, so that a block's
per-edge tensors live only while the block is computed (in the forward,
and again in the backward): the full-size graph then fits on one card
beside the parameters.  Softmax denominators and weighted sums are
``index_add`` into the destinations, so no edge order is assumed.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

CLIP_LOGIT = 60.0  # the configuration's "clip": logits clamped to +-60
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # Adam's defaults
BLOCK_EDGES = 4_000_000  # edges a checkpointed block


@dataclass
class EdgeBlock:
    rel: int
    src: torch.Tensor  # int64 source ids
    dst: torch.Tensor  # int64 destination ids


@dataclass
class RefGraph:
    num_nodes: int
    num_rels: int
    ntype_offsets: Tuple[int, ...]  # node types as contiguous id ranges
    blocks: List[EdgeBlock]


def ref_graph(src: torch.Tensor, dst: torch.Tensor, rel: torch.Tensor,
              num_nodes: int, num_rels: int, ntype_offsets: Sequence[int],
              block_edges: int = BLOCK_EDGES) -> RefGraph:
    """The edges grouped by relation (a stable sort of the COO) and cut
    into blocks of at most ``block_edges``."""
    order = torch.sort(rel, stable=True).indices
    s, d, r = src[order], dst[order], rel[order]
    counts = torch.bincount(r, minlength=num_rels).tolist()
    blocks, lo = [], 0
    for rid, n in enumerate(counts):
        for a in range(lo, lo + n, block_edges):
            b = min(a + block_edges, lo + n)
            blocks.append(EdgeBlock(rid, s[a:b], d[a:b]))
        lo += n
    return RefGraph(num_nodes, num_rels, tuple(int(o) for o in ntype_offsets),
                    blocks)


def softmax_aggregate(graph: RefGraph,
                      edge_fn: Callable[..., Tuple[torch.Tensor,
                                                   torch.Tensor]],
                      inputs: Sequence[torch.Tensor],
                      per_rel: Callable[[int], Sequence[torch.Tensor]],
                      heads: int, width: int) -> torch.Tensor:
    """``out[v] = sum_{dst(e)=v} exp(l_e) m_e / sum_{dst(e)=v} exp(l_e)``
    (0 where ``v`` has no incoming edge), per head: (N, heads, width).
    ``edge_fn(src, dst, *inputs, *per_rel(rel))`` gives a block's logits
    ``l`` (B, heads), already clamped, and messages ``m`` (B, heads,
    width)."""
    N = graph.num_nodes
    like = inputs[0]
    num = like.new_zeros(N, heads, width)
    den = like.new_zeros(N, heads)

    def block(src, dst, *args):
        logit, msg = edge_fn(src, dst, *args)
        z = torch.exp(logit)
        n = like.new_zeros(N, heads, width).index_add(0, dst,
                                                      z[..., None] * msg)
        return n, like.new_zeros(N, heads).index_add(0, dst, z)

    for b in graph.blocks:
        n, d = checkpoint(block, b.src, b.dst, *inputs, *per_rel(b.rel),
                          use_reentrant=False)
        num = num + n
        den = den + d
    ok = den > 0
    return torch.where(ok[..., None],
                       num / torch.where(ok, den, torch.ones_like(den))[
                           ..., None],
                       torch.zeros_like(num))


def type_linear(x: torch.Tensor, w: torch.Tensor,
                offsets: Sequence[int]) -> torch.Tensor:
    """``y[n] = x[n] @ w[type(n)]`` over contiguous type ranges: x (N, K),
    w (T, H, K, O) -> (N, H, O)."""
    T, H, K, O = w.shape
    outs = [x[offsets[t]:offsets[t + 1]] @ w[t].permute(1, 0, 2)
            .reshape(K, H * O) for t in range(T)]
    return torch.cat(outs).view(x.shape[0], H, O)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood under ``log_softmax``."""
    return -torch.log_softmax(logits, -1).gather(
        1, labels[:, None]).mean()


def adam_update(params: Dict[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor],
                state: Dict[str, Dict[str, torch.Tensor]], step: int,
                lr: float) -> None:
    """Adam with bias correction and eps outside the square root, in
    place on ``params``."""
    b1, b2 = ADAM_BETAS
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            st = state.setdefault(name, {"m": torch.zeros_like(p),
                                         "v": torch.zeros_like(p)})
            st["m"].mul_(b1).add_(g, alpha=1 - b1)
            st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (st["v"] / (1 - b2 ** step)).sqrt_().add_(ADAM_EPS)
            p.addcdiv_(st["m"], denom, value=-lr / (1 - b1 ** step))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for CUDA matmuls (the reference's own run is f32
    with TF32 off; its control takes TF32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def train_readings(forward: Callable[[Dict[str, torch.Tensor], RefGraph],
                                     torch.Tensor],
                   params: Dict[str, torch.Tensor], graph: RefGraph,
                   labels: torch.Tensor, train_idx: torch.Tensor, *,
                   lr: float, steps: int = 3, tf32: bool = False,
                   loss_rows: Callable[[torch.Tensor], torch.Tensor]
                   = lambda idx: idx,
                   frozen: Sequence[str] = ()) -> Dict[str, object]:
    """``steps`` full-graph Adam steps from ``params`` (changed in place):
    each step's loss, the first step's gradient norm a leaf, and the norm
    a leaf of the change after the last step.  ``loss_rows`` picks the
    rows the loss is taken over, and Adam leaves the leaves ``frozen``
    unchanged (all of ``train_idx`` and none frozen but in a planted
    fault)."""
    start = {n: p.detach().clone() for n, p in params.items()}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    losses, grad_norms = [], {}
    rows = loss_rows(train_idx)
    with matmul_precision(tf32):
        for step in range(1, steps + 1):
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in params.items()}
            loss = nll(forward(leaves, graph)[rows], labels[rows])
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            losses.append(loss.item())
            if step == 1:
                grad_norms = {n: leaf_norm(g) for n, g in grads.items()}
            del leaves, loss
            adam_update({n: p for n, p in params.items()
                         if n not in frozen}, grads, state, step, lr)
            del grads
    change = {n: leaf_norm(params[n] - start[n]) for n in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}

