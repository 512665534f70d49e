"""Data-parallel training over destination-partitioned shards.

Counterpart of ``het_tpu/parallel/dp.py`` and of the training step of
``dryrun_multichip`` (``__graft_entry__.py``), on a ``torch.distributed``
process group with one rank a shard.  Per layer:

    h (per, F) --exchange--> h_src (src_space, F)
    h = layer(shard, h_src, x_dst=h)

The exchange is :func:`halo_gather` (every rank's rows, an all-gather) or
:func:`halo_exchange` (only the boundary rows, an all-to-all), picked by
how the shard was partitioned.  Aggregations stay on the rank that owns
the destinations.  After the backward each parameter gradient is summed
over the ranks, in parameter order: the psum that ``shard_map``'s
transpose inserts in the JAX package.  Every collective runs over a
process group, the world unless the caller passes another: a run over
:func:`make_mesh2`'s two-level layout passes the group of its axis pair,
as het_tpu's collectives take ``axis=("host", "chip")``.  The exchange is
not overlapped with the local matmuls (het_tpu leaves that to XLA).

Ranks get their device and group from :func:`setup_rank`: one card each
with NCCL when there are as many cards as ranks, else every rank on
``cuda:0`` with gloo (NCCL refuses two ranks on one card), and gloo on
the CPU.  Gloo takes CUDA tensors for the all-gather, reduce-scatter,
all-to-all and all-reduce used here (PyTorch 2.11), so nothing is staged
through host memory by hand; gloo copies through the host itself.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.hgt import HGTLayer
from ..ops.kernels import seg_sum_sorted
from ..train.loop import train_steps
from ..utils import spans
from ..utils.misc import resolve_device

__all__ = ["setup_rank", "Mesh2", "make_mesh2", "halo_gather",
           "halo_exchange", "halo_bytes", "DPGNN", "masked_nll", "sum_grads",
           "train_dp", "train_full", "CollectiveTimes", "timed_collectives"]


def setup_rank(rank: int, world: int, *, init_method: str,
               device: str = "cuda") -> torch.device:
    """Open the default process group for ``rank`` of ``world`` and pick
    the rank's device: ``make_mesh``'s role.

    ``init_method`` is ``tcp://localhost:<port>`` or ``file://<path>``.
    On the card (``device="cuda"``) rank ``r`` takes ``cuda:r`` and NCCL
    when there are at least ``world`` cards, else ``cuda:0`` and gloo; on
    the CPU the group is gloo."""
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        own = torch.cuda.device_count() >= world
        dev = torch.device("cuda", rank if own else 0)
        torch.cuda.set_device(dev)
        if own:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


@dataclass(frozen=True)
class Mesh2:
    """A rank's place in the two-level ``(host, chip)`` layout."""

    coords: Tuple[int, int]  # this rank's (host, chip)
    host: dist.ProcessGroup  # along the host axis: this chip on every host
    chip: dist.ProcessGroup  # along the chip axis: this host's chips
    pair: dist.ProcessGroup  # both axes, host-major: every rank, in order


def make_mesh2(n_hosts: int, chips_per_host: int) -> Mesh2:
    """The two-level ``(host, chip)`` layout of het_tpu's ``make_mesh2``
    over the world's ranks: rank ``p`` at ``(p // C, p % C)``, so
    contiguous destination ranges, which share the most boundary, stay on
    one host (NVLink) and only the blocks between hosts cross the
    network.  Every rank calls it after :func:`setup_rank`, in the same
    order (groups are made collectively).

    The axis groups are ``dist.new_subgroups_by_enumeration``'s, on the
    world's backend and without a device of their own, so the rank keeps
    the card :func:`setup_rank` gave it (``init_device_mesh("cuda")``
    would set ``cuda:r % cards``, against the rule that ranks
    outnumbering the cards all share ``cuda:0``).  The pair's group is
    the world itself: both axes host-major are rank order, as jax
    flattens ``("host", "chip")``."""
    n = n_hosts * chips_per_host
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {n_hosts} x {chips_per_host} mesh needs {n} "
                         f"ranks, the world has {world}")
    C = chips_per_host
    host, _ = dist.new_subgroups_by_enumeration(
        [list(range(c, n, C)) for c in range(C)])
    chip, _ = dist.new_subgroups_by_enumeration(
        [list(range(h * C, (h + 1) * C)) for h in range(n_hosts)])
    p = dist.get_rank()
    return Mesh2(coords=(p // C, p % C), host=host, chip=chip,
                 pair=dist.group.WORLD)


# ---------------------------------------------------------- collectives

# the kinds of collective call a data-parallel step makes
COLLECTIVES = ("all_gather / reduce_scatter", "all_to_all", "all_reduce")


class CollectiveTimes:
    """Host ms and calls of each kind of collective (``COLLECTIVES``)
    while ``on``.  Each call is timed after a ``torch.cuda.synchronize()``
    and a barrier over its group, up to a synchronize after it: the
    transfer alone, with nothing of the card's queue before it and none of
    the wait for a peer to reach the call.  That wait (the barrier, from
    this rank's arrival to the last rank's) is summed apart in
    ``wait_ms``.  Every rank of the group must time the same calls (the
    barrier is collective)."""

    def __init__(self) -> None:
        self.on = False
        self.ms = dict.fromkeys(COLLECTIVES, 0.0)
        self.calls = dict.fromkeys(COLLECTIVES, 0)
        self.wait_ms = 0.0


_times: Optional[CollectiveTimes] = None


@contextlib.contextmanager
def timed_collectives() -> Iterator[CollectiveTimes]:
    """Within the block, every collective this module makes is timed while
    the yielded :class:`CollectiveTimes` is ``on`` (off at first)."""
    global _times
    if _times is not None:
        raise RuntimeError("collectives are already being timed")
    _times = CollectiveTimes()
    try:
        yield _times
    finally:
        _times = None


def _collective(kind: str, group, call: Callable[[], object]) -> None:
    t = _times
    if t is None or not t.on:
        call()
        return
    card = torch.cuda.is_available() and torch.cuda.is_initialized()
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.barrier(group=group)
    t1 = time.perf_counter()
    call()
    if card:
        torch.cuda.synchronize()
    t.wait_ms += (t1 - t0) * 1e3
    t.ms[kind] += (time.perf_counter() - t1) * 1e3
    t.calls[kind] += 1


# ---------------------------------------------------------------- halo


@spans.function
class _HaloGather(torch.autograd.Function):
    """All-gather of every rank's rows in rank order; the backward is its
    transpose, a reduce-scatter that sums each rank's block."""

    @staticmethod
    def forward(ctx, h_local, group):
        ctx.group = group
        out = h_local.new_empty((dist.get_world_size(group)
                                 * h_local.shape[0],) + h_local.shape[1:])
        src = h_local.contiguous()
        _collective(COLLECTIVES[0], group, lambda: dist.all_gather_into_tensor(
            out, src, group=group))
        return out

    @staticmethod
    def backward(ctx, ct):
        out = ct.new_empty((ct.shape[0] // dist.get_world_size(ctx.group),)
                           + ct.shape[1:])
        src, group = ct.contiguous(), ctx.group
        _collective(COLLECTIVES[0], group, lambda: dist.reduce_scatter_tensor(
            out, src, op=dist.ReduceOp.SUM, group=group))
        return out, None


def halo_gather(h_local: torch.Tensor, group=None) -> torch.Tensor:
    """(per, ...) local rows -> (ranks * per, ...), the padded global node
    space a shard partitioned with ``halo="gather"`` indexes; ``group``
    (the world when None) holds the shards in rank order."""
    return _HaloGather.apply(h_local, group)


@spans.function
class _HaloExchange(torch.autograd.Function):
    """``[own rows | rows received from each rank]``: the own rows by a
    local gather, the rest by an all-to-all of the rows each peer needs.
    The backward sends each received block's cotangent back (the same
    all-to-all) and sums the buffer's cotangent rows into the local rows
    with one sorted segment sum over the shard's ``halo_back_ptr`` /
    ``halo_back_perm`` (the JAX package leaves this scatter to XLA): in a
    fixed order, without atomics, where a row sent to several peers
    returns several cotangents."""

    @staticmethod
    def forward(ctx, h_local, shard, impl, group):
        ctx.shard, ctx.impl, ctx.group = shard, impl, group
        own = h_local.index_select(0, shard.halo_self_idx)
        send = h_local.index_select(0, shard.halo_send_idx.reshape(-1))
        recv = torch.empty_like(send)
        _collective(COLLECTIVES[1], group, lambda: dist.all_to_all_single(
            recv, send, group=group))
        return torch.cat([own, recv], dim=0)

    @staticmethod
    def backward(ctx, ct):
        shard = ctx.shard
        b_self = shard.halo_self_idx.shape[0]
        back = torch.empty_like(ct[b_self:])
        sent, group = ct[b_self:].contiguous(), ctx.group
        _collective(COLLECTIVES[1], group, lambda: dist.all_to_all_single(
            back, sent, group=group))
        slots = torch.cat([ct[:b_self], back])
        dx = seg_sum_sorted(slots.reshape(slots.shape[0], -1),
                            shard.halo_back_ptr, shard.halo_back_perm,
                            impl=ctx.impl)
        return dx.reshape((dx.shape[0],) + ct.shape[1:]), None, None, None


def halo_exchange(h_local: torch.Tensor, shard, *, impl: str = "kernel",
                  group=None) -> torch.Tensor:
    """Boundary-only source exchange for a shard partitioned with
    ``halo="boundary"``: (per, ...) -> (B_self + ranks * B_off, ...), the
    buffer its edges index, over ``group`` (the world when None).
    ``impl`` picks the backward's segment sum (``ops.kernels``)."""
    if shard.halo_send_idx is None:
        raise ValueError("the shard was partitioned without halo='boundary'")
    return _HaloExchange.apply(h_local, shard, impl, group)


def halo_bytes(shard, n_parts: int, feat_width: int, itemsize: int = 4,
               chips_per_host: int = 0) -> Dict[str, object]:
    """Bytes a rank receives per layer for a ``feat_width``-wide exchange:
    the boundary all-to-all's (``bytes``) against the all-gather's
    (``gather_bytes``), host only.

    ``chips_per_host = C > 0`` splits ``bytes`` by link class under
    :func:`make_mesh2`'s layout: the blocks from the rank's C - 1 host
    peers cross NVLink (``intra_host_bytes``), those from the other P - C
    ranks the network between hosts (``inter_host_bytes``); het_tpu's
    ``ici_bytes`` and ``dcn_bytes``."""
    if chips_per_host and n_parts % chips_per_host:
        raise ValueError(f"{n_parts} ranks do not fill hosts of "
                         f"{chips_per_host}")
    per_peer = shard.num_nodes * feat_width * itemsize
    if shard.halo_send_idx is None:
        out = {"mode": "gather", "bytes": (n_parts - 1) * per_peer}
    else:
        per_peer = int(shard.halo_send_idx.shape[-1]) * feat_width * itemsize
        out = {"mode": "boundary", "bytes": (n_parts - 1) * per_peer}
    out["gather_bytes"] = (n_parts - 1) * shard.num_nodes * feat_width \
        * itemsize
    if chips_per_host:
        out["intra_host_bytes"] = (chips_per_host - 1) * per_peer
        out["inter_host_bytes"] = (n_parts - chips_per_host) * per_peer
    return out


# --------------------------------------------------------------- model


class DPGNN(nn.Module):
    """A stack of single-shard layers with a halo exchange before each.

    Takes any layer whose ``forward(g, x, x_dst=...)`` tells source-space
    from destination-space features (``RGATLayer``, ``RGCNLayer``), or
    one that takes its local rows and a ``halo`` hook (``HGTLayer``, as
    het_tpu's ``_is_halo_style``): the layer projects locally and
    exchanges only its projected k and v.  Parameter names are
    ``layers.{i}.*``, those of ``RGATModel``, ``RGCNModel`` and
    ``HGTModel``, so one state dict serves a single-process model and its
    data-parallel twin.  ``impl`` is the layers' (the boundary exchange's
    backward is a kernel too); ``group`` the ranks that hold the shards
    (the world when None), whose collectives the exchanges and
    :func:`train_dp` make."""

    def __init__(self, layers: Sequence[nn.Module], *, impl: str = "kernel",
                 group=None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.impl = impl
        self.group = group

    def exchange(self, shard, h: torch.Tensor) -> torch.Tensor:
        if shard.halo_send_idx is not None:
            return halo_exchange(h, shard, impl=self.impl, group=self.group)
        return halo_gather(h, self.group)

    def forward(self, shard, x_loc: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x_loc
        for i, layer in enumerate(self.layers):
            with spans.span("layer", i):
                if isinstance(layer, HGTLayer):
                    h = layer(shard, h,
                              halo=lambda t: self.exchange(shard, t),
                              generator=generator)
                else:
                    h = layer(shard, self.exchange(shard, h), x_dst=h,
                              generator=generator)
        return h


# ------------------------------------------------------------- training


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               distributed: bool = True, group=None):
    """``-sum(ll * mask) / sum(mask)`` over the rows whose label is not
    -1, both sums taken over every rank of ``group`` (the world when
    None) when ``distributed``.

    Returns ``(local, value)``: ``local`` is this rank's share, whose
    gradient is this rank's part of the gradient of the whole loss (the
    denominator is the global one), and ``value`` the whole loss."""
    logp = F.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    ll = logp.gather(1, labels.clamp(min=0).long()[:, None])[:, 0]
    num = torch.where(mask, ll, torch.zeros_like(ll)).sum()
    sums = torch.stack([num.detach(), mask.sum().float()])
    if distributed:
        _collective(COLLECTIVES[2], group,
                    lambda: dist.all_reduce(sums, group=group))
    return -num / sums[1], -(sums[0] / sums[1])


def sum_grads(module: nn.Module, group=None) -> None:
    """Sum every parameter gradient over the ranks of ``group`` (the world
    when None), in parameter order, so every rank sums the same way; a
    parameter this shard did not reach adds zeros."""
    for p in module.parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        _collective(COLLECTIVES[2], group,
                    lambda: dist.all_reduce(p.grad, group=group))


def train_dp(dp: DPGNN, shard, x_loc: torch.Tensor, labels_loc: torch.Tensor,
             *, steps: int, lr: float = 1e-2,
             log: Optional[Callable[[str], None]] = None) -> Dict[str, List]:
    """``steps`` data-parallel training steps of ``dp`` on this rank's
    ``shard``: masked NLL (labels -1 on unlabelled and padding rows),
    gradients summed over ``dp.group``, the single-process trainer's Adam
    loop (``log`` after each step).  Returns the losses and step times
    (CUDA events on the card; ranks that share a card share its time)."""
    return train_steps(dp, lambda: masked_nll(dp(shard, x_loc), labels_loc,
                                              group=dp.group),
                       steps=steps, lr=lr, device=labels_loc.device, log=log,
                       after_backward=lambda: sum_grads(dp, dp.group))


def train_full(model: nn.Module, g, x: torch.Tensor, labels: torch.Tensor, *,
               steps: int, lr: float = 1e-2) -> Dict[str, List]:
    """The same steps in one process on the unpartitioned graph: the
    reference a data-parallel run is held to."""
    return train_steps(model,
                       lambda: masked_nll(model(g, x), labels,
                                          distributed=False),
                       steps=steps, lr=lr, device=labels.device)
