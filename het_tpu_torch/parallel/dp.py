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
transpose inserts in the JAX package.

Ranks get their device and group from :func:`setup_rank`: one card each
with NCCL when there are as many cards as ranks, else every rank on
``cuda:0`` with gloo (NCCL refuses two ranks on one card), and gloo on
the CPU.  Gloo takes CUDA tensors for the all-gather, reduce-scatter,
all-to-all and all-reduce used here (PyTorch 2.11), so nothing is staged
through host memory by hand; gloo copies through the host itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.hgt import HGTLayer
from ..ops.kernels import seg_sum_sorted
from ..train.loop import train_steps
from ..utils.misc import resolve_device

__all__ = ["setup_rank", "halo_gather", "halo_exchange", "halo_bytes",
           "DPGNN", "masked_nll", "sum_grads", "train_dp", "train_full"]


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


# ---------------------------------------------------------------- halo


class _HaloGather(torch.autograd.Function):
    """All-gather of every rank's rows in rank order; the backward is its
    transpose, a reduce-scatter that sums each rank's block."""

    @staticmethod
    def forward(ctx, h_local):
        out = h_local.new_empty((dist.get_world_size() * h_local.shape[0],)
                                + h_local.shape[1:])
        dist.all_gather_into_tensor(out, h_local.contiguous())
        return out

    @staticmethod
    def backward(ctx, ct):
        out = ct.new_empty((ct.shape[0] // dist.get_world_size(),)
                           + ct.shape[1:])
        dist.reduce_scatter_tensor(out, ct.contiguous(), op=dist.ReduceOp.SUM)
        return out


def halo_gather(h_local: torch.Tensor) -> torch.Tensor:
    """(per, ...) local rows -> (world * per, ...), the padded global node
    space a shard partitioned with ``halo="gather"`` indexes."""
    return _HaloGather.apply(h_local)


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
    def forward(ctx, h_local, shard, impl):
        ctx.shard, ctx.impl = shard, impl
        own = h_local.index_select(0, shard.halo_self_idx)
        send = h_local.index_select(0, shard.halo_send_idx.reshape(-1))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return torch.cat([own, recv], dim=0)

    @staticmethod
    def backward(ctx, ct):
        shard = ctx.shard
        b_self = shard.halo_self_idx.shape[0]
        back = torch.empty_like(ct[b_self:])
        dist.all_to_all_single(back, ct[b_self:].contiguous())
        slots = torch.cat([ct[:b_self], back])
        dx = seg_sum_sorted(slots.reshape(slots.shape[0], -1),
                            shard.halo_back_ptr, shard.halo_back_perm,
                            impl=ctx.impl)
        return dx.reshape((dx.shape[0],) + ct.shape[1:]), None, None


def halo_exchange(h_local: torch.Tensor, shard, *,
                  impl: str = "kernel") -> torch.Tensor:
    """Boundary-only source exchange for a shard partitioned with
    ``halo="boundary"``: (per, ...) -> (B_self + world * B_off, ...), the
    buffer its edges index.  ``impl`` picks the backward's segment sum
    (``ops.kernels``)."""
    if shard.halo_send_idx is None:
        raise ValueError("the shard was partitioned without halo='boundary'")
    return _HaloExchange.apply(h_local, shard, impl)


def halo_bytes(shard, n_parts: int, feat_width: int,
               itemsize: int = 4) -> Dict[str, object]:
    """Bytes a rank receives per layer for a ``feat_width``-wide exchange:
    the boundary all-to-all's against the all-gather's (host only)."""
    gather = (n_parts - 1) * shard.num_nodes * feat_width * itemsize
    if shard.halo_send_idx is None:
        return {"mode": "gather", "bytes": gather, "gather_bytes": gather}
    b_off = int(shard.halo_send_idx.shape[-1])
    return {"mode": "boundary",
            "bytes": (n_parts - 1) * b_off * feat_width * itemsize,
            "gather_bytes": gather}


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
    backward is a kernel too)."""

    def __init__(self, layers: Sequence[nn.Module], *, impl: str = "kernel"):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.impl = impl

    def exchange(self, shard, h: torch.Tensor) -> torch.Tensor:
        if shard.halo_send_idx is not None:
            return halo_exchange(h, shard, impl=self.impl)
        return halo_gather(h)

    def forward(self, shard, x_loc: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x_loc
        for layer in self.layers:
            if isinstance(layer, HGTLayer):
                h = layer(shard, h, halo=lambda t: self.exchange(shard, t),
                          generator=generator)
            else:
                h = layer(shard, self.exchange(shard, h), x_dst=h,
                          generator=generator)
        return h


# ------------------------------------------------------------- training


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               distributed: bool = True):
    """``-sum(ll * mask) / sum(mask)`` over the rows whose label is not
    -1, both sums taken over every rank when ``distributed``.

    Returns ``(local, value)``: ``local`` is this rank's share, whose
    gradient is this rank's part of the gradient of the whole loss (the
    denominator is the global one), and ``value`` the whole loss."""
    logp = F.log_softmax(logits.float(), dim=-1)
    mask = labels >= 0
    ll = logp.gather(1, labels.clamp(min=0).long()[:, None])[:, 0]
    num = torch.where(mask, ll, torch.zeros_like(ll)).sum()
    sums = torch.stack([num.detach(), mask.sum().float()])
    if distributed:
        dist.all_reduce(sums)
    return -num / sums[1], -(sums[0] / sums[1])


def sum_grads(module: nn.Module) -> None:
    """Sum every parameter gradient over the ranks, in parameter order, so
    every rank sums the same way; a parameter this shard did not reach
    adds zeros."""
    for p in module.parameters():
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad)


def train_dp(dp: DPGNN, shard, x_loc: torch.Tensor, labels_loc: torch.Tensor,
             *, steps: int, lr: float = 1e-2) -> Dict[str, List]:
    """``steps`` data-parallel training steps of ``dp`` on this rank's
    ``shard``: masked NLL (labels -1 on unlabelled and padding rows),
    gradients summed over the ranks, the single-process trainer's Adam
    loop.  Returns the losses and step times (CUDA events on the card;
    ranks that share a card share its time)."""
    return train_steps(dp, lambda: masked_nll(dp(shard, x_loc), labels_loc),
                       steps=steps, lr=lr, device=labels_loc.device,
                       after_backward=lambda: sum_grads(dp))


def train_full(model: nn.Module, g, x: torch.Tensor, labels: torch.Tensor, *,
               steps: int, lr: float = 1e-2) -> Dict[str, List]:
    """The same steps in one process on the unpartitioned graph: the
    reference a data-parallel run is held to."""
    return train_steps(model,
                       lambda: masked_nll(model(g, x), labels,
                                          distributed=False),
                       steps=steps, lr=lr, device=labels.device)
