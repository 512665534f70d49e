"""Neighbour-sampled minibatch training (counterpart of
``het_tpu/train/minibatch.py``, the reference's ``--full_graph_training
False`` path).

A trainable table of node features (``num_nodes`` x ``n_infeat``, uniform
on [-0.5, 0.5)) feeds the model, both Adam parameters (the dense Adam
over the whole table, as ``optax.adam`` updates it).  Each batch's seeds
are sampled by :class:`~het_tpu_torch.data.sampling.NeighborSampler` into
a subgraph padded to fixed sizes, the table's rows of its nodes are
gathered (``ops.common.sorted_gather``, whose backward is one sorted
segment sum over a host counting sort of ``node_map``: no atomic
scatter), the model runs on the subgraph and the loss is the NLL of the
seeds' logits.  The draws, the subgraphs' sorts and the table's counting
sort run in the port's host library (``graph/native.py``), and the
sampler's generator is consumed as het_tpu's trainer consumes it (one
draw a batch: the training batches, then the accuracy batches), so both
trainers see the same batches from one ``seed``.  As in het_tpu the
model is built on the full graph, trains with no dropout (het_tpu's step
applies the model deterministically), and a batch's padding nodes read
row 0 and add zero rows to it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..data.loaders import Dataset, load_dataset
from ..data.sampling import NeighborSampler
from ..graph import native
from ..graph.build import round_up
from ..ops.common import sorted_gather, take_rows
from ..utils import spans
from ..utils.misc import (EarlyStopping, exact_matmuls, nll_loss,
                          resolve_device)
from .config import TrainConfig
from .driver import _mean_after_first_quarter, build_model

# at most this many batches of training seeds in the training accuracy
TRAIN_ACC_BATCHES = 32


def minibatch_pads(cfg: TrainConfig):
    """The padded edge and node counts every batch is built to: room for
    the most edges a batch of ``cfg.batch_size`` seeds can take."""
    most = cfg.batch_size * sum(cfg.fanout ** h
                                for h in range(1, cfg.num_hops + 1))
    return (round_up(most + 2048, 2048),
            round_up(most + cfg.batch_size, max(cfg.tile, 128)))


def table_sort(node_map: np.ndarray, num_rows: int):
    """``(ptr, perm)`` of a gather of the table rows ``node_map``: the
    gathered rows stably sorted by table row and the start of each row's
    group, as int32 tensors (the host library's counting sort)."""
    ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(native.bincount(node_map, num_rows), out=ptr[1:])
    perm = native.counting_argsort(node_map, num_rows)
    return (torch.from_numpy(ptr.astype(np.int32)),
            torch.from_numpy(perm.astype(np.int32)))


@dataclasses.dataclass
class Batch:
    """One sampled batch on the device, with its host times in ms."""

    graph: Any
    node_map: np.ndarray  # local id -> node id, padding included
    nodes: torch.Tensor  # node_map on the device (int32)
    ptr: Optional[torch.Tensor]  # the table gather's sort (training only)
    perm: Optional[torch.Tensor]
    draw_ms: float
    build_ms: float
    copy_ms: float


def make_batch(sampler: NeighborSampler, seeds: np.ndarray,
               cfg: TrainConfig, num_rows: int, device: torch.device,
               grad: bool = True) -> Batch:
    """Draw (in the host library), build (with the table gather's sort
    where ``grad``) and copy one batch to ``device``, each part timed on
    the host clock (the copy up to the card's end of it)."""
    pad_edges, pad_nodes = minibatch_pads(cfg)
    t0 = time.perf_counter()
    drawn = sampler.draw(seeds, max_edges=pad_edges, max_nodes=pad_nodes)
    t1 = time.perf_counter()
    sub, node_map = sampler.finalize(
        *drawn, tile=cfg.tile, pad_edges_to=pad_edges,
        pad_nodes_to=pad_nodes, build_compact=cfg.compact)
    ptr = perm = None
    if grad:
        ptr, perm = table_sort(node_map, num_rows)
    t2 = time.perf_counter()
    g = sub.to(device)
    nodes = torch.from_numpy(node_map.astype(np.int32)).to(device)
    if grad:
        ptr, perm = ptr.to(device), perm.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    return Batch(g, node_map, nodes, ptr, perm, (t1 - t0) * 1e3,
                 (t2 - t1) * 1e3, (t3 - t2) * 1e3)


def check_minibatch_config(cfg: TrainConfig) -> None:
    """Raise for the flags the minibatch trainer does not take (het_tpu's
    drops them silently): ``--dtype bfloat16``, ``--save_every``,
    ``--resume`` and ``--compact_union_flag`` (its subgraphs are
    dual-list)."""
    bad = [name for name, on in (
        ("--dtype bfloat16", cfg.dtype != "float32"),
        ("--save_every", cfg.save_every > 0), ("--resume", cfg.resume),
        ("--compact_union_flag", cfg.compact_union)) if on]
    if bad:
        raise ValueError(f"--minibatch does not take {', '.join(bad)}")


def train_minibatch(
    cfg: TrainConfig,
    data: Optional[Dataset] = None,
    *,
    state: Optional[Mapping[str, Any]] = None,
    impl: str = "kernel",
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Train on batches of ``cfg.batch_size`` training seeds, each
    epoch's seeds in the order of ``default_rng(seed + epoch)``'s
    permutation, only full batches, up to ``cfg.max_batches`` batches in
    all; with ``cfg.patience > 0`` stop when an epoch's mean loss has not
    improved for that many epochs.  Then the accuracy of the training
    seeds (at most ``TRAIN_ACC_BATCHES`` batches) and of the whole test
    split (its last batch padded with repeated seeds, left out of the
    count).

    Returns het_tpu's metrics: ``task`` "minibatch_entity", the losses,
    ``n_batches``, ``wall_s``, ``sample_wall_s`` (draw and build of the
    training batches), the sampling sizes, ``train_acc``, ``test_acc``,
    ``embed_trained_delta`` (the largest change of a table entry),
    ``early_stopped`` and the forward, backward and step means over the
    last 3/4 of the batches (CUDA events on the card: the forward up to
    the loss, the backward the rest of the step, Adam included).  Beside
    them the port's own: ``device``, ``step_ms_list``,
    ``forward_ms_list``, the host's ``sample_ms_list`` (draw),
    ``build_ms_list`` and ``copy_ms_list`` (host to card) of the training
    batches, ``timer``, and the peak device memory in MB (``None`` on the
    CPU).

    ``state`` (a state dict of ``embed.embed`` and ``model.*``) replaces
    the seeded initial parameters; ``impl="plain"`` runs every kernel's
    plain PyTorch version on the card instead of the kernel."""
    check_minibatch_config(cfg)
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"
    exact_matmuls()
    if data is None:
        # the full graph's compact tables are never read: each subgraph
        # builds its own
        data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                            num_classes=cfg.num_classes, seed=cfg.seed,
                            tile=cfg.tile, build_compact=False)
    g_full = data.graph
    E, N = g_full.num_edges, g_full.num_nodes
    sampler = NeighborSampler(
        g_full.src[:E].numpy(), g_full.dst[:E].numpy(),
        g_full.rel[:E].numpy(), N, g_full.num_rels, fanout=cfg.fanout,
        num_hops=cfg.num_hops, seed=cfg.seed)
    gen = torch.Generator().manual_seed(cfg.seed)
    net = build_model(dataclasses.replace(cfg, dropout=0.0), data,
                      impl=impl, generator=gen)
    with torch.no_grad():
        net.embed.embed.uniform_(-0.5, 0.5, generator=gen)
    if state is not None:
        net.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    table0 = net.embed.embed.detach().clone()
    net.to(dev).train()
    table, model = net.embed.embed, net.model
    labels = np.asarray(data.labels)
    B = cfg.batch_size

    def logits(batch: Batch) -> torch.Tensor:
        if batch.ptr is None:
            x = take_rows(table, batch.nodes)
        else:
            x = sorted_gather(table, batch.nodes, batch.ptr, batch.perm,
                              impl=impl, sentinel=False)
        return model(batch.graph, x)[:B]

    def accuracy(seeds: np.ndarray, max_batches: Optional[int] = None):
        correct = total = 0
        with torch.no_grad():
            for bi, i in enumerate(range(0, len(seeds), B)):
                if max_batches is not None and bi >= max_batches:
                    break
                s = seeds[i:i + B]
                valid = len(s)
                if valid < B:  # pad the last batch to the batch size
                    s = np.concatenate([s, np.full(B - valid, s[0])])
                batch = make_batch(sampler, s, cfg, N, dev, grad=False)
                pred = logits(batch).argmax(-1)[:valid].cpu().numpy()
                correct += int((pred == labels[s[:valid]]).sum())
                total += valid
        return correct / max(total, 1)

    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr)
    stopper = (EarlyStopping(patience=cfg.patience, mode="min")
               if cfg.patience > 0 else None)
    seeds_all = np.asarray(data.train_idx)
    test_seeds = np.asarray(data.test_idx if data.test_idx is not None
                            else seeds_all)
    losses, step_ms, forward_ms = [], [], []
    draw_ms, build_ms, copy_ms = [], [], []
    n_batches, stopped = 0, False
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for ep in range(cfg.num_epochs):
        order = np.random.default_rng(cfg.seed + ep).permutation(
            len(seeds_all))
        ep_losses = []
        for i in range(0, len(order) - B + 1, B):
            batch = make_batch(sampler, seeds_all[order[i:i + B]], cfg, N,
                               dev)
            y = torch.from_numpy(labels[batch.node_map[:B]]).to(dev)
            step = spans.Step(on_card, first=n_batches == 0)
            with step.phase("zero_grad"):
                opt.zero_grad(set_to_none=True)
            with step.phase("forward"):
                loss = nll_loss(logits(batch), y)
            with step.phase("backward"):
                loss.backward()
            with step.phase("adam"):
                opt.step()
            with step.phase("sync"):
                fwd, bwd = step.ms()
                losses.append(loss.item())
            step.close()
            ep_losses.append(losses[-1])
            step_ms.append(fwd + bwd)
            forward_ms.append(fwd)
            draw_ms.append(batch.draw_ms)
            build_ms.append(batch.build_ms)
            copy_ms.append(batch.copy_ms)
            log(f"batch {n_batches} loss {losses[-1]:.6f} step_ms "
                f"{step_ms[-1]:.3f} draw_ms {batch.draw_ms:.3f} build_ms "
                f"{batch.build_ms:.3f} copy_ms {batch.copy_ms:.3f}")
            del batch
            n_batches += 1
            if n_batches >= cfg.max_batches:
                break
        if stopper is not None and ep_losses and stopper.update(
                float(np.mean(ep_losses)), ep):
            stopped = True
            break
        if n_batches >= cfg.max_batches:
            break
    wall = time.perf_counter() - t0
    peak_mb = (torch.cuda.max_memory_allocated(dev) / 1e6 if on_card
               else None)
    net.eval()
    train_acc = accuracy(seeds_all, TRAIN_ACC_BATCHES)
    test_acc = accuracy(test_seeds)
    net.train()
    delta = (table.detach().cpu() - table0).abs().max().item()
    backward_ms = [t - f for t, f in zip(step_ms, forward_ms)]
    return {
        "task": "minibatch_entity",
        "dataset": data.name,
        "model": cfg.model,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "loss_list": losses,
        "n_batches": n_batches,
        "wall_s": wall,
        "sample_wall_s": (sum(draw_ms) + sum(build_ms)) / 1e3,
        "batch_size": B,
        "fanout": cfg.fanout,
        "num_hops": cfg.num_hops,
        "train_acc": train_acc,
        "test_acc": test_acc,
        "embed_trained_delta": delta,
        "early_stopped": stopped,
        "mean_forward_time": _mean_after_first_quarter(forward_ms),
        "mean_backward_time": _mean_after_first_quarter(backward_ms),
        "mean_training_time": _mean_after_first_quarter(step_ms),
        "step_ms_list": step_ms,
        "forward_ms_list": forward_ms,
        "sample_ms_list": draw_ms,
        "build_ms_list": build_ms,
        "copy_ms_list": copy_ms,
        "timer": "cuda_events" if on_card else "host_clock",
        "max_memory_usage (mb)": peak_mb,
        "flags": {"compact": cfg.compact,
                  "multiply_first": cfg.multiply_first,
                  "stable_softmax": cfg.stable_softmax, "impl": impl},
        "synthetic_data": data.meta.get("synthetic", False),
    }
