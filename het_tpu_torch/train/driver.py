"""Full-graph training driver (counterpart of ``het_tpu/train/driver.py``).

Node embeddings feed the model; the loss is the NLL of ``log_softmax`` on
the training nodes; the optimizer is Adam, whose defaults (eps outside the
square root, bias correction) are ``optax.adam``'s.  The run is f32 with
TF32 off, or with ``--dtype bfloat16`` mixed: f32 master parameters and
Adam state, the model run on bf16 copies of the parameters, the loss head
in f32, under ``--loss_scale`` (``scaling.py``), with cuBLAS's reduced-
precision bf16 reductions off (het_tpu's dots accumulate in f32).
``--save_every`` writes checkpoints (``checkpoint.py``), ``--resume``
continues from the latest one, ``--patience`` stops on the training
loss.  Each step's loss is printed with its time: CUDA events on the
card, the host clock on the CPU.  ``train`` returns het_tpu's metrics
(the reference's schema: means over the last 3/4 of the timed steps, the
forward/backward split, memory, train and test accuracy) beside the
port's own keys.
"""

from __future__ import annotations

import json
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from ..data.loaders import Dataset, load_dataset
from ..models import GATModel, HGTModel, NodeEmbed, RGATModel, RGCNModel
from ..utils.misc import EarlyStopping, nll_loss, resolve_device
from .checkpoint import load_checkpoint, save_checkpoint
from .compiled import build_compiled_model
from .config import TrainConfig
from .loop import train_steps
from .scaling import cast_floating


class NodeClassifier(nn.Module):
    """Learned node embeddings (``embed``) feeding a model (``model``)."""

    def __init__(self, embed: NodeEmbed, model: nn.Module):
        super().__init__()
        self.embed = embed
        self.model = model

    def forward(self, g, *, generator: Optional[torch.Generator] = None):
        return self.model(g, self.embed(), generator=generator)


def build_model(cfg: TrainConfig, data: Dataset, *,
                impl: str = "kernel",
                generator: Optional[torch.Generator] = None
                ) -> NodeClassifier:
    """The model ``cfg`` names, with parameters drawn from ``generator``.
    RGCN is het_tpu's trainer's: two layers from the embeddings, whatever
    ``--num_layers`` and ``--num_heads`` say.  HGT is too: neither
    multiply-first nor ``use_norm`` (het_tpu's trainer passes neither).
    GAT is too: at least two layers (``max(--num_layers, 2)``), and
    neither ``--dropout`` nor ``--stable_softmax`` reaches it, so its
    ``feat_drop`` is 0 and its softmax raw; the relational flags change
    nothing.  With ``--use_compiler`` RGAT, HGT and RGCN are the compiled
    models (``compiled.py``), and any other family raises."""
    g = data.graph
    name = cfg.model.upper()
    if cfg.use_compiler:
        model = build_compiled_model(cfg, g, data.num_classes, impl=impl,
                                     generator=generator)
    elif name == "RGAT":
        model = RGATModel(
            cfg.n_infeat, cfg.hidden, data.num_classes, g.num_rels,
            cfg.num_heads, max(cfg.num_layers, 1), compact=cfg.compact,
            multiply_first=cfg.multiply_first, dropout=cfg.dropout,
            stable_softmax=cfg.stable_softmax, impl=impl,
            generator=generator,
        )
    elif name == "RGCN":
        model = RGCNModel(
            g.num_nodes, cfg.hidden, data.num_classes, g.num_rels,
            featureless=False, in_feat=cfg.n_infeat, compact=cfg.compact,
            dropout=cfg.dropout, impl=impl, generator=generator,
        )
    elif name == "HGT":
        model = HGTModel(
            cfg.n_infeat, cfg.hidden, data.num_classes, g.num_ntypes,
            g.num_rels, cfg.num_heads, max(cfg.num_layers, 1),
            dropout=cfg.dropout, compact=cfg.compact,
            stable_softmax=cfg.stable_softmax, impl=impl,
            generator=generator,
        )
    elif name == "GAT":
        model = GATModel(
            cfg.n_infeat, cfg.hidden, data.num_classes, cfg.num_heads,
            max(cfg.num_layers, 2), impl=impl, generator=generator,
        )
    else:
        raise ValueError(f"--model {cfg.model}: RGAT, RGCN, HGT or GAT")
    return NodeClassifier(
        NodeEmbed(g.num_nodes, cfg.n_infeat, generator=generator), model
    )


def _mean_after_first_quarter(xs: List[float]) -> float:
    """The reference's mean over the last 3/4 of the timed steps."""
    tail = xs[len(xs) // 4:]
    return sum(tail) / len(tail) if tail else float("nan")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_forward(net: nn.Module, dtype: torch.dtype):
    """``net``'s forward on its parameters and buffers cast to ``dtype``
    (``torch.func.functional_call``: the cast is differentiable, so the
    gradients reach the f32 masters as f32), or ``net`` itself for f32."""
    if dtype == torch.float32:
        return net

    def forward(*args, **kwargs):
        tensors = cast_floating(
            {**dict(net.named_parameters()), **dict(net.named_buffers())},
            dtype)
        return torch.func.functional_call(net, tensors, args, kwargs)

    return forward


def train(
    cfg: TrainConfig,
    data: Optional[Dataset] = None,
    *,
    state: Optional[Mapping[str, Any]] = None,
    impl: str = "kernel",
    log: Callable[[str], None] = print,
    net: Optional[NodeClassifier] = None,
) -> Dict[str, Any]:
    """Train full-graph: ``cfg.warmup_epochs`` untimed Adam steps (none
    with ``cfg.no_warm_up`` or ``cfg.resume``), as het_tpu's trainer takes
    them, then the timed epochs up to ``cfg.num_epochs``.  The warm-up
    draws its dropout masks from the same generator, so a run still
    repeats exactly.

    With ``cfg.dtype == "bfloat16"`` every forward (the accuracy pass
    too) runs on bf16 copies of the f32 parameters and ``cfg.loss_scale``
    scales the loss.  ``cfg.save_every > 0`` saves a checkpoint every
    ``save_every`` epochs and at the end, under the epoch reached (also
    after an early stop); ``cfg.resume`` restores the latest checkpoint of
    ``cfg.checkpoint_dir`` (parameters, Adam, loss scale, dropout
    generator) and trains the epochs after it, so that the run repeats
    the uninterrupted one; ``cfg.patience > 0`` stops when the step's
    loss has not improved for that many epochs, checked after the save.

    Returns het_tpu's metrics: the losses; the step, forward and backward
    times (CUDA events around the step and at the loss; the backward is
    the rest of the step, Adam included) with their means over the last
    3/4 of the steps; ``train_acc`` / ``test_acc``, the argmax of the
    final logits in eval mode (het_tpu's accuracy applies dropout, so the
    two agree where dropout is 0); the peak device memory and its rise
    over the memory held before the first step, in MB (``None`` on the
    CPU); the graph's sizes and flags.  Beside them the port's own keys:
    ``device``, ``step_ms_list``, ``timer``, ``epochs_done``,
    ``loss_scale_state`` and ``flags["impl"]``.  With
    ``cfg.logfile_enabled`` the metrics are appended to
    ``cfg.logfilename`` as one JSON line.

    ``state`` (a state dict) replaces the seeded initial parameters;
    ``impl="plain"`` runs every kernel's plain PyTorch version on the card
    instead of the kernel, to compare the two.  ``net``, where given, is
    the model trained in place of a new one (``impl`` is then its own), so
    that the caller holds the final parameters."""
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"
    dtype = DTYPES[cfg.dtype]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if data is None:
        data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                            num_classes=cfg.num_classes, seed=cfg.seed,
                            tile=cfg.tile, build_compact=cfg.compact,
                            compact_union=cfg.compact_union)
    if cfg.compact:
        dup = data.graph.compact_duplication("src")
        if dup is not None and dup < 1.5:
            warnings.warn(
                f"--compact_as_of_node_flag: duplication factor {dup:.2f} "
                "(edges per unique (rel, node) pair) is < 1.5 on this "
                "graph; compact materialization mostly adds the expand "
                "indirection here and measured as a net slowdown at this "
                "regime — consider dropping the flag",
                stacklevel=2,
            )
    if net is None:
        net = build_model(cfg, data, impl=impl,
                          generator=torch.Generator().manual_seed(cfg.seed))
    if state is not None:
        net.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()}
        )
    drop_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    resumed = None
    if cfg.resume:
        resumed = load_checkpoint(cfg.checkpoint_dir)
        net.load_state_dict(resumed["model"])
        drop_gen.set_state(resumed["generator"])
    net.to(dev).train()
    forward = model_forward(net, dtype)
    g = data.graph.to(dev)
    labels = torch.as_tensor(data.labels, device=dev).long()
    train_idx = torch.as_tensor(data.train_idx, device=dev).long()
    test_idx = torch.as_tensor(data.test_idx, device=dev).long()
    train_labels = labels[train_idx]
    if on_card:
        torch.cuda.synchronize(dev)
        mem_base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    def step_loss():
        loss = nll_loss(forward(g, generator=drop_gen)[train_idx],
                        train_labels)
        return loss, loss

    stopper = (EarlyStopping(patience=cfg.patience, mode="min")
               if cfg.patience > 0 else None)

    def stop(epoch, loss, snapshot):
        done = stopper is not None and stopper.update(loss, epoch)
        if cfg.save_every > 0 and ((epoch + 1) % cfg.save_every == 0 or done
                                   or epoch + 1 == cfg.num_epochs):
            save_checkpoint(cfg.checkpoint_dir, {
                "model": net.state_dict(), **snapshot(),
                "generator": drop_gen.get_state(), "epoch": epoch + 1,
            }, epoch + 1)
        return done

    steps = train_steps(
        net, step_loss, steps=cfg.num_epochs, lr=cfg.lr, device=dev, log=log,
        warmup=0 if (cfg.no_warm_up or cfg.resume) else cfg.warmup_epochs,
        start=resumed["epoch"] if resumed is not None else 0,
        loss_scale=cfg.loss_scale if dtype == torch.bfloat16 else "none",
        resume=resumed, stop=stop)
    peak_mb = rise_mb = None
    if on_card:
        peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6
        rise_mb = peak_mb - mem_base / 1e6

    net.eval()
    with torch.no_grad():
        pred = forward(g).argmax(-1)
    net.train()

    def accuracy(idx):
        return (pred[idx] == labels[idx]).float().mean().item()

    total = steps["step_ms_list"]
    fwd = steps.pop("forward_ms_list")
    bwd = [t - f for t, f in zip(total, fwd)]
    metrics = {
        "dataset": data.name,
        "model": cfg.model,
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "mean_forward_time": _mean_after_first_quarter(fwd),
        "mean_backward_time": _mean_after_first_quarter(bwd),
        "mean_training_time": _mean_after_first_quarter(total),
        "forward_time_list": fwd,
        "backward_time_list": bwd,
        "training_time_list": list(total),
        **steps,
        "train_acc": accuracy(train_idx),
        "test_acc": accuracy(test_idx),
        "max_memory_usage (mb)": peak_mb,
        "intermediate_memory_usage (mb)": rise_mb,
        "num_nodes": data.graph.num_nodes,
        "num_edges": data.graph.num_edges,
        "num_rels": data.graph.num_rels,
        "flags": {"compact": cfg.compact,
                  "compact_union": cfg.compact_union,
                  "multiply_first": cfg.multiply_first,
                  "stable_softmax": cfg.stable_softmax,
                  "dtype": cfg.dtype,
                  "loss_scale": cfg.loss_scale,
                  "impl": impl},
        "synthetic_data": data.meta.get("synthetic", False),
    }
    if cfg.logfile_enabled:
        with open(cfg.logfilename, "a") as f:
            f.write(json.dumps(metrics) + "\n")
    return metrics
