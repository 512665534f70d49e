"""Full-graph training driver (counterpart of ``het_tpu/train/driver.py``).

Node embeddings feed the model; the loss is the NLL of ``log_softmax`` on
the training nodes; the optimizer is Adam, whose defaults (eps outside the
square root, bias correction) are ``optax.adam``'s.  The run is f32 with
TF32 off.  Each step's loss is printed with its time: CUDA events on the
card, the host clock on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from ..data.loaders import Dataset, load_dataset
from ..models import HGTModel, NodeEmbed, RGATModel, RGCNModel
from ..utils.misc import nll_loss, resolve_device
from .config import TrainConfig
from .loop import train_steps


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
    multiply-first nor ``use_norm`` (het_tpu's trainer passes neither)."""
    g = data.graph
    name = cfg.model.upper()
    if name == "RGAT":
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
    else:
        raise NotImplementedError(
            f"--model {cfg.model}: only RGAT, RGCN and HGT are ported so "
            "far (ROADMAP.md queue 1 lists GAT)"
        )
    return NodeClassifier(
        NodeEmbed(g.num_nodes, cfg.n_infeat, generator=generator), model
    )


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
    with ``cfg.no_warm_up``), as het_tpu's trainer takes them, then
    ``cfg.num_epochs`` timed ones, whose losses and times are returned
    with the metrics.  The warm-up draws its dropout masks from the same
    generator, so a run still repeats exactly.

    ``state`` (a state dict) replaces the seeded initial parameters;
    ``impl="plain"`` runs every kernel's plain PyTorch version on the card
    instead of the kernel, to compare the two.  ``net``, where given, is
    the model trained in place of a new one (``impl`` is then its own), so
    that the caller holds the final parameters."""
    dev = resolve_device(cfg.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if data is None:
        data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                            num_classes=cfg.num_classes, seed=cfg.seed,
                            build_compact=cfg.compact,
                            compact_union=cfg.compact_union)
    if net is None:
        net = build_model(cfg, data, impl=impl,
                          generator=torch.Generator().manual_seed(cfg.seed))
    if state is not None:
        net.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state.items()}
        )
    net.to(dev).train()
    g = data.graph.to(dev)
    train_idx = torch.as_tensor(data.train_idx, device=dev).long()
    labels = torch.as_tensor(data.labels, device=dev).long()[train_idx]
    drop_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)

    def step_loss():
        loss = nll_loss(net(g, generator=drop_gen)[train_idx], labels)
        return loss, loss

    steps = train_steps(net, step_loss, steps=cfg.num_epochs, lr=cfg.lr,
                        device=dev, log=log,
                        warmup=0 if cfg.no_warm_up else cfg.warmup_epochs)
    return {
        "dataset": data.name,
        "model": cfg.model,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        **steps,
        "num_nodes": data.graph.num_nodes,
        "num_edges": data.graph.num_edges,
        "num_rels": data.graph.num_rels,
        "flags": {"compact": cfg.compact,
                  "compact_union": cfg.compact_union,
                  "multiply_first": cfg.multiply_first,
                  "stable_softmax": cfg.stable_softmax,
                  "impl": impl},
        "synthetic_data": data.meta.get("synthetic", False),
    }
