"""Trainer configuration with the reference's flag spellings.

``het_tpu/train/config.py``'s flags but ``--backend`` (the TPU
backend), plus ``--device``.  ``--use_compiler`` trains RGAT, HGT or
RGCN through the compiled Inter-Op DSL programs (``compiled.py``).  ``--task link`` trains link
prediction (``link.py``), ``--minibatch`` neighbour-sampled minibatches
(``minibatch.py``: ``--batch_size``, ``--fanout``, ``--num_hops``,
``--max_batches``), else full-graph (``driver.py``); ``--tile`` is the
graphs' relation-segment padding.  ``--model`` is RGAT, RGCN, HGT or
GAT, as in het_tpu, or SimpleHGN (HGB's Simple-HGN, the port's own);
``--logfile_enabled`` appends the run's metrics to ``--logfilename`` as
one JSON line.  ``--dtype bfloat16`` trains in mixed precision (f32
master parameters, the model in bf16) with ``--loss_scale`` none, dynamic
or a number; ``--patience`` stops on the training loss;
``--save_every`` / ``--checkpoint_dir`` / ``--resume`` checkpoint and
resume (``train/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class TrainConfig:
    model: str = "RGAT"
    task: str = "entity"  # entity (node classification) | link
    dataset: str = "aifb"
    n_infeat: int = 64
    num_classes: int = 8
    num_heads: int = 1
    num_layers: int = 1
    hidden: int = 64
    lr: float = 1e-2
    num_epochs: int = 10  # timed training steps (full-graph: one an epoch)
    # untimed Adam steps before the timed ones (het_tpu's warm-up, the
    # reference's 5 epochs); none with --no_warm_up
    warmup_epochs: int = 5
    no_warm_up: bool = False
    dropout: float = 0.5
    compact: bool = False  # --compact_as_of_node_flag
    # --compact_union_flag: union-list compact rows (the reference's
    # default Enabled kind: unique (rel, node) over sources and
    # destinations, shared by both attention sides); False: dual-list
    compact_union: bool = False
    multiply_first: bool = False  # --multiply_among_weights_first_flag
    # edge-softmax overflow protection: "clip" (clamp logits to +-60),
    # "max" (the exact max-subtracted softmax) or "raw" (reference parity)
    stable_softmax: str = "clip"
    dataset_scale: float = 1.0  # synthetic stand-in scale (1.0 = published)
    # float32 | bfloat16 (mixed: f32 master parameters, the model in bf16)
    dtype: str = "float32"
    # bf16 loss scaling: "none" | "dynamic" | a number (static)
    loss_scale: str = "none"
    # early stopping on the training loss (0 = off)
    patience: int = 0
    # run the model THROUGH the compiler (train/compiled.py): each layer
    # core a compiled Inter-Op DSL program (parse -> passes -> flag
    # rewrites -> fuse -> Op-Spec schedule -> lowering onto the port's ops)
    use_compiler: bool = False
    # checkpoint every N timed epochs (0 = off) into checkpoint_dir;
    # --resume restarts from its latest step
    save_every: int = 0
    checkpoint_dir: str = "checkpoints"
    resume: bool = False
    seed: int = 0
    # False: neighbour-sampled minibatches (--minibatch)
    full_graph_training: bool = True
    batch_size: int = 1024  # seeds a batch
    fanout: int = 10  # in-edges a node takes a hop
    num_hops: int = 2
    max_batches: int = 100  # across epochs
    tile: int = 128  # relation-segment padding of the graphs
    device: str = "cuda"
    logfile_enabled: bool = False
    logfilename: str = "metrics.json"


def add_args(parser: argparse.ArgumentParser) -> None:
    p = parser
    p.add_argument("--model", type=str, default="RGAT")
    p.add_argument("--task", type=str, default="entity",
                   choices=["entity", "link"])
    p.add_argument("--dataset", "-d", type=str, default="aifb")
    p.add_argument("--n_infeat", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=8)
    p.add_argument("--num_heads", type=int, default=1)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--num_epochs", "-e", type=int, default=10)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--no_warm_up", action="store_true")
    p.add_argument("--compact_as_of_node_flag", action="store_true",
                   dest="compact")
    p.add_argument("--compact_union_flag", action="store_true",
                   dest="compact_union",
                   help="union-list compact rows shared by both attention "
                        "sides (reference CompactAsOfNodeKind::Enabled)")
    p.add_argument("--multiply_among_weights_first_flag",
                   action="store_true", dest="multiply_first")
    p.add_argument("--stable_softmax", type=str, default="clip",
                   choices=["clip", "max", "raw"])
    p.add_argument("--dataset_scale", type=float, default=1.0)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--loss_scale", type=str, default="none",
                   help="bf16 loss scaling: none | dynamic | <float>")
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--use_compiler", action="store_true",
                   help="run the model through the compiled DSL pipeline")
    p.add_argument("--save_every", type=int, default=0,
                   help="checkpoint every N epochs (0 = off)")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint_dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--full_graph_training", action="store_true",
                   default=True)
    p.add_argument("--minibatch", action="store_false",
                   dest="full_graph_training",
                   help="neighbor-sampled minibatch training")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--fanout", type=int, default=10)
    p.add_argument("--num_hops", type=int, default=2)
    p.add_argument("--max_batches", type=int, default=100)
    p.add_argument("--tile", type=int, default=128)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--logfile_enabled", action="store_true")
    p.add_argument("--logfilename", type=str, default="metrics.json")


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in vars(args).items()
                          if k in fields})
