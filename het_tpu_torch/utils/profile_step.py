"""Where a training step's time goes on the card.

    python -m het_tpu_torch.utils.profile_step --model RGAT -d mag \\
        --dataset_scale 0.1 --num_heads 4 --num_layers 2 \\
        [--compact_as_of_node_flag] [--multiply_among_weights_first_flag] \\
        [--compact_union_flag] [--stable_softmax max]
    python -m het_tpu_torch.utils.profile_step --model RGCN -d mag \\
        --dataset_scale 0.1 [--compact_as_of_node_flag]
    python -m het_tpu_torch.utils.profile_step --model GAT -d mag \\
        --dataset_scale 0.1 --num_heads 4 --num_layers 2 --dropout 0
    python -m het_tpu_torch.utils.profile_step --model RGAT -d mag \\
        --dataset_scale 0.1 --num_heads 4 --num_layers 2 \\
        --compact_as_of_node_flag --multiply_among_weights_first_flag \\
        --dropout 0 --dtype bfloat16 --loss_scale dynamic
    python -m het_tpu_torch.utils.profile_step --minibatch -d mag \
        --dataset_scale 0.1 --num_heads 4 --num_layers 2 \
        --compact_as_of_node_flag --multiply_among_weights_first_flag
    python -m het_tpu_torch.utils.profile_step --task link -d fb15k \
        --num_heads 4 --num_layers 2

Takes the trainer's flags (``--dtype bfloat16`` profiles a mixed-precision
step; ``--minibatch`` a minibatch batch's step, ``--task link`` a link
epoch), runs six steps and traces steps 3-5 with
``torch.profiler`` (the trainer's per-step log call advances the
profiler's schedule).  Prints each kernel's device time per step
(averaged over the traced steps), the traced steps' own times (CUDA
events) and the device's busy share of them.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from ..train.config import add_args, config_from_args
from ..train.driver import train
from ..train.link import train_link
from ..train.minibatch import train_minibatch

STEPS, WAIT, WARMUP, ACTIVE = 6, 1, 1, 3
TOP = 30  # kernels listed by name
# kernel-name fragments -> category, first match wins
CATEGORIES = (
    ("SumOp", "seg_sum_sorted (port kernel)"),
    ("MaxOp", "seg_max_sorted (port kernel)"),
    ("strided_copy", "force_rowmajor (port kernel)"),
    ("segment_matmul_dw", "segment_matmul_dw (port kernel)"),
    ("segment_matmul_fwd", "segment_matmul_fwd (port kernel)"),
    ("segment_matmul_dx", "segment_matmul_dx (port kernel)"),
    ("gemm", "matmul"), ("gemv", "matmul"), ("splitKreduce", "matmul"),
    ("index", "gather / index"), ("gather", "gather / index"),
    ("Cat", "concatenate"),
    ("multi_tensor_apply", "optimizer"),
    ("reduce_kernel", "reductions"),
    ("elementwise", "elementwise"),
)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def category(kernel: str) -> str:
    for frag, cat in CATEGORIES:
        if frag in kernel:
            return cat
    return "other"


def main() -> None:
    parser = argparse.ArgumentParser("profile one training step")
    add_args(parser)
    cfg = config_from_args(parser.parse_args())
    cfg.num_epochs = STEPS
    if not cfg.full_graph_training:  # six batches, in one epoch or more
        cfg.max_batches = STEPS
    if torch.device(cfg.device).type != "cuda":
        raise SystemExit("profile_step measures the card: --device cuda")
    trainer = (train_link if cfg.task == "link" else
               train if cfg.full_graph_training else train_minibatch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=WAIT, warmup=WARMUP,
                                   active=ACTIVE, repeat=1)) as prof:
        metrics = trainer(cfg, log=lambda s: (print(s), prof.step()))
    traced = metrics["step_ms_list"][WAIT + WARMUP: WAIT + WARMUP + ACTIVE]
    # kernel rows only: operator rows and annotations (the optimizer's
    # step range) carry their kernels' time again
    rows = sorted(((e.key, _device_us(e) / 1e3 / ACTIVE, e.count // ACTIVE)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith(("Optimizer.", "ProfilerStep"))),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    step = sum(traced) / len(traced)
    print(f"device: {metrics['device']}")
    print(f"traced steps (CUDA events, ms): {traced}")
    print(f"device busy per step: {busy:.3f} ms of {step:.3f} ms "
          f"({100 * busy / step:.1f}%)")
    cats = {}
    for key, ms, calls in rows:
        c = cats.setdefault(category(key), [0.0, 0])
        c[0] += ms
        c[1] += calls
    print("category | device ms per step | launches per step")
    for cat, (ms, calls) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"{cat} | {ms:.4f} | {calls}")
    print("kernel | device ms per step | launches per step")
    for key, ms, calls in rows[:TOP]:
        print(f"{key[:110]} | {ms:.4f} | {calls}")
    print(json.dumps({"step_ms": step, "device_busy_ms": busy,
                      "categories": {k: v[0] for k, v in cats.items()}}))


if __name__ == "__main__":
    main()
