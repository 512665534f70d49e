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
    python -m het_tpu_torch.utils.profile_step --model RGAT -d mag \
        --dataset_scale 0.1 --num_layers 2 --use_compiler \
        --compact_as_of_node_flag --multiply_among_weights_first_flag \
        --dropout 0

Takes the trainer's flags (``--dtype bfloat16`` profiles a mixed-precision
step; ``--minibatch`` a minibatch batch's step, ``--task link`` a link
epoch; ``--use_compiler`` a compiled model's step), runs six steps and
traces steps 3-5 with
``torch.profiler`` (the trainer's per-step log call advances the
profiler's schedule).  Prints each kernel's device time per step
(averaged over the traced steps), the traced steps' own times (CUDA
events), the device's busy share of them and the rest, the host's share
(the card idle, waiting for the host to issue work).  Then the port's
spans (``utils/spans.py``) of the traced steps by path: calls, device ms
and self ms a step, and for a ``kernel:`` span its bytes, operations and
share of its roofline (the H100 SXM's peaks); and the set-up spans (the
graph build, the kernel libraries' loads, the first step) in host
seconds.  The last line, JSON, holds the same under ``spans``.

A data-parallel job's step is split by :func:`profile_dp` (a job's
``profile`` option, ``parallel/launch.py``): rank 0 traces the same warm
steps, and every rank times each collective call in them on the host,
after a ``torch.cuda.synchronize()`` and a barrier over the call's group
(the wait for the peers timed apart), up to a synchronize after it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from ..parallel.dp import COLLECTIVES, timed_collectives, train_dp
from ..train.config import add_args, config_from_args
from ..train.driver import train
from ..train.link import train_link
from ..train.minibatch import train_minibatch
from . import spans
from .profiling import device_peaks

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
    *((f"compact_gat_packed_{w}", f"compact_gat_packed_{w} (port kernel)")
      for w in ("fwd", "bwd_dst", "bwd_src")),
    ("gemm", "matmul"), ("gemv", "matmul"), ("splitKreduce", "matmul"),
    ("index", "gather / index"), ("gather", "gather / index"),
    ("Cat", "concatenate"),
    ("multi_tensor_apply", "optimizer"),
    ("reduce_kernel", "reductions"),
    ("elementwise", "elementwise"),
    ("Memcpy", "copies"),  # host <-> card (gloo stages a collective so)
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


def _kernel_rows(prof) -> List[Tuple[str, float, int]]:
    """(kernel, device ms a traced step, launches a traced step), largest
    first: kernel rows only, since operator rows and annotations (the
    optimizer's step range) carry their kernels' time again."""
    return sorted(((e.key, _device_us(e) / 1e3 / ACTIVE, e.count // ACTIVE)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith(("Optimizer.", "ProfilerStep"))),
                  key=lambda r: -r[1])


def _categories(rows) -> Dict[str, List]:
    """{category: [device ms, launches]} a traced step."""
    cats = {}
    for key, ms, calls in rows:
        c = cats.setdefault(category(key), [0.0, 0])
        c[0] += ms
        c[1] += calls
    return cats


def _traced():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=WAIT, warmup=WARMUP, active=ACTIVE,
                                     repeat=1))


def profile_dp(dp, shard, x_loc: torch.Tensor, labels: torch.Tensor, *,
               lr: float, trace: bool) -> Dict:
    """``STEPS`` data-parallel training steps (``parallel.dp.train_dp``)
    on this rank.  Every rank times each collective call in the ``ACTIVE``
    steps from step ``WAIT + WARMUP`` on (``parallel.dp.CollectiveTimes``:
    a barrier before each call, so that the wait for the peers is timed
    apart from the transfer; the barrier is collective, so every rank
    takes part).  Where ``trace`` (rank 0), the same steps are traced with
    ``torch.profiler`` and the result gains ``"profile"``: the traced
    steps' ms (CUDA events) and the untraced warm ones', the card's busy
    ms a step in all and by category, the ms a step and calls of each kind
    of collective, the ms a step waiting for the peers at them, and the
    rest of the step, neither a collective, a wait nor this rank's work on
    the card: the host issuing work, and the card's time given to the
    other ranks that share it.  The synchronizes and barriers slow the
    traced steps; the untraced warm steps show by how much."""
    if labels.device.type != "cuda":
        raise ValueError("profile_dp measures the card: its tensors are on "
                         f"{labels.device}")
    first = WAIT + WARMUP
    with contextlib.ExitStack() as stack:
        times = stack.enter_context(timed_collectives())
        prof = stack.enter_context(_traced()) if trace else None
        done = 0

        def log(_):
            nonlocal done
            if prof is not None:
                prof.step()
            done += 1
            times.on = first <= done < first + ACTIVE

        out = train_dp(dp, shard, x_loc, labels, steps=STEPS, lr=lr,
                       log=log)
    if not trace:
        return out
    traced = out["step_ms_list"][first:first + ACTIVE]
    step = sum(traced) / len(traced)
    rows = _kernel_rows(prof)
    cats = {k: v[0] for k, v in _categories(rows).items()}
    busy = sum(cats.values())
    coll = {k: times.ms[k] / ACTIVE for k in COLLECTIVES}
    wait = times.wait_ms / ACTIVE
    out["profile"] = {
        "traced_step_ms": traced, "step_ms": step,
        "untraced_warm_step_ms": [
            ms for i, ms in enumerate(out["step_ms_list"])
            if i and not first <= i < first + ACTIVE],
        "device_busy_ms": busy, "device_ms_by_category": cats,
        "collective_ms": coll,
        "collective_calls": {k: times.calls[k] // ACTIVE
                             for k in COLLECTIVES},
        "collective_wait_ms": wait,
        # the copies are gloo's, inside the collectives' windows
        "rest_ms": (step - sum(coll.values()) - wait
                    - (busy - cats.get("copies", 0.0))),
        "top_kernels": rows[:TOP]}
    return out


def span_table(steps: List[Dict], peaks: Dict[str, float]) -> Dict:
    """The traced steps' spans by path, each total a step (calls, ms,
    self ms; a ``kernel:`` span's launches, bytes, flops and calls by
    operands too, and ``roofline_pct``: its least time, the larger of its
    bytes at the HBM peak and its operations at the f32 peak, over its
    ms)."""
    out: Dict[str, Dict] = {}
    for step in steps:
        for path, t in step.items():
            row = out.setdefault(path, {})
            for k, v in t.items():
                if isinstance(v, dict):  # calls by operands
                    d = row.setdefault(k, {})
                    for key, n in v.items():
                        d[key] = d.get(key, 0) + n / len(steps)
                else:
                    row[k] = row.get(k, 0) + v / len(steps)
    for path, row in out.items():
        if "bytes" in row and row["ms"] > 0:
            least_s = max(row["bytes"] / (peaks["hbm_gbps"] * 1e9),
                          row["flops"] / (peaks["f32_tflops"] * 1e12))
            row["roofline_pct"] = 100 * least_s * 1e3 / row["ms"]
    return dict(sorted(out.items()))


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
    spans.reset()
    with _traced() as prof:
        metrics = trainer(cfg, log=lambda s: (print(s), prof.step()))
    traced = metrics["step_ms_list"][WAIT + WARMUP: WAIT + WARMUP + ACTIVE]
    rows = _kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    step = sum(traced) / len(traced)
    print(f"device: {metrics['device']}")
    print(f"traced steps (CUDA events, ms): {traced}")
    print(f"device busy per step: {busy:.3f} ms of {step:.3f} ms "
          f"({100 * busy / step:.1f}%); host share (device idle) "
          f"{100 * (1 - busy / step):.1f}%")
    cats = _categories(rows)
    print("category | device ms per step | launches per step")
    for cat, (ms, calls) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"{cat} | {ms:.4f} | {calls}")
    print("kernel | device ms per step | launches per step")
    for key, ms, calls in rows[:TOP]:
        print(f"{key[:110]} | {ms:.4f} | {calls}")
    table = span_table(spans.REGISTRY.steps,
                       device_peaks(metrics["device"]))
    print(f"spans of {len(spans.REGISTRY.steps)} traced steps, a step: "
          "path | calls | device ms | self ms | launches | bytes | flops | "
          "roofline %")
    for path, r in table.items():
        kern = (f" | {r['launches']:g} | {r['bytes']:.4g} | "
                f"{r['flops']:.4g} | {r.get('roofline_pct', 0):.2f}"
                if "bytes" in r else "")
        print(f"{path} | {r['calls']:g} | {r['ms']:.4f} | "
              f"{r['self_ms']:.4f}{kern}")
    print("set-up spans: path | calls | host s | counters")
    for path, r in spans.REGISTRY.setup.items():
        extra = {k: v for k, v in r.items() if k not in ("calls", "s")}
        print(f"{path} | {r['calls']} | {r['s']:.3f} | {extra or ''}")
    print(json.dumps({"step_ms": step, "device_busy_ms": busy,
                      "host_share": 1 - busy / step,
                      "categories": {k: v[0] for k, v in cats.items()},
                      "spans": {"traced_steps": len(spans.REGISTRY.steps),
                                "by_path": table,
                                "setup": spans.REGISTRY.setup}}))


if __name__ == "__main__":
    main()
