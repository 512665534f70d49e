"""The device trace of a window, read from ``torch.profiler``.

The profiler (CUPTI on the card) records every kernel, copy and fill the
device ran and every operator the host ran.  From them: the seconds in
which the device ran anything (the union of its intervals), each
category's device seconds by the kernel-name table below, the kernels
that took most time, and the idle gaps between device intervals, each
named by the host operator that overlaps it most (a top-level operator:
the one a thread was in; "host, no operator" where none was), and each
category's count of device intervals (its launches).

``CATEGORIES`` is a copy of the port's ``utils/profile_step.py`` table,
kept here so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

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
    ("Memcpy", "copies"),
)
PORT_KERNELS = tuple(c for _, c in CATEGORIES if c.endswith("(port kernel)"))
TOP = 10  # rows of the breakdown's lists
NAME_CHARS = 96  # a kernel's name as the breakdown keeps it
NO_OP = "host, no operator"
# ranges the profiler marks on the device's timeline around their kernels
# (the optimizer's step), which are not device work of their own
ANNOTATIONS = ("Optimizer.", "ProfilerStep")


def category(kernel: str) -> str:
    for frag, cat in CATEGORIES:
        if frag in kernel:
            return cat
    return "other"


def start(on_card: bool):
    """A started profiler: host operators and, on the card, the device."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.start()
    return prof


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _gap_names(gaps, host_events) -> Dict[str, float]:
    """Each gap's microseconds under the top-level host operator that
    overlaps it most; top-level operators of one thread never overlap, so
    a thread's overlapping ones are one run of its list."""
    by_thread = defaultdict(list)
    for ev in host_events:
        by_thread[ev.thread].append((ev.time_range.start, ev.time_range.end,
                                     ev.name))
    lists = []
    for evs in by_thread.values():
        evs.sort()
        lists.append(([e[1] for e in evs], evs))
    out: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        best, name = 0.0, NO_OP
        for ends, evs in lists:
            i = bisect.bisect_right(ends, a)
            while i < len(evs) and evs[i][0] < b:
                ov = min(b, evs[i][1]) - max(a, evs[i][0])
                if ov > best:
                    best, name = ov, evs[i][2]
                i += 1
        out[name] += b - a
    return out


def summarize(prof) -> Optional[Dict]:
    """The device's busy seconds, each category's device seconds and
    count of intervals, and the breakdown's two lists; None where the trace holds no device interval
    (a host run)."""
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(ANNOTATIONS)]
    if not dev:
        return None
    spans = [(float(e.time_range.start), float(e.time_range.end))
             for e in dev]
    merged = _union(spans)
    busy_us = sum(b - a for a, b in merged)
    by_cat: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    by_kernel: Dict[str, float] = defaultdict(float)
    for e, (a, b) in zip(dev, spans):
        cat = category(e.name)
        by_cat[cat] += (b - a) / 1e6
        launches[cat] += 1
        by_kernel[e.name] += (b - a) / 1e6
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.cpu_parent is None]
    first = min([merged[0][0]] + [float(e.time_range.start) for e in host])
    last = max([merged[-1][1]] + [float(e.time_range.end) for e in host])
    edges = [first] + [x for m in merged for x in m] + [last]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = _gap_names(gaps, host)

    def top(d, scale):
        rows = sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k[:NAME_CHARS], v * scale] for k, v in rows]

    return {"busy_s": busy_us / 1e6, "by_category_s": dict(by_cat),
            "launches_by_category": dict(launches),
            "breakdown": {"device_ops": top(by_kernel, 1.0),
                          "idle_gaps": top(idle, 1e-6)}}

