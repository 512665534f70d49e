"""Spans and counters inside the port: one registry, read after a traced
window by the benchmark's per-layer readers and by ``profile_step``.

*When it records.*  Tracing is on while a ``torch.profiler`` (or
``torch.autograd.profiler``, ``emit_nvtx`` included) session records;
the check is one C-level call.  Off, a hot-path span costs that check
and nothing else: no ``record_function``, no CUDA event, nothing
appended.

*Hot-path spans* record only inside a traced step of a trainer's loop
(:class:`Step`).  Each has a name, a parent (a stack a thread) and a start
and an end on two clocks: a profiler range (``record_function``'s, in its
fast form where torch has it) on the host clock that the profiler's
device trace shares, and, on the card, a pair of CUDA events on the
current stream (``perf_counter`` on the CPU).  They are:

* the loop's phases (:data:`PHASES`), top-level ranges ``het.<phase>``
  under the step's root ``step``, which has no range of its own;
* a model's layers, :func:`span` (``layer<i>``);
* the public ops, :func:`op`, in the families ``linear:`` and ``agg:``;
* every ``torch.autograd.Function`` of the port, :func:`function`: CUDA
  events only, since autograd names its own range.  The backward records
  if and only if the forward did, under the op path that ran the forward,
  grafted onto the phase it runs in
  (``step/het.backward/layer0/agg:x/FnBackward``); ancestors that exist
  only so have no calls, no self time, and the sum of their children;
* the kernel wrappers, :func:`kernel` (``kernel:<name>``), which count
  the call's launches, its least bytes and operations, and its operands'
  element types and shapes;
* a part of a Function's forward or backward, :func:`inner` (CUDA events
  only), such as Simple-HGN's ``res_attn``.

:func:`count` adds counters to the innermost open span (an op's blocks
and bytes).

Once a traced step's sync has passed, its events are read into totals by
path: calls, ms (device ms on the card), self ms (ms minus the children's
cover) and a kernel span's ``launches``, ``bytes``, ``flops`` and
``args`` (its calls by operands): one small dict a step in
:attr:`Registry.steps`, holding no tensor.  They are read when the next
traced step has queued its forward, or when a reader asks, so the card
does not wait for the reading.

*Set-up spans* (:func:`setup`: the graph build, each kernel library's
load, a loop's first step) are always recorded, on the host clock, into
totals by path (:attr:`Registry.setup`); they open a range only while
tracing is on.
"""

from __future__ import annotations

import functools
import itertools
import json
import threading
import time
from contextlib import ContextDecorator, nullcontext
from typing import Any, Callable, Dict, List, Optional

import torch

PHASES = ("zero_grad", "forward", "backward", "adam", "sync")
FAMILIES = ("linear", "agg")
ROOT, FIRST = "step", "step.first"
# the three marks a timed step takes, traced or not (the step's start,
# the loss, the end of Adam), and the boundaries only a traced step marks
_MARK_AT = {("zero_grad", 0), ("forward", 1), ("adam", 1)}
_TRACED_AT = {("zero_grad", 1), ("backward", 1)}

_profiling = torch._C._autograd._profiler_enabled
# a profiler range; the fast form where this build of torch has it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.autograd.profiler.record_function
_NULL = nullcontext()


class Registry:
    """What the spans recorded: :attr:`steps`, one dict of totals by path
    a traced step; ``setup``, the set-up spans' totals by path (``calls``,
    ``s`` and their counters), in the order they first opened."""

    def __init__(self):
        self._steps: List[Dict[str, Any]] = []
        # closed steps whose events are still to read: the next traced
        # step reads them once its forward is queued, or a reader does
        self.pending: List[Step] = []
        self.setup: Dict[str, Dict[str, float]] = {}
        self.step: Optional[Step] = None  # the traced step now open
        self.setup_stack: List[str] = []
        self.free_events: List[Any] = []  # CUDA events read, for reuse
        self.local = threading.local()  # .stack: open spans, this thread

    @property
    def steps(self) -> List[Dict[str, Any]]:
        self.flush()
        return self._steps

    def flush(self) -> None:
        """Read the closed steps' events into their totals."""
        while self.pending:
            step = self.pending.pop(0)
            self._steps.append(step.totals())
            self.free_events.extend(step.events)
            step.events, step.recs = [], []

    def stack(self) -> List:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


REGISTRY = Registry()
_step_ids = itertools.count(1)


def reset() -> None:
    """Forget every step and set-up span recorded."""
    REGISTRY.steps.clear()
    REGISTRY.setup.clear()


def _range(name: str):
    rf = _RANGE(name)
    rf.__enter__()
    return rf


# ------------------------------------------------------------ hot path


class _Span:
    """A span of the traced step now open; a profiler range too where
    ``host_range``.  ``path`` and ``owner`` place a grafted
    backward; by default the thread's innermost open span is the
    parent."""

    __slots__ = ("name", "host_range", "counters", "path", "owner", "_rf",
                 "_step", "_rec")

    def __init__(self, name: str, host_range: bool, counters=None,
                 path: Optional[str] = None, owner: Optional[int] = None):
        self.name, self.host_range, self.counters = name, host_range, counters
        self.path, self.owner = path, owner

    def __enter__(self):
        self._rf = _range(self.name) if self.host_range else None
        self._step = step = REGISTRY.step
        self._rec = None
        if step is not None:
            self._rec = step.open(self.name, self.counters, self.path,
                                  self.owner)
            self.path = step.recs[self._rec][0]
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._step.close_rec(self._rec)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, index: Optional[int] = None):
    """A span named ``name`` (``name<index>`` with an index), or a null
    context while tracing is off."""
    if not _profiling():
        return _NULL
    return _Span(name if index is None else f"{name}{index}", True)


def inner(name: str):
    """A span inside an autograd Function's forward or backward (CUDA
    events only: autograd names the Function's own range), under the
    Function's span; a null context outside a traced step."""
    if REGISTRY.step is None:
        return _NULL
    return _Span(name, False)


def count(**counters: float) -> None:
    """Add ``counters`` to the innermost span open on this thread (an op
    span's own counts: its blocks, its bytes); nothing outside a traced
    step."""
    step = REGISTRY.step
    stack = REGISTRY.stack()
    if step is None or not stack:
        return
    rec = step.recs[stack[-1][1]]
    if rec[4] is None:
        rec[4] = {}
    for k, v in counters.items():
        rec[4][k] = rec[4].get(k, 0) + v


def op(family: str) -> Callable:
    """Decorator: a span ``<family>:<function name>`` around each call."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")

    def wrap(fn):
        name = f"{family}:{fn.__name__}"

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _Span(name, True):
                return fn(*args, **kwargs)
        return traced
    return wrap


def function(cls):
    """Class decorator of a ``torch.autograd.Function``: device spans
    around its forward and, where the forward recorded, its backward.
    The flag and the forward's path ride on ``ctx``, so the autograd
    engine's thread checks nothing of its own."""
    fwd, bwd = cls.forward, cls.backward
    name = cls.__name__

    @functools.wraps(fwd)
    def forward(ctx, *args, **kwargs):
        step = REGISTRY.step  # set only inside a traced step
        if step is None:
            return fwd(ctx, *args, **kwargs)
        s = _Span(name, False)
        with s:
            out = fwd(ctx, *args, **kwargs)
        # the path below the root and the phase, for the backward
        ctx._het_span = (step.id, s.path.split("/", 2)[-1])
        return out

    @functools.wraps(bwd)
    def backward(ctx, *grads):
        tag = getattr(ctx, "_het_span", None)
        step = REGISTRY.step
        if tag is None or step is None or step.id != tag[0]:
            return bwd(ctx, *grads)
        with _Span(name + "Backward", False,
                   path=f"{step.phase_path}/{tag[1]}Backward",
                   owner=step.phase_idx):
            return bwd(ctx, *grads)

    cls.forward = staticmethod(forward)
    cls.backward = staticmethod(backward)
    return cls


def _operand(v):
    """An operand as a kernel span's ``args`` record it: a tensor as its
    element type and shape, an element type by name, anything else as
    is."""
    if isinstance(v, torch.Tensor):
        return [str(v.dtype).removeprefix("torch."), list(v.shape)]
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    return v


class _KernelSpan(_Span):
    __slots__ = ("fn", "_launches")

    def __init__(self, fn, work: Callable, args: Dict[str, Any]):
        nbytes, flops = work(**args)
        key = json.dumps({k: _operand(v) for k, v in args.items()},
                         separators=(",", ":"))
        super().__init__(f"kernel:{fn.__name__}", True,
                         {"launches": 0, "bytes": nbytes, "flops": flops,
                          "args": {key: 1}})
        self.fn = fn

    def __enter__(self):
        self._launches = self.fn.launches
        return super().__enter__()

    def __exit__(self, *exc):
        self.counters["launches"] = self.fn.launches - self._launches
        return super().__exit__(*exc)


def kernel(fn, work: Callable, **args):
    """While tracing is on, a span ``kernel:<name>`` around a call of
    kernel wrapper ``fn`` that counts its ``launches``, its least
    ``bytes`` and ``flops`` (``work(**args)``, the wrapper's own count)
    and, under ``args``, the call by its operands (``args``' element
    types and shapes, as JSON), from which a reader may count the work
    itself; a null context while tracing is off."""
    if not _profiling():
        return _NULL
    return _KernelSpan(fn, work, args)


# ----------------------------------------------------------------- loop


class Step:
    """One step of a trainer's loop, run phase by phase (``with
    step.phase(name)``, :data:`PHASES` in order), then :meth:`close`.

    A timed step takes three marks, CUDA events on the card or the host
    clock on the CPU: its start, the loss (the forward's end) and the end
    of Adam; :meth:`ms` waits for the last and gives the forward's ms and
    the rest's.  A timed step that starts while tracing is on is traced:
    its phase spans reuse those marks, add two at the zero_grad's and the
    backward's ends, and hold the step's spans until :meth:`close` hands
    them to the registry.  The sync phase waits for the card and launches
    nothing: on the card its span reads 0 and the step's root ends at
    Adam's end.  A ``first`` step (a loop's first) is a set-up span
    ``step.first`` with one a phase, on the host clock, and never
    traced."""

    def __init__(self, on_card: bool, *, first: bool = False,
                 timed: bool = True):
        self.on_card, self.timed, self.first = on_card, timed, first
        self.ranges = _profiling()
        self.traced = self.ranges and timed and not first
        self.marks: List[Any] = []
        self.id = next(_step_ids)
        self.recs: List[List] = []  # [path, owner, start, end, counters]
        self.events: List[Any] = []
        self.phase_path: Optional[str] = None
        self.phase_idx: Optional[int] = None
        self._last = None  # the latest boundary marked
        self._name: Optional[str] = None
        self._open: List[Any] = []  # this phase's range or set-up span
        self._setup = setup(FIRST).__enter__() if first else None

    def _now(self):
        if not self.on_card:
            return time.perf_counter()
        free = REGISTRY.free_events
        e = free.pop() if free else torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append(e)
        return e

    def _boundary(self, name: str, end: int) -> None:
        if (self.timed and (name, end) in _MARK_AT) or (
                self.traced and (name, end) in _TRACED_AT):
            self._last = self._now()
            if self.timed and (name, end) in _MARK_AT:
                self.marks.append(self._last)

    def phase(self, name: str) -> "Step":
        self._name = name
        return self

    def __enter__(self):
        name = self._name
        self._boundary(name, 0)
        if self.first:
            self._open.append(setup(f"het.{name}").__enter__())
        elif self.ranges:
            self._open.append(_range(f"het.{name}"))
        if self.traced:
            stack = REGISTRY.stack()
            if name == PHASES[0]:
                REGISTRY.step = self
                self.recs.append([ROOT, None, self._last, None, None])
                stack.append((ROOT, 0))
            elif name == "backward":  # the card has the forward to run
                REGISTRY.flush()
            t0 = (time.perf_counter() if name == "sync" and not self.on_card
                  else self._last)
            self.phase_idx = len(self.recs)
            self.phase_path = f"{ROOT}/het.{name}"
            self.recs.append([self.phase_path, 0, t0, None, None])
            stack.append((self.phase_path, self.phase_idx))
        return self

    def __exit__(self, exc_type, exc, tb):
        name = self._name
        self._boundary(name, 1)
        if self.traced:
            REGISTRY.stack().pop()
            end = (time.perf_counter() if name == "sync" and not self.on_card
                   else self._last)
            self.recs[self.phase_idx][3] = end
        while self._open:
            self._open.pop().__exit__(exc_type, exc, tb)
        if exc_type is not None:  # the step ends here
            self._abandon()
            self._end_setup()
        return False

    def ms(self) -> List[float]:
        """ms between consecutive marks, after waiting for the last."""
        m = self.marks
        if self.on_card:
            m[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]

    def open(self, name: str, counters, path: Optional[str],
             owner: Optional[int]) -> int:
        """A span's record; its parent the thread's innermost open span,
        or, on a thread with none, the phase now open."""
        stack = REGISTRY.stack()
        if path is None:
            parent, owner = stack[-1] if stack else (self.phase_path,
                                                     self.phase_idx)
            path = f"{parent}/{name}"
        idx = len(self.recs)
        # appended from the autograd engine's thread only while the loop's
        # thread waits in the backward
        self.recs.append([path, owner, self._now(), None, counters])
        stack.append((path, idx))
        return idx

    def close_rec(self, idx: int) -> None:
        self.recs[idx][3] = self._now()
        REGISTRY.stack().pop()

    def close(self) -> None:
        """Hand a traced step to the registry (after the sync phase: its
        events are read later, off the card's critical path), and end a
        first step's set-up span."""
        if self.traced and REGISTRY.step is self:
            self.recs[0][3] = (self._last if self.on_card
                               else self.recs[self.phase_idx][3])
            REGISTRY.step = None
            REGISTRY.stack().clear()
            REGISTRY.pending.append(self)
        self._end_setup()

    def _abandon(self) -> None:
        """Drop a step that raised."""
        if REGISTRY.step is self:
            REGISTRY.step = None
            REGISTRY.stack().clear()  # the root's frame, or a phase's
        REGISTRY.free_events.extend(self.events)
        self.events, self.recs = [], []

    def _end_setup(self) -> None:
        if self._setup is not None:
            self._setup.__exit__(None, None, None)
            self._setup = None

    def totals(self) -> Dict[str, Dict[str, float]]:
        """The step's spans' totals by path (its events done)."""
        recs = self.recs
        if self.on_card:
            dur = [a.elapsed_time(b) if a is not b else 0.0
                   for _, _, a, b, _ in recs]
        else:
            dur = [(b - a) * 1e3 for _, _, a, b, _ in recs]
        cover = [0.0] * len(recs)
        for i, r in enumerate(recs):
            if r[1] is not None:
                cover[r[1]] += dur[i]
        out: Dict[str, Dict[str, float]] = {}
        for i, (path, _, _, _, counters) in enumerate(recs):
            t = out.setdefault(path, {"calls": 0, "ms": 0.0, "self_ms": 0.0})
            t["calls"] += 1
            t["ms"] += dur[i]
            t["self_ms"] += dur[i] - cover[i]
            for k, v in (counters or {}).items():
                if isinstance(v, dict):  # calls by operands
                    d = t.setdefault(k, {})
                    for key, n in v.items():
                        d[key] = d.get(key, 0) + n
                else:
                    t[k] = t.get(k, 0) + v
        # the ancestors a grafted backward path has only by its graft
        grafted = {path.rsplit("/", n)[0] for path in out
                   for n in range(1, path.count("/") + 1)} - set(out)
        sums = dict.fromkeys(grafted, 0.0)
        for path in sorted(set(out) | grafted, key=lambda p: -p.count("/")):
            parent = path.rsplit("/", 1)[0]
            if parent in sums:
                sums[parent] += out[path]["ms"] if path in out else \
                    sums[path]
        for path in grafted:
            out[path] = {"calls": 0, "ms": sums[path], "self_ms": 0.0}
        return out


# --------------------------------------------------------------- set-up


class _Setup(ContextDecorator):
    """A set-up span: host seconds into ``Registry.setup`` by path, under
    the set-up spans open (on any thread); a range while tracing is on.
    As a decorator, a new span each call."""

    def __init__(self, name: str):
        self.name = name
        self.counts: Dict[str, float] = {}

    def _recreate_cm(self):
        return _Setup(self.name)

    def count(self, key: str, n: float) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self):
        st = REGISTRY.setup_stack
        self.path = f"{st[-1]}/{self.name}" if st else self.name
        st.append(self.path)
        REGISTRY.setup.setdefault(self.path, {"calls": 0, "s": 0.0})
        self._rf = _range(self.name) if _profiling() else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        s = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        REGISTRY.setup_stack.remove(self.path)
        t = REGISTRY.setup[self.path]
        t["calls"] += 1
        t["s"] += s
        for k, v in self.counts.items():
            t[k] = t.get(k, 0) + v
        return False


def setup(name: str) -> _Setup:
    """A set-up span named ``name`` (a context manager or a decorator;
    ``count(key, n)`` adds a counter)."""
    return _Setup(name)
