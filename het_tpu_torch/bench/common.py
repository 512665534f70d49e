"""What every bench module shares: the device and its precision, the
card's peaks, the card line, a step timer, peak memory, seeded
parameters, the agreement checks and the JSON lines.

A time on the card is the median of CUDA events around each timed call,
after untimed warm-up calls; on the CPU it is ``time.perf_counter``'s,
and every row says which clock it read (``"clock"``), so that a host time
is never read as a card figure.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..ops import kernels
from ..train.config import TrainConfig
from ..train.driver import DTYPES, build_model, model_forward
from ..utils.misc import exact_matmuls, nll_loss, resolve_device
from ..utils.profiling import H100_SXM, device_peaks

# the agreement limits of PERF.md §2: a kernel step against the plain
# versions' (f32), a bf16 step against the plain versions' bf16 step
TRAIN_RTOL = 1e-4
BF16_RTOL = 1e-2


class BenchFailure(RuntimeError):
    """A variant that failed, a kernel that disagrees with its plain
    version, or a share of a bound past 100%."""


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the plain versions on the "
                        "CPU, timed on the host clock")
    p.add_argument("--out", default=None,
                   help="append each JSON line to this file as well")


def setup(device: str = "cuda") -> torch.device:
    """``device`` (a CUDA device must exist for "cuda") with the matmuls
    exact (``utils/misc.py::exact_matmuls``), as every port measurement
    runs."""
    dev = resolve_device(device)
    exact_matmuls()
    return dev


def peaks_of(dev: torch.device,
             peaks: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The peaks a bound is counted with: ``peaks`` where given, else on
    the card ``utils/profiling.py::device_peaks`` (the H100 SXM row; any
    other card raises), and on the CPU the H100 SXM row, so that a host
    run does the same arithmetic (its times are the host's, not a card
    figure)."""
    if peaks is not None:
        return peaks
    if dev.type == "cuda":
        return device_peaks(torch.cuda.get_device_name(dev))
    return dict(H100_SXM)


def card_line(dev: Optional[torch.device] = None) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line on the card; on the CPU a line that says the times are the
    host's."""
    if dev is not None and dev.type != "cuda":
        return "cpu (host clock, not a card figure)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def clock_name(dev: torch.device) -> str:
    return "cuda_events" if dev.type == "cuda" else "host_perf_counter"


def _call_ms(fn: Callable[[], Any], dev: torch.device) -> float:
    """The ms of one call of ``fn``: between CUDA events on the card, on
    the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def time_steps(fn: Callable[[], Any], dev: torch.device, *, warmup: int,
               steps: int) -> Dict[str, Any]:
    """``warmup`` untimed calls of ``fn``, then ``steps`` timed ones
    (:func:`_call_ms`): the median ms, the least and most, their spread
    over the median, and each time."""
    if steps < 1:
        raise ValueError("steps must be at least 1")
    for _ in range(warmup):
        fn()
    times = [_call_ms(fn, dev) for _ in range(steps)]
    med = statistics.median(times)
    return {"median_ms": med, "min_ms": min(times), "max_ms": max(times),
            "spread": (max(times) - min(times)) / med if med else 0.0,
            "times_ms": times, "clock": clock_name(dev)}


# the card's spin before a timed call: this much, plus SPIN_PER_HOST times
# the host's enqueue of one call
SPIN_MS, SPIN_PER_HOST = 0.1, 3.0
_SLEEP_CYCLES_A_MS: Dict[int, float] = {}


def _sleep_cycles_a_ms(dev: torch.device) -> float:
    """``torch.cuda._sleep``'s cycles a millisecond on ``dev``'s clock,
    measured once a device."""
    i = torch.device(dev).index
    i = torch.cuda.current_device() if i is None else i
    if i not in _SLEEP_CYCLES_A_MS:
        cycles = 2_000_000
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0.record()
        torch.cuda._sleep(cycles)
        t1.record()
        t1.synchronize()
        _SLEEP_CYCLES_A_MS[i] = cycles / t0.elapsed_time(t1)
    return _SLEEP_CYCLES_A_MS[i]


def time_call(fn: Callable[[], Any], dev: torch.device, reps: int = 20,
              flush: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """``reps`` single calls of ``fn`` after two untimed ones: ``{"ms":
    their median, "host_ms": the median of the host's enqueue of a timed
    call, "spin_ms": the spin before each, "host_hidden": every enqueue
    ended within its spin}``.  On the card each call reads its inputs from
    device memory (``flush``, a buffer larger than the L2 cache, 256 MB by
    default, is overwritten before it) and the card spins before the start
    event for ``SPIN_MS`` plus ``SPIN_PER_HOST`` times the second untimed
    call's enqueue, so that the host has enqueued the whole call before
    the card reaches it: the time is the card's, not the host's (unless
    ``fn`` waits for the card, which ``host_hidden`` then shows).  On the
    CPU the host clock, and ``host_ms`` is None."""
    fn()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    if dev.type != "cuda":
        times = [_call_ms(fn, dev) for _ in range(reps)]
        return {"ms": statistics.median(times), "host_ms": None,
                "spin_ms": 0.0, "host_hidden": True}
    if flush is None:
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    spin_ms = SPIN_MS + SPIN_PER_HOST * host_ms
    cycles = int(spin_ms * _sleep_cycles_a_ms(dev))
    times, hosts = [], []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        hosts.append((time.perf_counter() - h0) * 1e3)
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return {"ms": statistics.median(times),
            "host_ms": statistics.median(hosts), "spin_ms": spin_ms,
            "host_hidden": max(hosts) < spin_ms}


def time_call_ms(fn: Callable[[], Any], dev: torch.device, reps: int = 20,
                 flush: Optional[torch.Tensor] = None) -> float:
    """:func:`time_call`'s median ms."""
    return time_call(fn, dev, reps, flush)["ms"]


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_mb(dev: torch.device) -> Optional[float]:
    """Peak device memory since :func:`reset_peak`, in MB (None on the
    CPU)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e6


def share_pct(bound_ms: float, ms: float, what: str) -> float:
    """``bound_ms`` as a percent of the measured ``ms``; a bound is a
    least time, so a share past 100% is a miscount and raises."""
    pct = 100.0 * bound_ms / ms
    if not 0.0 < pct <= 100.0:
        raise BenchFailure(f"{what}: bound {bound_ms} ms is {pct:.3f}% of "
                           f"the measured {ms} ms, outside (0, 100]")
    return pct


def seeded_state(net: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Parameters for ``net`` from a numpy seed: embeddings uniform on
    [0, 1), weights Glorot-uniform (flax's fan convention), biases zero,
    HGT's ``relation_pri`` (the compiled model's ``rel_pri``) and
    ``skip`` one, as flax initializes them.  Every compared run loads the
    same state."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in net.state_dict().items():
        shape = tuple(p.shape)
        if name == "embed.embed":
            a = rng.uniform(0.0, 1.0, shape)
        elif name.endswith(("h_bias", ".bias")):
            a = np.zeros(shape)
        elif name.endswith((".relation_pri", ".rel_pri", ".skip")):
            a = np.ones(shape)
        else:
            rf = math.prod(shape[:-2])
            lim = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * rf))
            a = rng.uniform(-lim, lim, shape)
        state[name] = torch.from_numpy(a.astype(np.float32))
    return state


def model_of(data, impl: str, *, seed: int = 1, **cfg) -> torch.nn.Module:
    """The model the trainer builds for ``cfg`` (``TrainConfig`` fields)
    on ``data``, without its node embeddings: it takes the features as
    its input, as het_tpu's bench scripts feed theirs.  The same ``seed``
    gives the same parameters for either ``impl``."""
    net = build_model(TrainConfig(**cfg), data, impl=impl,
                      generator=torch.Generator().manual_seed(seed))
    return net.model


def features(num_nodes: int, f_in: int, dev: torch.device,
             seed: int = 0) -> torch.Tensor:
    """Standard normal input rows from a numpy seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((num_nodes, f_in)).astype(np.float32)).to(dev)


def make_step(model: torch.nn.Module, g, x: torch.Tensor,
              labels: torch.Tensor, dtype: torch.dtype = torch.float32):
    """One forward + backward of ``model`` on ``(g, x)``: the NLL of
    every node's label, the gradients into the parameters' ``.grad``
    (f32 masters: with bf16 the model runs on bf16 copies through
    ``train/driver.py::model_forward`` and ``x`` is cast to bf16, as the
    trainer's mixed precision runs).  Returns the loss."""
    forward = model_forward(model, dtype)
    xx = x.to(dtype)
    params = [p for p in model.parameters() if p.requires_grad]

    def step():
        for p in params:
            p.grad = None
        loss = nll_loss(forward(g, xx), labels)
        loss.backward()
        return loss

    return step


def grads_of(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float) -> float:
    """``got`` within ``rtol`` of ``want``, relative to ``want``'s largest
    magnitude (a gradient's small entries are sums of cancelling terms);
    returns the worst relative gap, raises ``BenchFailure`` past it."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        raise BenchFailure(f"{what}: shape {tuple(got.shape)} against "
                           f"{tuple(want.shape)}")
    scale = float(want.abs().max()) if want.numel() else 0.0
    return rtol * within(what, got, want, rtol * (scale or 1.0))


def within(what: str, got: torch.Tensor, want: torch.Tensor,
           limit: torch.Tensor) -> float:
    """``got`` finite and within ``limit`` (a bound on ``|got - want|``,
    elementwise or one number) of ``want``; returns the worst gap as a
    share of its limit, raises ``BenchFailure`` past 1."""
    gap = (got.detach() - want.detach()).abs()
    share = float((gap / torch.as_tensor(limit).clamp_min(1e-30)).max()) \
        if gap.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or share > 1.0:
        raise BenchFailure(f"{what}: kernel against plain {share:.3g} of the "
                           f"limit (largest gap {float(gap.max())})")
    return share


def first_step(model: torch.nn.Module, step) -> Dict[str, Any]:
    """Run ``step`` (:func:`make_step` of ``model``) once: its loss and
    ``model``'s gradients."""
    loss = float(step().detach())
    return {"loss": loss, "grads": grads_of(model)}


def launches_between(before: Dict[str, int], calls: int,
                     what: str) -> Dict[str, int]:
    """Each kernel's launches a call since the counts were ``before``
    (``kernels.launch_counts()``) over ``calls`` equal calls; a count that
    does not divide evenly raises."""
    out = {}
    for k, n in kernels.launch_counts().items():
        n -= before[k]
        if n % calls:
            raise BenchFailure(f"{what}: {n} launches of {k} in {calls} "
                               "calls")
        if n:
            out[k] = n // calls
    return out


def measure_step(model: torch.nn.Module, g, x: torch.Tensor,
                 labels: torch.Tensor, dev: torch.device, dtype: str, *,
                 warmup: int, steps: int) -> Dict[str, Any]:
    """``model``'s forward + backward (:func:`make_step` in ``dtype``,
    "float32" or "bfloat16"): its first step (loss, gradients), then the
    timed steps after ``warmup`` more, the peak memory over them and the
    kernel launches a step."""
    step = make_step(model, g, x, labels, DTYPES[dtype])
    reset_peak(dev)
    before = kernels.launch_counts()
    first = first_step(model, step)
    timing = time_steps(step, dev, warmup=warmup, steps=steps)
    return {"first": first, "timing": timing, "peak_mem_mb": peak_mb(dev),
            "launches_a_step": launches_between(
                before, 1 + warmup + steps, "step")}


def hold(what: str, kernel: Dict[str, Any], plain: Dict[str, Any],
         dtype: str) -> float:
    """A kernel step's loss and gradients (``{"loss", "grads"}``) against
    the plain versions' on the same parameters, within PERF.md §2's limit
    for ``dtype``; returns the worst gap."""
    rtol = BF16_RTOL if dtype == "bfloat16" else TRAIN_RTOL
    worst = check_close(f"{what} loss", torch.tensor(kernel["loss"]),
                        torch.tensor(plain["loss"]), rtol)
    if set(kernel["grads"]) != set(plain["grads"]):
        raise BenchFailure(f"{what}: gradients of {sorted(kernel['grads'])}"
                           f" against {sorted(plain['grads'])}")
    for name, gk in kernel["grads"].items():
        worst = max(worst, check_close(f"{what} d{name}", gk,
                                       plain["grads"][name], rtol))
    return worst


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def emit(row: Dict[str, Any], out: Optional[str] = None) -> None:
    """Print ``row`` as one JSON line, and append it to ``out`` where
    given."""
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def parse(p: argparse.ArgumentParser,
          argv: Optional[Iterable[str]]) -> argparse.Namespace:
    add_common_args(p)
    return p.parse_args(None if argv is None else list(argv))
