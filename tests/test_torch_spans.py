"""The port's span registry (``het_tpu_torch/utils/spans.py``) on the CPU:
off, the loop records only its set-up spans and the hot path creates no
range or event; on, under ``torch.profiler``, each timed step is recorded
once by path (phases, layers, ``linear:`` and ``agg:`` ops, the grafted
backwards, ``kernel:`` spans), children within their parents and self
times summing to the step, and the profiler sees the ranges; a step's
three marks (five traced) on the card's clock; and each kernel wrapper's
traced bytes and operations against a hand count from the call's shapes."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from het_tpu_torch.graph.build import build_segments
from het_tpu_torch.graph.synth import random_heterograph
from het_tpu_torch.models import HGTModel, RGATModel
from het_tpu_torch.ops import kernels
from het_tpu_torch.train.loop import train_steps
from het_tpu_torch.utils import spans
from het_tpu_torch.utils.misc import nll_loss

N, E, R, F, C = 48, 300, 3, 8, 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_registry():
    spans.reset()
    yield
    spans.reset()


def _model(kind):
    g = random_heterograph(N, E, R, seed=3, ntype_offsets=(0, 20, N))
    gen = torch.Generator().manual_seed(0)
    if kind == "rgat":
        net = RGATModel(F, F, C, R, 2, compact=True, multiply_first=True,
                        dropout=0.0, impl="plain", generator=gen)
    else:
        net = HGTModel(F, F, C, 2, R, 2, num_layers=2, dropout=0.0,
                       stable_softmax="clip", impl="plain", generator=gen)
    x = torch.randn(N, F, generator=gen)
    y = torch.randint(0, C, (N,), generator=gen)

    def step_loss():
        loss = nll_loss(net(g, x), y)
        return loss, loss
    return net, step_loss


class _Counting:
    """Counts constructions of the wrapped class."""

    def __init__(self, cls):
        self.cls, self.n = cls, 0

    def __call__(self, *a, **k):
        self.n += 1
        return self.cls(*a, **k)


class _FakeEvent:
    """A CUDA event on a fake device clock that ticks one ms a record."""
    clock = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_off_records_only_setup_spans(monkeypatch):
    ranges = _Counting(spans._RANGE)
    events = _Counting(_FakeEvent)
    monkeypatch.setattr(spans, "_RANGE", ranges)
    monkeypatch.setattr(torch.cuda, "Event", events)
    net, step_loss = _model("rgat")
    out = train_steps(net, step_loss, steps=2, lr=0.01, device=CPU)
    assert len(out["step_ms_list"]) == 2 and min(out["step_ms_list"]) > 0
    assert ranges.n == 0 and events.n == 0
    assert spans.REGISTRY.steps == []
    setup = spans.REGISTRY.setup
    assert setup["graph.build"]["calls"] == 1
    assert {"graph.build/graph.sort", "graph.build/graph.segments",
            "graph.build/graph.ntypes", "graph.build/graph.compact.src",
            "graph.build/graph.compact.dst"} <= set(setup)
    assert [p for p in setup if p.startswith("step.first")] == [
        "step.first"] + [f"step.first/het.{p}" for p in spans.PHASES]
    first = setup["step.first"]
    assert first["calls"] == 1 and first["s"] >= sum(
        setup[f"step.first/het.{p}"]["s"] for p in spans.PHASES)


def _check_tree(step):
    for path, t in step.items():
        assert t["self_ms"] >= -1e-9, path
        parent = path.rsplit("/", 1)[0]
        if parent != path:
            assert step[parent]["ms"] >= t["ms"] - 1e-9, path
    assert sum(t["self_ms"] for t in step.values()) == pytest.approx(
        step["step"]["ms"], rel=1e-9)


@pytest.mark.parametrize("kind", ["rgat", "hgt"])
def test_on_records_each_step_once_under_the_profiler(kind):
    net, step_loss = _model(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_steps(net, step_loss, steps=3, lr=0.01, device=CPU)
    steps = spans.REGISTRY.steps
    assert len(steps) == 2  # the first step is set-up
    fwd, bwd = "step/het.forward", "step/het.backward"
    if kind == "rgat":
        agg = "agg:relational_fused_gat_compact_packed"
        own = {f"{fwd}/layer0/{agg}/CompactFusedGATPacked",
               f"{bwd}/layer1/{agg}/CompactFusedGATPackedBackward",
               f"{fwd}/layer1/linear:compact_typed_linear/"
               "linear:segment_matmul/_SegmentMatmul",
               f"{bwd}/layer1/linear:compact_typed_linear/"
               "_SortedGatherBackward/kernel:seg_sum_sorted"}
    else:
        agg = "agg:hgt_plain_layer_core"
        own = {f"{fwd}/layer0/{agg}/HGTPlainFull",
               f"{bwd}/layer0/{agg}/HGTPlainFullBackward",
               f"{fwd}/layer1/linear:ntype_linear/linear:segment_matmul",
               f"{bwd}/layer1/linear:ntype_linear/_GatherRowsInjective"
               "Backward"}
    for step in steps:
        assert {"step"} | {f"step/het.{p}" for p in spans.PHASES} <= \
            set(step)
        assert all(step[f"step/het.{p}"]["calls"] == 1
                   for p in spans.PHASES)
        assert {f"{fwd}/layer0", f"{fwd}/layer1", f"{fwd}/layer0/{agg}",
                f"{bwd}/layer0/{agg}"} | own <= set(step)
        assert step[f"{bwd}/layer0/{agg}"]["calls"] == 0  # grafted
        kern = [t for p, t in step.items() if p.endswith("kernel:"
                                                         "seg_sum_sorted")]
        assert kern and all(t["bytes"] > 0 and t["flops"] > 0
                            and t["launches"] == 0
                            and sum(t["args"].values()) == t["calls"]
                            for t in kern)
        _check_tree(step)
    names = {e.name for e in prof.events()}
    assert {"het.forward", "het.sync", "layer0",
            f"{agg}", "kernel:seg_sum_sorted"} <= names


def test_step_marks_on_the_card_clock(monkeypatch):
    events = _Counting(_FakeEvent)
    monkeypatch.setattr(torch.cuda, "Event", events)
    net, step_loss = _model("rgat")
    opt = torch.optim.Adam(net.parameters(), lr=0.01)

    def one(step):
        with step.phase("zero_grad"):
            opt.zero_grad()
        with step.phase("forward"):
            loss, _ = step_loss()
        with step.phase("backward"):
            loss.backward()
        with step.phase("adam"):
            opt.step()
        with step.phase("sync"):
            ms = step.ms()
        step.close()
        return ms

    assert one(spans.Step(True)) == [1.0, 1.0]  # three marks, untraced
    assert events.n == 3 and spans.REGISTRY.steps == []
    with profile(activities=[ProfilerActivity.CPU]):
        fwd, rest = one(spans.Step(True))
        assert events.n > 5 and fwd > 1 and rest > 1
        step, = spans.REGISTRY.steps
        _check_tree(step)
        assert step["step"]["ms"] == fwd + rest
        assert step["step/het.sync"]["ms"] == 0.0
        phases = sum(step[f"step/het.{p}"]["ms"] for p in spans.PHASES)
        assert phases == step["step"]["ms"]
        for _ in range(2):  # a step's events are read during the next one
            one(spans.Step(True))
        made = events.n
        one(spans.Step(True))  # and then used again
        assert events.n == made and len(spans.REGISTRY.steps) == 4


SEG = np.repeat([0, 1], 4)  # 8 rows in two segments of a tile of 4
W_SHAPE = (2, 2, 3, 4)  # S, H, K, O


def _call(name, impl):
    g = torch.Generator().manual_seed(1)
    seg = build_segments(SEG, 2, 4, sorts="plain")
    vals = torch.randn(10, 3, generator=g)
    row_ptr = torch.tensor([0, 4, 10], dtype=torch.int32)
    perm = torch.randperm(10, generator=g).to(torch.int32)
    w = torch.randn(*W_SHAPE, generator=g)
    calls = {
        "seg_sum_sorted": lambda: kernels.seg_sum_sorted(
            vals, row_ptr, perm, impl=impl),
        "seg_max_sorted": lambda: kernels.seg_max_sorted(
            vals, row_ptr, impl=impl),
        "force_rowmajor": lambda: kernels.force_rowmajor(
            torch.randn(6, 4, generator=g).t(), impl=impl),
        "segment_matmul_fwd": lambda: kernels.segment_matmul_fwd(
            torch.randn(8, 3, generator=g), w, seg, impl=impl),
        "segment_matmul_dx": lambda: kernels.segment_matmul_dx(
            torch.randn(8, 8, generator=g), w, seg, impl=impl),
        "segment_matmul_dw": lambda: kernels.segment_matmul_dw(
            torch.randn(8, 3, generator=g), torch.randn(8, 8, generator=g),
            W_SHAPE, seg, impl=impl),
    }
    calls[name]()


# each input element read once, each output element written once (f32 and
# int32, 4 bytes); an add or a max an element walked, two operations a
# multiply-add
HAND = {
    # vals 10x3, perm 10, row_ptr 3 in; 2x3 out
    "seg_sum_sorted": ((30 + 10 + 3 + 6) * 4, 30),
    # vals 10x3, row_ptr 3 in; 2x3 out
    "seg_max_sorted": ((30 + 3 + 6) * 4, 30),
    # 4x6 in and out
    "force_rowmajor": ((24 + 24) * 4, 0),
    # x 8x3, w 2x2x3x4, offsets 3 in; 8x2x4 out; 8 rows x 2 heads x 3 x 4
    "segment_matmul_fwd": ((24 + 48 + 3 + 64) * 4, 2 * 8 * 2 * 3 * 4),
    # ct 8x8, w, offsets in; dx 8x3 out
    "segment_matmul_dx": ((64 + 48 + 3 + 24) * 4, 2 * 8 * 2 * 3 * 4),
    # x 8x3, ct 8x8, offsets in; dW 2x2x3x4 out
    "segment_matmul_dw": ((24 + 64 + 3 + 48) * 4, 2 * 8 * 2 * 3 * 4),
}


def traced_call(name, impl):
    """The totals of one traced step that makes one call of kernel
    wrapper ``name``."""
    with profile(activities=[ProfilerActivity.CPU]):
        step = spans.Step(False)
        with step.phase("zero_grad"):
            _call(name, impl)
        step.close()
    totals, = spans.REGISTRY.steps
    return totals[f"step/het.zero_grad/kernel:{name}"]


# the packed compact GAT op's walks: no ``kernel:`` span (the benchmark's
# cost table has no count for them); their time shows under the op's
UNSPANNED = ("compact_gat_packed_fwd", "compact_gat_packed_bwd_dst",
             "compact_gat_packed_bwd_src")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("name", [k for k in kernels.KERNELS
                                  if k not in UNSPANNED])
def test_kernel_counters_match_a_hand_count(name, impl):
    kernels.reset_launches()
    t = traced_call(name, impl)
    assert (t["calls"], t["bytes"], t["flops"]) == (1, *HAND[name])
    assert t["launches"] == 0  # the CPU launches none
    assert list(t["args"].values()) == [1]
    assert kernels.launch_counts()[name] == 0
    spans.reset()
    _call(name, impl)  # untraced: no span, nothing counted
    assert spans.REGISTRY.steps == []


def _walk_calls():
    """One call of each packed compact GAT walk on a tiny graph (H = 2,
    D = 3)."""
    g = random_heterograph(N, E, R, seed=3)
    gen = torch.Generator().manual_seed(2)
    S, Dc = g.compact_src, g.compact_dst
    fe2d = torch.randn(S.seg.n_rows, 8, generator=gen)
    er = torch.randn(Dc.seg.n_rows, 2, generator=gen)
    ct = torch.randn(N, 2, 3, generator=gen)
    rows = (S.edge_map, Dc.edge_map, g.in_row_ptr)
    s, out = kernels.compact_gat_packed_fwd(fe2d, er, *rows, 0.2)
    draw, alpha = kernels.compact_gat_packed_bwd_dst(fe2d, er, *rows, s,
                                                     out, ct, 0.2)
    kernels.compact_gat_packed_bwd_src(draw, alpha, ct, g.dst,
                                       S.edge_row_ptr, S.edge_sort_perm)


def test_walks_open_no_kernel_span():
    with profile(activities=[ProfilerActivity.CPU]):
        step = spans.Step(False)
        with step.phase("zero_grad"):
            _walk_calls()
        step.close()
    totals, = spans.REGISTRY.steps
    assert not [p for p in totals if "kernel:" in p]
    assert set(UNSPANNED) <= set(kernels.KERNELS)
