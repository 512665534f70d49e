"""The readers of the port's span registry (``program_spans.py`` and the
six ``metrics/`` that use it) on a fake registry: None where the program
has no registry or the traced steps are not the window's, the outermost
op family owning a path, the split of the phases, the roofline share
raising above 100%, and the set-up seconds; then a traced tiny run on the
CPU, whose split accounts for the step."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans, run
from benchmark.costs.kernels import WORK, call_work
from benchmark.tests.tiny import CPU, tiny_spec

H100 = "NVIDIA H100 80GB HBM3"
F, B = program_spans.FORWARD, program_spans.BACKWARD


def _copy_args(nbytes):
    """A ``kernel:force_rowmajor`` call's operands that read and write
    ``nbytes`` in all."""
    return json.dumps({"x": ["float32", [int(nbytes) // 8]]})


def _step(kernel_bytes=3.35e9, kernel_ms=2.0):
    def t(ms, **kw):
        return {"calls": 1, "ms": ms, "self_ms": 0.0, **kw}
    return {
        "step": t(20.0), "step/het.zero_grad": t(1.0),
        F: t(7.0), B: t(10.0), "step/het.adam": t(2.0),
        "step/het.sync": t(0.0),
        f"{F}/layer0": t(6.0),
        f"{F}/layer0/agg:a": t(3.0),
        f"{F}/layer0/agg:a/linear:inner": t(1.0),  # owned by agg:
        f"{F}/layer0/agg:a/linear:inner/kernel:force_rowmajor": t(
            kernel_ms, launches=1, bytes=kernel_bytes, flops=0,
            args={_copy_args(kernel_bytes): 1}),
        f"{F}/layer0/linear:l": t(2.0),
        f"{B}/layer0/agg:a": t(4.0, calls=0),  # grafted
        f"{B}/layer0/agg:a/FnBackward": t(4.0),
        f"{B}/layer0/linear:l": t(5.0, calls=0),
    }


@pytest.fixture
def fake(monkeypatch):
    reg = SimpleNamespace(steps=[_step(), _step()], setup={
        "graph.build": {"calls": 1, "s": 9.0},
        "graph.build/graph.compact.src": {"calls": 1, "s": 2.5},
        "graph.build/graph.compact.dst": {"calls": 1, "s": 3.0},
        "step.first": {"calls": 1, "s": 7.5},
        "step.first/het.forward/kernels.load.seg_reduce": {
            "calls": 1, "s": 1.0, "built": 1}})
    monkeypatch.setattr(program_spans, "registry", lambda: reg)
    return reg


def read(name, **ctx):
    return run.load("metrics", name).read(
        {"window_steps": 2, "device_name": H100, **ctx})


def test_no_registry_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "registry", lambda: None)
    for m in ("fused_agg_ms", "typed_linear_ms", "unattributed_ms",
              "port_kernel_roofline_pct", "first_step_s",
              "compact_build_s"):
        assert read(m) is None


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_a_step_count_not_the_windows_reads_none(fake, steps):
    fake.steps = [_step() for _ in range(steps)]
    for m in ("fused_agg_ms", "typed_linear_ms", "unattributed_ms",
              "port_kernel_roofline_pct"):
        assert read(m) is None


def test_the_outermost_family_owns_a_path(fake):
    assert program_spans.family(f"{F}/layer0/agg:a/linear:inner") == "agg:"
    assert program_spans.family(f"{F}/layer0") is None
    assert not program_spans.outermost(f"{F}/layer0/agg:a/linear:inner")
    assert read("fused_agg_ms") == 3.0 + 4.0
    assert read("typed_linear_ms") == 2.0 + 5.0
    # the phases less both families: glue, the loss, the einsum
    assert read("unattributed_ms") == 7.0 + 10.0 - 7.0 - 7.0


def test_roofline_share_and_its_bounds(fake):
    # 3.35 GB at 3.35 TB/s is 1 ms, in 2 ms of the span
    assert read("port_kernel_roofline_pct") == pytest.approx(50.0)
    fake.steps = [_step(kernel_ms=0.9), _step(kernel_ms=0.9)]
    with pytest.raises(ValueError, match="outside"):
        read("port_kernel_roofline_pct")
    fake.steps = [_step(kernel_bytes=0), _step(kernel_bytes=0)]
    with pytest.raises(ValueError, match="outside"):
        read("port_kernel_roofline_pct")


def test_setup_seconds(fake):
    assert read("first_step_s") == 7.5 - 1.0  # less the library's load
    assert read("compact_build_s") == 5.5
    fake.setup["step.first"]["calls"] = 2  # two loops: not one first step
    assert read("first_step_s") is None
    del fake.setup["graph.build/graph.compact.src"]
    del fake.setup["graph.build/graph.compact.dst"]
    assert read("compact_build_s") is None


def _kernel_calls(g):
    """One call of each port kernel wrapper at a tiny shape, on the CPU."""
    from het_tpu_torch.graph.build import build_segments
    from het_tpu_torch.ops import kernels
    seg = build_segments([0] * 4 + [1] * 4, 2, 4, sorts="plain")
    w = torch.randn(2, 2, 3, 4, generator=g)
    row_ptr = torch.tensor([0, 4, 10], dtype=torch.int32)
    perm = torch.randperm(10, generator=g).to(torch.int32)
    vals = torch.randn(10, 3, generator=g)
    return {
        "seg_sum_sorted": lambda: kernels.seg_sum_sorted(
            vals.bfloat16(), row_ptr, perm, impl="plain"),
        "seg_max_sorted": lambda: kernels.seg_max_sorted(
            vals, row_ptr, impl="plain"),
        "force_rowmajor": lambda: kernels.force_rowmajor(
            torch.randn(6, 4, generator=g).t(), impl="plain"),
        "segment_matmul_fwd": lambda: kernels.segment_matmul_fwd(
            torch.randn(8, 6, generator=g), w, seg, impl="plain"),
        "segment_matmul_dx": lambda: kernels.segment_matmul_dx(
            torch.randn(8, 8, generator=g), w, seg, impl="plain"),
        "segment_matmul_dw": lambda: kernels.segment_matmul_dw(
            torch.randn(8, 3, generator=g).bfloat16(),
            torch.randn(8, 8, generator=g).bfloat16(), (2, 2, 3, 4), seg,
            impl="plain"),
    }


@pytest.mark.parametrize("name", sorted(WORK))
def test_kernel_work_from_the_recorded_operands(name):
    """The benchmark's count from a traced call's recorded operands equals
    the wrapper's own (which the port's tests hold to a hand count)."""
    from torch.profiler import ProfilerActivity, profile

    from het_tpu_torch.utils import spans
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        step = spans.Step(False)
        with step.phase("zero_grad"):
            _kernel_calls(torch.Generator().manual_seed(2))[name]()
        step.close()
    t = spans.REGISTRY.steps[0][f"step/het.zero_grad/kernel:{name}"]
    (args, calls), = t["args"].items()
    assert calls == 1 and call_work(name, args) == (t["bytes"], t["flops"])
    spans.reset()


def test_a_traced_tiny_run_accounts_for_its_steps():
    from het_tpu_torch.utils import spans
    spans.reset()
    result, notes = run.run_cell(tiny_spec("rgat.mag.compact_mf"),
                                 2**31 + 11, 0.2, True, CPU)
    assert result["correct"] is True
    ctx = notes["ctx"]
    steps = spans.REGISTRY.steps
    assert len(steps) == ctx["window_steps"] > 0
    split = sum(run.load("metrics", m).read(ctx) for m in (
        "fused_agg_ms", "typed_linear_ms", "unattributed_ms"))
    rest = sum(s[p]["ms"] for s in steps for p in (
        "step/het.zero_grad", "step/het.adam", "step/het.sync")) / len(
        steps) + sum(s["step"]["self_ms"] for s in steps) / len(steps)
    step = sum(s["step"]["ms"] for s in steps) / len(steps)
    assert split + rest == pytest.approx(step, rel=1e-9)
    assert run.load("metrics", "first_step_s").read(ctx) > 0
    assert run.load("metrics", "compact_build_s").read(ctx) > 0
    spans.reset()
