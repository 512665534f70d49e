"""The reading of a device trace, on a trace made by hand."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from benchmark import trace


def _ev(name, a, b, dev=True, thread=1, parent=None, note=False):
    return NS(name=name, time_range=NS(start=a, end=b), thread=thread,
              device_type=DeviceType.CUDA if dev else DeviceType.CPU,
              cpu_parent=parent, is_user_annotation=note)


def test_busy_categories_breakdown_and_gaps():
    events = [
        # host: two top-level operators, one child, one on another thread
        _ev("aten::index_select", 0, 10, dev=False),
        _ev("child", 1, 2, dev=False, parent=object()),
        _ev("aten::item", 40, 60, dev=False),
        _ev("autograd::engine::evaluate_function", 70, 90, dev=False,
            thread=2),
        # device: two overlapping gathers, a gemm, the optimizer's range
        _ev("vectorized_gather_kernel", 5, 25),
        _ev("indexSelectLargeIndex", 20, 30),
        _ev("ampere_sgemm", 50, 65),
        _ev("Optimizer.step#Adam.step", 30, 100, note=True),
    ]
    got = trace.summarize(NS(events=lambda: events))
    assert got["busy_s"] == pytest.approx(40e-6)  # [5, 30] and [50, 65]
    assert got["by_category_s"] == pytest.approx(
        {"gather / index": 30e-6, "matmul": 15e-6})
    assert got["launches_by_category"] == {"gather / index": 2,
                                           "matmul": 1}
    assert [n for n, _ in got["breakdown"]["device_ops"]] == [
        "vectorized_gather_kernel", "ampere_sgemm", "indexSelectLargeIndex"]
    # idle: [0, 5] under index_select, [30, 50] under item, [65, 90]
    # under the backward's operator on the other thread
    assert dict(got["breakdown"]["idle_gaps"]) == pytest.approx({
        "aten::index_select": 5e-6, "aten::item": 20e-6,
        "autograd::engine::evaluate_function": 25e-6})


def test_a_host_trace_gives_nothing():
    events = [_ev("aten::mm", 0, 10, dev=False)]
    assert trace.summarize(NS(events=lambda: events)) is None


def test_categories_follow_the_table():
    assert trace.category("void seg_reduce_kernel<SumOp, float>") == \
        "seg_sum_sorted (port kernel)"
    assert trace.category("segment_matmul_dw_kernel") == \
        "segment_matmul_dw (port kernel)"
    assert trace.category("something else") == "other"
    assert len(trace.PORT_KERNELS) == 6
