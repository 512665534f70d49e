"""The step counts against a hand count, and the readers that use them."""

import pytest

from benchmark import run

# one layer: K = 4 in, O = 4 out (the classes), H = 2 heads of D = 2
CFG = {"num_heads": 2, "num_layers": 1, "n_infeat": 4, "hidden": 4,
       "num_classes": 4}
SIZES = {"num_nodes": 5, "num_edges": 6, "num_rels": 2, "num_ntypes": 2,
         "unique_src_pairs": 4, "unique_dst_pairs": 3, "train_nodes": 2}


def test_rgat_by_hand():
    # parameters: embed 5*4, W 2*2*4*2, a_l and a_r 2*2*2 each, bias 4
    sizes = dict(SIZES, num_params=20 + 32 + 16 + 4)
    # forward: typed linear 2*4*4*4 = 128, el 2*4*4 = 32, W a_r folded
    # 2*2*4*4 = 64, er 2*3*4*2 = 48, edges 6*(4*2 + 2*4) = 96, nodes
    # (division and bias) 2*5*4 = 40 -> 408, times 3 with the backward;
    # loss 4*2*4*3 = 96; Adam 12*72 = 864
    flops = 408 * 3 + 96 + 864
    # graph 4*(2*6 + 5 + 1) = 72; layer parameters 32 + 16 + 4 = 52;
    # forward 4*(20 + 52 + 20) + 72; backward 4*(20 + 20 + 52 + 20 + 52)
    # + 72; loss 4*(8 + 4) + 4*8; Adam 28*72
    nbytes = 440 + 728 + 80 + 2016
    assert run.load("costs", "rgat").step_cost(CFG, sizes) == {
        "flops": flops, "bytes": nbytes}


def test_hgt_by_hand():
    # layer parameters: k, q, v 3*2*4*4 = 96, a 2*4*4 = 32, pri 2*2 = 4,
    # att and msg 2*2*2*2*2 = 32, skip 2 -> 166; embed 20
    sizes = dict(SIZES, num_params=20 + 166)
    # forward: k, q, v 6*5*4*4 = 480, att q and msg v 2*(4 + 3)*4*2 = 112,
    # edges 6*(4*4 + 3*2) = 132, nodes 5*(4 + 2*4*4) = 180 -> 904
    flops = 904 * 3 + 96 + 12 * 186
    nbytes = (4 * (20 + 166 + 20) + 72) + (4 * (20 + 20 + 166 + 20 + 166)
                                           + 72) + 80 + 28 * 186
    assert run.load("costs", "hgt").step_cost(CFG, sizes) == {
        "flops": flops, "bytes": nbytes}


def _ctx(**kw):
    return dict({"device_name": "NVIDIA H100 80GB HBM3",
                 "cost": {"flops": 67e12 * 0.001, "bytes": 3.35e12 * 0.002},
                 "window_steps": 10, "window_s": 1.0}, **kw)


def test_step_mfu_reads_the_larger_bound_and_refuses_past_100():
    read = run.load("metrics", "step_mfu_pct").read
    # least time 2 ms (bytes) a step of 100 ms
    assert read(_ctx()) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        read(_ctx(window_s=0.01))
    with pytest.raises(ValueError):
        read(_ctx(device_name="NVIDIA A100-SXM4-80GB"))


def test_trace_readers_find_nothing_without_a_trace():
    ctx = _ctx(trace=None)
    for name in ("gather_ms", "matmul_ms", "port_kernel_ms",
                 "port_kernel_launches", "device_idle_pct"):
        assert run.load("metrics", name).read(ctx) is None


def test_end_to_end_readers():
    ctx = {"edges": 1000, "window_steps": 30, "window_s": 2.0,
           "peak_bytes": 25e9, "setup_s": 31.5}
    got = {m: run.load("metrics", m).read(ctx)
           for m in ("train_edges_per_s", "peak_mem_gb", "setup_s")}
    assert got == {"train_edges_per_s": 15000.0, "peak_mem_gb": 25.0,
                   "setup_s": 31.5}


def test_trace_readers():
    trace = {"busy_s": 0.9, "by_category_s": {
        "gather / index": 0.5, "matmul": 0.1,
        "seg_sum_sorted (port kernel)": 0.03,
        "segment_matmul_dw (port kernel)": 0.01},
        "launches_by_category": {
            "seg_sum_sorted (port kernel)": 80,
            "segment_matmul_dw (port kernel)": 20, "matmul": 500}}
    ctx = _ctx(trace=trace, forward_ms=[30.0, 31.0, 29.0],
               backward_adam_ms=[70.0, 68.0, 72.0])
    got = {m: run.load("metrics", m).read(ctx) for m in (
        "gather_ms", "matmul_ms", "port_kernel_ms", "port_kernel_launches",
        "device_idle_pct", "fwd_ms", "bwd_adam_ms")}
    assert got == pytest.approx({
        "gather_ms": 50.0, "matmul_ms": 10.0, "port_kernel_ms": 4.0,
        "port_kernel_launches": 10.0, "device_idle_pct": 10.0,
        "fwd_ms": 30.0, "bwd_adam_ms": 70.0})
