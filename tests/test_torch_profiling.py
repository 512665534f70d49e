"""The port's step bound (``het_tpu_torch/utils/profiling.py``) against
het_tpu's on the same numpy COO and the same peaks: the strict bound in
f32 and every per-op cost but the fused aggregation's operations equal
within 1e-12 relative.  The port's own terms (the fused aggregation's
operations, the traffic bound, the bf16 strict bound) held to a hand count
on a graph of 40 edges.  ``device_peaks`` and ``trace``."""

import json

import numpy as np
import pytest
import torch

from het_tpu.graph import build_heterograph as j_build_heterograph
from het_tpu.utils import profiling as jp
from het_tpu_torch.graph import build_heterograph as t_build_heterograph
from het_tpu_torch.utils import profiling as tp

N, E, R = 12, 40, 3
EXACT = dict(rtol=1e-12, atol=0)
# the H100 row and het_tpu's own TPU row, each in both packages' keys
PEAKS = [tp.H100_SXM, {"hbm_gbps": 470.0, "f32_tflops": 30.0,
                       "bf16_tflops": 30.0}]


def _jax_peaks(p):
    return {"hbm_gbps": p["hbm_gbps"], "mxu_tflops_f32": p["f32_tflops"]}


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(4)
    coo = (rng.integers(0, N, E), rng.integers(0, N, E),
           rng.integers(0, R, E))
    return (j_build_heterograph(*coo, N, R, tile=8),
            t_build_heterograph(*coo, N, R, tile=8))


# (f_in, heads, d_head, classes): bench.py's and two narrower
SHAPES = [(64, 4, 2, 8), (5, 2, 3, 6), (16, 1, 8, 8)]


@pytest.mark.parametrize("peaks", PEAKS, ids=["h100", "v5e"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_strict_bound_matches_het_tpu(graphs, shape, peaks):
    jg, tg = graphs
    want = jp.rgat_compact_step_roofline_ms(jg, *shape, itemsize=4,
                                            peaks=_jax_peaks(peaks))
    got = tp.rgat_compact_step_roofline_ms(tg, *shape, itemsize=4,
                                           peaks=peaks)
    np.testing.assert_allclose(got, want, **EXACT)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_layer_costs_match_het_tpu(graphs, shape, itemsize):
    jg, tg = graphs
    f_in, heads, d_head, _ = shape
    want = jp.rgat_layer_costs(jg, f_in, heads, d_head, itemsize)
    got = tp.rgat_layer_costs(tg, f_in, heads, d_head, itemsize)
    assert list(got) == list(want)
    for name in want:
        assert got[name].name == want[name].name
        np.testing.assert_allclose(got[name].hbm_bytes, want[name].hbm_bytes,
                                   **EXACT)
        if name != "fused_softmax_agg":
            np.testing.assert_allclose(got[name].flops, want[name].flops,
                                       **EXACT)
            for p in PEAKS:
                np.testing.assert_allclose(
                    got[name].time_ms(p), want[name].time_ms(_jax_peaks(p)),
                    **EXACT)


def test_speed_of_light_rows_match_het_tpu(graphs):
    jg, tg = graphs
    measured = {"gather_src": 0.01, "attn_logits": 0.002}
    want = json.loads(jp.speed_of_light_report(
        jg, measured, 5, 2, 3, peaks=_jax_peaks(tp.H100_SXM)))
    got = json.loads(tp.speed_of_light_report(tg, measured, 5, 2, 3,
                                              peaks=tp.H100_SXM))
    assert [r["op"] for r in got] == [r["op"] for r in want]
    for a, b in zip(got, want):
        if a["op"] != "fused_softmax_agg":
            assert a == b


def test_port_terms_hand_count(graphs):
    """At f_in 5, 2 heads of 3, 6 classes: H = 2, D = 3, C = 6, P = 8."""
    g = graphs[1]
    # the graph's sizes the counts read
    assert (g.num_edges, g.num_padded_edges, g.num_nodes) == (40, 1152, 12)
    assert (g.compact_src.seg.n_rows, g.compact_dst.seg.n_rows) == (32, 32)
    p = tp.H100_SXM
    # the fused aggregation: the payload on every padded edge row (EP C =
    # 1152 * 6) and the two sums over the real edges (E (C + H) = 40 * 8)
    flops = tp.rgat_layer_costs(g, 5, 2, 3)["fused_softmax_agg"].flops
    assert flops == 1152 * 6 + 40 * 8 == 7232
    # per-edge lanes: forward P + H + 2H + 2C = 8 + 2 + 4 + 12; backward
    # (P + H) + (C + 2H) + 2H + 2C + H = 10 + 10 + 4 + 12 + 2
    assert tp.compact_step_edge_lanes(2, 3) == {"forward": 26,
                                                "backward": 38}
    # the strict step's elements: forward N K + UCs P + UCd H + (UCs P +
    # UCd H) + N H D = 60 + 256 + 64 + 320 + 72 = 772; backward N classes
    # + 2 (UCs P + UCd H) + (UCs P + UCd H) + 2 UCs K + N K = 72 + 640 +
    # 320 + 320 + 60 = 1412; operations 3 * 2 UCs H K (1 + D) = 7680
    elems, ops = 772 + 1412, 3 * 2 * 32 * 2 * 5 * 4
    assert ops == 7680
    # bf16: 2 bytes an element at the HBM rate against the bf16 rate
    bf16 = tp.rgat_compact_step_roofline_ms(g, 5, 2, 3, 6, itemsize=2,
                                            peaks=p)
    want = max(elems * 2 / 3.35e12, ops / 989e12) * 1e3
    np.testing.assert_allclose(bf16, want, **EXACT)
    assert bf16 == pytest.approx(4368 / 3.35e12 * 1e3, rel=1e-12)
    # traffic, f32: the strict bytes plus 64 lanes on each of 1152 edges
    traffic = tp.rgat_compact_step_traffic_ms(g, 5, 2, 3, 6, itemsize=4,
                                              peaks=p)
    np.testing.assert_allclose(
        traffic, (elems * 4 + 1152 * 64 * 4) / 3.35e12 * 1e3, **EXACT)
    # both bounds of the step at once: the traffic one is the larger
    strict = tp.rgat_compact_step_roofline_ms(g, 5, 2, 3, 6, peaks=p)
    assert strict < traffic


def test_device_peaks(monkeypatch):
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe",
                 "Tesla V100-SXM2-16GB"):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a, n=name: n)
        with pytest.raises(ValueError, match=name):
            tp.device_peaks()
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert tp.device_peaks() == {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                                 "bf16_tflops": 989.0}
    assert tp.device_peaks() is not tp.H100_SXM


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with tp.trace(str(logdir), cuda=False) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
