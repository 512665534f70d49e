"""The pieces the Simple-HGN cell adds: the plain reference's parameter
shapes against the port's state dict, the step and op counts of
``costs/simple_hgn.py`` on hand-counted tiny sizes, the two new readers
on a fake span registry, and a tiny traced run of the cell end to end on
the CPU."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans, run
from benchmark.costs import simple_hgn as costs
from benchmark.tests.tiny import CPU, tiny_spec

H100 = "NVIDIA H100 80GB HBM3"
CELL = "simplehgn.mag.plain"


def test_reference_shapes_are_the_ports_state_dict():
    from het_tpu_torch.graph import random_heterograph
    from het_tpu_torch.train.driver import build_model
    spec = run.cell_spec(CELL)
    cfg = spec.config
    g = random_heterograph(num_nodes=30, num_edges=90, num_rels=3, seed=1,
                           tile=8)
    net = build_model(run.trainer_config(cfg, []),
                      SimpleNamespace(graph=g, num_classes=cfg["num_classes"]),
                      generator=torch.Generator())
    shapes = run.load("reference", cfg["family"]).param_shapes(
        cfg, g.num_nodes, g.num_rels, g.num_ntypes)
    assert shapes == {n: tuple(p.shape) for n, p in net.named_parameters()}
    # the hidden layers' 8 x 64 heads; the output layer's one head of 64
    assert shapes["model.layers.1.fc"] == (512, 512)
    assert "model.layers.1.res_fc" not in shapes  # identity: 512 = 8 x 64
    assert shapes["model.layers.2.res_fc"] == (512, 64)
    assert shapes["model.layers.0.edge_emb"] == (4, 64)
    assert all(n.endswith(".bias") for n, s in shapes.items()
               if len(s) == 1 or "bias" in n)


TINY_CFG = {"num_layers": 3, "n_infeat": 2, "hidden": 2, "num_heads": 2,
            "num_classes": 3, "edge_feats": 2}
TINY = {"num_nodes": 3, "num_edges": 4, "num_rels": 1, "num_ntypes": 1,
        "train_nodes": 2, "num_params": 100}


def test_agg_bytes_by_hand():
    """E1 = 4 + 3 = 7 edges with the self-loops, 2 relation rows.  Layer
    0: 2 heads of 2 (HD 4), hands its attention on; layer 1: the same,
    takes it; layer 2: 1 head of 3, neither."""
    l0 = 3 * 7 * 4 + 2 * 3 * 4 + 8 * 3 * 2 + 3 * 2 * 2 + 7 * 2 * 1
    l1 = 3 * 7 * 4 + 2 * 3 * 4 + 8 * 3 * 2 + 3 * 2 * 2 + 7 * 2 * 2
    l2 = 3 * 7 * 3 + 2 * 3 * 3 + 8 * 3 * 1 + 3 * 2 * 1
    assert costs.agg_bytes(TINY_CFG, TINY) == 4 * (l0 + l1 + l2)


def test_step_cost_by_hand():
    n, e1, g_bytes = 3, 7, 4 * (2 * 4 + 3 + 1)
    fc_in = n * (2 * 2 * 2 + 2)
    # (F, heads, HD, el/er lesser form, takes prev, residual, res_fc)
    rows = [(2, 2, 4, min(2 * n * 4, 2 * 2 * 4 + 2 * n * 2 * 2), 0, 0, 0),
            (4, 2, 4, min(2 * n * 4, 2 * 4 * 4 + 2 * n * 4 * 2), 1, 1, 0),
            (4, 1, 3, min(2 * n * 3, 2 * 4 * 3 + 2 * n * 4 * 1), 0, 1, 1)]
    fwd, nbytes = fc_in, 4 * (3 * n * 2 + 2 * n * 2 + 3 * 1 * 3 * 2)
    for i, (f, h, hd, logit, prev, res, res_fc) in enumerate(rows):
        hidden = i < 2
        fwd += (2 * n * f * hd + 2 * logit + 2 * (2 * 2 * h * 2 + 2 * h * 2)
                + e1 * (6 * h + 2 * hd + 3 * h * prev)
                + n * hd * (res + hidden) + 2 * n * f * hd * res_fc)
        params = f * hd * (1 + res_fc) + 2 * hd + 2 * 2 + 2 * h * 2 + h * 2
        nbytes += 4 * (n * f + params + n * hd) + g_bytes + 4 * (
            n * hd + n * f + params + n * f + params) + g_bytes
    fwd += 3 * n * 3
    loss_f, loss_b = 4 * 2 * 3 * 3, 4 * (2 * 3 + 2 * 2) + 4 * 2 * 3
    adam_f, adam_b = 12 * 100, 7 * 4 * 100
    got = costs.step_cost(TINY_CFG, TINY)
    assert got["flops"] == pytest.approx(3 * fwd + loss_f + adam_f)
    assert got["bytes"] == pytest.approx(nbytes + loss_b + adam_b)
    assert got["agg_bytes"] == costs.agg_bytes(TINY_CFG, TINY)


def _step(agg_ms=(2.0, 3.0), res_ms=0.5):
    f, b = program_spans.FORWARD, program_spans.BACKWARD
    op = "agg:simple_hgn_attention"

    def t(ms, calls=1):
        return {"calls": calls, "ms": ms, "self_ms": 0.0}
    return {
        "step": t(10.0), f: t(4.0), b: t(6.0),
        f"{f}/layer0/{op}": t(agg_ms[0]),
        f"{f}/layer0/{op}/NodeFusedHGNAttention/res_attn": t(res_ms),
        f"{b}/layer0/{op}": t(agg_ms[1], 0),
        f"{b}/layer0/{op}/NodeFusedHGNAttentionBackward": t(agg_ms[1]),
        f"{b}/layer0/{op}/NodeFusedHGNAttentionBackward/res_attn": t(
            2 * res_ms, 3),
    }


def read(name, **ctx):
    return run.load("metrics", name).read(
        {"window_steps": 2, "device_name": H100, "cost": None, **ctx})


def test_readers_on_a_fake_registry(monkeypatch):
    monkeypatch.setattr(program_spans, "registry", lambda: None)
    assert read("res_attn_ms") is None
    assert read("hgn_agg_roofline_pct",
                cost={"agg_bytes": 1.0}) is None
    reg = SimpleNamespace(steps=[_step(), _step()], setup={})
    monkeypatch.setattr(program_spans, "registry", lambda: reg)
    assert read("res_attn_ms") == pytest.approx(0.5 + 1.0)
    # 3.35 GB at 3.35 TB/s is 1 ms, in the op's 5 ms a step
    cost = {"agg_bytes": 3.35e9}
    assert read("hgn_agg_roofline_pct", cost=cost) == pytest.approx(20.0)
    assert read("hgn_agg_roofline_pct", cost={"flops": 1.0}) is None
    reg.steps = [_step(agg_ms=(0.4, 0.5))] * 2
    with pytest.raises(ValueError, match="outside"):
        read("hgn_agg_roofline_pct", cost=cost)
    reg.steps = [_step()]  # not the window's steps
    assert read("res_attn_ms") is None


def test_a_traced_tiny_simple_hgn_run():
    from het_tpu_torch.utils import spans
    spans.reset()
    spec = tiny_spec(CELL)
    result, notes = run.run_cell(spec, 2**31 + 13, 0.2, True, CPU)
    assert result["correct"] is True
    ctx = dict(notes["ctx"], device_name=H100)
    assert ctx["cost"]["agg_bytes"] > 0
    assert run.load("metrics", "res_attn_ms").read(ctx) > 0
    assert 0 < run.load("metrics", "hgn_agg_roofline_pct").read(ctx) <= 100
    fwd = [t for s in spans.REGISTRY.steps for p, t in s.items()
           if p.endswith("/agg:simple_hgn_attention") and t["calls"]]
    assert len(fwd) == 3 * ctx["window_steps"]
    assert sum(t["alpha_carried_bytes"] > 0 for t in fwd) == ctx[
        "window_steps"]  # layer 0 hands its attention to layer 1
    assert all(t["dst_blocks"] >= 1 and t["bytes"] > 0 for t in fwd)
    spans.reset()
    with open(run.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    mine = [m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", [CELL])]
    assert {"res_attn_ms", "hgn_agg_roofline_pct", "fused_agg_ms",
            "typed_linear_ms", "step_mfu_pct"} <= set(mine)
    assert "compact_build_s" not in mine
