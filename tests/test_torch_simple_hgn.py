"""The port's Simple-HGN against the benchmark's plain reference
(``benchmark/reference/simple_hgn.py``, plain PyTorch per edge with
explicit self-loop edges), on seeded weights (``benchmark/params.py``) at
a tiny heterograph of 3 node types, one of which has no in-edges, with
padding edges: the logits, every leaf's gradient and the parameters after
two Adam steps, with the op's edges in one block and in several (their
boundaries between two destinations' segments), under "clip" and "raw".
Then: the previous layer's attention enters detached; the configuration
file's constants are the model's defaults; the blocks bound every
per-edge tensor the op builds; the node blocks themselves; a traced step's
spans and the op's counters; and the trainer's ``--model SimpleHGN`` on
the CPU."""

import json
import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import params
from benchmark.reference import common as refc
from benchmark.reference import simple_hgn as ref
from benchmark.run import load
from het_tpu_torch import ops
from het_tpu_torch.graph.blocks import graph_blocks, node_blocks
from het_tpu_torch.graph.build import build_heterograph
from het_tpu_torch.models import simple_hgn
from het_tpu_torch.ops import fused_agg
from het_tpu_torch.train import TrainConfig, train
from het_tpu_torch.train.driver import build_model
from het_tpu_torch.train.loop import train_steps
from het_tpu_torch.utils import spans
from het_tpu_torch.utils.misc import nll_loss

CPU = torch.device("cpu")
SEED = 2**31 + 5
CONFIG = "benchmark/configs/simplehgn3_h8_64.json"
GRAPH = {"node_types": [["a", 40], ["b", 30], ["c", 20]],
         "relations": [["ab", "a", "b", 260], ["ba", "b", "a", 180],
                       ["aa", "a", "a", 120], ["cb", "c", "b", 90]],
         "train_nodes": {"type": "b", "count": 24}}
SMALL = dict(n_infeat=8, hidden=4, num_heads=2, num_layers=3,
             num_classes=5)
# logits (within 1.5e-7 of the reference at a scale of 1): f32 sums of a
# few terms in another order (the port's segment sums round once from f64
# on the CPU, the reference adds in f32), and el, er taken as x (W a)
# rather than (x W) a
LOGITS = dict(rtol=1e-5, atol=1e-6)
# gradients (within 9e-7 of each leaf's largest element): the same
# round-off carried through three layers' backward
GRAD = dict(rtol=1e-5)
GRAD_ATOL = 1e-5  # of the leaf's largest element
# parameters after two Adam steps (within 1.2e-7): Adam divides each
# element's gradient by its root mean square, which carries the
# gradients' round-off into the step undiminished
ADAM = dict(rtol=1e-5, atol=1e-6)


def _cfg(stable):
    with open(CONFIG) as f:
        return dict(json.load(f), **SMALL, stable_softmax=stable)


@pytest.fixture(scope="module")
def graph():
    inp = load("graphs", "ogbn_mag").generate(GRAPH, SMALL["num_classes"],
                                              SEED, CPU)
    N, R = inp["num_nodes"], inp["num_rels"]
    g = build_heterograph(*(inp[k].numpy() for k in ("src", "dst", "rel")),
                          N, R, ntype_offsets=inp["ntype_offsets"], tile=8)
    assert g.num_padded_edges > g.num_edges
    assert (g.in_deg[70:] == 0).all()  # type c: no in-edges
    rg = refc.ref_graph(inp["src"], inp["dst"], inp["rel"], N, R,
                        inp["ntype_offsets"])
    return SimpleNamespace(g=g, rg=rg, inp=inp, N=N, R=R,
                           T=len(inp["ntype_offsets"]) - 1)


def _blocks(monkeypatch, edges, width):
    """Make the op's blocks ``edges`` edges long at ``width`` lanes (its
    payload bound set to that many f32 rows)."""
    monkeypatch.setattr(fused_agg, "HGN_BLOCK_BYTES", 4 * width * edges)
    assert fused_agg.hgn_block_edges(width) == edges


def _net(graph, cfg):
    tcfg = TrainConfig(model="SimpleHGN", **SMALL,
                       stable_softmax=cfg["stable_softmax"])
    net = build_model(tcfg, SimpleNamespace(graph=graph.g,
                                            num_classes=cfg["num_classes"]),
                      generator=torch.Generator().manual_seed(0))
    shapes = ref.param_shapes(cfg, graph.N, graph.R, graph.T)
    net.load_state_dict(params.seeded_params(shapes, SEED, CPU))
    return net, shapes


def _grads(loss, named):
    names = list(named)
    return dict(zip(names, torch.autograd.grad(loss, [named[n]
                                                      for n in names])))


# 1000 edges at the hidden layers' 8 lanes: one block; 150: five, each
# a run of whole destination segments (the output layer's 5 lanes take
# 1600 and 240)
@pytest.mark.parametrize("block_edges", [1000, 150], ids=["one", "several"])
@pytest.mark.parametrize("stable", ["clip", "raw"])
def test_model_matches_the_reference(graph, stable, block_edges,
                                     monkeypatch):
    cfg = _cfg(stable)
    _blocks(monkeypatch, block_edges, SMALL["hidden"] * SMALL["num_heads"])
    net, shapes = _net(graph, cfg)
    g = graph.g
    blocks = graph_blocks(g, "dst", block_edges)
    assert (len(blocks) == 1) == (block_edges >= g.num_edges)
    idx = graph.inp["train_idx"]
    lab = graph.inp["labels"][idx]
    logits = net(g)
    got = _grads(refc.nll(logits[idx], lab), dict(net.named_parameters()))

    p = {n: t.clone().requires_grad_(True)
         for n, t in params.seeded_params(shapes, SEED, CPU).items()}
    want_logits = ref.forward(p, graph.rg, cfg)
    want = _grads(refc.nll(want_logits[idx], lab), p)
    torch.testing.assert_close(logits, want_logits, **LOGITS)
    assert set(got) == set(want)
    for n in want:
        scale = float(want[n].abs().max())
        torch.testing.assert_close(got[n], want[n], atol=GRAD_ATOL * scale,
                                   **GRAD, msg=n)

    # two Adam steps on each side from the same start
    train_steps(net, lambda: (nll_loss(net(g)[idx], lab),) * 2, steps=2,
                lr=cfg["lr"], device=CPU)
    start = params.seeded_params(shapes, SEED, CPU)
    refc.train_readings(lambda q, gr: ref.forward(q, gr, cfg), start,
                        graph.rg, graph.inp["labels"], idx, lr=cfg["lr"],
                        steps=2)
    for n, t in net.named_parameters():
        torch.testing.assert_close(t.detach(), start[n], **ADAM, msg=n)


def test_previous_attention_enters_detached(graph, monkeypatch):
    g, N = graph.g, graph.N
    H, D = 2, 3
    _blocks(monkeypatch, 50, H * D)
    gen = torch.Generator().manual_seed(3)
    feat = torch.randn(N, H * D, generator=gen, requires_grad=True)
    el, er = (torch.randn(N, H, generator=gen, requires_grad=True)
              for _ in range(2))
    ee = torch.randn(graph.R + 1, H, generator=gen, requires_grad=True)
    prev = torch.rand(g.num_padded_edges + N, H, generator=gen,
                      requires_grad=True)
    out, alpha = ops.simple_hgn_attention(
        g, feat, el, er, ee, prev, beta=0.05, slope=0.05, keep_alpha=True)
    assert not alpha.requires_grad
    out.square().sum().backward()
    assert prev.grad is None
    assert all(t.grad is not None for t in (feat, el, er, ee))
    # a destination's softmax (its edges and its self-loop) sums to 1, so
    # its mixed attention to 0.95 + 0.05 (the same sum of prev)
    def per_dst(a):
        E, EP = g.num_edges, g.num_padded_edges
        return torch.zeros(N, H).index_add_(0, g.dst[:E].long(),
                                            a[:E]) + a[EP:]

    torch.testing.assert_close(per_dst(alpha),
                               0.95 + 0.05 * per_dst(prev.detach()))
    assert (alpha[g.num_edges:g.num_padded_edges] == 0).all()


def test_config_constants_are_the_model_defaults(graph):
    with open(CONFIG) as f:
        cfg = json.load(f)
    assert (cfg["edge_feats"], cfg["beta"], cfg["slope"]) == (
        simple_hgn.EDGE_FEATS, simple_hgn.BETA, simple_hgn.SLOPE)
    net, _ = _net(graph, dict(cfg, **SMALL))
    for layer in net.model.layers:
        assert layer.edge_emb.shape[1] == cfg["edge_feats"]


class _Largest(TorchDispatchMode):
    """The most elements any op's output holds."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_blocks_bound_every_per_edge_tensor(graph, monkeypatch):
    """At H*D = 64 lanes and 650 edges, one block builds (650, 64)
    tensors; blocks of at most 100 edges none past 100 x 64 elements, the
    node tensors (90 x 64) and the attention carried ((EP + N) x H)
    included, for the same result."""
    g, N = graph.g, graph.N
    H, D, B = 2, 32, 100
    assert B * H * D > max(N * H * D, (g.num_padded_edges + N) * H)
    gen = torch.Generator().manual_seed(4)
    inputs = [torch.randn(N, H * D, generator=gen),
              torch.randn(N, H, generator=gen),
              torch.randn(N, H, generator=gen),
              torch.randn(graph.R + 1, H, generator=gen),
              torch.rand(g.num_padded_edges + N, H, generator=gen)]
    got = {}
    for n in (g.num_edges, B):
        _blocks(monkeypatch, n, H * D)
        leaves = [t.clone().requires_grad_(i < 4)
                  for i, t in enumerate(inputs)]
        with _Largest() as mode:
            out, alpha = ops.simple_hgn_attention(
                g, *leaves, beta=0.05, slope=0.05, keep_alpha=True)
            out.square().sum().backward()
        got[n] = (mode.most, out, alpha,
                  [t.grad for t in leaves[:4]])
    assert got[g.num_edges][0] >= g.num_edges * H * D
    assert got[B][0] <= B * H * D
    for a, b in zip(got[g.num_edges][1:3] + tuple(got[g.num_edges][3]),
                    got[B][1:3] + tuple(got[B][3])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_node_blocks():
    ptr = torch.tensor([0, 3, 3, 9, 10, 30, 31, 31], dtype=torch.int32)
    assert node_blocks(ptr, 6) == ((0, 2, 0, 3), (2, 3, 3, 9),
                                   (3, 4, 9, 10), (4, 5, 10, 30),
                                   (5, 7, 30, 31))
    assert node_blocks(ptr, 100) == ((0, 7, 0, 31),)
    with pytest.raises(ValueError):
        node_blocks(ptr, 0)


def test_traced_steps_record_the_ops_spans_and_counters(graph,
                                                       monkeypatch):
    """Each layer's op under ``agg:simple_hgn_attention`` with its blocks,
    bytes and carried attention counted; the residual attention's own
    ``res_attn`` spans forward and backward; the linears under
    ``linear:``."""
    _blocks(monkeypatch, 100, SMALL["hidden"] * SMALL["num_heads"])
    net, _ = _net(graph, _cfg("clip"))
    idx = graph.inp["train_idx"]
    lab = graph.inp["labels"][idx]
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        train_steps(net, lambda: (nll_loss(net(graph.g)[idx], lab),) * 2,
                    steps=2, lr=0.01, device=CPU)
    steps = spans.REGISTRY.steps
    assert len(steps) == 1  # the first step is set-up
    fwd, bwd = "step/het.forward", "step/het.backward"
    op = "agg:simple_hgn_attention"
    EP, H = graph.g.num_padded_edges, 2
    # the hidden layers' 8 lanes: 100 edges a block; the output layer's
    # 5: 160
    n_blocks = len(graph_blocks(graph.g, "dst", 100))
    n_out = len(graph_blocks(graph.g, "dst",
                             fused_agg.hgn_block_edges(SMALL["num_classes"])))
    assert n_blocks > n_out > 1
    for step in steps:
        for i in range(3):
            t = step[f"{fwd}/layer{i}/{op}"]
            assert t["dst_blocks"] == (n_out if i == 2 else n_blocks)
            assert t["bytes"] > 0
            assert t["alpha_carried_bytes"] == (4 * (EP + graph.N) * H
                                                if i == 0 else 0)
            assert step[f"{bwd}/layer{i}/{op}"]["calls"] == 0  # grafted
        # layer 0 writes its attention; layer 1 mixes it in, forward and
        # backward, a block each
        assert step[f"{fwd}/layer0/{op}/NodeFusedHGNAttention/res_attn"][
            "calls"] == n_blocks
        assert step[f"{fwd}/layer1/{op}/NodeFusedHGNAttention/res_attn"][
            "calls"] == 2 * n_blocks
        assert step[f"{bwd}/layer1/{op}/NodeFusedHGNAttentionBackward/"
                    "res_attn"]["calls"] == 3 * n_blocks
        assert not any("res_attn" in p for p in step if "layer2" in p)
        assert {f"{fwd}/linear:ntype_linear",
                f"{fwd}/layer1/linear:attention_projection",
                f"{fwd}/layer1/linear:edge_type_logits",
                f"{fwd}/layer2/linear:node_linear"} <= set(step)
    spans.reset()


def test_trainer_runs_simple_hgn_on_the_cpu():
    m = train(TrainConfig(model="SimpleHGN", dataset="mag",
                          dataset_scale=0.0005, n_infeat=8, hidden=4,
                          num_heads=2, num_layers=3, num_epochs=2,
                          warmup_epochs=0, device="cpu"), log=lambda s: None)
    assert m["model"] == "SimpleHGN" and len(m["loss_list"]) == 2
    assert all(math.isfinite(x) for x in m["loss_list"])
    assert m["flags"]["stable_softmax"] == "clip"
