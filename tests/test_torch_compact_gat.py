"""The packed compact GAT op's three walks (``ops/kernels/compact_gat.py``)
on the CPU: each plain version against the op's chain and its autograd,
the op's walk route (taken on the card) against its chain, and the
launches a forward and a backward make there.

The walk route runs here under a stand-in that makes ``_dispatch`` say a
CUDA tensor is at hand and counts each launch, while each wrapper runs its
plain version.  Tolerances: f32 sums in another order (rtol 1e-5, atol
1e-5 * max|want|)."""

import numpy as np
import pytest
import torch

from het_tpu_torch.graph.build import build_heterograph
from het_tpu_torch.ops import fused_agg, kernels
from het_tpu_torch.ops.fused_agg import CLIP_LOGIT, CompactFusedGATPacked
from het_tpu_torch.ops.kernels import (_dispatch, compact_gat_packed_bwd_dst,
                                       compact_gat_packed_bwd_dst_plain,
                                       compact_gat_packed_bwd_src,
                                       compact_gat_packed_bwd_src_plain,
                                       compact_gat_packed_fwd,
                                       compact_gat_packed_fwd_plain)

SLOPE = 0.2
NEW = ("compact_gat_packed_fwd", "compact_gat_packed_bwd_dst",
       "compact_gat_packed_bwd_src")


def hub_graph(num_nodes=60, num_edges=900, num_rels=3, seed=0):
    """A skewed graph: node 0 takes about a fifth of the edges (a run
    past the walks' split length), node 5 none; padding edges and padding
    compact rows (tile 8)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (1.0 + np.arange(num_nodes))
    w[5] = 0.0
    dst = rng.choice(num_nodes, size=num_edges, p=w / w.sum())
    src = rng.integers(0, num_nodes, size=num_edges)
    rel = rng.integers(0, num_rels, size=num_edges)
    return build_heterograph(src, dst, rel, num_nodes, num_rels, tile=8)


def _inputs(g, H, D, scale, seed=0):
    gen = torch.Generator().manual_seed(seed)
    UCs, UCd = g.compact_src.seg.n_rows, g.compact_dst.seg.n_rows
    fe = torch.randn(UCs, H, 1 + D, generator=gen)
    fe[..., 0] *= scale
    er = torch.randn(UCd, H, generator=gen) * scale
    ct = torch.randn(g.num_nodes, H, D, generator=gen)
    return fe.reshape(UCs, -1), er, ct


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def _chain(g, fe2d, er, ct, stable):
    """The op's chain (CPU tensors take it): out and the gradients of
    <out, ct> into fe2d and er."""
    fe2d = fe2d.clone().requires_grad_()
    er = er.clone().requires_grad_()
    out = CompactFusedGATPacked.apply(fe2d, er, g, SLOPE, stable, "kernel")
    d_fe, d_er = torch.autograd.grad((out * ct).sum(), (fe2d, er))
    return out.detach(), d_fe, d_er


@pytest.fixture(scope="module")
def graph():
    return hub_graph()


@pytest.mark.parametrize("stable,scale", [("raw", 1.0), ("clip", 60.0)])
@pytest.mark.parametrize("H,D", [(1, 8), (2, 3)])
def test_plain_walks_match_the_chain(graph, H, D, stable, scale):
    """The three plain versions and ``d_er``'s sum against the chain's
    output and autograd, under "raw" and with logits past the clip."""
    g = graph
    fe2d, er, ct = _inputs(g, H, D, scale)
    clip = CLIP_LOGIT if stable == "clip" else None
    out, d_fe, d_er = _chain(g, fe2d, er, ct, stable)
    src, dst = g.compact_src, g.compact_dst
    s, got = compact_gat_packed_fwd_plain(fe2d, er, src.edge_map,
                                          dst.edge_map, g.in_row_ptr, SLOPE,
                                          clip)
    _close(got, out)
    assert (s[5] == 0).all() and (got[5] == 0).all()  # no in-edges
    draw, alpha = compact_gat_packed_bwd_dst_plain(
        fe2d, er, src.edge_map, dst.edge_map, g.in_row_ptr, s, got, ct,
        SLOPE, clip)
    assert (draw[g.num_edges:] == 0).all()  # padding edges
    _close(compact_gat_packed_bwd_src_plain(draw, alpha, ct, g.dst,
                                            src.edge_row_ptr,
                                            src.edge_sort_perm), d_fe)
    _close(fused_agg._d_er(dst, draw, "plain"), d_er)


def test_wrappers_on_the_cpu_take_the_plain_versions(graph):
    g = graph
    fe2d, er, ct = _inputs(g, 2, 3, 1.0)
    src, dst = g.compact_src, g.compact_dst
    kernels.reset_launches()
    s, out = compact_gat_packed_fwd(fe2d, er, src.edge_map, dst.edge_map,
                                    g.in_row_ptr, SLOPE)
    want = compact_gat_packed_fwd_plain(fe2d, er, src.edge_map, dst.edge_map,
                                        g.in_row_ptr, SLOPE, None)
    assert torch.equal(s, want[0]) and torch.equal(out, want[1])
    draw, alpha = compact_gat_packed_bwd_dst(fe2d, er, src.edge_map,
                                             dst.edge_map, g.in_row_ptr, s,
                                             out, ct, SLOPE)
    d_fe = compact_gat_packed_bwd_src(draw, alpha, ct, g.dst,
                                      src.edge_row_ptr, src.edge_sort_perm)
    assert d_fe.shape == fe2d.shape
    assert not any(kernels.launch_counts().values())


def test_wrappers_raise_on_what_the_kernels_do_not_take(graph):
    g = graph
    fe2d, er, ct = _inputs(g, 2, 3, 1.0)
    src, dst = g.compact_src, g.compact_dst
    args = (src.edge_map, dst.edge_map, g.in_row_ptr, SLOPE)
    with pytest.raises(TypeError):
        compact_gat_packed_fwd(fe2d.bfloat16(), er, *args)
    with pytest.raises(TypeError):
        compact_gat_packed_fwd(fe2d, er, src.edge_map.long(), *args[1:])
    with pytest.raises(ValueError):
        compact_gat_packed_fwd(fe2d[:, :7], er, *args)  # not [el | feat]
    wide = torch.zeros(fe2d.shape[0], 2 * 258)
    with pytest.raises(ValueError, match="wider"):
        compact_gat_packed_fwd(wide, er, *args)
    with pytest.raises(ValueError):
        compact_gat_packed_fwd(fe2d, er, *args, impl="triton")
    s = torch.zeros(g.num_nodes, 2)
    with pytest.raises(TypeError):
        compact_gat_packed_bwd_dst(fe2d, er, *args[:3], s, ct[:-1], ct,
                                   SLOPE)


@pytest.fixture
def on_card(monkeypatch):
    """The walk route on CPU tensors: ``_dispatch`` says the wrappers
    launch under impl="kernel", and each launch is counted while the
    wrapper runs its plain version."""
    plain = _dispatch.takes_plain

    def counted(t, impl, what):
        if impl == "kernel":
            getattr(kernels, what).launches += 1
        return plain(t, "plain", what)

    monkeypatch.setattr(_dispatch, "launches",
                        lambda t, impl: impl == "kernel")
    monkeypatch.setattr(_dispatch, "takes_plain", counted)
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _counts():
    return {k: n for k, n in kernels.launch_counts().items() if n}


@pytest.mark.parametrize("stable,scale", [("raw", 1.0), ("clip", 60.0)])
def test_walk_route_matches_the_chain(graph, on_card, stable, scale):
    """f32 under "raw" and "clip" on the card takes the walks: one
    forward launches the forward walk alone, one backward the two
    backward walks and d_er's segment sum; the results are the chain's."""
    g = graph
    fe2d, er, ct = _inputs(g, 2, 3, scale, seed=1)
    fe_k = fe2d.clone().requires_grad_()
    er_k = er.clone().requires_grad_()
    out = CompactFusedGATPacked.apply(fe_k, er_k, g, SLOPE, stable, "kernel")
    assert _counts() == {"compact_gat_packed_fwd": 1}
    kernels.reset_launches()
    d_fe, d_er = torch.autograd.grad((out * ct).sum(), (fe_k, er_k))
    assert _counts() == {"compact_gat_packed_bwd_dst": 1,
                         "compact_gat_packed_bwd_src": 1,
                         "seg_sum_sorted": 1}
    want = _chain(g, fe2d, er, ct, stable)
    for a, b in zip((out.detach(), d_fe, d_er), want):
        _close(a, b)


@pytest.mark.parametrize("case", ["bf16", "max", "plain"])
def test_other_inputs_keep_the_chain(graph, on_card, case):
    """bf16 payloads, stable="max" and impl="plain" take the chain: no
    walk launches."""
    g = graph
    fe2d, er, ct = _inputs(g, 2, 3, 1.0)
    if case == "bf16":
        fe2d, er, ct = fe2d.bfloat16(), er.bfloat16(), ct.bfloat16()
    stable = "max" if case == "max" else "clip"
    impl = "plain" if case == "plain" else "kernel"
    fe2d.requires_grad_()
    out = CompactFusedGATPacked.apply(fe2d, er, g, SLOPE, stable, impl)
    (out * ct).sum().backward()
    assert not set(_counts()) & set(NEW)
    if impl == "kernel":
        assert _counts()["seg_sum_sorted"] > 0
