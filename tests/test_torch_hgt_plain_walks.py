"""HGT's plain layer core in three walks (``ops/kernels/hgt_plain.py``) on
the CPU: each plain version against ``HGTPlainFull``'s chain and its
autograd, the op's walk route (taken on the card) against its chain and
against het_tpu's ``_make_hgt_plain_full_op``, the orders the card's
walks read, and the launches a forward and a backward make there.

The graphs: a skewed one (a destination and a source past the walks'
split length, destinations with no in-edge, padding edges), a shard's
(sources past ``num_nodes``) and one with more relations than the card's
shared memory holds weights for.  The walk route runs here under a
stand-in that makes ``_dispatch`` say a CUDA tensor is at hand and counts
each launch, while each wrapper runs its plain version.  Tolerances:
values rtol 1e-5 / atol 1e-5 * max|want| (f32 sums in another order);
against het_tpu, the repo's backend-parity ones."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from het_tpu.graph import build_heterograph as j_build_heterograph
from het_tpu.ops.pallas.fused_agg import hgt_fused_plain_full
from het_tpu_torch.graph.build import build_heterograph
from het_tpu_torch.ops import kernels
from het_tpu_torch.ops.fused_agg import (CLIP_LOGIT, HGTPlainFull,
                                         _hgt_walk_plan)
from het_tpu_torch.ops.kernels import (_dispatch, hgt_plain_bwd_dst,
                                       hgt_plain_bwd_dst_plain,
                                       hgt_plain_bwd_src,
                                       hgt_plain_bwd_src_plain,
                                       hgt_plain_fwd, hgt_plain_fwd_plain)
from het_tpu_torch.ops.kernels.hgt_plain import (SPLIT_LEN, dst_runs,
                                                 src_rel_perm)
from het_tpu_torch.ops.linear import edge_rel_scale_grad
from het_tpu_torch.utils import spans

NEW = ("hgt_plain_fwd", "hgt_plain_bwd_dst", "hgt_plain_bwd_src")
NAMES = ("v", "q", "k", "w_msg", "w_att", "mu")
VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)


def _graph_coo(kind, seed=0):
    """COO arrays of graph ``kind``: "hub" (node 0 takes about a fifth of
    the edges into it and node 7 a fifth of those out of it, node 5 no
    in-edge), "shard" (the same with sources over 90 rows past the 60
    destinations) or "rels" (60 relations: 2 * 60 * 2 * 64 + 120 floats of
    weights at H = 2, dk = 8, past the card's shared memory for them)."""
    rng = np.random.default_rng(seed)
    N, E = 60, 900
    R = 60 if kind == "rels" else 3
    S = 90 if kind == "shard" else N
    w = 1.0 / (1.0 + np.arange(N))
    w[5] = 0.0
    dst = rng.choice(N, size=E, p=w / w.sum())
    src = rng.integers(0, S, size=E)
    src[:E // 5] = 7
    rel = rng.integers(0, R, size=E)
    return src, dst, rel, N, R, S


def _graph(kind):
    src, dst, rel, N, R, S = _graph_coo(kind)
    return build_heterograph(src, dst, rel, N, R, tile=8, src_space=S)


@pytest.fixture(scope="module")
def graphs():
    return {k: _graph(k) for k in ("hub", "shard", "rels")}


def _inputs(g, H, dk, scale, seed=0):
    """v, q, k, w_msg, w_att, mu and the output's cotangent ct."""
    gen = torch.Generator().manual_seed(seed)
    S, N, R = g.src_space, g.num_nodes, g.num_rels
    HD = H * dk

    def n(*shape):
        return torch.randn(*shape, generator=gen)

    mu = 1.0 + 0.3 * n(R, H)
    return (n(S, HD), n(N, HD) * scale, n(S, HD), n(R, H, dk, dk) / 2,
            n(R, H, dk, dk) / 2, mu), n(N, H, dk)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def _op(g, inputs, ct, clip, impl="kernel"):
    """The op's output and the gradients of <out, ct> into every input."""
    xs = [x.clone().requires_grad_() for x in inputs]
    out = HGTPlainFull.apply(*xs, g, clip, impl)
    grads = torch.autograd.grad((out * ct.to(out.dtype)).sum(), xs)
    return (out.detach(),) + grads


@pytest.mark.parametrize("stable,scale", [("raw", 1.0), ("clip", 30.0)])
@pytest.mark.parametrize("kind", ["hub", "shard", "rels"])
def test_plain_walks_match_the_chain(graphs, kind, stable, scale):
    """The three plain versions and ``d_mu``'s dW against the chain's
    output and autograd, under "raw" and with logits past the clip; the
    source walk both through ``out_perm`` and through the card's (source,
    relation) order."""
    g = graphs[kind]
    (v, q, k, wm, wa, mu), ct = _inputs(g, 2, 8, scale)
    clip = CLIP_LOGIT if stable == "clip" else None
    want = _op(g, (v, q, k, wm, wa, mu), ct, clip)
    s, out, score = hgt_plain_fwd_plain(v, q, k, wm, wa, mu, g.src, g.rel,
                                        g.in_row_ptr, clip)
    _close(out, want[0])
    assert (s[5] == 0).all() and (out[5] == 0).all()  # no in-edges
    assert (score[g.num_edges:] == 0).all()  # padding edges
    seg = g.edge_rel_seg
    draw, alpha, d_q, d_wm, d_wa, score_rows, draw_rows = \
        hgt_plain_bwd_dst_plain(v, q, k, wm, wa, mu, g.src, g.rel,
                                g.in_row_ptr, score, s, out, ct, clip,
                                seg.inv, seg.n_rows)
    assert (draw[g.num_edges:] == 0).all()
    assert not score_rows[~seg.row_valid].any()  # padding rows
    assert not draw_rows[~seg.row_valid].any()
    for perm in (g.out_perm, _hgt_walk_plan(g)[1]):
        d_k, d_v = hgt_plain_bwd_src_plain(q, ct, wm, wa, mu, g.dst, g.rel,
                                           g.out_row_ptr, perm, draw, alpha)
        _close(d_k, want[3])
        _close(d_v, want[1])
    d_mu = edge_rel_scale_grad(g, score, draw, impl="plain")
    d_mu_rows = edge_rel_scale_grad(g, score_rows, draw_rows, impl="plain",
                                    rows=True)
    for got, w in zip((d_q, d_wm, d_wa, d_mu, d_mu_rows),
                      (want[2], want[4], want[5], want[6], want[6])):
        _close(got, w)


def test_walk_orders(graphs):
    """The (dst, rel) runs against a count by hand, and the source order:
    a permutation of ``out_perm`` within each source's edges, sorted by
    relation there."""
    g = graphs["hub"]
    runs = dst_runs(g.rel, g.in_row_ptr, g.num_rels)
    E = g.num_edges
    dst, rel = g.dst[:E].tolist(), g.rel[:E].tolist()
    starts = [e for e in range(E)
              if e == 0 or (dst[e], rel[e]) != (dst[e - 1], rel[e - 1])]
    assert runs.run_ptr.tolist() == starts + [E]
    assert runs.row_run.tolist() == [
        sum(1 for s in starts if s < p) for p in g.in_row_ptr.tolist()]
    slots = runs.run_slot.long()
    assert sorted(slots.tolist()) == list(range(len(starts)))
    by_rel = [rel[starts[j]] for j in torch.argsort(slots).tolist()]
    assert by_rel == sorted(by_rel)
    assert runs.seg.seg_ptrs_static == tuple(
        np.searchsorted(by_rel, np.arange(g.num_rels + 1)))
    assert max(np.diff(g.in_row_ptr.numpy())) > SPLIT_LEN  # a split row
    perm = src_rel_perm(g.src, g.rel, g.out_row_ptr, g.out_perm, g.num_rels)
    assert max(np.diff(g.out_row_ptr.numpy())) > SPLIT_LEN
    assert torch.equal(perm[E:], g.out_perm[E:])
    for a, b in zip(g.out_row_ptr[:-1].tolist(), g.out_row_ptr[1:].tolist()):
        mine = perm[a:b].long()
        assert sorted(mine.tolist()) == sorted(g.out_perm[a:b].tolist())
        assert g.rel[mine].tolist() == sorted(g.rel[mine].tolist())


def test_wrappers_on_the_cpu_take_the_plain_versions(graphs):
    g = graphs["hub"]
    (v, q, k, wm, wa, mu), ct = _inputs(g, 2, 4, 1.0)
    kernels.reset_launches()
    s, out, score = hgt_plain_fwd(v, q, k, wm, wa, mu, g.src, g.rel,
                                  g.in_row_ptr)
    want = hgt_plain_fwd_plain(v, q, k, wm, wa, mu, g.src, g.rel,
                               g.in_row_ptr, None)
    assert all(torch.equal(a, b) for a, b in zip((s, out, score), want))
    seg = g.edge_rel_seg
    draw, alpha, d_q, *_ = hgt_plain_bwd_dst(
        v, q, k, wm, wa, mu, g.src, g.rel, g.in_row_ptr, score, s, out, ct,
        None, seg.inv, seg.n_rows)
    d_k, _ = hgt_plain_bwd_src(q, ct, wm, wa, mu, g.dst, g.rel,
                               g.out_row_ptr, g.out_perm, draw, alpha)
    assert d_q.shape == q.shape and d_k.shape == k.shape
    assert not any(kernels.launch_counts().values())


def test_wrappers_raise_on_what_the_kernels_do_not_take(graphs):
    g = graphs["hub"]
    (v, q, k, wm, wa, mu), ct = _inputs(g, 2, 4, 1.0)
    edges = (g.src, g.rel, g.in_row_ptr)
    with pytest.raises(TypeError):
        hgt_plain_fwd(v.bfloat16(), q, k, wm, wa, mu, *edges)
    with pytest.raises(TypeError):
        hgt_plain_fwd(v, q, k, wm, wa, mu, g.src.long(), *edges[1:])
    with pytest.raises(ValueError, match="dk"):  # dk = 3
        hgt_plain_fwd(v[:, :6], q[:, :6], k[:, :6], wm[..., :3, :3],
                      wa[..., :3, :3], mu, *edges)
    with pytest.raises(ValueError):
        hgt_plain_fwd(v, q, k, wm, wa, mu, *edges, impl="triton")
    with pytest.raises(TypeError):
        hgt_plain_bwd_dst(v, q, k, wm, wa, mu, *edges,
                          torch.zeros(g.num_padded_edges, 2),
                          torch.zeros(g.num_nodes, 2), ct[:-1], ct, None,
                          g.edge_rel_seg.inv, g.edge_rel_seg.n_rows)


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


@pytest.mark.parametrize("stable,scale", [("raw", 1.0), ("clip", 30.0)])
@pytest.mark.parametrize("kind", ["hub", "shard"])
def test_walk_route_matches_the_chain(graphs, on_card, kind, stable, scale):
    """f32 on the card under "raw" and "clip" takes the walks: a forward
    launches the forward walk alone, a backward the two backward walks
    and ``d_mu``'s dW (on the card the destination walk adds the weights'
    two dWs); each side counts ``walks`` once in its span in a traced
    step; the results are the chain's."""
    g = graphs[kind]
    inputs, ct = _inputs(g, 2, 8, scale, seed=1)
    clip = CLIP_LOGIT if stable == "clip" else None
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        step = spans.Step(False)
        with step.phase("zero_grad"):
            pass
        with step.phase("forward"):
            xs = [x.clone().requires_grad_() for x in inputs]
            out = HGTPlainFull.apply(*xs, g, clip, "kernel")
            assert _counts() == {"hgt_plain_fwd": 1}
            kernels.reset_launches()
        with step.phase("backward"):
            grads = torch.autograd.grad((out * ct).sum(), xs)
        step.close()
    assert _counts() == {"hgt_plain_bwd_dst": 1, "hgt_plain_bwd_src": 1,
                         "segment_matmul_dw": 1}
    totals, = spans.REGISTRY.steps
    spans.reset()
    walks = {p: t["walks"] for p, t in totals.items() if "walks" in t}
    assert sorted(walks) == ["step/het.backward/HGTPlainFullBackward",
                             "step/het.forward/HGTPlainFull"]
    assert set(walks.values()) == {1}
    want = _op(g, inputs, ct, clip, "plain")
    for a, b in zip((out.detach(),) + grads, want):
        _close(a, b)


@pytest.mark.parametrize("case", ["bf16", "dk3", "plain"])
def test_other_inputs_keep_the_chain(graphs, on_card, case):
    """bf16 operands, a head width the kernels do not take and
    impl="plain" take the chain: no walk launches."""
    g = graphs["hub"]
    inputs, ct = _inputs(g, 2, 3 if case == "dk3" else 8, 1.0)
    if case == "bf16":
        inputs = [x.bfloat16() for x in inputs]
    _op(g, inputs, ct, CLIP_LOGIT, "plain" if case == "plain" else "kernel")
    assert not set(_counts()) & set(NEW)
    if case != "plain":
        assert _counts()["seg_sum_sorted"] > 0


@pytest.mark.parametrize("stable,scale", [("raw", 1.0), ("clip", 30.0)])
def test_walk_route_matches_het_tpu(on_card, stable, scale):
    """The walk route's output and every input's gradient against
    het_tpu's ``_make_hgt_plain_full_op`` (through
    ``hgt_fused_plain_full``, jitted) on the same numpy inputs, on the
    shard's graph."""
    src, dst, rel, N, R, S = _graph_coo("shard")
    g = build_heterograph(src, dst, rel, N, R, tile=8, src_space=S)
    jg = j_build_heterograph(src, dst, rel, N, R, tile=8, src_space=S)
    inputs, ct = _inputs(g, 2, 8, scale, seed=2)
    clip = CLIP_LOGIT if stable == "clip" else None
    got = _op(g, inputs, ct, clip)
    H, dk = 2, 8

    def loss(v, q, k, wm, wa, mu):
        out = hgt_fused_plain_full(
            jg, v.reshape(-1, H, dk), q.reshape(-1, H, dk),
            k.reshape(-1, H, dk), wm, wa, mu, clip=clip)
        return jnp.sum(out * jnp.asarray(ct.numpy())), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True))(
            *[jnp.asarray(x.numpy()) for x in inputs])
    torch.testing.assert_close(got[0], torch.tensor(np.asarray(jout)), **VAL)
    for name, a, b in zip(NAMES, got[1:], jgrads):
        torch.testing.assert_close(a, torch.tensor(np.asarray(b)), **GRAD,
                                   msg=lambda m, n=name: f"d_{n}: {m}")
