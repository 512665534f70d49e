"""The port's HGT against het_tpu's (pallas backend, interpret mode on the
CPU) with the same inputs, made from a numpy seed, and the same
parameters: the ops (per-head ``segment_matmul`` on host offsets,
``ntype_linear`` at two node types, ``scatter_sum_src``,
``expand_compact`` at 16 lanes and fewer, ``compact_dst_inner``,
``inner_product_edge_node`` on both sides, ``hgt_edge_softmax``,
``hgt_softmax_weighted_agg``, ``hgt_compact_attention``,
``hgt_plain_attention`` and ``hgt_plain_layer_core`` under clip, raw and
max; the fused plain attention also on device-only offsets, against
het_tpu's on the same offsets and its own host-offset result, with its
launches counted), ``HGTLayer`` over
compact x stable x ``use_norm`` and multiply-first at two node types,
``HGTModel``'s logits and every gradient, and three Adam steps against
``optax.adam``.  Every gradient is held, ``relation_pri``'s (``mu``'s)
included.  Tolerances: values rtol 1e-4 / atol 2e-4, gradients rtol 5e-3
/ atol 2e-4 (the repo's backend-parity ones)."""

import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from het_tpu import ops as jops
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.models import NodeEmbed as JNodeEmbed
from het_tpu.models.hgt import HGTLayer as JHGTLayer
from het_tpu.models.hgt import HGTModel as JHGTModel
from het_tpu.ops.linear import segment_matmul as j_segment_matmul
from het_tpu.utils.misc import nll_loss as j_nll_loss
from het_tpu_torch import ops
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.models import (HGTLayer, HGTModel, NodeEmbed,
                                  dp_params_from_jax, params_from_jax)
from het_tpu_torch.ops import kernels
from het_tpu_torch.ops.fused_agg import HGTPlainAttention
from het_tpu_torch.ops.kernels import _dispatch
from het_tpu_torch.train.driver import NodeClassifier
from het_tpu_torch.utils.misc import nll_loss

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
IN, HID, CLS, H, LR = 12, 8, 4, 2, 1e-2
DK = HID // H
MODES = ("clip", "raw", "max")


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


@pytest.fixture(scope="module")
def graphs():
    """One node type (as the mag stand-in) and two, whose boundary splits
    the node ids; both with padding edges."""
    out = {}
    for T, offsets in ((1, None), (2, (0, 20, 48))):
        kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=5, tile=8,
                  ntype_offsets=offsets)
        jg, tg = j_random_heterograph(**kw), t_random_heterograph(**kw)
        assert tg.num_padded_edges > tg.num_edges
        assert tg.num_ntypes == T and tg.ntype_seg.n_segments == T
        out[T] = (jg, tg)
    return out


def _init(module, *args, **kw):
    """flax ``init`` on the XLA backend (shapes only: no interpret mode)."""
    prev = jops.get_backend()
    jops.set_backend("xla")
    try:
        return jax.tree.map(np.asarray,
                            module.init(jax.random.PRNGKey(4), *args, **kw))
    finally:
        jops.set_backend(prev)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _j_shape(jfn, inputs):
    return jax.eval_shape(jfn, *map(jnp.asarray, inputs)).shape


def _j_value_and_grads(jfn, inputs, proj):
    """het_tpu's ``sum(out * proj)``, ``out`` and the gradient of every
    input, in one jitted call (interpret mode runs several times faster
    compiled than op by op)."""
    def loss(*a):
        out = jfn(*a)
        return jnp.sum(out * proj), out

    (jv, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs))), has_aux=True))(
            *map(jnp.asarray, inputs))
    return jv, jout, jgrads


def _op_case(name, jg, tg, rng):
    """(het_tpu function, port function, numpy inputs, output rows) of op
    ``name``: each function maps the inputs to its output."""
    EP, N, R = tg.num_padded_edges, tg.num_nodes, tg.num_rels
    UCs, UCd = tg.compact_src.seg.n_rows, tg.compact_dst.seg.n_rows
    n = rng.standard_normal
    mu = 1.0 + 0.3 * n((R, H))
    op, _, mode = name.partition(":")
    if op in ("segment_matmul", "segment_matmul_hx1"):
        hx = H if op == "segment_matmul" else 1
        seg_j, seg_t = jg.edge_rel_seg, tg.edge_rel_seg
        return (lambda x, w: j_segment_matmul(x, w, seg_j),
                lambda x, w: ops.segment_matmul(x, w, seg_t),
                [n((seg_t.n_rows, hx, DK)), n((R, H, DK, 3)) / 2], None)
    if op == "ntype_linear":
        T = tg.num_ntypes
        return (lambda x, w: jops.ntype_linear(jg, x, w),
                lambda x, w: ops.ntype_linear(tg, x, w),
                [n((N, IN)), n((T, H, IN, DK)) / 3], None)
    if op == "scatter_sum_src":
        return (lambda v: jops.scatter_sum_src(jg, v),
                lambda v: ops.scatter_sum_src(tg, v), [n((EP, 3, 2))], None)
    if op == "expand_compact":
        lanes = int(mode)  # 16 lanes take het_tpu's sorted form, 4 XLA's
        return (lambda c: jops.expand_compact(jg, c, "src"),
                lambda c: ops.expand_compact(tg, c, "src"),
                [n((UCs, 2, lanes // 2))], "edges")
    if op == "compact_dst_inner":
        return (lambda c, x: jops.compact_dst_inner(jg, c, x),
                lambda c, x: ops.compact_dst_inner(tg, c, x),
                [n((UCd, H, DK)), n((N, H, DK))], None)
    if op == "inner_product_edge_node":
        return (lambda l, r: jops.inner_product_edge_node(jg, l, r, mode),
                lambda l, r: ops.inner_product_edge_node(tg, l, r, mode),
                [n((EP, H, DK)), n((N, H, DK))], None)
    if op == "hgt_edge_softmax":
        return (lambda s, m: jops.hgt_edge_softmax(jg, s, m, stable=mode),
                lambda s, m: ops.hgt_edge_softmax(tg, s, m, stable=mode),
                [n((EP, H)), mu], "edges")
    if op == "hgt_softmax_weighted_agg":
        return (lambda f, s, m: jops.hgt_softmax_weighted_agg(
                    jg, f, s, m, stable=mode),
                lambda f, s, m: ops.hgt_softmax_weighted_agg(
                    tg, f, s, m, stable=mode),
                [n((EP, H, DK)), n((EP, H)), mu], None)
    if op == "hgt_compact_attention":
        return (lambda f, a, k, m: jops.hgt_compact_attention(
                    jg, f, a, k, m, stable=mode),
                lambda f, a, k, m: ops.hgt_compact_attention(
                    tg, f, a, k, m, stable=mode),
                [n((UCs, H, DK)), n((UCd, H, DK)), n((N, H, DK)), mu], None)
    if op == "hgt_plain_attention":
        return (lambda f, q, k, wa, m: jops.hgt_plain_attention(
                    jg, f, q, k, wa, m, stable=mode),
                lambda f, q, k, wa, m: ops.hgt_plain_attention(
                    tg, f, q, k, wa, m, stable=mode),
                [n((EP, H, DK)), n((N, H, DK)), n((N, H, DK)),
                 n((R, H, DK, DK)) / 2, mu], None)
    assert op == "hgt_plain_layer_core"
    return (lambda v, q, k, wm, wa, m: jops.hgt_plain_layer_core(
                jg, v, q, k, wm, wa, m, stable=mode),
            lambda v, q, k, wm, wa, m: ops.hgt_plain_layer_core(
                tg, v, q, k, wm, wa, m, stable=mode),
            [n((N, H, DK)), n((N, H, DK)), n((N, H, DK)),
             n((R, H, DK, DK)) / 2, n((R, H, DK, DK)) / 2, mu], None)


OP_CASES = (["segment_matmul", "segment_matmul_hx1", "ntype_linear",
             "scatter_sum_src", "expand_compact:16", "expand_compact:4",
             "compact_dst_inner", "inner_product_edge_node:dst",
             "inner_product_edge_node:src"]
            + [f"{op}:{mode}" for op in (
                "hgt_edge_softmax", "hgt_softmax_weighted_agg",
                "hgt_compact_attention", "hgt_plain_attention",
                "hgt_plain_layer_core")
               for mode in MODES])


@pytest.mark.parametrize("name", OP_CASES)
def test_op_matches_het_tpu(pallas_backend, graphs, name):
    """Each op's output and the gradients of every input of ``sum(out *
    proj)``; ``ntype_linear`` at two node types, the rest at one.  Where
    the output is per edge (``"edges"``), ``proj`` is zero on padding
    edges, as every consumer's cotangent is: het_tpu's narrow
    ``expand_compact`` (XLA's scatter-add) sums padding cotangents into
    row 0, its sorted form and the port's drop them."""
    jg, tg = graphs[2 if name == "ntype_linear" else 1]
    rng = np.random.default_rng(7)
    jfn, tfn, inputs, rows = _op_case(name, jg, tg, rng)
    inputs = [np.asarray(a, np.float32) for a in inputs]
    proj = rng.standard_normal(_j_shape(jfn, inputs)).astype(np.float32)
    if rows == "edges":
        proj[tg.num_edges:] = 0.0
    jv, jout, jgrads = _j_value_and_grads(jfn, inputs, proj)
    targs = [_t(a, grad=True) for a in inputs]
    tout = tfn(*targs)
    assert tuple(tout.shape) == tuple(jout.shape)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **VAL)
    tv = (tout * torch.from_numpy(proj)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **VAL)
    for i, (t, jgr) in enumerate(zip(targs, jgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgr),
                                   err_msg=f"input {i}", **GRAD)


def _device_only(g):
    """``g`` with its relation offsets on the device only
    (``seg_ptrs_static = None``, as on a shard)."""
    return dataclasses.replace(g, edge_rel_seg=dataclasses.replace(
        g.edge_rel_seg, seg_ptrs_static=None))


@pytest.fixture(scope="module")
def device_offsets_graph(graphs):
    """The one-node-type graph, het_tpu's and the port's, with the
    relation offsets on the device only: the typed linears take the
    segment-matmul kernels' path (het_tpu's W-resident Pallas kernel)."""
    jg, tg = graphs[1]
    return _device_only(jg), _device_only(tg)


def _plain_attention_inputs(tg, seed):
    rng = np.random.default_rng(seed)
    EP, N, R = tg.num_padded_edges, tg.num_nodes, tg.num_rels
    shapes = [(EP, H, DK), (N, H, DK), (N, H, DK), (R, H, DK, DK), (R, H)]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    xs[3] /= 2
    xs[4] = (1.0 + 0.3 * xs[4]).astype(np.float32)
    return xs


@pytest.mark.parametrize("mode", ["raw", "clip"])
def test_plain_attention_on_device_offsets(pallas_backend, graphs,
                                           device_offsets_graph, mode):
    """``HGTPlainAttention`` with the offsets on the device only (the
    segment-matmul forward, dX and dW): the output and the gradients of
    all five inputs against het_tpu's fused op on the same offsets (its
    segment matmul the W-resident Pallas kernel, interpret mode), and
    against the port's own host-offset result."""
    jg_dev, tg_dev = device_offsets_graph
    _, tg = graphs[1]
    xs = _plain_attention_inputs(tg, 21)
    ct = np.random.default_rng(22).standard_normal(
        (tg.num_nodes, H, DK)).astype(np.float32)
    _, jout, jgrads = _j_value_and_grads(
        lambda *a: jops.hgt_plain_attention(jg_dev, *a, stable=mode), xs,
        ct)
    results = []
    for g in (tg_dev, tg):
        targs = [_t(a, grad=True) for a in xs]
        out = ops.hgt_plain_attention(g, *targs, stable=mode)
        (out * torch.from_numpy(ct)).sum().backward()
        results.append([out.detach()] + [t.grad for t in targs])
    want = [np.asarray(jout)] + [np.asarray(a) for a in jgrads]
    for i, (dev, host, j) in enumerate(zip(*results, want)):
        tol = VAL if i == 0 else GRAD
        np.testing.assert_allclose(dev.numpy(), j, err_msg=f"tensor {i}",
                                   **tol)
        np.testing.assert_allclose(dev.numpy(), host.numpy(),
                                   err_msg=f"tensor {i}", **tol)


@pytest.mark.parametrize("offsets", ["host", "device"])
def test_plain_attention_launches(graphs, device_offsets_graph, monkeypatch,
                                  offsets):
    """The launches ``chip_smoke.py`` asserts for a forward and a backward
    into every input (``HGTPlainAttention.LAUNCHES``), counted on
    the CPU by a stand-in that bumps a kernel's count wherever a CUDA
    tensor would launch it and runs the plain version."""
    plain = _dispatch.takes_plain

    def counted(t, impl, what):
        if impl == "kernel":
            getattr(kernels, what).launches += 1
        return plain(t, "plain", what)

    monkeypatch.setattr(_dispatch, "takes_plain", counted)
    g = graphs[1][1] if offsets == "host" else device_offsets_graph[1]
    targs = [_t(a, grad=True) for a in _plain_attention_inputs(g, 23)]
    kernels.reset_launches()
    ops.hgt_plain_attention(g, *targs, stable="clip").square().sum(
        ).backward()
    got = {k: n for k, n in kernels.launch_counts().items() if n}
    kernels.reset_launches()
    assert got == HGTPlainAttention.LAUNCHES[offsets]


def test_hgt_ops_sum_without_atomics(graphs):
    """The HGT ops' node-side and ``mu`` gradients go through no
    ``index_add_`` / ``index_put_`` / scatter node (PyTorch's indexing
    backwards): they are sorted segment sums, which repeat bit for bit."""
    _, tg = graphs[1]
    rng = np.random.default_rng(12)
    N, R, EP = tg.num_nodes, tg.num_rels, tg.num_padded_edges
    UCs, UCd = tg.compact_src.seg.n_rows, tg.compact_dst.seg.n_rows
    for mode in MODES:
        for compact in (False, True):
            shapes = ([(UCs, H, DK), (UCd, H, DK), (N, H, DK), (R, H)]
                      if compact else
                      [(N, H, DK)] * 3 + [(R, H, DK, DK)] * 2 + [(R, H)])
            xs = [_t(rng.standard_normal(s).astype(np.float32), grad=True)
                  for s in shapes]
            fn = (ops.hgt_compact_attention if compact
                  else ops.hgt_plain_layer_core)
            out = fn(tg, *xs, stable=mode)
            names, todo = set(), [out.grad_fn]
            while todo:
                f = todo.pop()
                if f is not None and type(f).__name__ not in names:
                    names.add(type(f).__name__)
                    todo += [g for g, _ in f.next_functions]
            assert not any(n.startswith(("Index", "Scatter", "Embedding"))
                           for n in names), (mode, compact, names)
            ct = torch.randn(out.shape, generator=torch.Generator()
                             .manual_seed(0))
            first = torch.autograd.grad(out, xs, ct, retain_graph=True)
            again = torch.autograd.grad(out, xs, ct)
            for a, b in zip(first, again):
                assert torch.equal(a, b)
    assert EP > tg.num_edges


@pytest.mark.parametrize("op", ["hgt_compact_attention",
                                "hgt_plain_layer_core"])
def test_stable_max_with_logits_past_exp_range(pallas_backend, graphs, op):
    """Under "max", real logits far past ``exp``'s range (mu ~ 300): het_tpu
    masks padding edges after its ``exp`` (RGAT's row-0 NaN there),
    but HGT's padding scores are exactly 0 (their source is the sentinel
    row), so its gradients stay finite, and the port's equal them."""
    jg, tg = graphs[1]
    rng = np.random.default_rng(14)
    jfn, tfn, inputs, _ = _op_case(f"{op}:max", jg, tg, rng)
    inputs = [np.asarray(a, np.float32) for a in inputs]
    inputs[-1] = inputs[-1] * 300.0  # mu
    proj = rng.standard_normal(_j_shape(jfn, inputs)).astype(np.float32)
    _, _, jgrads = _j_value_and_grads(jfn, inputs, proj)
    assert all(np.isfinite(np.asarray(g)).all() for g in jgrads)
    targs = [_t(a, grad=True) for a in inputs]
    (tfn(*targs) * torch.from_numpy(proj)).sum().backward()
    for i, (t, jgr) in enumerate(zip(targs, jgrads)):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgr),
                                   err_msg=f"input {i}", **GRAD)


LAYER_CASES = list(itertools.product((False, True), MODES, (False, True)))


def _compare_layer(jlayer, params, layer, jg, tg, x):
    """``sum(layer(x) * proj)`` of both: the value, the gradient of ``x``
    and of every parameter."""
    rng = np.random.default_rng(9)
    out_dim = layer.out_dim
    proj = rng.standard_normal((tg.num_nodes, out_dim)).astype(np.float32)

    def j_loss(p, xx):
        return jnp.sum(jlayer.apply(p, jg, xx) * proj)

    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    layer.load_state_dict({k.split(".", 2)[2]: v for k, v in
                           dp_params_from_jax([params]).items()})
    tx = _t(x, grad=True)
    tv = (layer(tg, tx) * torch.from_numpy(proj)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **VAL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD)
    want = dp_params_from_jax([jax.tree.map(np.asarray, jgp)])
    got = {f"layers.0.{n}": p.grad for n, p in layer.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize(
    "compact,stable,use_norm", LAYER_CASES,
    ids=[f"{'compact' if c else 'plain'}-{s}-norm{int(u)}"
         for c, s, u in LAYER_CASES])
def test_layer_matches_het_tpu(pallas_backend, graphs, compact, stable,
                               use_norm):
    """One ``HGTLayer`` (dropout 0) at two node types, with ``skip``,
    ``relation_pri`` and the LayerNorm's scale and bias away from their
    initial values."""
    jg, tg = graphs[2]
    rng = np.random.default_rng(10)
    x = rng.standard_normal((tg.num_nodes, IN)).astype(np.float32)
    kw = dict(num_ntypes=2, num_rels=tg.num_rels, num_heads=H, dropout=0.0,
              use_norm=use_norm, compact=compact, stable_softmax=stable)
    jlayer = JHGTLayer(in_dim=IN, out_dim=HID, **kw)
    params = _init(jlayer, jg, jnp.asarray(x))
    p = params["params"]
    p["skip"] = rng.standard_normal(p["skip"].shape).astype(np.float32)
    p["relation_pri"] = (1.0 + 0.3 * rng.standard_normal(
        p["relation_pri"].shape)).astype(np.float32)
    if use_norm:
        for leaf in ("scale", "bias"):
            p["LayerNorm_0"][leaf] = (1.0 * (leaf == "scale") + 0.2 *
                                      rng.standard_normal(HID)).astype(
                                          np.float32)
    layer = HGTLayer(IN, HID, 2, tg.num_rels, H, dropout=0.0,
                     use_norm=use_norm, compact=compact,
                     stable_softmax=stable)
    _compare_layer(jlayer, params, layer, jg, tg, x)


@pytest.mark.parametrize("stable", MODES)
def test_multiply_first_layer_matches_het_tpu(pallas_backend, graphs,
                                              stable):
    """The multiply-first form at two node types, each relation with its
    own source and destination type (v from the source type, as
    het_tpu)."""
    jg, tg = graphs[2]
    rng = np.random.default_rng(13)
    x = rng.standard_normal((tg.num_nodes, IN)).astype(np.float32)
    types = dict(src_ntype_per_rel=(0, 1, 1, 0), dst_ntype_per_rel=(1, 0, 1,
                                                                    0))
    kw = dict(num_ntypes=2, num_rels=tg.num_rels, num_heads=H, dropout=0.0,
              multiply_first=True, stable_softmax=stable)
    jlayer = JHGTLayer(in_dim=IN, out_dim=HID, **kw, **types)
    params = _init(jlayer, jg, jnp.asarray(x))
    layer = HGTLayer(IN, HID, 2, tg.num_rels, H, dropout=0.0,
                     multiply_first=True, stable_softmax=stable, **types)
    _compare_layer(jlayer, params, layer, jg, tg, x)


MODEL_CASES = [(False, "clip"), (True, "clip"), (True, "max")]


@pytest.fixture(scope="module", params=MODEL_CASES,
                ids=[f"{'compact' if c else 'plain'}-{s}"
                     for c, s in MODEL_CASES])
def model_setup(request, graphs):
    """het_tpu's 2-layer ``HGTModel`` fed by learned embeddings, and the
    loss on a train split."""
    compact, stable = request.param
    jg, tg = graphs[1]
    rng = np.random.default_rng(3)
    kw = dict(num_ntypes=1, num_rels=jg.num_rels, num_heads=H,
              num_layers=2, dropout=0.0, compact=compact,
              stable_softmax=stable)
    jmodel = JHGTModel(in_dim=IN, hidden=HID, num_classes=CLS, **kw)
    jembed = JNodeEmbed(num_nodes=jg.num_nodes, embed_dim=IN)
    e_params = jembed.init(jax.random.PRNGKey(1))
    m_params = _init(jmodel, jg, jembed.apply(e_params))
    tree = {"embed": jax.tree.map(np.asarray, e_params), "model": m_params}
    labels = rng.integers(0, CLS, jg.num_nodes)
    train_idx = rng.permutation(jg.num_nodes)[:36]

    def loss(p):
        logits = jmodel.apply(p["model"], jg, jembed.apply(p["embed"]))
        y = jnp.asarray(labels)[train_idx]
        return j_nll_loss(logits[train_idx], y), logits

    def net():
        n = NodeClassifier(
            NodeEmbed(tg.num_nodes, IN),
            HGTModel(IN, HID, CLS, 1, tg.num_rels, H, 2, dropout=0.0,
                     compact=compact, stable_softmax=stable))
        n.load_state_dict(params_from_jax(tree))
        return n.train()

    return (jax.jit(jax.value_and_grad(loss, has_aux=True)), tree, net,
            labels, train_idx, tg)


def _j_leaf(tree, name):
    if name == "embed.embed":
        return tree["embed"]["params"]["embed"]
    _, _, i, leaf = name.split(".")
    return tree["model"]["params"][f"HGTLayer_{i}"][leaf]


def test_model_forward_and_grads(pallas_backend, model_setup):
    jfn, tree, make_net, labels, train_idx, tg = model_setup
    net = make_net()
    logits = net(tg)
    (jv, jlogits), jgrad = jfn(tree)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **VAL)
    loss = nll_loss(logits[torch.from_numpy(train_idx)],
                    torch.from_numpy(labels[train_idx]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), **VAL)
    names = [n for n, _ in net.named_parameters()]
    assert len(names) == 1 + 2 * 8
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(_j_leaf(jgrad, name)),
                                   err_msg=name, **GRAD)


def test_model_three_adam_steps(pallas_backend, model_setup):
    jfn, tree, make_net, labels, train_idx, tg = model_setup
    tx = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    j_losses = []
    for _ in range(3):
        (v, _), grads = jfn(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(v))

    net = make_net()
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    idx = torch.from_numpy(train_idx)
    y = torch.from_numpy(labels[train_idx])
    t_losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = nll_loss(net(tg)[idx], y)
        loss.backward()
        opt.step()
        t_losses.append(loss.item())
    np.testing.assert_allclose(t_losses, j_losses, **VAL)
    assert t_losses[-1] < t_losses[0]
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(_j_leaf(params, name)),
                                   err_msg=name, **VAL)


def test_params_from_jax_maps_hgt_groups_and_layer_norm():
    """``HGTLayer_i`` groups go to ``model.layers.{i}``, their nested
    ``LayerNorm_0`` to the port's ``norm`` (``scale`` is ``weight``), and
    the result loads into a model built with ``use_norm``; an unknown
    nested group raises."""
    leaf = np.ones(HID, np.float32)
    layer = HGTLayer(IN, HID, 1, 3, H, use_norm=True)
    sd = {k: v.numpy() for k, v in layer.state_dict().items()}
    group = {k: v for k, v in sd.items() if not k.startswith("norm.")}
    group["LayerNorm_0"] = {"scale": leaf * 2, "bias": leaf * 3}
    tree = {"embed": {"params": {"embed": np.zeros((5, IN), np.float32)}},
            "model": {"params": {"HGTLayer_0": group}}}
    out = params_from_jax(tree)
    assert out["model.layers.0.norm.weight"].eq(2).all()
    assert out["model.layers.0.norm.bias"].eq(3).all()
    layer.load_state_dict({k.split(".", 3)[3]: v for k, v in out.items()
                           if k.startswith("model.")})
    assert layer.norm.eps == 1e-6
    group["Dense_0"] = {"kernel": leaf}
    with pytest.raises(KeyError, match="Dense_0"):
        params_from_jax(tree)
