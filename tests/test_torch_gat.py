"""The port's homogeneous GAT against het_tpu's (pallas backend, interpret
mode on the CPU) with the same inputs, made from a numpy seed, and the
same parameters: ``gat_node_fused`` under raw, clip and max on graphs of
one and four relations (GAT reads every edge as one relation),
``gat_layer_core`` on both sides of its gate (the fused op where F <=
H*D, the composed path past it and under max), ``GATLayer`` with both
residual forms, ``GATModel``'s logits and every gradient, and three Adam
steps against ``optax.adam``.  Every graph has padding edges.
Tolerances: values rtol 1e-4 / atol 2e-4, gradients rtol 5e-3 / atol
2e-4 (the repo's backend-parity ones)."""


import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from het_tpu import ops as jops
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.models import NodeEmbed as JNodeEmbed
from het_tpu.models.gat import GATLayer as JGATLayer
from het_tpu.models.gat import GATModel as JGATModel
from het_tpu.utils.misc import nll_loss as j_nll_loss
from het_tpu_torch import ops
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.models import (GATLayer, GATModel, NodeEmbed,
                                  dp_params_from_jax, params_from_jax)
from het_tpu_torch.train.driver import NodeClassifier
from het_tpu_torch.utils.misc import nll_loss

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
SLOPE = 0.2
MODES = ("raw", "clip", "max")
IN, HID, CLS, H, LR = 12, 6, 4, 2, 1e-2


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


@pytest.fixture(scope="module")
def graphs():
    """R = 1 (GAT's own graphs) and R = 4, both with padding edges."""
    out = {}
    for R in (1, 4):
        kw = dict(num_nodes=40, num_edges=300, num_rels=R, seed=11, tile=8)
        jg, tg = j_random_heterograph(**kw), t_random_heterograph(**kw)
        assert tg.num_padded_edges > tg.num_edges
        out[R] = (jg, tg)
    return out


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def _compare(jfn, tfn, inputs, seed):
    """``sum(out * proj)`` of both, its value, ``out`` and the gradient
    of every input, het_tpu's in one jitted call.  Returns the port's
    output."""
    inputs = [np.asarray(a, np.float32) for a in inputs]
    shape = jax.eval_shape(jfn, *map(jnp.asarray, inputs)).shape
    proj = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)

    def loss(*a):
        out = jfn(*a)
        return jnp.sum(out * proj), out

    (jv, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs))), has_aux=True))(
            *map(jnp.asarray, inputs))
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
    return tout


def _grad_fns(out):
    """The names of the autograd nodes ``out`` was made by."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        f = todo.pop()
        if f is not None and f not in seen:
            seen.add(f)
            todo += [g for g, _ in f.next_functions]
    return {type(f).__name__ for f in seen}


def test_padding_lies_past_both_row_pointers(graphs):
    """Padding edges lie past the end of ``in_row_ptr`` (destinations)
    and of ``out_row_ptr`` (sources, through ``out_perm``), so no segment
    sum of the GAT ops reads one; they read the sentinel rows."""
    for _, tg in graphs.values():
        E, EP, N = tg.num_edges, tg.num_padded_edges, tg.num_nodes
        assert int(tg.in_row_ptr[-1]) == int(tg.out_row_ptr[-1]) == E < EP
        assert (tg.dst[E:] == N).all() and (tg.src[E:] == tg.src_space).all()
        assert sorted(tg.out_perm[:E].tolist()) == list(range(E))


# (1, 40): the arxiv stand-in's last layer, one head of its 40 classes
NODE_CASES = [(R, hd, mode) for R in (1, 4)
              for hd in ((2, 8), (2, 6), (4, 7), (1, 40)) for mode in MODES]


@pytest.mark.parametrize("R,hd,mode", NODE_CASES,
                         ids=[f"R{R}-H{h}D{d}-{m}"
                              for R, (h, d), m in NODE_CASES])
def test_gat_node_fused_matches_het_tpu(pallas_backend, graphs, R, hd, mode):
    """feat (N, H, D), el (N, H), er (N, H): the output and every input's
    gradient; raw and clip through ``NodeFusedGAT``, max through the
    per-edge op on gathered inputs."""
    jg, tg = graphs[R]
    Hh, D = hd
    N = tg.num_nodes
    rng = np.random.default_rng(R * 100 + Hh * 10 + D)
    inputs = [rng.standard_normal((N, Hh, D)),
              0.5 * rng.standard_normal((N, Hh)),
              0.5 * rng.standard_normal((N, Hh))]
    out = _compare(
        lambda f, l, r: jops.gat_node_fused(jg, f, l, r, SLOPE, stable=mode),
        lambda f, l, r: ops.gat_node_fused(tg, f, l, r, SLOPE, stable=mode),
        inputs, seed=R + Hh)
    fused = "NodeFusedGATBackward" in _grad_fns(out)
    assert fused == (mode != "max")


# (4, 16, 8): the relational models' layer-0 heads (H*D = 64)
CORE_CASES = [(h, d, f, mode) for h, d, f in ((2, 4, 4), (4, 8, 8), (1, 6, 3),
                                              (2, 3, 9), (4, 16, 8))
              for mode in MODES]


@pytest.mark.parametrize("Hh,D,F,mode", CORE_CASES,
                         ids=[f"H{h}D{d}F{f}-{m}"
                              for h, d, f, m in CORE_CASES])
def test_gat_layer_core_matches_het_tpu(pallas_backend, graphs, Hh, D, F,
                                        mode):
    """x (N, F), w (F, H*D), attn_l / attn_r (H, D): the output and all
    four gradients.  F <= H*D under raw and clip takes ``GATLayerFused``
    in both packages; F > H*D (the last case) and max take the composed
    path."""
    jg, tg = graphs[1]
    N = tg.num_nodes
    rng = np.random.default_rng(Hh * 100 + D * 10 + F)
    inputs = [rng.standard_normal((N, F)),
              0.4 * rng.standard_normal((F, Hh * D)),
              0.4 * rng.standard_normal((Hh, D)),
              0.4 * rng.standard_normal((Hh, D))]
    out = _compare(
        lambda x, w, a, b: jops.gat_layer_core(jg, x, w, a, b, SLOPE,
                                               stable=mode),
        lambda x, w, a, b: ops.gat_layer_core(tg, x, w, a, b, SLOPE,
                                              stable=mode),
        inputs, seed=F)
    fused = "GATLayerFusedBackward" in _grad_fns(out)
    assert fused == (mode != "max" and F <= Hh * D)


def test_gat_ops_sum_without_atomics(graphs):
    """The GAT ops' gradients go through no ``index_add_`` /
    ``index_put_`` / scatter node (PyTorch's indexing backwards): their
    node-side sums are sorted segment sums, which repeat bit for bit."""
    _, tg = graphs[1]
    N = tg.num_nodes
    gen = torch.Generator().manual_seed(3)
    for mode in MODES:
        for F in (4, 9):  # fused (raw, clip) and composed
            xs = [torch.randn(s, generator=gen).requires_grad_()
                  for s in ((N, F), (F, 8), (2, 4), (2, 4))]
            out = ops.gat_layer_core(tg, *xs, SLOPE, stable=mode)
            names = _grad_fns(out)
            assert not any(n.startswith(("Index", "Scatter", "Embedding"))
                           for n in names), (mode, F, names)
            ct = torch.randn(out.shape, generator=gen)
            first = torch.autograd.grad(out, xs, ct, retain_graph=True)
            again = torch.autograd.grad(out, xs, ct)
            for a, b in zip(first, again):
                assert torch.equal(a, b)


def _init(module, *args):
    """flax ``init`` on the XLA backend (shapes only: no interpret mode)."""
    prev = jops.get_backend()
    jops.set_backend("xla")
    try:
        return jax.tree.map(np.asarray,
                            module.init(jax.random.PRNGKey(4), *args))
    finally:
        jops.set_backend(prev)


@pytest.mark.parametrize("in_feat,residual", [
    pytest.param(H * HID, True, id="identity-residual"),
    pytest.param(IN, True, id="res_fc"),
    pytest.param(IN, False, id="no-residual"),
])
def test_layer_matches_het_tpu(pallas_backend, graphs, in_feat, residual):
    """One ``GATLayer`` with ELU: the value, the input's gradient and every
    parameter's; ``res_fc`` exists only where the residual needs a
    projection."""
    jg, tg = graphs[1]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((tg.num_nodes, in_feat)).astype(np.float32)
    jlayer = JGATLayer(in_feat=in_feat, out_feat=HID, num_heads=H,
                       residual=residual, activation=jax.nn.elu)
    params = _init(jlayer, jg, jnp.asarray(x))
    layer = GATLayer(in_feat, HID, H, residual=residual,
                     activation=torch.nn.functional.elu)
    assert (layer.res_fc is not None) == (residual and in_feat != H * HID)
    proj = rng.standard_normal((tg.num_nodes, H * HID)).astype(np.float32)

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


def test_feat_drop_repeats_from_one_generator(graphs):
    """``feat_drop > 0`` draws its masks from the caller's generator: one
    seed gives one result, another seed another, eval mode none, and
    training without a generator raises."""
    _, tg = graphs[1]
    model = GATModel(IN, HID, CLS, H, 3, feat_drop=0.5,
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(tg.num_nodes, IN, generator=torch.Generator()
                    .manual_seed(1))

    def run(seed):
        return model(tg, x, generator=torch.Generator().manual_seed(seed))

    dropped = run(5)
    assert torch.equal(dropped, run(5))
    assert not torch.equal(dropped, run(6))
    model.eval()
    assert not torch.equal(model(tg, x), dropped)
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(tg, x)


@pytest.fixture(scope="module", params=[1, 4], ids=["R1", "R4"])
def model_setup(request, graphs):
    """het_tpu's 2-layer ``GATModel`` fed by learned embeddings, and the
    loss on a train split: layer 0 takes the fused op (F = 12 <= H*D =
    12), layer 1 the composed path (F = 12 > 4 classes).  The embeddings
    are drawn zero-mean from numpy, not uniform on [0, 1): attention
    smooths uniform inputs until every destination's logits in layer 1
    sit on one side of the leaky ReLU's kink, where the softmax is
    invariant to ``er`` and ``attn_r``'s gradient is roundoff (~1e-10),
    which Adam's normalization would turn into steps of either sign."""
    jg, tg = graphs[request.param]
    rng = np.random.default_rng(3)
    jmodel = JGATModel(in_feat=IN, hidden=HID, num_classes=CLS, num_heads=H,
                       num_layers=2)
    jembed = JNodeEmbed(num_nodes=jg.num_nodes, embed_dim=IN)
    e_params = {"params": {"embed": jnp.asarray(rng.standard_normal(
        (jg.num_nodes, IN)).astype(np.float32))}}
    m_params = _init(jmodel, jg, jembed.apply(e_params))
    tree = {"embed": jax.tree.map(np.asarray, e_params), "model": m_params}
    labels = rng.integers(0, CLS, jg.num_nodes)
    train_idx = rng.permutation(jg.num_nodes)[:30]

    def loss(p):
        logits = jmodel.apply(p["model"], jg, jembed.apply(p["embed"]))
        y = jnp.asarray(labels)[train_idx]
        return j_nll_loss(logits[train_idx], y), logits

    def net():
        n = NodeClassifier(NodeEmbed(tg.num_nodes, IN),
                           GATModel(IN, HID, CLS, H, 2))
        n.load_state_dict(params_from_jax(tree))
        return n.train()

    return (jax.jit(jax.value_and_grad(loss, has_aux=True)), tree, net,
            labels, train_idx, tg)


def _j_leaf(tree, name):
    if name == "embed.embed":
        return tree["embed"]["params"]["embed"]
    _, _, i, leaf = name.split(".")
    return tree["model"]["params"][f"GATLayer_{i}"][leaf]


def test_model_forward_and_grads(pallas_backend, model_setup):
    jfn, tree, make_net, labels, train_idx, tg = model_setup
    net = make_net()
    logits = net(tg)
    (jv, jlogits), jgrad = jfn(tree)
    assert tuple(logits.shape) == (tg.num_nodes, CLS)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **VAL)
    names = _grad_fns(logits)
    assert {"GATLayerFusedBackward", "NodeFusedGATBackward"} <= names
    loss = nll_loss(logits[torch.from_numpy(train_idx)],
                    torch.from_numpy(labels[train_idx]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), **VAL)
    assert len(list(net.named_parameters())) == 1 + 2 * 3
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


def test_params_from_jax_tells_gat_from_rgat_groups():
    """``GATLayer_i`` and ``RGATLayer_i`` are different flax groups: each
    maps to ``model.layers.{i}`` with its own leaves."""
    leaf = np.ones((2, 3), np.float32)
    for group in ("GATLayer_1", "RGATLayer_1"):
        tree = {"embed": {"params": {"embed": leaf}},
                "model": {"params": {group: {"attn_l": leaf * 2}}}}
        out = params_from_jax(tree)
        assert sorted(out) == ["embed.embed", "model.layers.1.attn_l"]
    with pytest.raises(KeyError, match="XGATLayer_0"):
        params_from_jax({"embed": {"params": {"embed": leaf}},
                         "model": {"params": {"XGATLayer_0": {}}}})
