"""The port's RGCN against het_tpu's (pallas backend, interpret mode on the
CPU) with the same inputs, made from a numpy seed, and the same
parameters, carried by ``params_from_jax``: the ops (``rgcn_norm``,
``rgcn_aggregate``, ``compact_weighted_agg`` with its weight gradient,
``rgcn_layer1``, ``rgcn_layer0`` with padding edges present), the layers
(``RGCNLayer`` over compact x self_loop x bias, ``SeastarRGCNLayer0``) and
the 2-layer model (featureless or not, compact or not): logits, every
parameter gradient, and three Adam steps against ``optax.adam``.
Tolerances: values rtol 1e-4 / atol 2e-4, gradients rtol 5e-3 / atol
2e-4 (the repo's backend-parity ones)."""

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
from het_tpu.models.rgcn import RGCNLayer as JRGCNLayer
from het_tpu.models.rgcn import RGCNModel as JRGCNModel
from het_tpu.models.rgcn import SeastarRGCNLayer0 as JSeastarRGCNLayer0
from het_tpu.ops.pallas.fused_agg import compact_weighted_agg as j_cwa
from het_tpu.utils.misc import nll_loss as j_nll_loss
from het_tpu_torch import ops
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.models import (NodeEmbed, RGCNLayer, RGCNModel,
                                  SeastarRGCNLayer0, params_from_jax)
from het_tpu_torch.train.driver import NodeClassifier
from het_tpu_torch.utils.misc import nll_loss

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
IN, HID, CLS, C, LR = 12, 8, 4, 6, 1e-2


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=5, tile=8)
    jg, tg = j_random_heterograph(**kw), t_random_heterograph(**kw)
    assert tg.num_padded_edges > tg.num_edges  # padding edges present
    return jg, tg


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


def test_rgcn_norm_and_gather_src(pallas_backend, graphs):
    jg, tg = graphs
    want = np.asarray(jops.rgcn_norm(jg))
    got = ops.rgcn_norm(tg).numpy()
    np.testing.assert_allclose(got, want, **VAL)
    assert not got[tg.num_edges:].any()
    x = np.random.default_rng(6).standard_normal((tg.num_nodes, C)).astype(
        np.float32)
    np.testing.assert_array_equal(
        ops.gather_src(tg, torch.from_numpy(x)).numpy(),
        np.asarray(jops.gather_src(jg, jnp.asarray(x))))


def _op_case(name, jg, tg, rng):
    """(het_tpu function, port function, numpy inputs) of op ``name``:
    each function maps the inputs to its output."""
    EP, N, R = tg.num_padded_edges, tg.num_nodes, tg.num_rels
    norm = np.asarray(jops.rgcn_norm(jg))
    UC = tg.compact_src.seg.n_rows
    if name == "aggregate":
        return (lambda f, n: jops.rgcn_aggregate(jg, f, n),
                lambda f, n: ops.rgcn_aggregate(tg, f, n),
                [rng.standard_normal((EP, C)), norm])
    if name == "compact_weighted_agg":
        # a weight on every edge, padding ones included: they must add 0
        return (lambda f, w: j_cwa(jg, f, w),
                lambda f, w: ops.compact_weighted_agg(tg, f, w),
                [rng.standard_normal((UC, C)), rng.standard_normal(EP)])
    if name == "aggregate_compact":
        return (lambda f: jops.rgcn_aggregate_compact(jg, f,
                                                      jnp.asarray(norm)),
                lambda f: ops.rgcn_aggregate_compact(tg, f, _t(norm)),
                [rng.standard_normal((UC, C))])
    if name == "layer1":
        return (lambda x, w: jops.rgcn_layer1(jg, x, w, jnp.asarray(norm)),
                lambda x, w: ops.rgcn_layer1(tg, x, w, _t(norm)),
                [rng.standard_normal((N, IN)),
                 rng.standard_normal((R, IN, C)) / np.sqrt(IN)])
    assert name == "layer0"
    return (lambda w: jops.rgcn_layer0(jg, w, jnp.asarray(norm)),
            lambda w: ops.rgcn_layer0(tg, w, _t(norm)),
            [rng.standard_normal((R, N, C))])


@pytest.mark.parametrize("name", ["aggregate", "compact_weighted_agg",
                                  "aggregate_compact", "layer1", "layer0"])
def test_op_matches_het_tpu(pallas_backend, graphs, name):
    """Each RGCN op's output and the gradients of every input of
    ``sum(out * proj)``."""
    jg, tg = graphs
    rng = np.random.default_rng(7)
    jfn, tfn, inputs = _op_case(name, jg, tg, rng)
    inputs = [a.astype(np.float32) for a in inputs]
    proj = rng.standard_normal((tg.num_nodes, C)).astype(np.float32)
    argnums = tuple(range(len(inputs)))
    jv, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(jfn(*a) * proj), argnums=argnums)(
            *map(jnp.asarray, inputs))
    targs = [_t(a, grad=True) for a in inputs]
    tv = (tfn(*targs) * torch.from_numpy(proj)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **VAL)
    for i, (t, jgr) in enumerate(zip(targs, jgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgr),
                                   err_msg=f"input {i}", **GRAD)


def test_layer0_weight_grad_is_one_sorted_segment_sum(graphs):
    """The featureless layer's weight gradient goes through no
    ``index_put_`` / scatter-add node (PyTorch's indexing backward): it is
    one sorted segment sum over the (relation, source) runs, which repeats
    bit for bit, and padding edges add exactly zero whatever their
    relation and source hold."""
    _, tg = graphs
    rng = np.random.default_rng(8)
    R, N = tg.num_rels, tg.num_nodes
    w = _t(rng.standard_normal((R, N, C)).astype(np.float32), grad=True)
    norm = ops.rgcn_norm(tg)
    ct = torch.from_numpy(rng.standard_normal((N, C)).astype(np.float32))

    def grad(g):
        out = ops.rgcn_layer0(g, w, norm)
        names, todo = set(), [out.grad_fn]
        while todo:
            fn = todo.pop()
            if fn is not None and type(fn).__name__ not in names:
                names.add(type(fn).__name__)
                todo += [f for f, _ in fn.next_functions]
        assert "_SortedGatherBackward" in names, names
        assert not any(n.startswith(("Index", "Scatter")) for n in names), \
            names
        return torch.autograd.grad(out, w, ct)[0]

    first = grad(tg)
    assert torch.equal(first, grad(tg))
    pad = tg.dst >= N
    odd = dataclasses.replace(
        tg, rel=torch.where(pad, torch.full_like(tg.rel, R - 1), tg.rel),
        src=torch.where(pad, torch.zeros_like(tg.src), tg.src))
    assert not torch.equal(odd.rel, tg.rel)
    assert torch.equal(first, grad(odd))


def _compare_layer(jlayer, params, layer, jg, tg, inputs):
    """``sum(layer(...) * proj)`` of both: the value, the gradient of each
    numpy input and of every parameter."""
    rng = np.random.default_rng(9)
    proj = rng.standard_normal((tg.num_nodes, HID)).astype(np.float32)

    def j_loss(p, *xs):
        return jnp.sum(jlayer.apply(p, jg, *xs) * proj)

    argnums = tuple(range(len(inputs) + 1))
    jv, jgr = jax.value_and_grad(j_loss, argnums=argnums)(
        params, *map(jnp.asarray, inputs))
    layer.load_state_dict({k: torch.tensor(v)
                           for k, v in params["params"].items()})
    txs = [_t(a, grad=True) for a in inputs]
    tv = (layer(tg, *txs) * torch.from_numpy(proj)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **VAL)
    for t, g in zip(txs, jgr[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD)
    names = [n for n, _ in layer.named_parameters()]
    assert sorted(names) == sorted(params["params"])
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgr[0]["params"][name]),
                                   err_msg=name, **GRAD)


LAYER_CASES = list(itertools.product((False, True), repeat=3))


@pytest.mark.parametrize(
    "compact,self_loop,bias", LAYER_CASES,
    ids=[f"{'compact' if c else 'plain'}-loop{int(s)}-bias{int(b)}"
         for c, s, b in LAYER_CASES])
def test_layer_matches_het_tpu(pallas_backend, graphs, compact, self_loop,
                               bias):
    """One ``RGCNLayer`` (ReLU, dropout 0) with non-zero biases."""
    jg, tg = graphs
    rng = np.random.default_rng(10)
    x = rng.standard_normal((tg.num_nodes, IN)).astype(np.float32)
    kw = dict(bias=bias, activation=jax.nn.relu, self_loop=self_loop,
              compact=compact)
    jlayer = JRGCNLayer(in_feat=IN, out_feat=HID, num_rels=jg.num_rels, **kw)
    params = _init(jlayer, jg, jnp.asarray(x))
    if bias:
        params["params"]["bias"] = rng.standard_normal(HID).astype(
            np.float32)
    layer = RGCNLayer(IN, HID, tg.num_rels, bias=bias, activation=torch.relu,
                      self_loop=self_loop, compact=compact)
    _compare_layer(jlayer, params, layer, jg, tg, [x])


def test_seastar_layer0_matches_het_tpu(pallas_backend, graphs):
    jg, tg = graphs
    rng = np.random.default_rng(11)
    jlayer = JSeastarRGCNLayer0(num_nodes=jg.num_nodes, num_rels=jg.num_rels,
                                out_feat=HID, activation=jax.nn.relu)
    params = _init(jlayer, jg)
    params["params"]["bias"] = rng.standard_normal(HID).astype(np.float32)
    layer = SeastarRGCNLayer0(tg.num_nodes, tg.num_rels, HID,
                              activation=torch.relu)
    _compare_layer(jlayer, params, layer, jg, tg, [])


MODEL_CASES = list(itertools.product((False, True), repeat=2))
MODEL_IDS = [f"{'featureless' if f else 'features'}-"
             f"{'compact' if c else 'plain'}" for f, c in MODEL_CASES]


@pytest.fixture(scope="module", params=MODEL_CASES, ids=MODEL_IDS)
def model_setup(request, graphs):
    """het_tpu's 2-layer ``RGCNModel`` fed by learned embeddings (unused
    by the featureless one, whose embedding gradient is zero), its
    parameters with non-zero biases, and the loss on a train split."""
    featureless, compact = request.param
    jg, tg = graphs
    rng = np.random.default_rng(3)
    jmodel = JRGCNModel(num_nodes=jg.num_nodes, hidden=HID, num_classes=CLS,
                        num_rels=jg.num_rels, featureless=featureless,
                        in_feat=IN, compact=compact)
    jembed = JNodeEmbed(num_nodes=jg.num_nodes, embed_dim=IN)
    e_params = jembed.init(jax.random.PRNGKey(1))
    m_params = _init(jmodel, jg, jembed.apply(e_params))
    tree = {"embed": jax.tree.map(np.asarray, e_params), "model": m_params}
    for layer in tree["model"]["params"].values():
        layer["bias"] = rng.standard_normal(
            layer["bias"].shape).astype(np.float32) * 0.1
    labels = rng.integers(0, CLS, jg.num_nodes)
    train_idx = rng.permutation(jg.num_nodes)[:36]

    def loss(p):
        logits = jmodel.apply(p["model"], jg, jembed.apply(p["embed"]))
        y = jnp.asarray(labels)[train_idx]
        return j_nll_loss(logits[train_idx], y), logits

    def net():
        n = NodeClassifier(
            NodeEmbed(tg.num_nodes, IN),
            RGCNModel(tg.num_nodes, HID, CLS, tg.num_rels,
                      featureless=featureless, in_feat=IN, compact=compact))
        n.load_state_dict(params_from_jax(tree))
        return n.train()

    return (jax.jit(jax.value_and_grad(loss, has_aux=True)), tree, net,
            labels, train_idx, featureless, tg)


def _j_leaf(tree, name, featureless):
    """The JAX leaf behind the port's state-dict key ``name``: the
    featureless model's flax groups are ``SeastarRGCNLayer0_0`` and
    ``RGCNLayer_0``."""
    if name == "embed.embed":
        return tree["embed"]["params"]["embed"]
    _, _, i, leaf = name.split(".")
    groups = (["SeastarRGCNLayer0_0", "RGCNLayer_0"] if featureless
              else ["RGCNLayer_0", "RGCNLayer_1"])
    return tree["model"]["params"][groups[int(i)]][leaf]


def test_model_forward_and_grads(pallas_backend, model_setup):
    jfn, tree, make_net, labels, train_idx, featureless, tg = model_setup
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
    assert len(names) == 1 + 2 * 2
    for name, p in net.named_parameters():
        want = np.asarray(_j_leaf(jgrad, name, featureless))
        if p.grad is None:  # the featureless model reads no embedding
            assert featureless and name == "embed.embed"
            assert not want.any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name,
                                   **GRAD)


def test_model_three_adam_steps(pallas_backend, model_setup):
    jfn, tree, make_net, labels, train_idx, featureless, tg = model_setup
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
        np.testing.assert_allclose(
            p.detach().numpy(),
            np.asarray(_j_leaf(params, name, featureless)), err_msg=name,
            **VAL)


def test_params_from_jax_maps_groups_by_module_order():
    """A featureless tree's ``RGCNLayer_0`` is the port's layer 1; a group
    of no ported layer raises."""
    leaf = np.zeros(2, np.float32)
    tree = {"embed": {"params": {"embed": leaf}},
            "model": {"params": {"RGCNLayer_0": {"bias": leaf + 1},
                                 "SeastarRGCNLayer0_0": {"bias": leaf}}}}
    sd = params_from_jax(tree)
    assert sorted(sd) == ["embed.embed", "model.layers.0.bias",
                          "model.layers.1.bias"]
    assert sd["model.layers.1.bias"].eq(1).all()
    tree["model"]["params"]["GCNLayer_0"] = {}
    with pytest.raises(KeyError, match="GCNLayer_0"):
        params_from_jax(tree)
