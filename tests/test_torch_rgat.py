"""The port's 2-layer RGAT against het_tpu's (pallas backend, interpret
mode on the CPU) with the same parameters, carried by ``params_from_jax``,
in every branch het_tpu has: the four dual-list ones (plain or compact,
with or without multiply-first), union-list compact with and without
multiply-first, compact multiply-first against both of het_tpu's operand
forms (the split one and the packed one, which the port always takes:
het_tpu's row gate ``PACKED_COMPACT_ROWS`` set low in its ``rgat`` module
for the ``packed`` branches), and the exact max softmax: logits, every parameter gradient, and three Adam
steps against ``jax.value_and_grad`` + ``optax.adam``; single layers too.
Tolerances: values rtol 1e-4 / atol 2e-4, gradients rtol 5e-3 / atol
2e-4 (the repo's backend-parity ones)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from het_tpu import ops as jops
from het_tpu.graph import build_heterograph as j_build_heterograph
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.models import NodeEmbed as JNodeEmbed
from het_tpu.models import RGATLayer as JRGATLayer
from het_tpu.models import RGATModel as JRGATModel
from het_tpu.models import rgat as j_rgat
from het_tpu.utils.misc import nll_loss as j_nll_loss
from het_tpu_torch.graph import build_heterograph as t_build_heterograph
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.models import NodeEmbed, RGATLayer, RGATModel
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.train import TrainConfig, train
from het_tpu_torch.train.driver import NodeClassifier
from het_tpu_torch.utils.misc import nll_loss

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
IN, HID, CLS, HEADS, LR = 12, 8, 4, 2, 1e-2
# branch -> (compact, multiply_first, union-list graph, het_tpu in its
# packed form, stable_softmax)
BRANCHES = {
    "plain": (False, False, False, False, "clip"),
    "plain_multiply_first": (False, True, False, False, "clip"),
    "compact": (True, False, False, False, "clip"),
    "compact_multiply_first": (True, True, False, False, "clip"),
    "union": (True, False, True, False, "clip"),
    "union_multiply_first": (True, True, True, False, "clip"),
    "packed": (True, True, False, True, "clip"),
    "plain_max": (False, False, False, False, "max"),
    "packed_max": (True, True, False, True, "max"),
    "union_multiply_first_max": (True, True, True, False, "max"),
}


def _packed_gate(monkeypatch, branch):
    """het_tpu takes its packed form from one source compact row on where
    the branch asks for it (its gate is 1M rows)."""
    if BRANCHES[branch][3]:
        monkeypatch.setattr(j_rgat, "PACKED_COMPACT_ROWS", 1)


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=5, tile=8)
    return j_random_heterograph(**kw), t_random_heterograph(**kw)


@pytest.fixture(scope="module")
def union_graphs(graphs):
    """The same edges with union-list compact rows, in both packages."""
    tg = graphs[1]
    coo = [t[:tg.num_edges].numpy() for t in (tg.src, tg.dst, tg.rel)]
    kw = dict(tile=8, compact_union=True)
    return (j_build_heterograph(*coo, tg.num_nodes, tg.num_rels, **kw),
            t_build_heterograph(*coo, tg.num_nodes, tg.num_rels, **kw))


@pytest.fixture(scope="module", params=list(BRANCHES))
def setup(request, graphs, union_graphs):
    compact, multiply_first, union, _, stable = BRANCHES[request.param]
    jg, tg = union_graphs if union else graphs
    rng = np.random.default_rng(3)
    jmodel = JRGATModel(in_feat=IN, hidden=HID, num_classes=CLS,
                        num_rels=jg.num_rels, num_heads=HEADS, num_layers=2,
                        compact=compact, multiply_first=multiply_first,
                        dropout=0.0, stable_softmax=stable)
    jembed = JNodeEmbed(num_nodes=jg.num_nodes, embed_dim=IN)
    e_params = jembed.init(jax.random.PRNGKey(1))
    prev = jops.get_backend()
    jops.set_backend("xla")  # init needs shapes only: skip interpret mode
    m_params = jmodel.init(jax.random.PRNGKey(2), jg,
                           jembed.apply(e_params))
    jops.set_backend(prev)
    tree = jax.tree.map(np.asarray, {"embed": e_params, "model": m_params})
    for layer in tree["model"]["params"].values():  # non-zero biases
        layer["h_bias"] = rng.standard_normal(
            layer["h_bias"].shape).astype(np.float32) * 0.1
    labels = rng.integers(0, CLS, jg.num_nodes)
    train_idx = rng.permutation(jg.num_nodes)[:36]
    jfn = _j_loss(jg, jmodel, jembed, labels, train_idx)
    return jg, tg, jfn, tree, labels, train_idx, request.param


def _j_loss(jg, jmodel, jembed, labels, train_idx):
    def loss(p):
        x = jembed.apply(p["embed"])
        logits = jmodel.apply(p["model"], jg, x)
        y = jnp.asarray(labels)[train_idx]
        return j_nll_loss(logits[train_idx], y), logits
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _t_net(tg, tree, branch):
    compact, multiply_first, _, _, stable = BRANCHES[branch]
    net = NodeClassifier(
        NodeEmbed(tg.num_nodes, IN),
        RGATModel(IN, HID, CLS, tg.num_rels, HEADS, 2, compact=compact,
                  multiply_first=multiply_first, dropout=0.0,
                  stable_softmax=stable),
    )
    net.load_state_dict(params_from_jax(tree))
    return net.train()


def _j_leaf(tree, name):
    """The JAX leaf behind the port's state-dict key ``name``."""
    if name == "embed.embed":
        return tree["embed"]["params"]["embed"]
    _, _, i, leaf = name.split(".")
    return tree["model"]["params"][f"RGATLayer_{i}"][leaf]


def test_forward_and_grads(pallas_backend, setup, monkeypatch):
    jg, tg, jfn, tree, labels, train_idx, branch = setup
    _packed_gate(monkeypatch, branch)
    net = _t_net(tg, tree, branch)
    logits = net(tg)
    (jv, jlogits), jgrad = jfn(tree)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **VAL)
    loss = nll_loss(logits[torch.from_numpy(train_idx)],
                    torch.from_numpy(labels[train_idx]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), **VAL)
    names = [n for n, _ in net.named_parameters()]
    assert len(names) == 1 + 4 * 2
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(_j_leaf(jgrad, name)),
                                   err_msg=name, **GRAD)


def test_three_adam_steps(pallas_backend, setup, monkeypatch):
    jg, tg, loss_fn, tree, labels, train_idx, branch = setup
    _packed_gate(monkeypatch, branch)
    tx = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    j_losses = []
    for _ in range(3):
        (v, _), grads = loss_fn(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        j_losses.append(float(v))

    net = _t_net(tg, tree, branch)
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


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cpu_training_run(branch, monkeypatch):
    compact, multiply_first, union, _, stable = BRANCHES[branch]
    _packed_gate(monkeypatch, branch)
    cfg = TrainConfig(model="RGAT", dataset="mag", dataset_scale=0.002,
                      n_infeat=16, hidden=16, num_heads=2, num_layers=2,
                      compact=compact, compact_union=union,
                      multiply_first=multiply_first, stable_softmax=stable,
                      num_epochs=3, device="cpu")
    logs = []
    m1 = train(cfg, log=logs.append)
    assert len(logs) == 3 and m1["timer"] == "host_clock"
    assert np.isfinite(m1["loss_list"]).all() and len(m1["loss_list"]) == 3
    # the dropout masks come from a seeded generator: runs repeat exactly
    m2 = train(cfg, log=lambda s: None)
    assert m1["loss_list"] == m2["loss_list"]
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    m3 = train(cfg0, log=lambda s: None)
    assert m3["loss_list"][-1] < m3["loss_list"][0]


# layer-test case -> (branch, the layer options het_tpu's RGATLayer shares
# with RGCNLayer); cases named by a branch take the defaults
LAYER_OPTIONS = {
    "plain_self_loop": ("plain", dict(self_loop=True)),
    "plain_no_bias": ("plain", dict(bias=False)),
    "compact_self_loop_no_bias": ("compact", dict(self_loop=True,
                                                  bias=False)),
    "packed_self_loop": ("packed", dict(self_loop=True)),
    "union_multiply_first_no_bias": ("union_multiply_first",
                                     dict(bias=False)),
}


@pytest.mark.parametrize("case", [
    "plain_max", "union", "union_multiply_first", "packed", "packed_max",
    "union_multiply_first_max", *LAYER_OPTIONS,
])
def test_layer_matches_het_tpu(pallas_backend, graphs, union_graphs,
                               monkeypatch, case):
    """One RGAT layer (no activation, dropout 0) of each branch this slice
    ports, and with ``self_loop`` or ``bias=False``, against het_tpu's
    layer with the same parameters: output and the gradients of the input
    and of every parameter."""
    branch, options = LAYER_OPTIONS.get(case, (case, {}))
    compact, multiply_first, union, _, stable = BRANCHES[branch]
    jg, tg = union_graphs if union else graphs
    _packed_gate(monkeypatch, branch)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((tg.num_nodes, IN)).astype(np.float32)
    proj = rng.standard_normal((tg.num_nodes, HID)).astype(np.float32)
    jlayer = JRGATLayer(IN, HID, jg.num_rels, HEADS, compact=compact,
                        multiply_first=multiply_first, dropout=0.0,
                        stable_softmax=stable, **options)
    prev = jops.get_backend()
    jops.set_backend("xla")  # init needs shapes only: skip interpret mode
    params = jlayer.init(jax.random.PRNGKey(4), jg, jnp.asarray(x))
    jops.set_backend(prev)
    params = jax.tree.map(np.asarray, params)
    if options.get("bias", True):
        params["params"]["h_bias"] = rng.standard_normal(HID).astype(
            np.float32)

    def j_loss(p, xx):
        return jnp.sum(jlayer.apply(p, jg, xx) * proj)

    jv, (jgp, jgx) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    layer = RGATLayer(IN, HID, tg.num_rels, HEADS, compact=compact,
                      multiply_first=multiply_first, dropout=0.0,
                      stable_softmax=stable, **options)
    assert sorted(layer.state_dict()) == sorted(params["params"])
    layer.load_state_dict({k: torch.tensor(v)
                           for k, v in params["params"].items()})
    tx = torch.from_numpy(x).requires_grad_()
    tv = (layer(tg, tx) * torch.from_numpy(proj)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **VAL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgp["params"][name]),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("branch", [
    "compact", "compact_multiply_first", "union", "union_multiply_first"])
def test_compact_multiply_first_takes_the_packed_op(graphs, union_graphs,
                                                    monkeypatch, branch):
    """Dual-list compact multiply-first takes the packed op at any size;
    the other compact branches take the split one."""
    from het_tpu_torch import ops

    compact, multiply_first, union, _, _ = BRANCHES[branch]
    tg = (union_graphs if union else graphs)[1]
    calls = []

    def counted(name):
        fn = getattr(ops, name)

        def call(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return call

    for name in ("relational_fused_gat_compact",
                 "relational_fused_gat_compact_packed"):
        monkeypatch.setattr(ops, name, counted(name))
    layer = RGATLayer(IN, HID, tg.num_rels, HEADS, compact=compact,
                      multiply_first=multiply_first, dropout=0.0)
    layer(tg, torch.randn(tg.num_nodes, IN))
    packed = multiply_first and not union
    assert calls == ["relational_fused_gat_compact"
                     + ("_packed" if packed else "")]


def test_plain_path_needs_no_compact_indices(graphs):
    """The plain branches run on a graph built without compact rows."""
    tg = dataclasses.replace(graphs[1], compact_src=None, compact_dst=None)
    for mf in (False, True):
        layer = RGATLayer(IN, HID, tg.num_rels, HEADS, multiply_first=mf,
                          dropout=0.0)
        out = layer(tg, torch.randn(tg.num_nodes, IN))
        assert out.shape == (tg.num_nodes, HID)
        assert torch.isfinite(out).all()
