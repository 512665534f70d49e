"""The port's 2-layer RGAT against het_tpu's (pallas backend, interpret
mode on the CPU) with the same parameters, carried by ``params_from_jax``,
in each of the four dual-list branches (plain or compact, with or without
multiply-first): logits, every parameter gradient, and three Adam steps
against ``jax.value_and_grad`` + ``optax.adam``.  Tolerances: values rtol
1e-4 / atol 2e-4, gradients rtol 5e-3 / atol 2e-4 (the repo's
backend-parity ones)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from het_tpu import ops as jops
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.models import NodeEmbed as JNodeEmbed
from het_tpu.models import RGATModel as JRGATModel
from het_tpu.utils.misc import nll_loss as j_nll_loss
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.models import NodeEmbed, RGATLayer, RGATModel
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.train import TrainConfig, train
from het_tpu_torch.train.driver import NodeClassifier
from het_tpu_torch.utils.misc import nll_loss

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
IN, HID, CLS, HEADS, LR = 12, 8, 4, 2, 1e-2
# branch -> (compact, multiply_first)
BRANCHES = {
    "plain": (False, False),
    "plain_multiply_first": (False, True),
    "compact": (True, False),
    "compact_multiply_first": (True, True),
}


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=5, tile=8)
    return j_random_heterograph(**kw), t_random_heterograph(**kw)


@pytest.fixture(scope="module", params=list(BRANCHES))
def setup(request, graphs):
    jg, tg = graphs
    compact, multiply_first = BRANCHES[request.param]
    rng = np.random.default_rng(3)
    jmodel = JRGATModel(in_feat=IN, hidden=HID, num_classes=CLS,
                        num_rels=jg.num_rels, num_heads=HEADS, num_layers=2,
                        compact=compact, multiply_first=multiply_first,
                        dropout=0.0, stable_softmax="clip")
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
    compact, multiply_first = BRANCHES[branch]
    net = NodeClassifier(
        NodeEmbed(tg.num_nodes, IN),
        RGATModel(IN, HID, CLS, tg.num_rels, HEADS, 2, compact=compact,
                  multiply_first=multiply_first, dropout=0.0,
                  stable_softmax="clip"),
    )
    net.load_state_dict(params_from_jax(tree))
    return net.train()


def _j_leaf(tree, name):
    """The JAX leaf behind the port's state-dict key ``name``."""
    if name == "embed.embed":
        return tree["embed"]["params"]["embed"]
    _, _, i, leaf = name.split(".")
    return tree["model"]["params"][f"RGATLayer_{i}"][leaf]


def test_forward_and_grads(pallas_backend, setup):
    jg, tg, jfn, tree, labels, train_idx, branch = setup
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


def test_three_adam_steps(pallas_backend, setup):
    jg, tg, loss_fn, tree, labels, train_idx, branch = setup
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
def test_cpu_training_run(branch):
    compact, multiply_first = BRANCHES[branch]
    cfg = TrainConfig(model="RGAT", dataset="mag", dataset_scale=0.002,
                      n_infeat=16, hidden=16, num_heads=2, num_layers=2,
                      compact=compact, multiply_first=multiply_first,
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


@pytest.mark.parametrize("kw", [
    dict(compact=False, multiply_first=False),
    dict(compact=True, multiply_first=True),
])
def test_unported_branches_raise(graphs, kw):
    """``stable="max"`` raises on the plain and the compact path."""
    tg = graphs[1]
    layer = RGATLayer(IN, HID, tg.num_rels, HEADS, stable_softmax="max",
                      **kw)
    with pytest.raises(NotImplementedError, match="stable=max"):
        layer(tg, torch.zeros(tg.num_nodes, IN))


@pytest.mark.parametrize("graph_change,match", [
    ("union", "union"),
    ("packed", "packed"),
])
def test_unported_graph_branches_raise(graphs, graph_change, match):
    tg = graphs[1]
    if graph_change == "union":
        tg = dataclasses.replace(tg, compact_shared=True)
    else:
        seg = dataclasses.replace(tg.compact_src.seg, n_rows=1_000_000)
        tg = dataclasses.replace(
            tg, compact_src=dataclasses.replace(tg.compact_src, seg=seg))
    layer = RGATLayer(IN, HID, tg.num_rels, HEADS, compact=True,
                      multiply_first=True)
    with pytest.raises(NotImplementedError, match=match):
        layer(tg, torch.zeros(tg.num_nodes, IN))


def test_plain_path_needs_no_compact_indices(graphs):
    """The plain branches run on a graph built without compact rows."""
    tg = dataclasses.replace(graphs[1], compact_src=None, compact_dst=None)
    for mf in (False, True):
        layer = RGATLayer(IN, HID, tg.num_rels, HEADS, multiply_first=mf,
                          dropout=0.0)
        out = layer(tg, torch.randn(tg.num_nodes, IN))
        assert out.shape == (tg.num_nodes, HID)
        assert torch.isfinite(out).all()
