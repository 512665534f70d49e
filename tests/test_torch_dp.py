"""The port's data-parallel RGAT on two gloo ranks spawned on the CPU
against het_tpu's single-chip ``RGATModel`` on the unpartitioned graph,
with the same parameters (``DPGNN.init``'s, carried by
``dp_params_from_jax``), the same features and the same masked NLL: the
logits of every real node (through ``info.relabel``) and every summed
parameter gradient, in the four dual-list branches (compact
multiply-first in the port's packed form, het_tpu's split one) and two
with the exact max softmax, and for RGCN (``RGCNModel``, plain and
compact, from ``DPGNN.init`` over ``RGCNLayer``s) and HGT (``HGTModel``,
plain and compact, at two node types whose boundary falls inside a
shard, from ``DPGNN.init`` over ``HGTLayer``s, which exchange only their
projected k and v), with the halo gathered and exchanged at the
boundary; and three data-parallel Adam steps against the port's
single-process run.  This is the comparison
``tests/test_parallel.py`` makes for het_tpu's own data parallelism.
Tolerances: forward rtol 1e-4 / atol 2e-4, gradients rtol 5e-3 / atol
2e-4, losses rtol 1e-4 (the repo's backend-parity ones)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from het_tpu.graph import build_heterograph as j_build
from het_tpu.models import HGTLayer as JHGTLayer
from het_tpu.models import HGTModel as JHGTModel
from het_tpu.models import RGATLayer as JRGATLayer
from het_tpu.models import RGATModel as JRGATModel
from het_tpu.models.rgcn import RGCNLayer as JRGCNLayer
from het_tpu.models.rgcn import RGCNModel as JRGCNModel
from het_tpu.parallel import DPGNN as JDPGNN
from het_tpu.parallel import make_mesh
from het_tpu.parallel import partition_by_dst as j_partition
from het_tpu_torch.graph import build_heterograph as t_build
from het_tpu_torch.models import (HGTModel, RGATModel, RGCNModel,
                                  dp_params_from_jax)
from het_tpu_torch.parallel import partition_by_dst, train_full
from het_tpu_torch.parallel.launch import spawn_ranks
from tests.test_torch_dp_worker import record_job

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
IN, HID, CLS, HEADS, LR, STEPS, P = 12, 8, 4, 2, 1e-2, 3, 2
# branch -> (compact, multiply_first, stable_softmax)
BRANCHES = {
    "plain": (False, False, "clip"),
    "plain_multiply_first": (False, True, "clip"),
    "compact": (True, False, "clip"),
    "compact_multiply_first": (True, True, "clip"),
    "plain_max": (False, False, "max"),
    "compact_multiply_first_max": (True, True, "max"),
}
# RGCN and HGT branches -> compact
RGCN_BRANCHES = {"rgcn_plain": False, "rgcn_compact": True}
HGT_BRANCHES = {"hgt_plain": False, "hgt_compact": True}
N_NODES = 200
# HGT's two node types; the boundary lies inside the first shard
HGT_NTYPES = (0, 70, N_NODES)
HALOS = ("gather", "boundary")
ALL = [*BRANCHES, *RGCN_BRANCHES, *HGT_BRANCHES]
CASES = [(b, h) for b in ALL for h in HALOS]
MODELS = {"RGAT": RGATModel, "RGCN": RGCNModel, "HGT": HGTModel}


def _problem():
    rng = np.random.default_rng(11)
    n, e, r = N_NODES, 900, 4
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    x = rng.standard_normal((n, IN)).astype(np.float32)
    labels = rng.integers(0, CLS, n)
    labels[rng.random(n) < 0.2] = -1  # unlabelled nodes
    return src, dst, rel, n, r, x, labels


def _family(branch):
    if branch in RGCN_BRANCHES:
        return "RGCN"
    return "HGT" if branch in HGT_BRANCHES else "RGAT"


def _ntypes(branch):
    """The node-type offsets of a branch's graph (None: one type)."""
    return HGT_NTYPES if branch in HGT_BRANCHES else None


def _group(branch, i):
    """het_tpu's flax group of layer ``i``."""
    return f"{_family(branch)}Layer_{i}"


def _model_kw(r, branch):
    if branch in HGT_BRANCHES:
        return dict(in_dim=IN, hidden=HID, num_classes=CLS, num_ntypes=2,
                    num_rels=r, num_heads=HEADS, num_layers=2, dropout=0.0,
                    compact=HGT_BRANCHES[branch], stable_softmax="clip")
    if branch in RGCN_BRANCHES:
        return dict(num_nodes=N_NODES, hidden=HID, num_classes=CLS,
                    num_rels=r, featureless=False, in_feat=IN,
                    compact=RGCN_BRANCHES[branch], dropout=0.0)
    compact, multiply_first, stable = BRANCHES[branch]
    return dict(in_feat=IN, hidden=HID, num_classes=CLS, num_rels=r,
                num_heads=HEADS, num_layers=2, compact=compact,
                multiply_first=multiply_first, dropout=0.0,
                stable_softmax=stable)


def _jax_params(branch, jsg, x_pad, r):
    """het_tpu's ``DPGNN.init`` on its own partition, with non-zero
    biases (HGT: ``skip`` and ``relation_pri`` moved off their initial
    ones)."""
    if branch in HGT_BRANCHES:
        kw = dict(num_ntypes=2, num_rels=r, num_heads=HEADS, dropout=0.0,
                  compact=HGT_BRANCHES[branch], stable_softmax="clip")
        layers = [JHGTLayer(in_dim=IN, out_dim=HID, **kw),
                  JHGTLayer(in_dim=HID, out_dim=CLS, **kw)]
    elif branch in RGCN_BRANCHES:
        kw = dict(num_rels=r, compact=RGCN_BRANCHES[branch])
        layers = [JRGCNLayer(in_feat=IN, out_feat=HID,
                             activation=jax.nn.relu, **kw),
                  JRGCNLayer(in_feat=HID, out_feat=CLS, **kw)]
    else:
        compact, multiply_first, stable = BRANCHES[branch]
        kw = dict(num_rels=r, num_heads=HEADS, compact=compact,
                  multiply_first=multiply_first, dropout=0.0,
                  stable_softmax=stable)
        layers = [JRGATLayer(in_feat=IN, out_feat=HID,
                             activation=jax.nn.relu, **kw),
                  JRGATLayer(in_feat=HID, out_feat=CLS, **kw)]
    params = JDPGNN(layers, make_mesh(P)).init(jax.random.PRNGKey(3), jsg,
                                               jnp.asarray(x_pad))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(5)
    moved = {"RGAT": ("h_bias",), "RGCN": ("bias",),
             "HGT": ("skip", "relation_pri")}[_family(branch)]
    for layer in params:
        for leaf in moved:
            b = layer["params"][leaf]
            noise = rng.standard_normal(b.shape).astype(np.float32) * 0.1
            # biases from zero, HGT's ones moved off one
            layer["params"][leaf] = noise if "bias" in leaf else b + noise
    return params


def _jax_reference(branch, params, g1, x, labels, r):
    """Logits, loss and gradients of het_tpu's single-chip model."""
    model = {"RGAT": JRGATModel, "RGCN": JRGCNModel,
             "HGT": JHGTModel}[_family(branch)](**_model_kw(r, branch))
    tree = {"params": {_group(branch, i): p["params"]
                       for i, p in enumerate(params)}}
    y = jnp.asarray(labels)

    def loss(t):
        logits = model.apply(t, g1, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits, axis=-1)
        mask = (y >= 0).astype(jnp.float32)
        ll = jnp.take_along_axis(logp, jnp.maximum(y, 0)[:, None], 1)[:, 0]
        return -jnp.sum(ll * mask) / jnp.sum(mask), logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss,
                                                        has_aux=True))(tree)
    return float(value), np.asarray(logits), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    src, dst, rel, n, r, x, labels = _problem()
    parts = {}
    for halo in HALOS:
        for nt in (None, HGT_NTYPES):
            kw = dict(tile=8, build_compact=True, balance="edges", halo=halo,
                      ntype_offsets=nt)
            parts[halo, nt] = (partition_by_dst(src, dst, rel, n, r, P, **kw),
                               j_partition(src, dst, rel, n, r, P, **kw)[0])
    info = parts["gather", None][0][1]
    x_pad = info.pad_node_data(x)
    labels_pad = info.pad_node_data(labels, fill=-1)
    refs = {}
    for branch in ALL:
        nt = _ntypes(branch)
        assert parts["gather", nt][0][1].nodes_per_part == info.nodes_per_part
        g1 = j_build(src, dst, rel, n, r, tile=8, ntype_offsets=nt)
        params = _jax_params(branch, parts["gather", nt][1], x_pad, r)
        refs[branch] = (params,
                        _jax_reference(branch, params, g1, x, labels, r))
    jobs = []
    for branch, halo in CASES:
        shards, info_h = parts[halo, _ntypes(branch)][0]
        jobs.append(dict(shards=shards, nodes_per_part=info_h.nodes_per_part,
                         x=x_pad, labels=labels_pad,
                         family=_family(branch), model=_model_kw(r, branch),
                         state=dp_params_from_jax(refs[branch][0]),
                         steps=STEPS, lr=LR, impl="kernel"))
    workdir = tmp_path_factory.mktemp("dp_ranks")
    results = spawn_ranks(P, jobs, workdir=str(workdir), device="cpu",
                          job_fn=record_job)
    out = {}
    for i, case in enumerate(CASES):
        out[case] = [results[rank][i] for rank in range(P)]
    problem = dict(src=src, dst=dst, rel=rel, n=n, r=r, x=x, labels=labels,
                   info=info)
    return out, refs, problem


@pytest.mark.parametrize("branch,halo", CASES)
def test_dp_matches_single_chip(runs, branch, halo):
    out, refs, pb = runs
    ranks = out[branch, halo]
    params, (value, logits, grads) = refs[branch]
    assert ranks[0]["backend"] == "gloo" and ranks[0]["device"] == "cpu"
    dp_logits = torch.cat([r_["logits"] for r_ in ranks]).numpy()
    rows = pb["info"].relabel(np.arange(pb["n"]))
    np.testing.assert_allclose(dp_logits[rows], logits, **VAL)
    np.testing.assert_allclose(ranks[0]["loss"], value, **VAL)
    names = sorted(ranks[0]["grads"])
    assert len(names) == {"RGCN": 4, "RGAT": 8, "HGT": 16}[_family(branch)]
    for name in names:
        _, i, leaf = name.split(".")
        want = grads["params"][_group(branch, i)][leaf]
        for rank in ranks:  # every rank holds the same summed gradient
            np.testing.assert_allclose(rank["grads"][name].numpy(), want,
                                       err_msg=name, **GRAD)
    # the shards' typed linears ran on offsets held only on the device,
    # the path of the segment-matmul kernels
    compact = {**RGCN_BRANCHES, **HGT_BRANCHES}.get(
        branch, BRANCHES.get(branch, (None,))[0])
    key = "compact_src" if compact else "edge_rel_seg"
    assert any(r_["device_only"][key] for r_ in ranks)
    if branch in HGT_BRANCHES:  # the shards' node types differ
        assert all(r_["device_only"]["ntype_seg"] for r_ in ranks)


@pytest.mark.parametrize("branch", ALL)
def test_dp_training_matches_single_process(runs, branch):
    """Three data-parallel Adam steps (gather and boundary halos) against
    the port's single-process run on the unpartitioned graph."""
    out, refs, pb = runs
    g = t_build(pb["src"], pb["dst"], pb["rel"], pb["n"], pb["r"], tile=8,
                ntype_offsets=_ntypes(branch))
    model = MODELS[_family(branch)](**_model_kw(pb["r"], branch))
    model.load_state_dict(dp_params_from_jax(refs[branch][0]))
    single = train_full(model.train(), g, torch.from_numpy(pb["x"]),
                        torch.from_numpy(pb["labels"]), steps=STEPS, lr=LR)
    losses = single["loss_list"]
    assert losses[-1] < losses[0]
    for halo in HALOS:
        for rank in out[branch, halo]:
            np.testing.assert_allclose(rank["loss_list"], losses, **VAL)
            assert rank["launches"] == {k: 0 for k in rank["launches"]}
