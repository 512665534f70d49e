"""The port's compiled models (``--use_compiler``) against het_tpu's, on
the CPU: ``CompiledRGATModel`` under its four flag combinations,
``CompiledHGTModel`` and ``CompiledRGCNModel`` plain and compact, two
layers each, from the same parameters (het_tpu's ``init``) and the same
numpy inputs on the same graph (two node types, padding edges), het_tpu's
on its pallas backend in interpret mode.  The logits and the gradient of
every parameter and of the input are held.  Besides: the parameter names
and initialisation, the Op-Spec overrides on a whole model, the compiled
model in bf16, and what ``build_model`` refuses.

Tolerances: values rtol 1e-4 / atol 2e-4, gradients rtol 5e-3 / atol
2e-4 (the repo's backend-parity ones), TF32 off."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from het_tpu import ops as jops
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.train import compiled as jcompiled
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.train import compiled
from het_tpu_torch.train.config import TrainConfig

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
IN, HID, CLS, R = 6, 8, 4, 3

# (family, compact, multiply-first)
MODELS = [("RGAT", c, m) for c in (False, True) for m in (False, True)] + [
    (f, c, False) for f in ("HGT", "RGCN") for c in (False, True)]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=60, num_edges=360, num_rels=R, seed=3, tile=8,
              ntype_offsets=(0, 25, 60))
    jg, tg = j_random_heterograph(**kw), t_random_heterograph(**kw)
    assert tg.num_padded_edges > tg.num_edges and tg.num_ntypes == 2
    return jg, tg


def _models(family, compact, mf, tg):
    """(het_tpu's model, the port's) with the same arguments."""
    T = tg.num_ntypes
    if family == "RGAT":
        return (jcompiled.CompiledRGATModel(
                    IN, HID, CLS, R, num_layers=2, compact=compact,
                    multiply_first=mf, dropout=0.0),
                compiled.CompiledRGATModel(
                    IN, HID, CLS, R, 2, compact=compact, multiply_first=mf,
                    dropout=0.0))
    if family == "HGT":
        return (jcompiled.CompiledHGTModel(IN, HID, CLS, T, R, num_layers=2,
                                           compact=compact, dropout=0.0),
                compiled.CompiledHGTModel(IN, HID, CLS, T, R, 2,
                                          compact=compact, dropout=0.0))
    return (jcompiled.CompiledRGCNModel(IN, HID, CLS, R, compact=compact,
                                        dropout=0.0),
            compiled.CompiledRGCNModel(IN, HID, CLS, R, compact=compact,
                                       dropout=0.0))


def _flat(params):
    """het_tpu's compiled parameter tree -> the port's state dict."""
    return {f"{layer}.{leaf}": np.asarray(v)
            for layer, leaves in params.items() for leaf, v in leaves.items()}


@pytest.mark.parametrize("family,compact,mf", MODELS)
def test_compiled_model_matches_het_tpu(graphs, family, compact, mf):
    jg, tg = graphs
    jm, tm = _models(family, compact, mf, tg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), jg,
                                              None))
    # rel_pri away from one, so that mu's gradient is not the only one
    # that sees it
    for leaves in params.values():
        if "rel_pri" in leaves:
            leaves["rel_pri"] = np.linspace(0.5, 1.5, R, dtype=np.float32)
    state = _flat(params)
    assert sorted(state) == sorted(tm.state_dict())
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((tg.num_nodes, IN)).astype(np.float32)
    proj = rng.standard_normal((tg.num_nodes, CLS)).astype(np.float32)

    def j_loss(p, xx):
        out = jm.apply(p, jg, xx)
        return jnp.sum(out * proj), out

    jops.set_backend("pallas")
    try:
        (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
            j_loss, argnums=(0, 1), has_aux=True))(
                jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    finally:
        jops.set_backend("xla")
    tx = torch.tensor(x, requires_grad=True)
    out = tm(tg, tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **VAL)
    (out * torch.tensor(proj)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD)
    want = _flat(jgp)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name,
                                   **GRAD)


def test_parameters_and_initialisation():
    """het_tpu's names and shapes; glorot-uniform from the generator
    (flax's fans: the leading axes multiply both), biases zero, HGT's
    ``rel_pri`` and ``skip`` one; the same generator seed the same
    parameters."""
    m = compiled.CompiledHGTModel(IN, HID, CLS, 2, R, 2,
                                  generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes["layer_0.k_w"] == (2, IN, HID)
    assert shapes["layer_1.rel_att"] == (R, CLS, CLS)
    assert (m.state_dict()["layer_0.rel_pri"] == 1).all()
    assert (m.state_dict()["layer_1.skip"] == 1).all()
    w = m.state_dict()["layer_0.rel_msg"]
    limit = math.sqrt(6.0 / (2 * R * HID))
    assert w.abs().max() <= limit and w.abs().max() > 0.8 * limit
    r = compiled.CompiledRGATModel(IN, HID, CLS, R, 2,
                                   generator=torch.Generator().manual_seed(0))
    assert sorted(r.state_dict()) == sorted(
        f"layer_{i}.{n}" for i in range(2)
        for n in ("W", "attn_l", "attn_r", "bias"))
    assert (r.state_dict()["layer_1.bias"] == 0).all()
    again = compiled.CompiledRGATModel(
        IN, HID, CLS, R, 2, generator=torch.Generator().manual_seed(0))
    for k, v in r.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


@pytest.mark.parametrize("strategy,packing", [("gather_einsum", None),
                                              (None, "split")])
def test_rescheduled_model_keeps_its_result(graphs, strategy, packing):
    """``reschedule`` flips every GEMM spec to the segment-matmul kernels'
    device offsets (their plain versions on CPU tensors) or the softmax
    aggregation to the unfused chain: the same logits and gradients."""
    _, tg = graphs
    gen = torch.Generator().manual_seed(2)
    base = compiled.CompiledRGATModel(IN, HID, CLS, R, 2, dropout=0.0,
                                      generator=gen)
    other = compiled.CompiledRGATModel(IN, HID, CLS, R, 2, dropout=0.0)
    other.load_state_dict(base.state_dict())
    other.reschedule(strategy=strategy, packing=packing)
    gemm = [s.gpu for s in other.opspec.gemms()]
    assert gemm and all(g["strategy"] == (strategy or "host_offsets")
                        for g in gemm)
    x = torch.randn(tg.num_nodes, IN, generator=gen)
    outs = []
    for m in (base, other):
        out = m(tg, x)
        (out ** 2).sum().backward()
        outs.append((out.detach(), {k: p.grad for k, p in
                                    m.named_parameters()}))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(), **VAL)
    for k, g in outs[0][1].items():
        np.testing.assert_allclose(outs[1][1][k].numpy(), g.numpy(),
                                   err_msg=k, **GRAD)


def test_compiled_model_in_bf16(graphs):
    """The trainer's mixed precision on a compiled model: the forward on
    bf16 copies of the parameters (``model_forward``), close to the f32
    forward, and f32 gradients on the f32 parameters."""
    from het_tpu_torch.train.driver import model_forward

    _, tg = graphs
    m = compiled.CompiledRGATModel(IN, HID, CLS, R, 2, compact=True,
                                   multiply_first=True, dropout=0.0,
                                   generator=torch.Generator().manual_seed(4))
    x = torch.rand(tg.num_nodes, IN, generator=torch.Generator()
                   .manual_seed(5))
    want = m(tg, x)
    got = model_forward(m, torch.bfloat16)(tg, x.bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               want.detach().numpy(), rtol=5e-2, atol=5e-2)
    got.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all() for p in m.parameters())


def test_build_model_refuses_gat():
    from het_tpu_torch.data.loaders import load_dataset
    from het_tpu_torch.train.driver import build_model

    data = load_dataset("mag", scale=0.002, num_classes=CLS, seed=0)
    for name in ("RGAT", "HGT", "RGCN"):
        net = build_model(TrainConfig(model=name, use_compiler=True,
                                      num_layers=2), data)
        assert isinstance(net.model, compiled.FAMILIES[name])
    with pytest.raises(ValueError, match="RGAT/HGT/RGCN, got GAT"):
        build_model(TrainConfig(model="GAT", use_compiler=True), data)
