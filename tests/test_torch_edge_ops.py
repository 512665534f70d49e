"""The port's per-edge ops against het_tpu's pallas backend (interpret mode
on the CPU): ``edge_typed_linear`` (both sides), ``edge_rel_inner`` and
``relational_fused_gat`` (raw, clip and max), forward and every input
gradient, from the same numpy inputs.  Tolerances are the repo's
backend-parity ones: forward rtol 1e-4 / atol 2e-4, gradients rtol 5e-3 /
atol 2e-4."""

import numpy as np
import pytest
import torch

from het_tpu import ops as jops
from het_tpu_torch import ops as tops
from tests.test_torch_ops import STABLE_CASES, _check, _graphs, logits


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


@pytest.mark.parametrize("side", ["src", "dst"])
def test_edge_typed_linear(pallas_backend, side):
    jg, tg = _graphs(2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((jg.num_nodes, 12)).astype(np.float32)
    w = (rng.standard_normal((jg.num_rels, 2, 12, 5)) * 0.4).astype(
        np.float32)
    proj = rng.standard_normal((jg.num_padded_edges, 2, 5)).astype(
        np.float32)
    _check(
        lambda xx, ww: jops.edge_typed_linear(jg, xx, ww, side=side),
        lambda xx, ww: tops.edge_typed_linear(tg, xx, ww, side),
        (x, w), proj,
    )


def test_edge_typed_linear_is_zero_on_padding_edges():
    _, tg = _graphs(2)
    x = torch.randn(tg.num_nodes, 6)
    w = torch.randn(tg.num_rels, 2, 6, 3)
    for side in ("src", "dst"):
        y = tops.edge_typed_linear(tg, x, w, side)
        assert y.shape == (tg.num_padded_edges, 2, 3)
        assert (y[tg.num_edges:] == 0).all()


def test_edge_rel_inner(pallas_backend):
    jg, tg = _graphs(3)
    rng = np.random.default_rng(6)
    H, D = 2, 6
    feat_e = rng.standard_normal((jg.num_padded_edges, H, D)).astype(
        np.float32)
    a = rng.standard_normal((jg.num_rels, H, D)).astype(np.float32)
    proj = rng.standard_normal((jg.num_padded_edges, H)).astype(np.float32)
    _check(
        lambda f, aa: jops.edge_rel_inner(jg, f, aa),
        lambda f, aa: tops.edge_rel_inner(tg, f, aa),
        (feat_e, a), proj,
    )


@pytest.mark.parametrize("stable,logit", STABLE_CASES)
def test_relational_fused_gat(pallas_backend, stable, logit):
    jg, tg = _graphs(4)
    rng = np.random.default_rng(7)
    H, D, EP, E = 2, 6, jg.num_padded_edges, jg.num_edges
    feat_e = rng.standard_normal((EP, H, D)).astype(np.float32)
    el, er = logits(rng, stable, logit, EP, EP, H)
    if logit == "past_exp":  # padding edges carry zeros, as in the model
        el[E:], er[E:] = 0.0, 0.0
    proj = rng.standard_normal((jg.num_nodes, H, D)).astype(np.float32)
    _check(
        lambda f, l, r: jops.relational_fused_gat(jg, f, l, r, 0.2,
                                                  stable=stable),
        lambda f, l, r: tops.relational_fused_gat(tg, f, l, r, 0.2,
                                                  stable=stable),
        (feat_e, el, er), proj,
    )



def test_stable_max_is_shift_invariant_and_exact():
    """Under ``stable="max"`` a constant added to every logit of a
    destination leaves the output unchanged, also where the raw ``exp``
    overflows; ``"raw"`` matches it wherever it does not overflow."""
    _, tg = _graphs(4)
    gen = torch.Generator().manual_seed(3)
    EP, E = tg.num_padded_edges, tg.num_edges
    feat = torch.randn(EP, 2, 4, generator=gen)
    el = torch.rand(EP, 2, generator=gen)  # leaky_relu is x on x >= 0
    er = torch.zeros(EP, 2)
    base = tops.relational_fused_gat(tg, feat, el, er, 0.2, stable="max")
    torch.testing.assert_close(
        tops.relational_fused_gat(tg, feat, el, er, 0.2, stable="raw"),
        base, rtol=1e-5, atol=1e-6)
    shift = torch.zeros(EP, 2)
    shift[:E] = 200.0
    out = tops.relational_fused_gat(tg, feat, el + shift, er, 0.2,
                                    stable="max")
    torch.testing.assert_close(out, base, rtol=1e-4, atol=1e-5)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="stable"):
        tops.relational_fused_gat(tg, feat, el, er, 0.2, stable="exact")
