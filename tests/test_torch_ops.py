"""The port's compact ops against het_tpu's pallas backend (interpret mode
on the CPU): ``compact_typed_linear``, ``relational_fused_gat_compact``
and ``relational_fused_gat_compact_packed`` in every softmax mode,
forward and every input gradient, from the same numpy inputs.  Tolerances
are the repo's own backend-parity ones: forward rtol 1e-4 / atol 2e-4,
gradients rtol 5e-3 / atol 2e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from het_tpu import ops as jops
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu_torch import ops as tops
from het_tpu_torch.graph import random_heterograph as t_random_heterograph

FWD = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


def _graphs(seed):
    kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=seed, tile=8)
    return j_random_heterograph(**kw), t_random_heterograph(**kw)


def _check(j_fn, t_fn, args, proj):
    """Compare sum(fn(*args) * proj) and its gradients wrt every arg."""
    def j_loss(*a):
        return jnp.sum(j_fn(*a) * proj)

    jv, jg = jax.value_and_grad(j_loss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = t_fn(*targs)
    tv = (out * torch.from_numpy(proj)).sum()
    tv.backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j_fn(*map(jnp.asarray, args))),
                               **FWD)
    np.testing.assert_allclose(tv.item(), float(jv), **FWD)
    for i, (a, b) in enumerate(zip(targs, jg)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   err_msg=f"grad {i}", **GRAD)


@pytest.mark.parametrize("side", ["src", "dst"])
def test_compact_typed_linear(pallas_backend, side):
    jg, tg = _graphs(1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((jg.num_nodes, 12)).astype(np.float32)
    w = (rng.standard_normal((jg.num_rels, 2, 12, 5)) * 0.4).astype(
        np.float32)
    info = jg.compact_src if side == "src" else jg.compact_dst
    proj = rng.standard_normal((info.seg.n_rows, 2, 5)).astype(np.float32)
    _check(
        lambda xx, ww: jops.compact_typed_linear(jg, xx, ww, side=side),
        lambda xx, ww: tops.compact_typed_linear(tg, xx, ww, side),
        (x, w), proj,
    )


# (stable, logit) cases of the fused softmax aggregation tests
STABLE_CASES = [
    (False, "normal"),
    ("clip", "normal"),
    ("clip", "past_clip"),  # many logits beyond +-60: zero act' there
    ("raw", "past_clip"),  # beyond 60 but inside f32's exp range
    ("max", "normal"),
    (True, "past_clip"),  # True is "max"
    ("max", "past_exp"),  # past 88, where the raw exp overflows f32
]


def logits(rng, stable, logit, n_l, n_r, H):
    """``el``/``er`` rows for a (stable, logit) case.  Under "past_exp"
    row 0 of both stays small: padding edges read it, and het_tpu's
    masked ``exp`` of a padding edge must not overflow either."""
    if logit == "normal":
        el = rng.standard_normal((n_l, H)) * 0.3
        er = rng.standard_normal((n_r, H)) * 0.3
    elif logit == "past_exp":
        el = rng.uniform(85.0, 120.0, (n_l, H))
        er = rng.uniform(-5.0, 5.0, (n_r, H))
        el[0], er[0] = 0.1, -0.1
    elif stable == "clip":
        el = rng.standard_normal((n_l, H)) * 60.0
        er = rng.standard_normal((n_r, H)) * 30.0
    else:
        el = rng.uniform(55.0, 75.0, (n_l, H))
        er = rng.uniform(-5.0, 5.0, (n_r, H))
    return el.astype(np.float32), er.astype(np.float32)


@pytest.mark.parametrize("stable,logit", STABLE_CASES)
def test_relational_fused_gat_compact(pallas_backend, stable, logit):
    jg, tg = _graphs(4)
    rng = np.random.default_rng(1)
    H, D = 2, 6
    UCs, UCd = jg.compact_src.seg.n_rows, jg.compact_dst.seg.n_rows
    feat_c = rng.standard_normal((UCs, H, D)).astype(np.float32)
    el_c, er_c = logits(rng, stable, logit, UCs, UCd, H)
    proj = rng.standard_normal((jg.num_nodes, H, D)).astype(np.float32)
    _check(
        lambda f, l, r: jops.relational_fused_gat_compact(
            jg, f, l, r, 0.2, stable=stable),
        lambda f, l, r: tops.relational_fused_gat_compact(
            tg, f, l, r, 0.2, stable=stable),
        (feat_c, el_c, er_c), proj,
    )


@pytest.mark.parametrize("stable,logit", [
    ("clip", "normal"),
    ("raw", "past_clip"),
    ("max", "normal"),
    ("max", "past_exp"),
])
def test_relational_fused_gat_compact_packed(pallas_backend, stable, logit):
    """The packed op (one ``(UCs, H, 1+D)`` buffer of per-head
    ``[el | feat]`` lanes) against het_tpu's, whose gradient comes back
    in the same layout."""
    jg, tg = _graphs(6)
    rng = np.random.default_rng(2)
    H, D = 2, 5
    UCs, UCd = jg.compact_src.seg.n_rows, jg.compact_dst.seg.n_rows
    el_c, er_c = logits(rng, stable, logit, UCs, UCd, H)
    fe = np.concatenate(
        [el_c[..., None], rng.standard_normal((UCs, H, D))], axis=-1
    ).astype(np.float32)
    proj = rng.standard_normal((jg.num_nodes, H, D)).astype(np.float32)
    _check(
        lambda f, r: jops.relational_fused_gat_compact_packed(
            jg, f, r, 0.2, stable=stable),
        lambda f, r: tops.relational_fused_gat_compact_packed(
            tg, f, r, 0.2, stable=stable),
        (fe, er_c), proj,
    )


def test_stable_max_row0_past_exp_range(pallas_backend):
    """Padding edges read compact row 0.  Where row 0's logits pass
    exp's f32 range, het_tpu's exact softmax (an ``exp`` masked by
    ``jnp.where``) returns NaN gradients on row 0 (0 times inf in the
    mask's backward); the port's never reads a padding edge.  Everywhere
    else the two agree."""
    jg, tg = _graphs(4)
    rng = np.random.default_rng(1)
    H, D = 2, 6
    UCs, UCd = jg.compact_src.seg.n_rows, jg.compact_dst.seg.n_rows
    feat_c = rng.standard_normal((UCs, H, D)).astype(np.float32)
    el_c = rng.uniform(85.0, 120.0, (UCs, H)).astype(np.float32)
    er_c = rng.uniform(-5.0, 5.0, (UCd, H)).astype(np.float32)
    proj = rng.standard_normal((jg.num_nodes, H, D)).astype(np.float32)

    def j_loss(f, l, r):
        return jnp.sum(jops.relational_fused_gat_compact(
            jg, f, l, r, 0.2, stable="max") * proj)

    jv, jgrads = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        feat_c, el_c, er_c)
    targs = [torch.tensor(a, requires_grad=True)
             for a in (feat_c, el_c, er_c)]
    tv = (tops.relational_fused_gat_compact(tg, *targs, 0.2, stable="max")
          * torch.from_numpy(proj)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **FWD)
    assert np.isnan(np.asarray(jgrads[1])[0]).all()
    for t, j in zip(targs, jgrads):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy()[1:], np.asarray(j)[1:],
                                   **GRAD)


def test_packed_op_equals_split_op():
    """The packed and the split compact ops compute the same function
    with the same launches; their results agree to rounding."""
    _, tg = _graphs(6)
    gen = torch.Generator().manual_seed(0)
    UCs, UCd = tg.compact_src.seg.n_rows, tg.compact_dst.seg.n_rows
    fe = torch.randn(UCs, 3, 5, generator=gen)
    er_c = torch.randn(UCd, 3, generator=gen)
    for stable in ("clip", "max"):
        a = tops.relational_fused_gat_compact_packed(tg, fe, er_c, 0.2,
                                                     stable=stable)
        b = tops.relational_fused_gat_compact(
            tg, fe[..., 1:], fe[..., 0], er_c, 0.2, stable=stable)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
