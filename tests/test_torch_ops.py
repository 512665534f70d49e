"""The port's compact ops against het_tpu's pallas backend (interpret mode
on the CPU): ``compact_typed_linear`` and ``relational_fused_gat_compact``,
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


@pytest.mark.parametrize("stable,logit", [
    (False, "normal"),
    ("clip", "normal"),
    ("clip", "past_clip"),  # many logits beyond +-60: zero act' there
    ("raw", "past_clip"),  # beyond 60 but inside f32's exp range
])
def test_relational_fused_gat_compact(pallas_backend, stable, logit):
    jg, tg = _graphs(4)
    rng = np.random.default_rng(1)
    H, D = 2, 6
    UCs, UCd = jg.compact_src.seg.n_rows, jg.compact_dst.seg.n_rows
    feat_c = rng.standard_normal((UCs, H, D)).astype(np.float32)
    if logit == "normal":
        el_c = rng.standard_normal((UCs, H)) * 0.3
        er_c = rng.standard_normal((UCd, H)) * 0.3
    elif stable == "clip":
        el_c = rng.standard_normal((UCs, H)) * 60.0
        er_c = rng.standard_normal((UCd, H)) * 30.0
    else:
        el_c = rng.uniform(55.0, 75.0, (UCs, H))
        er_c = rng.uniform(-5.0, 5.0, (UCd, H))
    el_c, er_c = el_c.astype(np.float32), er_c.astype(np.float32)
    proj = rng.standard_normal((jg.num_nodes, H, D)).astype(np.float32)
    _check(
        lambda f, l, r: jops.relational_fused_gat_compact(
            jg, f, l, r, 0.2, stable=stable),
        lambda f, l, r: tops.relational_fused_gat_compact(
            tg, f, l, r, 0.2, stable=stable),
        (feat_c, el_c, er_c), proj,
    )


def test_stable_max_not_ported():
    _, tg = _graphs(0)
    UCs, UCd = tg.compact_src.seg.n_rows, tg.compact_dst.seg.n_rows
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.relational_fused_gat_compact(
            tg, torch.zeros(UCs, 1, 2), torch.zeros(UCs, 1),
            torch.zeros(UCd, 1), 0.2, stable="max")
