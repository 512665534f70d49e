"""The port's loss-scale policies and parameter cast against het_tpu's
``train/scaling.py``: the same sequence of finite and non-finite steps
gives the same trajectory of (scale, good steps), the static and no-op
policies scale and unscale alike, and the cast touches floating tensors
only.  Exact: the policies' arithmetic is powers of two and int32
counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from het_tpu.train import scaling as j_scaling
from het_tpu_torch.train import scaling


def _flags(seed, n, p_bad):
    return np.random.default_rng(seed).random(n) >= p_bad


def _trajectory(j_policy, policy, flags):
    j_state, state = j_policy.init_state(), policy.init_state()
    got, want = [], []
    for ok in flags:
        j_state = j_policy.update(j_state, jnp.asarray(bool(ok)))
        state = policy.update(state, torch.tensor(bool(ok)))
        want.append((float(j_state.scale), int(j_state.good_steps)))
        got.append((state.scale.item(), int(state.good_steps)))
        assert state.scale.dtype == torch.float32
        assert state.good_steps.dtype == torch.int32
    return got, want


@pytest.mark.parametrize("kwargs,flags", [
    # het_tpu's constants: growth past 200 finite steps, halvings between
    pytest.param({}, np.r_[_flags(0, 450, 0.01), np.ones(210, bool)],
                 id="defaults"),
    # down to min_scale and held there, then growth again
    pytest.param({}, np.r_[np.zeros(20, bool), np.ones(401, bool)],
                 id="min-clamp"),
    # up to max_scale and held there
    pytest.param(dict(init_scale=2.0 ** 22, growth_interval=3),
                 np.r_[np.ones(12, bool), [False], np.ones(7, bool)],
                 id="max-clamp"),
    pytest.param(dict(factor=4.0, min_scale=2.0, growth_interval=5),
                 _flags(1, 120, 0.3), id="other-constants"),
])
def test_dynamic_loss_scale_follows_het_tpu(kwargs, flags):
    policy = scaling.DynamicLossScale(**kwargs)
    j_policy = j_scaling.DynamicLossScale(**kwargs)
    assert policy.init_scale == j_policy.init_scale
    got, want = _trajectory(j_policy, policy, flags)
    assert got == want


def test_dynamic_defaults_are_het_tpus():
    p, j = scaling.DynamicLossScale(), j_scaling.DynamicLossScale()
    for name in ("init_scale", "growth_interval", "factor", "min_scale",
                 "max_scale"):
        assert getattr(p, name) == getattr(j, name), name
    assert (p.init_scale, p.growth_interval, p.max_scale) == (
        2.0 ** 15, 200, 2.0 ** 24)


@pytest.mark.parametrize("spec", ["none", None, 0, "dynamic", "1024",
                                  1024.0, "3.0"])
def test_make_loss_scale_follows_het_tpu(spec):
    """Each spec's policy: the same dynamic flag, initial state, scaled
    loss, unscaled gradients and update over finite and non-finite
    steps."""
    policy, dynamic = scaling.make_loss_scale(spec)
    j_policy, j_dynamic = j_scaling.make_loss_scale(spec)
    assert dynamic == j_dynamic
    got, want = _trajectory(j_policy, policy, [True, False, True, True])
    assert got == want
    state, j_state = policy.init_state(), j_policy.init_state()
    loss = np.float32(1.7)
    assert policy.scale(torch.tensor(loss), state).item() == float(
        j_policy.scale(jnp.asarray(loss), j_state))
    grads = np.random.default_rng(0).standard_normal((5, 3)).astype(
        np.float32)
    g = torch.tensor(grads)
    policy.unscale_([g, None], state)
    want_g = np.asarray(j_policy.unscale({"g": jnp.asarray(grads)},
                                         j_state)["g"])
    np.testing.assert_array_equal(g.numpy(), want_g)


def test_cast_floating_leaves_integer_tensors():
    """Only floating tensors are cast, as het_tpu's cast leaves integer
    leaves alone; values as a cast of each."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "idx": np.arange(6, dtype=np.int32),
            "ids": np.arange(3, dtype=np.int64),
            "mask": np.array([True, False])}
    got = scaling.cast_floating({k: torch.tensor(v) for k, v in tree.items()},
                                torch.bfloat16)
    want = j_scaling.cast_floating({k: jnp.asarray(v) for k, v in
                                    tree.items()}, jnp.bfloat16)
    assert got["w"].dtype == torch.bfloat16
    for k in ("idx", "ids", "mask"):
        assert got[k].dtype == torch.tensor(tree[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), tree[k])
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(want["w"].astype(jnp.float32)))


def test_all_finite_follows_het_tpu():
    ok = [torch.ones(3), None, torch.zeros(2, 2)]
    for bad in (float("inf"), float("-inf"), float("nan")):
        t = torch.ones(4)
        t[2] = bad
        assert not bool(scaling.all_finite(ok + [t]))
        assert not bool(j_scaling.all_finite([jnp.asarray(t.numpy())]))
    assert bool(scaling.all_finite(ok)) and bool(scaling.all_finite([]))
