"""bf16 mixed precision: the port's step against het_tpu's.

One bf16 step of het_tpu's trainer (``dtype="bfloat16"``, ``loss_scale=
"dynamic"``, the pallas backend in interpret mode) and the port's, from
the same initial parameters (``params_from_jax``) on a tiny synthetic
mag (scale 0.002, width 16, 2 heads, 2 layers; GAT on the cora
stand-in): the logits, the loss and the f32 gradients of the master
parameters (the scaled loss's gradients divided by the scale, as both
trainers take them), for RGAT compact multiply-first (the packed op),
compact, plain and plain max, RGCN plain and compact, and GAT.

Tolerance, ``BF16``: rtol 2e-2, atol 2e-2 times the largest magnitude of
the compared quantity.  For scale, het_tpu's own bf16 step against its f32
step on the same inputs differs by up to 0.95% of the largest logit,
1.7e-4 relative on the loss and 3-10% of a parameter's largest gradient
entry (bf16 keeps 8 significant bits; a layer rounds its matmul outputs,
payloads and sums several times).  The two packages round at the same
places, so they agree far more closely than either does with its f32
step; what remains is the order of f32 sums before a rounding, which can
move a bf16 result by a unit (0.4-0.8% relative).

The census: while the gradients are computed, every segment sum and
grouped dW records its (input, output) element types: het_tpu's at
``seg_sum_sorted_packed`` (the payload's ``pack_dt``, the rows its kernel
sums, and ``out_dtype``) and ``_dw_resident``, the port's at the plain
versions its wrappers call on the CPU.  Both packages must meet the same
set of pairs per kernel.

HGT cannot run in bf16 on het_tpu here: XLA's CPU backend stops on its
bf16 x bf16 -> f32 dots (``JaxRuntimeError: ... Unsupported element type
for DotThunk::Execute: BF16 x BF16 = F32``).  The port's bf16 HGT,
plain and compact, is held to the port's own f32 HGT instead, within
``HGT_BF16`` (rtol 3e-2, atol 3e-2 times the largest magnitude); the gap
measured here is 0.72% on the logits and 1.2% on the gradients, inside
het_tpu's own bf16-f32 gap on RGAT above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from het_tpu.data import load_dataset as j_load_dataset
from het_tpu.models import NodeEmbed as JNodeEmbed
from het_tpu.ops.pallas import seg_reduce as j_seg_reduce
from het_tpu.ops.pallas import segment_mm as j_segment_mm
from het_tpu.train import TrainConfig as JTrainConfig
from het_tpu.train.driver import build_model as j_build_model
from het_tpu.train.scaling import cast_floating as j_cast_floating
from het_tpu.utils.misc import nll_loss as j_nll_loss
from het_tpu_torch.data.loaders import load_dataset
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.ops.kernels import seg_reduce, segment_mm
from het_tpu_torch.train import TrainConfig
from het_tpu_torch.train.driver import build_model, model_forward
from het_tpu_torch.utils.misc import nll_loss

BF16 = 2e-2  # rtol, and atol as a share of the largest magnitude
HGT_BF16 = 3e-2
SCALE = 2.0 ** 15  # the dynamic policy's first scale
SHARED = dict(model="RGAT", dataset="mag", dataset_scale=0.002, n_infeat=16,
              hidden=16, num_heads=2, num_layers=2, num_classes=8,
              num_epochs=1, warmup_epochs=0, dropout=0.0, seed=0,
              dtype="bfloat16", loss_scale="dynamic")
RUNS = {
    "RGAT-packed": dict(compact=True, multiply_first=True),
    "RGAT-compact": dict(compact=True),
    "RGAT-plain": dict(),
    "RGAT-plain-max": dict(stable_softmax="max"),
    "RGCN-plain": dict(model="RGCN"),
    "RGCN-compact": dict(model="RGCN", compact=True),
    "GAT": dict(model="GAT", dataset="cora", dataset_scale=0.5),
}


def _name(dt) -> str:
    return str(jnp.dtype(dt)) if dt is not None else "float32"


def _census(monkeypatch):
    """Wrap both packages' segment sums and grouped dWs; returns the sets
    of (kernel, input dtype, output dtype) each records."""
    jax_pairs, port_pairs = set(), set()
    j_sum = j_seg_reduce.seg_sum_sorted_packed
    j_dw = j_segment_mm._dw_resident
    p_sum = seg_reduce.seg_sum_sorted_plain
    p_dw = segment_mm.segment_matmul_dw_plain

    def jax_sum(parts, C, pack_dt, *a, out_dtype=None, **k):
        jax_pairs.add(("sum", _name(pack_dt), _name(out_dtype)))
        return j_sum(parts, C, pack_dt, *a, out_dtype=out_dtype, **k)

    def jax_dw(x, ct, *a):
        jax_pairs.add(("dw", _name(x.dtype), _name(ct.dtype)))
        return j_dw(x, ct, *a)

    def port_sum(vals, ptr, perm=None, out_dtype=None):
        port_pairs.add(("sum", str(vals.dtype)[6:],
                        str(out_dtype or torch.float32)[6:]))
        return p_sum(vals, ptr, perm, out_dtype)

    def port_dw(x, ct, *a):
        port_pairs.add(("dw", str(x.dtype)[6:], str(ct.dtype)[6:]))
        return p_dw(x, ct, *a)

    monkeypatch.setattr(j_seg_reduce, "seg_sum_sorted_packed", jax_sum)
    monkeypatch.setattr(j_segment_mm, "_dw_resident", jax_dw)
    monkeypatch.setattr(seg_reduce, "seg_sum_sorted_plain", port_sum)
    monkeypatch.setattr(segment_mm, "segment_matmul_dw_plain", port_dw)
    return jax_pairs, port_pairs


def _jax_step(cfg, data, tree, mixed=True):
    """het_tpu's bf16 step (``train/driver.py:206-263``) on ``tree``, or
    its f32 step: logits (as f32) and their dtype, loss and the unscaled
    f32 gradients."""
    g = jax.device_put(data.graph)
    model = j_build_model(cfg, data)
    embed = JNodeEmbed(num_nodes=g.num_nodes, embed_dim=cfg.n_infeat,
                       param_dtype=jnp.float32)
    train_idx = jnp.asarray(data.train_idx, jnp.int32)
    labels = jnp.asarray(data.labels, jnp.int32)[train_idx]

    def logits_of(params):
        p = j_cast_floating(params, jnp.bfloat16) if mixed else params
        return model.apply(p["model"], g, embed.apply(p["embed"]),
                           deterministic=True)

    def scaled_loss(params):
        logits = logits_of(params)
        loss = j_nll_loss(jnp.take(logits, train_idx, axis=0), labels)
        return loss * SCALE, logits

    (sloss, logits), grads = jax.value_and_grad(scaled_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    grads = jax.tree.map(lambda t: np.asarray(t) / SCALE, grads)
    return (np.asarray(logits.astype(jnp.float32)), str(logits.dtype),
            float(sloss) / SCALE, params_from_jax(grads))


def _port_step(cfg, data, state, dtype=torch.bfloat16):
    """The port's step on ``state``: logits, loss and the unscaled f32
    gradients of the master parameters."""
    net = build_model(cfg, data)
    net.load_state_dict(state)
    g = data.graph
    train_idx = torch.as_tensor(data.train_idx).long()
    logits = model_forward(net, dtype)(g)
    loss = nll_loss(logits[train_idx],
                    torch.as_tensor(data.labels).long()[train_idx])
    (loss * SCALE).backward()
    grads = {k: p.grad / SCALE for k, p in net.named_parameters()}
    assert all(v.dtype == torch.float32 for v in grads.values())
    return logits, loss.item(), grads


def _close(got, want, tol, what):
    got = torch.as_tensor(got).float()
    want = torch.as_tensor(np.array(want)).float()
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * want.abs().max().item(),
                               msg=lambda m: f"{what}: {m}")


def _by_kernel(pairs):
    out = {}
    for kernel, a, b in pairs:
        out.setdefault(kernel, set()).add((a, b))
    return out


# het_tpu's compact RGAT without multiply-first takes its attention
# logits by an einsum over ``jnp.take(attn, row_seg)``, whose gradient is
# XLA's scatter-add in bf16: 45-58% off its own f32 gradient on these
# inputs.  The port sums it with the grouped dW (f32 sums of bf16
# products), within 0.7% of f32.  Those gradients are held to het_tpu's
# f32 step, and the dW is the port's alone in that run.
F32_REFERENCE = {"RGAT-compact": ("attn_l", "attn_r")}
PORT_ONLY_KERNELS = {"RGAT-compact": {"dw"}}


@pytest.mark.parametrize("run", RUNS)
def test_bf16_step_matches_het_tpu(run, monkeypatch):
    from het_tpu.ops import set_backend

    shared = dict(SHARED, **RUNS[run])
    jcfg = JTrainConfig(**shared, backend="pallas")
    jdata = j_load_dataset(jcfg.dataset, scale=jcfg.dataset_scale,
                           num_classes=jcfg.num_classes, seed=jcfg.seed,
                           build_compact=True)
    tree = _jax_initial_params(jcfg, jdata)
    cfg = TrainConfig(**shared, device="cpu")
    data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                        num_classes=cfg.num_classes, seed=cfg.seed)
    set_backend("pallas")
    f32_names = F32_REFERENCE.get(run, ())
    if f32_names:
        j_grads32 = _jax_step(jcfg, jdata, tree, mixed=False)[-1]
    jax_pairs, port_pairs = _census(monkeypatch)
    j_logits, j_dtype, j_loss, j_grads = _jax_step(jcfg, jdata, tree)
    logits, loss, grads = _port_step(cfg, data, params_from_jax(tree))
    # bf16, but f32 where het_tpu's promotion makes it so (plain RGCN's
    # f32 norm times bf16 rows)
    assert str(logits.dtype)[6:] == j_dtype
    _close(logits, j_logits, BF16, "logits")
    assert loss == pytest.approx(j_loss, rel=BF16)
    assert sorted(grads) == sorted(j_grads)
    for k, v in j_grads.items():
        if k.rsplit(".", 1)[-1] in f32_names:
            v = j_grads32[k]
        _close(grads[k], v, BF16, k)
    jax_k, port_k = _by_kernel(jax_pairs), _by_kernel(port_pairs)
    assert set(port_k) - set(jax_k) == PORT_ONLY_KERNELS.get(run, set())
    for kernel, want in jax_k.items():
        assert port_k.get(kernel) == want, kernel
    if "dw" in port_k:
        assert port_k["dw"] == {("bfloat16", "bfloat16")}


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_hgt_bf16_step_matches_port_f32(compact):
    """HGT in bf16 against the port's own f32 HGT from the same
    parameters: logits, loss and gradients within HGT_BF16 (het_tpu's bf16
    HGT cannot run on the CPU, module docstring)."""
    cfg = TrainConfig(**dict(SHARED, model="HGT", compact=compact),
                      device="cpu")
    data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                        num_classes=cfg.num_classes, seed=cfg.seed)
    state = build_model(cfg, data,
                        generator=torch.Generator().manual_seed(0)
                        ).state_dict()
    logits, loss, grads = _port_step(cfg, data, state)
    logits32, loss32, grads32 = _port_step(cfg, data, state, torch.float32)
    assert logits.dtype == torch.bfloat16
    _close(logits, logits32.detach(), HGT_BF16, "logits")
    assert loss == pytest.approx(loss32, rel=HGT_BF16)
    for k, v in grads32.items():
        _close(grads[k], v, HGT_BF16, k)


def _jax_initial_params(cfg, data):
    """het_tpu's trainer's initial parameters, made as its ``train``
    makes them."""
    key = jax.random.PRNGKey(cfg.seed)
    k_embed, k_model, _ = jax.random.split(key, 3)
    embed = JNodeEmbed(num_nodes=data.graph.num_nodes,
                       embed_dim=cfg.n_infeat, param_dtype=jnp.float32)
    e_params = embed.init(k_embed)
    m_params = j_build_model(cfg, data).init(
        k_model, jax.device_put(data.graph), embed.apply(e_params))
    return jax.tree.map(np.asarray, {"embed": e_params, "model": m_params})
