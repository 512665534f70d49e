"""The port's compiler against het_tpu's, on the CPU.

* The front half: for the in-repo DSL programs (``RGAT_LAYER_DSL``,
  ``HGT_LAYER_DSL``, ``RGCN_LAYER_DSL`` and ``tests/test_compiler.py``'s
  ``RGAT_DSL``) under every flag combination, the port's ``dumps`` of the
  analysed, rewritten and fused program equals het_tpu's text, and its
  ``dumps_opspec`` too, apart from the schedule dict (het_tpu's ``tpu``,
  the port's ``gpu``).
* The lowering: each program, compiled by both packages from the same
  numpy inputs on the same graph (het_tpu's on its pallas backend in
  interpret mode), gives the same outputs and gradients; ``grad_program``
  executed by the port's lowering matches ``torch.autograd`` of the
  compiled forward (het_tpu's own limits, rtol 1e-3 / atol 1e-4).
* Codegen: the emitted source imports only ``torch`` and
  ``het_tpu_torch.ops``, replays nothing, and equals the interpreted
  closure (rtol 1e-5 / atol 1e-6), gradients too.
* The schedule: ``packing: "split"`` and ``gather_einsum`` (the
  segment-matmul kernels' device offsets) give the default schedule's
  result; het_tpu's ``reduction`` and ``static_topk`` fields raise.
* The new ops: ``edge_softmax_weighted_sum`` and its source-compact form
  (``SrcCompactFusedSoftmaxAgg``), ``edge_rel_sum``, ``edge_rel_gather``
  and ``ntype_sum`` against het_tpu's.
* The fault of ``het_tpu/compiler/fuse.py::fuse_packed_projection``: it
  fuses a pair whose projection is read before the inner product, and two
  pairs sharing one producer, and so breaks the program; the port's skips
  both and computes the unfused result.

Tolerances: values rtol 1e-4 / atol 2e-4, gradients rtol 5e-3 / atol
2e-4 (the repo's backend-parity ones), TF32 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import het_tpu.compiler as jc
import het_tpu.compiler.fuse as jfuse
import het_tpu.compiler.rewrites as jrewrites
from het_tpu import ops as jops
from het_tpu.compiler.passes import run_default as j_run_default
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.train.compiled import RGAT_LAYER_DSL as J_RGAT_LAYER_DSL
from het_tpu_torch import compiler as tc
from het_tpu_torch import ops
from het_tpu_torch.compiler import fuse as tfuse
from het_tpu_torch.compiler.codegen import IMPORTS
from het_tpu_torch.compiler.ir import Op, Program, Var
from het_tpu_torch.compiler.passes import run_default
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.train.compiled import (HGT_LAYER_DSL, RGAT_LAYER_DSL,
                                          RGCN_LAYER_DSL, RGCN_SHAPE_HINTS,
                                          build_layer_program)
from tests.test_compiler import RGAT_DSL

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
AUTODIFF = dict(rtol=1e-3, atol=1e-4)  # tests/test_compiler.py:126-165
EMITTED = dict(rtol=1e-5, atol=1e-6)

# name -> (DSL, shape hints); every one under every flag combination
PROGRAMS = {"rgat_layer": (RGAT_LAYER_DSL, None),
            "hgt_layer": (HGT_LAYER_DSL, None),
            "rgcn_layer": (RGCN_LAYER_DSL, RGCN_SHAPE_HINTS),
            "rgat_dsl": (RGAT_DSL, None)}
FLAGS = [(c, m) for c in (False, True) for m in (False, True)]
CASES = [(name, c, m) for name in PROGRAMS for c, m in FLAGS]
F = 6  # feature width


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture
def pallas_backend():
    jops.set_backend("pallas")
    yield
    jops.set_backend("xla")


@pytest.fixture(scope="module")
def graphs():
    """Two node types (``NodeLinear`` and ``NodeTypeSumAccumulation`` see
    both), padding edges, compact rows on both sides."""
    kw = dict(num_nodes=40, num_edges=240, num_rels=3, seed=5, tile=8,
              ntype_offsets=(0, 16, 40))
    jg, tg = j_random_heterograph(**kw), t_random_heterograph(**kw)
    assert tg.num_padded_edges > tg.num_edges
    return jg, tg


# het_tpu's fuse_packed_projection breaks this one (the fault below):
# ExpandCompact reads the projection between its producer and the inner
# product, and the pass defines it only after that read.  The port skips
# the pair, so its program is het_tpu's without that pass
FAULTY = {("rgat_dsl", True, True)}


def _j_program(dsl, hints, compact, mf, packed=True):
    """het_tpu's pipeline, pass for pass: build_layer_program's steps
    (``fuse_packed_projection`` only where ``packed``)."""
    prog = j_run_default(jc.parse_dsl(dsl), shape_hints=hints)
    if mf:
        jrewrites.reorder_linear_operators(prog)
        j_run_default(prog, shape_hints=hints)
    if compact:
        jrewrites.compact_materialization(prog)
        j_run_default(prog, shape_hints=hints)
    jfuse.fuse_edge_softmax(prog)
    j_run_default(prog, shape_hints=hints)
    if compact:
        jfuse.fuse_compact_gat(prog)
        jfuse.fuse_compact_agg(prog)
        if mf and packed:
            jfuse.fuse_packed_projection(prog)
        j_run_default(prog, shape_hints=hints)
    return prog


def _read_before_definition(prog):
    """The names an op reads before the op that defines them."""
    defined, early = set(), set()
    later = {o.name for op in prog.ops for o in op.outputs}
    for op in prog.ops:
        early |= {v.name for v in op.inputs.values()
                  if v.name in later and v.name not in defined}
        defined |= {o.name for o in op.outputs}
    return early


def _programs(name, compact, mf):
    """(het_tpu's program, the port's): het_tpu's without the packed
    projection where that pass breaks it (``FAULTY``)."""
    dsl, hints = PROGRAMS[name]
    faulty = (name, compact, mf) in FAULTY
    return (_j_program(dsl, hints, compact, mf, packed=not faulty),
            build_layer_program(dsl, compact=compact, multiply_first=mf,
                                shape_hints=hints))


def _without_schedules(dumps_opspec, sched, field):
    """``dumps_opspec`` of ``sched`` with each spec's schedule dict
    (``field``, "tpu" or "gpu") taken out."""
    for spec in sched.specs:
        setattr(spec, field, None)
    return dumps_opspec(sched)


@pytest.mark.parametrize("name,compact,mf", CASES)
def test_texts_match_het_tpu(name, compact, mf):
    jp, tp = _programs(name, compact, mf)
    assert tc.dumps(tp) == jc.dumps(jp)
    assert not _read_before_definition(tp)
    if (name, compact, mf) in FAULTY:
        broken = _j_program(*PROGRAMS[name], compact, mf)
        assert _read_before_definition(broken)
    js, ts = jc.schedule_program(jp), tc.schedule_program(tp)
    assert len(ts.specs) == len(js.specs)
    assert all(s.gpu and "kernel" in s.gpu for s in ts.specs)
    jtext, ttext = jc.dumps_opspec(js), tc.dumps_opspec(ts)
    assert '"tpu"' in jtext and '"tpu"' not in ttext and '"gpu"' in ttext
    # the port's document parses back with its schedules
    back = tc.parse_opspec_ssa(ttext)
    assert [s.gpu for s in back.specs] == [s.gpu for s in ts.specs]
    assert _without_schedules(tc.dumps_opspec, ts, "gpu") == \
        _without_schedules(jc.dumps_opspec, js, "tpu")


def _arrays(prog, jg, rng):
    """numpy inputs and weights for every program input and weight, at F
    features (a weight's trailing dims from its slice type and name)."""
    inputs, weights = {}, {}
    EP, N, R, T = jg.num_padded_edges, jg.num_nodes, jg.num_rels, \
        jg.num_ntypes
    for v in prog.inputs:
        scalar = prog.shapes.get((v.kind, v.name)) == "scalar"
        lead = (EP,) if v.kind == "EDGEWISE" else (N,)
        inputs[v.name] = rng.standard_normal(
            lead if scalar else lead + (F,)).astype(np.float32) * 0.5
    for v in prog.weights:
        lead = {"EDGETYPE": (R,), "NODETYPE": (T,), "NONE": ()}[v.kind]
        vector = v.name.startswith("attn")
        shape = lead + ((F,) if vector else (F, F))
        weights[v.name] = rng.standard_normal(shape).astype(np.float32) \
            * 0.4
    return inputs, weights


def _t(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("name,compact,mf", CASES)
def test_lowering_matches_het_tpu(graphs, pallas_backend, name, compact, mf):
    """The compiled programs of both packages (het_tpu's on its pallas
    backend, interpret mode) from the same inputs: outputs and the
    gradients of ``sum(out * proj)`` in every input and weight."""
    jg, tg = graphs
    jp, tp = _programs(name, compact, mf)
    rng = np.random.default_rng(11)
    inputs, weights = _arrays(tp, jg, rng)
    jfn = jc.compile_program(jc.schedule_program(jp))
    tfn = tc.compile_program(tc.schedule_program(tp))
    out_name = tfn.output_vars[-1].name
    assert [v.name for v in tfn.output_vars] == \
        [v.name for v in jfn.output_vars]
    names = sorted(inputs) + sorted(weights)
    proj = rng.standard_normal((tg.num_nodes, F)).astype(np.float32)

    def j_loss(*arrs):
        a = dict(zip(names, arrs))
        out = jfn(jg, {k: a[k] for k in inputs}, {k: a[k] for k in weights})
        return jnp.sum(out[out_name] * proj), out[out_name]

    allv = {**inputs, **weights}
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(len(names))), has_aux=True))(
            *[jnp.asarray(allv[k]) for k in names])
    targs = {k: _t(allv[k], grad=True) for k in names}
    out = tfn(tg, {k: targs[k] for k in inputs},
              {k: targs[k] for k in weights})[out_name]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **VAL)
    (out * _t(proj)).sum().backward()
    for k, jgr in zip(names, jgrads):
        np.testing.assert_allclose(targs[k].grad.numpy(), np.asarray(jgr),
                                   err_msg=k, **GRAD)


GRAD_PROGRAMS = ("rgat_layer", "hgt_layer", "rgcn_layer", "rgat_dsl")


@pytest.mark.parametrize("name", GRAD_PROGRAMS)
def test_grad_program_matches_autograd(graphs, name):
    """IR-level reverse mode, executed by the port's lowering, against
    ``torch.autograd`` of the compiled forward: the delta of every input
    and weight the gradient reaches.  The typed denses' and node linears'
    weight deltas sum their outer products with ``edge_rel_sum`` and
    ``ntype_sum`` (the sorted segment sum)."""
    _, tg = graphs
    dsl, hints = PROGRAMS[name]
    fwd_prog = run_default(tc.parse_dsl(dsl), shape_hints=hints)
    fwd = tc.compile_program(fwd_prog)
    rng = np.random.default_rng(3)
    inputs, weights = _arrays(fwd_prog, tg, rng)
    out_name = fwd.output_vars[-1].name
    seed = rng.standard_normal((tg.num_nodes, F)).astype(np.float32)
    targs = {k: _t(v, grad=True) for k, v in {**inputs, **weights}.items()}
    out = fwd(tg, {k: targs[k] for k in inputs},
              {k: targs[k] for k in weights})[out_name]
    (out * _t(seed)).sum().backward()

    comb = tc.grad_program(fwd_prog)
    wanted = [k for k in targs if k != "norm_factor"]
    kinds = {v.name: v.kind for v in fwd_prog.inputs + fwd_prog.weights}
    outputs = [Var(kinds[k] if kinds[k] != "NONE" else "NONE",
                   f"{k}_delta") for k in wanted]
    res = tc.compile_program(comb, outputs=outputs)(
        tg, {**{k: _t(v) for k, v in inputs.items()},
             f"{out_name}_delta": _t(seed)},
        {k: _t(v) for k, v in weights.items()})
    for k in wanted:
        np.testing.assert_allclose(res[f"{k}_delta"].detach().numpy(),
                                   targs[k].grad.numpy(), err_msg=k,
                                   **AUTODIFF)


@pytest.mark.parametrize("name,compact,mf", CASES)
def test_emitted_source_equals_the_interpreter(graphs, name, compact, mf):
    _, tg = graphs
    tp = _programs(name, compact, mf)[1]
    sched = tc.schedule_program(tp)
    src = tc.emit_python(sched, "generated")
    imports = [ln for ln in src.splitlines()
               if ln.startswith(("import ", "from "))]
    assert imports == list(IMPORTS)
    assert "_exec_op" not in src and "compiler" not in src.replace(
        "het_tpu_torch.compiler.codegen", "")
    ns = {}
    exec(src, ns)
    fn = tc.compile_program(sched)
    rng = np.random.default_rng(5)
    inputs, weights = _arrays(tp, tg, rng)
    out_name = fn.output_vars[-1].name
    results = []
    for run in (fn, ns["generated"]):
        targs = {k: _t(v, grad=True) for k, v in {**inputs,
                                                  **weights}.items()}
        out = run(tg, {k: targs[k] for k in inputs},
                  {k: targs[k] for k in weights})[out_name]
        (out ** 2).sum().backward()
        results.append((out.detach(), {k: t.grad for k, t in targs.items()}))
    (want, wgrads), (got, ggrads) = results
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EMITTED)
    for k in wgrads:
        np.testing.assert_allclose(ggrads[k].numpy(), wgrads[k].numpy(),
                                   err_msg=k, rtol=1e-4, atol=1e-5)


def _edit(sched, key, value, kernel=None):
    for spec in sched.specs:
        if kernel is None or spec.gpu.get("kernel") == kernel:
            spec.gpu[key] = value
    return sched


EINSUM = ("strategy", "gather_einsum", "segment_matmul")
DEVICE = ("strategy", "device_offsets", "segment_matmul")
SPLIT = ("packing", "split", "fused_softmax_agg")
# (program, compact, multiply-first) and an override its schedule has
OVERRIDES = [(("rgat_layer", False, False), EINSUM),
             (("rgat_layer", False, False), DEVICE),
             (("rgat_layer", False, False), SPLIT),
             (("rgat_layer", True, True), EINSUM),
             (("hgt_layer", False, False), EINSUM),
             (("hgt_layer", False, False), SPLIT),
             (("hgt_layer", True, False), EINSUM),
             (("rgcn_layer", True, False), DEVICE)]


@pytest.mark.parametrize("prog,override", OVERRIDES)
def test_schedule_overrides_keep_the_result(graphs, monkeypatch, prog,
                                            override):
    """An edited schedule changes how the program runs, not what it
    computes, in the interpreter and in the emitted source: the
    segment-matmul kernels' device offsets (their plain versions here,
    which the wrappers run on CPU tensors) and the unfused softmax
    chain."""
    from het_tpu_torch.ops import linear

    _, tg = graphs
    key, value, kernel = override
    tp = _programs(*prog)[1]
    base = tc.compile_program(tc.schedule_program(tp))
    sched = _edit(tc.schedule_program(tp), key, value, kernel)
    assert any(s.gpu.get(key) == value for s in sched.specs)
    rows_calls = []
    rows_fwd = linear._rows_fwd
    monkeypatch.setattr(linear, "_rows_fwd", lambda *a: rows_calls.append(
        1) or rows_fwd(*a))
    rng = np.random.default_rng(9)
    inputs, weights = _arrays(tp, tg, rng)
    out_name = base.output_vars[-1].name
    ns = {}
    exec(tc.emit_python(sched, "generated"), ns)
    results = []
    for run in (base, tc.compile_program(sched), ns["generated"]):
        rows_calls.clear()
        targs = {k: _t(v, grad=True) for k, v in {**inputs,
                                                  **weights}.items()}
        out = run(tg, {k: targs[k] for k in inputs},
                  {k: targs[k] for k in weights})[out_name]
        (out ** 2).sum().backward()
        results.append((out.detach(), {k: t.grad for k, t in targs.items()},
                        len(rows_calls)))
    (want, wgrads, base_rows) = results[0]
    assert base_rows == 0
    for got, ggrads, rows in results[1:]:
        assert (rows > 0) == (key == "strategy")
        np.testing.assert_allclose(got.numpy(), want.numpy(), **VAL)
        for k in wgrads:
            np.testing.assert_allclose(ggrads[k].numpy(), wgrads[k].numpy(),
                                       err_msg=k, **GRAD)


@pytest.mark.parametrize("key,value", [("reduction", "xla_scatter_add"),
                                       ("static_topk", 2),
                                       ("strategy", "nonexistent"),
                                       ("packing", "nonexistent")])
def test_tpu_only_schedule_fields_raise(key, value):
    tp = build_layer_program(RGAT_LAYER_DSL)
    sched = _edit(tc.schedule_program(tp), key, value)
    with pytest.raises(ValueError, match=key):
        tc.compile_program(sched)
    with pytest.raises(ValueError, match=key):
        tc.emit_python(sched)


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("mode", ["raw", "clip", "max"])
def test_softmax_weighted_sum_matches_het_tpu(graphs, pallas_backend,
                                              compact, mode):
    """``edge_softmax_weighted_sum`` (the fused per-edge op, "max" the
    unfused chain) and its source-compact form (``SrcCompactFusedSoftmax
    Agg``, "max" the expansion into the chain) against het_tpu's (pallas,
    interpret mode), values and every gradient, one head and two."""
    jg, tg = graphs
    rng = np.random.default_rng(17)
    rows = tg.compact_src.seg.n_rows if compact else tg.num_padded_edges
    for shape_l, shape_m in (((tg.num_padded_edges,), (rows, 5)),
                             ((tg.num_padded_edges, 2), (rows, 2, 3))):
        logits = rng.standard_normal(shape_l).astype(np.float32)
        msg = rng.standard_normal(shape_m).astype(np.float32)
        out_shape = (tg.num_nodes,) + shape_m[1:]
        proj = rng.standard_normal(out_shape).astype(np.float32)
        jname = "edge_softmax_weighted_sum" + ("_compact" if compact else "")
        jop, top = getattr(jops, jname), getattr(ops, jname)

        def j_loss(lg, m):
            out = jop(jg, lg, m, stable=mode)
            return jnp.sum(out * proj), out

        (_, jout), jgr = jax.jit(jax.value_and_grad(
            j_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(logits),
                                                  jnp.asarray(msg))
        tl, tm = _t(logits, True), _t(msg, True)
        out = top(tg, tl, tm, stable=mode)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   **VAL)
        (out * _t(proj)).sum().backward()
        np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgr[0]),
                                   **GRAD)
        np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgr[1]),
                                   **GRAD)


def test_relation_and_node_type_sums_match_segment_sum(graphs):
    """``edge_rel_sum`` (padding edges add nothing), its transpose
    ``edge_rel_gather`` and ``ntype_sum`` against ``jax.ops.segment_sum``
    as het_tpu's lowering writes them, with gradients."""
    jg, tg = graphs
    rng = np.random.default_rng(2)
    EP, R = tg.num_padded_edges, tg.num_rels
    v = rng.standard_normal((EP, 3, 2)).astype(np.float32)
    ct = rng.standard_normal((R, 3, 2)).astype(np.float32)

    def j_rel(x):
        return jax.ops.segment_sum(jg.edge_mask(x), jg.rel, num_segments=R)

    want, vjp = jax.vjp(j_rel, jnp.asarray(v))
    tv = _t(v, True)
    got = ops.edge_rel_sum(tg, tv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    (got * _t(ct)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]), **GRAD)

    w = rng.standard_normal((R, 4)).astype(np.float32)
    cte = rng.standard_normal((EP, 4)).astype(np.float32)
    cte[tg.num_edges:] = 0.0  # het_tpu's take adds the padding edges' rows
    tw = _t(w, True)
    got = ops.edge_rel_gather(tg, tw)
    np.testing.assert_allclose(got.detach().numpy(), w[tg.rel.numpy()])
    (got * _t(cte)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jnp.take(a, jg.rel, axis=0) * cte))(
        jnp.asarray(w))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want), **GRAD)

    x = rng.standard_normal((tg.num_nodes, 2, 3)).astype(np.float32)
    ctn = rng.standard_normal((tg.num_ntypes, 2, 3)).astype(np.float32)
    offs = np.asarray(jg.ntype_offsets)
    node_t = np.searchsorted(offs[1:], np.arange(jg.num_nodes), "right")

    def j_nt(a):
        return jax.ops.segment_sum(a, node_t, num_segments=jg.num_ntypes)

    want, vjp = jax.vjp(j_nt, jnp.asarray(x))
    tx = _t(x, True)
    got = ops.ntype_sum(tg, tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    (got * _t(ctn)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ctn))[0]), **GRAD)


# -------------------------------------------- fuse_packed_projection's fault


def _unsafe_programs(Kind):
    """Two compact programs ``fuse_packed_projection`` must not fuse whole,
    built op by op with ``Kind`` (either package's ``Op``/``Var``).

    ``read_between``: an op between the producer ``zc = CompactDense(x,
    W)`` and ``el = <zc, a>`` reads ``zc``.  ``shared``: two same-side
    inner products ``<zc, a1>``, ``<zc, a2>`` share the producer."""
    Op_, Var_, Program_ = Kind
    x = Var_.data("SRCNODE", "feature")
    W = Var_.weight("W", "EDGETYPE")
    zc = Var_.data("UNIQUE_NODE_ETYPE", "zc")
    side = {"side": "src"}
    cmp = {"side": "src", "compact": True}

    def ip(a, out):
        return Op_("EdgeInnerProduct",
                   {"left": zc, "right": Var_.weight(a, "EDGETYPE")},
                   (Var_.data("UNIQUE_NODE_ETYPE", out),), dict(cmp))

    def tail(el):
        e = Var_.data("EDGEWISE", "el_e")
        return [
            Op_("ExpandCompact", {"input": Var_.data("UNIQUE_NODE_ETYPE",
                                                     el)}, (e,), dict(side)),
            Op_("ExpandCompact", {"input": zc},
                (Var_.data("EDGEWISE", "z_e"),), dict(side)),
            Op_("FusedEdgeSoftmaxAgg",
                {"logits": e, "msg": Var_.data("EDGEWISE", "z_e")},
                (Var_.data("DSTNODE", "output"),)),
        ]

    cd = Op_("CompactDense", {"input": x, "weight": W}, (zc,), dict(side))
    t = Var_.data("UNIQUE_NODE_ETYPE", "zc_scaled")
    read_between = [
        cd,
        Op_("Negative", {"input": zc}, (t,)),
        ip("a", "el_c"),
        Op_("ScalarAdd", {"left": Var_.data("UNIQUE_NODE_ETYPE", "el_c"),
                          "right": Var_.data("UNIQUE_NODE_ETYPE", "el_c")},
            (Var_.data("UNIQUE_NODE_ETYPE", "el2"),)),
        Op_("ExpandCompact", {"input": t},
            (Var_.data("EDGEWISE", "t_e"),), dict(side)),
        Op_("ExpandCompact", {"input": Var_.data("UNIQUE_NODE_ETYPE", "el2")},
            (Var_.data("EDGEWISE", "l_e"),), dict(side)),
        Op_("FusedEdgeSoftmaxAgg",
            {"logits": Var_.data("EDGEWISE", "l_e"),
             "msg": Var_.data("EDGEWISE", "t_e")},
            (Var_.data("DSTNODE", "output"),)),
    ]
    shared = [
        cd, ip("a1", "el_1"), ip("a2", "el_2"),
        Op_("ScalarAdd", {"left": Var_.data("UNIQUE_NODE_ETYPE", "el_1"),
                          "right": Var_.data("UNIQUE_NODE_ETYPE", "el_2")},
            (Var_.data("UNIQUE_NODE_ETYPE", "el_s"),)),
    ] + tail("el_s")
    return {"read_between": read_between, "shared": shared}


def _fault_inputs(tg, rng, names):
    x = rng.standard_normal((tg.num_nodes, F)).astype(np.float32)
    w = {"W": rng.standard_normal((tg.num_rels, F, F)).astype(np.float32)
         * 0.4}
    for a in names:
        w[a] = rng.standard_normal((tg.num_rels, F)).astype(np.float32) * 0.4
    return {"feature": x}, w


@pytest.mark.parametrize("case", ["read_between", "shared"])
def test_packed_projection_skips_unsafe_pairs(graphs, case):
    import het_tpu.compiler.ir as jir

    jg, tg = graphs
    j_ops = _unsafe_programs((jir.Op, jir.Var, jir.Program))[case]
    t_ops = _unsafe_programs((Op, Var, Program))[case]
    weights = ("a",) if case == "read_between" else ("a1", "a2")
    rng = np.random.default_rng(23)
    inputs, wts = _fault_inputs(tg, rng, weights)

    # the unfused program, by the port: the result to keep
    unfused = run_default(Program(ops=list(t_ops)))
    want = tc.compile_program(unfused)(
        tg, {k: _t(v) for k, v in inputs.items()},
        {k: _t(v) for k, v in wts.items()})["output"]

    # het_tpu's pass fuses every pair and breaks the program
    jprog = j_run_default(jir.Program(ops=list(j_ops)))
    assert jfuse.fuse_packed_projection(jprog) == len(weights)
    defined = [o.name for op in jprog.ops for o in op.outputs]
    if case == "read_between":
        # zc is read before its new definition: the program cannot run
        first_def = defined.index("zc")
        first_read = min(i for i, op in enumerate(jprog.ops)
                         if any(v.name == "zc" for v in op.inputs.values()))
        assert first_read < first_def
        with pytest.raises(KeyError, match="zc"):
            jc.compile_program(jprog)(
                jg, {k: jnp.asarray(v) for k, v in inputs.items()},
                {k: jnp.asarray(v) for k, v in wts.items()})
    else:
        # zc and its packed projection are defined twice: no longer SSA,
        # and the renaming makes the first definition a program output,
        # whose missing seed breaks the gradient program
        assert defined.count("zc") == 2 and defined.count("zc_packed") == 2
        j_run_default(jprog)
        outs = [v.name for v in jc.compile_program(jprog).output_vars]
        assert "zc" in outs and outs != ["output"]

    # the port's skips the unsafe pair: one fusion (shared) or none
    tprog = run_default(Program(ops=list(t_ops)))
    fused = tfuse.fuse_packed_projection(tprog)
    assert fused == (0 if case == "read_between" else 1)
    run_default(tprog)
    defined = [o.name for op in tprog.ops for o in op.outputs]
    assert defined.count("zc") == 1
    fn = tc.compile_program(tprog)
    assert [v.name for v in fn.output_vars] == ["output"]
    got = fn(tg, {k: _t(v) for k, v in inputs.items()},
             {k: _t(v) for k, v in wts.items()})["output"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **VAL)


def test_packed_projection_still_fuses_the_layer():
    """The checks leave the RGAT layer's safe pair fused: compact
    multiply-first folds ``el`` into the projection, as in het_tpu."""
    tp = build_layer_program(RGAT_LAYER_DSL, compact=True,
                             multiply_first=True)
    kinds = [op.kind for op in tp.ops]
    assert kinds.count("SplitFirstColumn") == 1
    assert "FusedGatCompact" in kinds
    jp = _j_program(J_RGAT_LAYER_DSL, None, True, True)
    assert tc.dumps(tp) == jc.dumps(jp)
