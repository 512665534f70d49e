"""Lowering: Inter-Op SSA program -> executable PyTorch closure.

The counterpart of ``het_tpu/compiler/lower.py``, retargeted op for op
to ``het_tpu_torch.ops``: each IR op maps to the port's differentiable
graph ops, which launch the hand-written CUDA kernels on the card (their
plain versions on the CPU), and ``torch.autograd`` of the compiled
closure is an independent check of the IR-level autodiff.  Every sum
over edges or nodes is a sorted segment sum, never an atomic scatter:

* ``NodeSumAccumulation``: ``scatter_sum_dst`` / ``scatter_sum_src``
  (over ``in_row_ptr`` / ``out_row_ptr``, which padding edges lie past);
* ``EdgeTypeSumAccumulation``: ``edge_rel_sum`` over the relation-sorted
  edge rows (padding rows add nothing);
* ``NodeTypeSumAccumulation``: ``ntype_sum`` over ``ntype_offsets``;
* the per-edge read of an ``EDGETYPE`` weight: inside an
  ``EdgeInnerProduct`` the relation-typed inner product
  (``edge_rel_inner`` per edge, ``segment_rel_inner`` on compact rows),
  whose weight gradient is the grouped dW kernel; anywhere else
  ``edge_rel_gather``, whose gradient is ``edge_rel_sum``.

Given an Op-Spec program, each spec's ``gpu`` dict steers the lowering:
``strategy`` "host_offsets" (het_tpu's "static_mix", the default) or
"device_offsets" (het_tpu's "gather_einsum") on GEMM specs, ``packing``
"packed" or "split" on the fused softmax aggregation.  het_tpu's
``reduction`` and ``static_topk`` fields (XLA's scatter-add, the static
mix's top-k) have no counterpart here and raise ``ValueError``.

Source-level codegen lives in ``compiler.codegen``; this module is the
interpreter the emitted source is tested against."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .. import ops
from ..ops.common import _masked_edges, safe_div
from ..ops.spmm import _masked_exp
from .ir import Op, Program, Var

NODE_KINDS = ("NODEWISE", "DSTNODE", "SRCNODE")
LEAKY_SLOPE = 0.2
# het_tpu's TPU-only schedule fields: XLA's scatter-add (the port has one
# segment-sum kernel and no atomic scatter) and the static mix's top-k
TPU_ONLY_FIELDS = ("reduction", "static_topk")
# GEMM ``strategy`` -> the typed linears' ``offsets`` (het_tpu's names
# beside the port's)
STRATEGIES = {"host_offsets": "host", "static_mix": "host",
              "device_offsets": "device", "gather_einsum": "device"}
PACKINGS = ("packed", "split")


def check_hint(hint: Dict) -> None:
    """Raise for a schedule field the card has no counterpart of."""
    for key in TPU_ONLY_FIELDS:
        if key in hint:
            raise ValueError(
                f"schedule field {key!r} ({hint[key]!r}) has no counterpart "
                "on the GPU: the port sums with its sorted segment-sum "
                "kernel, with no atomic scatter and no static top-k plan")
    if hint.get("strategy", "host_offsets") not in STRATEGIES:
        raise ValueError(f"GEMM strategy must be one of {tuple(STRATEGIES)}"
                         f", got {hint['strategy']!r}")
    if hint.get("packing", "packed") not in PACKINGS:
        raise ValueError(f"packing must be one of {PACKINGS}, got "
                         f"{hint['packing']!r}")


def offsets_of(hint: Dict) -> str:
    """The typed linears' ``offsets`` a GEMM spec's ``strategy`` asks."""
    return STRATEGIES[hint.get("strategy", "host_offsets")]


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """``jax.nn.leaky_relu``'s: slope 1 at 0, as its gradient has it."""
    return torch.where(x >= 0, x, slope * x)


class _Env:
    def __init__(self, g, impl: str):
        self.g = g
        self.impl = impl
        self.vals: Dict[Tuple[str, str], torch.Tensor] = {}
        self.hint: Dict = {}  # current op's Op-Spec ``gpu`` schedule dict

    def set(self, var: Var, val: torch.Tensor) -> None:
        self.vals[(var.kind, var.name)] = val

    def lookup(self, var: Var):
        key = (var.kind, var.name)
        if key in self.vals:
            return self.vals[key], var.kind
        # name-aliased node/edge reads (the goldens use kinds loosely)
        for k in NODE_KINDS + ("EDGEWISE",):
            if (k, var.name) in self.vals:
                return self.vals[(k, var.name)], k
        raise KeyError(f"undefined variable {var}")

    def as_edge(self, var: Var) -> torch.Tensor:
        """Coerce a value to per-edge canonical space (EP, ...)."""
        g, impl = self.g, self.impl
        if var.is_weight:
            w, _ = self.lookup(var)
            if var.kind == "EDGETYPE":
                return ops.edge_rel_gather(g, w, impl=impl)
            if var.kind == "NODETYPE":
                raise ValueError("node-typed weight used edge-wise")
            return w.expand((g.num_padded_edges,) + tuple(w.shape))
        val, kind = self.lookup(var)
        if kind == "EDGEWISE":
            return val
        if var.kind == "SRCNODE" or kind == "SRCNODE":
            return ops.gather_src(g, val, impl=impl)
        return ops.gather_dst(g, val, impl=impl)

    def as_node(self, var: Var) -> torch.Tensor:
        val, kind = self.lookup(var)
        assert kind != "EDGEWISE", f"{var} is edge-wise, node value expected"
        return val


def _typed_weight(op: Op):
    """(weight operand, other operand) of a product with exactly one
    relation-typed weight, else (None, None)."""
    l, r = op.inputs["left"], op.inputs["right"]
    lw = l.is_weight and l.kind == "EDGETYPE"
    rw = r.is_weight and r.kind == "EDGETYPE"
    if lw != rw:
        return (l, r) if lw else (r, l)
    return None, None


def _exec_op(env: _Env, op: Op) -> None:
    g, impl = env.g, env.impl
    k = op.kind
    out = op.outputs[0]

    if k in ("NodeDense", "EdgeDense", "CompactDense"):
        xv = op.inputs["input"]
        w, _ = env.lookup(op.inputs["weight"])
        wslice = op.inputs["weight"].kind
        if wslice == "NONE":
            # untyped dense: plain matmul in the input's own space
            x = env.as_node(xv) if xv.kind in NODE_KINDS else env.as_edge(xv)
            y = x @ w
            if out.kind == "EDGEWISE" and xv.kind in NODE_KINDS:
                y = (ops.gather_src(g, y, impl=impl) if xv.kind == "SRCNODE"
                     else ops.gather_dst(g, y, impl=impl))
            env.set(out, y)
            return
        if wslice == "NODETYPE":
            x = env.as_node(xv)
            env.set(out, ops.ntype_linear(g, x, w[:, None], impl=impl)[:, 0])
            return
        w4 = w[:, None] if w.dim() == 3 else w  # (R, 1, K, O)
        offsets = offsets_of(env.hint)
        if k == "CompactDense":
            side = op.attrs.get("side", "src")
            x = env.as_node(xv)
            env.set(out, ops.compact_typed_linear(
                g, x, w4, side, impl=impl, offsets=offsets)[:, 0])
            return
        if xv.kind in ("SRCNODE", "DSTNODE"):
            x = env.as_node(xv)
            side = "src" if xv.kind == "SRCNODE" else "dst"
            env.set(out, ops.edge_typed_linear(
                g, x, w4, side, impl=impl, offsets=offsets)[:, 0])
        else:
            # per-edge input rows times W[rel]
            env.set(out, ops.edge_rows_typed_linear(
                g, env.as_edge(xv), w4, impl=impl, offsets=offsets)[:, 0])
        return

    if k == "NodeLinear":
        w, _ = env.lookup(op.inputs["weight"])
        x = env.as_node(op.inputs["input"])
        env.set(out, ops.ntype_linear(g, x, w[:, None], impl=impl)[:, 0])
        return

    if k == "WeightDense":
        l, _ = env.lookup(op.inputs["left"])
        r, _ = env.lookup(op.inputs["right"])
        if r.dim() == l.dim() - 1:
            # matrix x vector per relation: (R, A, B) x (R, B) -> (R, A)
            env.set(out, torch.einsum("r...ab,r...b->r...a", l, r))
        else:
            env.set(out, torch.einsum("r...ab,r...bc->r...ac", l, r))
        return

    if k == "Copy":
        # Copy coerces into the destination kind's space (the goldens use
        # it to move node values edge-wise and vice versa)
        if out.kind == "EDGEWISE":
            env.set(out, env.as_edge(op.inputs["input"]))
        else:
            env.set(out, env.lookup(op.inputs["input"])[0])
        return

    if k == "Concatenate":
        l = env.as_edge(op.inputs["left"])
        r = env.as_edge(op.inputs["right"])
        env.set(out, torch.cat([l, r], dim=-1))
        return

    if k == "Split":
        val, _ = env.lookup(op.inputs["input"])
        h = val.shape[-1] // 2
        env.set(op.outputs[0], val[..., :h])
        env.set(op.outputs[1], val[..., h:])
        return

    if k == "Transpose":
        val, _ = env.lookup(op.inputs["input"])
        env.set(out, val.transpose(-1, -2))
        return

    if k == "EdgeInnerProduct":
        wv, xv = _typed_weight(op)
        if op.attrs.get("compact"):
            # compact-space SDDMM: operands per unique (rel, node) row
            side = op.attrs.get("side", "src")
            info = g.compact_src if side == "src" else g.compact_dst

            def as_c(v):
                if v.is_weight:
                    raise ValueError(f"{op}: a compact inner product takes "
                                     "one relation-typed weight at most")
                val, _ = env.lookup(v)
                if v.kind in NODE_KINDS:
                    # node tensor -> one row per unique (rel, node)
                    return ops.compact_rows(g, val, side, impl=impl)
                return val

            if wv is not None:
                w, _ = env.lookup(wv)
                env.set(out, ops.segment_rel_inner(
                    as_c(xv)[:, None], w[:, None], info.seg,
                    impl=impl)[:, 0])
                return
            l = as_c(op.inputs["left"])
            r = as_c(op.inputs["right"])
            env.set(out, (l * r).sum(-1))
            return
        if wv is not None:
            w, _ = env.lookup(wv)
            env.set(out, ops.edge_rel_inner(
                g, env.as_edge(xv)[:, None], w[:, None], impl=impl)[:, 0])
            return
        l = env.as_edge(op.inputs["left"])
        r = env.as_edge(op.inputs["right"])
        env.set(out, (l * r).sum(-1))
        return

    if k in ("EdgeOuterProduct", "NodeOuterProduct"):
        if out.kind != "EDGEWISE" and all(
            v.kind in NODE_KINDS for v in op.inputs.values()
        ):
            # node-space outer product (dW of a node-space dense)
            l = env.as_node(op.inputs["left"])
            r = env.as_node(op.inputs["right"])
        else:
            l = env.as_edge(op.inputs["left"])
            r = env.as_edge(op.inputs["right"])
        env.set(out, l[..., :, None] * r[..., None, :])
        return

    if k == "EdgeScalarVectorMul":
        s = env.as_edge(op.inputs["scalar"])
        v = env.as_edge(op.inputs["vector"])
        env.set(out, s[..., None] * v)
        return

    if k in ("LeakyRelu", "Exponential", "Tanh", "Negative"):
        val, _ = env.lookup(op.inputs["input"])
        fn = {
            "LeakyRelu": leaky_relu,
            "Exponential": torch.exp,
            "Tanh": torch.tanh,
            "Negative": torch.neg,
        }[k]
        env.set(out, fn(val))
        return

    if k == "GradLeakyRelu":
        d, _ = env.lookup(op.inputs["delta"])
        p, _ = env.lookup(op.inputs["primal"])
        env.set(out, d * torch.where(p >= 0, 1.0, LEAKY_SLOPE))
        return

    if k in ("ScalarDivide", "ScalarMultiply", "ScalarAdd", "VectorAdd",
             "MatrixAdd"):
        if out.is_weight or (
            op.inputs["left"].is_weight and op.inputs["right"].is_weight
        ):
            l, _ = env.lookup(op.inputs["left"])
            r, _ = env.lookup(op.inputs["right"])
        elif out.kind == "EDGEWISE":
            l = env.as_edge(op.inputs["left"])
            r = env.as_edge(op.inputs["right"])
        else:
            l = env.as_node(op.inputs["left"])
            r = env.as_node(op.inputs["right"])
        if k == "ScalarDivide":
            env.set(out, safe_div(l, r))
        elif k == "ScalarMultiply":
            env.set(out, l * r)
        else:
            env.set(out, l + r)
        return

    if k == "NodeSumAccumulation":
        # the sorted sums never read a padding edge (past the row
        # pointers' ends): het_tpu's edge_mask before its sums
        v = env.as_edge(op.inputs["input"])
        total = (ops.scatter_sum_src if out.kind == "SRCNODE"
                 else ops.scatter_sum_dst)
        env.set(out, total(g, v, impl=impl))
        return

    if k == "EdgeTypeSumAccumulation":
        v = env.as_edge(op.inputs["input"])
        env.set(out, ops.edge_rel_sum(g, v, impl=impl))
        return

    if k == "RowSumAccumulation":
        xv = op.inputs["input"]
        if xv.kind == "EDGEWISE":
            env.set(out, _masked_edges(g, env.as_edge(xv)).sum(0))
        else:
            env.set(out, env.as_node(xv).sum(0))
        return

    if k == "NodeTypeSumAccumulation":
        env.set(out, ops.ntype_sum(g, env.as_node(op.inputs["input"]),
                                   impl=impl))
        return

    if k == "FusedEdgeSoftmaxAgg":
        logits = env.as_edge(op.inputs["logits"])
        msg = env.as_edge(op.inputs["msg"])
        if env.hint.get("packing") == "split":
            # Op-Spec schedule override: the unfused chain's denominator
            # and numerator in two sums of their own
            z = _masked_exp(g, logits)
            s = ops.scatter_sum_dst(g, z, impl=impl)
            num = ops.scatter_sum_dst(g, z[..., None] * msg, impl=impl)
            env.set(out, safe_div(num, s[..., None]))
            return
        env.set(out, ops.edge_softmax_weighted_sum(g, logits, msg,
                                                   impl=impl))
        return

    if k == "FusedGatCompact":
        el_c, _ = env.lookup(op.inputs["el"])
        er_c, _ = env.lookup(op.inputs["er"])
        msg_c, _ = env.lookup(op.inputs["msg"])
        slope = float(op.attrs.get("slope", LEAKY_SLOPE))
        out_v = ops.relational_fused_gat_compact(
            g, msg_c[:, None, :], el_c[:, None], er_c[:, None], slope,
            impl=impl)
        env.set(out, out_v[:, 0, :])
        return

    if k == "FusedEdgeSoftmaxAggCompact":
        logits = env.as_edge(op.inputs["logits"])
        msg_c, _ = env.lookup(op.inputs["msg"])
        env.set(out, ops.edge_softmax_weighted_sum_compact(
            g, logits, msg_c, impl=impl))
        return

    if k == "WeightPackColumn":
        vec, _ = env.lookup(op.inputs["vec"])
        mat, _ = env.lookup(op.inputs["mat"])
        env.set(out, torch.cat([vec[..., :, None], mat], dim=-1))
        return

    if k == "SplitFirstColumn":
        val, _ = env.lookup(op.inputs["input"])
        env.set(op.outputs[0], val[..., 0])
        env.set(op.outputs[1], val[..., 1:])
        return

    if k == "ExpandCompact":
        val, _ = env.lookup(op.inputs["input"])
        side = op.attrs.get("side", "src")
        env.set(out, ops.expand_compact(g, val, side, impl=impl))
        return

    raise NotImplementedError(f"no lowering for op kind {k}")


def _spec_hints(opspec) -> Dict[int, Dict]:
    """Map DAG op position -> ``gpu`` schedule dict of its Op-Spec.

    ``schedule_program`` emits specs in DAG order, one per op except the
    FusedEdgeSoftmaxAgg motif (two: the fused accumulate pass and the
    node-space divide finish), so replaying the same walk recovers the
    association without back-pointers."""
    hints: Dict[int, Dict] = {}
    dag_ops = opspec.dag.ops
    si = 0
    for pos, op in enumerate(dag_ops):
        if si >= len(opspec.specs):
            break
        spec = opspec.specs[si]
        h = dict(spec.gpu or {})
        if op.kind == "FusedEdgeSoftmaxAgg" and si + 1 < len(opspec.specs):
            # merge the finish traversal's hints (fused op + divide)
            si += 1
        si += 1
        hints[pos] = h
    return hints


def program_outputs(prog: Program):
    """The values a program defines and never reads, in definition
    order: its outputs."""
    read = {v.name for op in prog.ops for v in op.inputs.values()}
    return [o for op in prog.ops for o in op.outputs if o.name not in read]


def compile_program(prog, outputs=None) -> Callable:
    """Program (or scheduled :class:`~.opspec.OpSpecProgram`) ->
    ``fn(graph, inputs: dict[name], weights: dict[name], *,
    impl="kernel") -> dict[name, Tensor]``, differentiable by
    ``torch.autograd``; ``impl="plain"`` runs every kernel's plain
    version on the card instead, as the port's ops take it.

    Given an ``OpSpecProgram`` (the Op-Spec SSA level,
    ``compiler.opspec.schedule_program``), each spec's ``gpu`` schedule
    dict steers the lowering — ``strategy`` on GEMM specs picks the
    segment-matmul plan, ``packing`` ("split") unfuses the
    softmax-aggregate — the role Op-Spec schedules play as codegen's
    input in the reference (hrt/pyctor/ir/OpSpecSSA/codegen.py)."""
    hints: Dict[int, Dict] = {}
    if hasattr(prog, "dag") and hasattr(prog, "specs"):
        hints = _spec_hints(prog)
        prog = prog.dag
    prog.validate()
    for hint in hints.values():
        check_hint(hint)
    if outputs is None:
        outputs = program_outputs(prog)

    def fn(g, inputs: Dict[str, torch.Tensor],
           weights: Dict[str, torch.Tensor], *,
           impl: str = "kernel") -> Dict[str, torch.Tensor]:
        env = _Env(g, impl)
        for v in prog.inputs:
            env.set(v, inputs[v.name])
        for v in prog.weights:
            env.set(v, weights[v.name])
        for pos, op in enumerate(prog.ops):
            env.hint = hints.get(pos, {})
            _exec_op(env, op)
        return {o.name: env.lookup(o)[0] for o in outputs}

    fn.output_vars = outputs  # type: ignore[attr-defined]
    return fn
