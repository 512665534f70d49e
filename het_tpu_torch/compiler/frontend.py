"""Inter-Op DSL frontend: python-ish graph loops -> Inter-Op SSA program.

Parses the reference's ``.inter-op`` surface language (examples:
hrt/pyctor/examples/inter-op-dsl/*.inter-op; reference frontend:
hrt/pyctor/transforms/InterOp/canonicalizer.py:22-82 +
hrt/pyctor/ir/InterOpDSL/pattern_matcher.py:29-936) using the Python ``ast``
module:

    for e in g.edges():            -> edgewise statements
    for n in g.dst_nodes():        -> dst-node statements; nested
        for e in n.incoming_edges():  `n[s] += expr` is NodeSumAccumulation
    for n in g.nodes():            -> node-wise statements

Expression forms: ``e.src.feature`` / ``e.dst.x`` / ``e.x`` / ``n.x``,
``W[e.etype]`` (edge-typed weight), ``V[n.ntype]`` (node-typed weight), bare
names (unsliced weights), calls ``concat/inner_product/leakyrelu/exp/tanh/
linear/transpose``, operators ``* + / -``.  Sub-expressions become
``_tmpN``-suffixed temporaries, mirroring the reference's naming grammar.

Unlike the reference (whose ``lower()`` raises NotImplementedError at the
shape step, lower_to_InterOpSSA.py:26-29), this frontend is complete: its
output feeds shape inference, autodiff, rewrites, and the lowering onto
the port's ops.  A copy of ``het_tpu/compiler/frontend.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .ir import Op, Program, Var

_UNARY_CALLS = {
    "leakyrelu": "LeakyRelu",
    "exp": "Exponential",
    "tanh": "Tanh",
}


class _Ctx:
    def __init__(self):
        self.prog = Program()
        self.tmp_counts: Dict[str, int] = {}

    def tmp(self, base: str) -> str:
        n = self.tmp_counts.get(base, 0) + 1
        self.tmp_counts[base] = n
        return f"{base}_tmp{n}"

    def emit(self, kind: str, inputs: Dict[str, Var], out: Var) -> Var:
        self.prog.ops.append(Op(kind, inputs, (out,)))
        return out


def parse_dsl(source: str) -> Program:
    tree = ast.parse(source)
    ctx = _Ctx()
    for node in tree.body:
        if not isinstance(node, ast.For):
            continue
        loop_kind = _loop_kind(node)
        if loop_kind == "edges":
            for stmt in node.body:
                _edge_stmt(ctx, stmt)
        elif loop_kind in ("dst_nodes", "nodes"):
            kind = "DSTNODE" if loop_kind == "dst_nodes" else "NODEWISE"
            for stmt in node.body:
                _node_stmt(ctx, stmt, kind)
    ctx.prog.validate()
    return ctx.prog


def _loop_kind(node: ast.For) -> Optional[str]:
    it = node.iter
    if (
        isinstance(it, ast.Call)
        and isinstance(it.func, ast.Attribute)
        and isinstance(it.func.value, ast.Name)
    ):
        return it.func.attr  # edges | dst_nodes | nodes | incoming_edges
    return None


def _target_name(t: ast.expr) -> Optional[str]:
    if isinstance(t, ast.Subscript):  # e["x"] / n["x"]
        s = t.slice
        if isinstance(s, ast.Constant):
            return str(s.value)
    if isinstance(t, ast.Name):  # bare weight-level assignment
        return t.id
    return None


def _edge_stmt(ctx: _Ctx, stmt: ast.stmt) -> None:
    if not isinstance(stmt, ast.Assign):
        return
    name = _target_name(stmt.targets[0])
    if name is None:
        return
    if isinstance(stmt.targets[0], ast.Name):
        # weight-level assignment (linear-operator reordering form)
        out = Var.weight(name, "EDGETYPE")
    else:
        out = Var.data("EDGEWISE", name)
    _lower_expr(ctx, stmt.value, out, "EDGEWISE")


def _defined(ctx: _Ctx, name: str) -> bool:
    return any(o.name == name for op in ctx.prog.ops for o in op.outputs)


def _node_stmt(ctx: _Ctx, stmt: ast.stmt, kind: str) -> None:
    if isinstance(stmt, ast.For) and _loop_kind(stmt) == "incoming_edges":
        for inner in stmt.body:
            if isinstance(inner, ast.AugAssign):
                name = _target_name(inner.target)
                # n[s] += expr  ->  NodeSumAccumulation(edge-expr); when the
                # accumulator already holds a value (e.g. a self-loop dense
                # written before the edge loop, rgcn.inter-op), accumulate
                # into a temp and add — the golden's _self/_neighbors split
                val = _as_var(ctx, inner.value, "EDGEWISE", base=name)
                tgt = Var.data(kind, name)
                if _defined(ctx, name):
                    tmp = Var.data(kind, ctx.tmp(name))
                    ctx.emit("NodeSumAccumulation", {"input": val}, tmp)
                    ctx.emit(
                        "UnrealizedAdd", {"left": tgt, "right": tmp}, tgt
                    )
                else:
                    ctx.emit("NodeSumAccumulation", {"input": val}, tgt)
        return
    if isinstance(stmt, ast.AugAssign):
        # n[y] += expr at node level (self-loop term): accumulate node-wise;
        # a += into an undefined accumulator is plain assignment
        name = _target_name(stmt.target)
        if not _defined(ctx, name):
            _lower_expr(ctx, stmt.value, Var.data(kind, name), kind)
            return
        val = _as_var(ctx, stmt.value, kind, base=name)
        prev = Var.data(kind, name)
        ctx.emit("VectorAdd", {"left": prev, "right": val}, prev)
        return
    if not isinstance(stmt, ast.Assign):
        return
    name = _target_name(stmt.targets[0])
    if name is None:
        return
    if isinstance(stmt.value, ast.Constant):
        return  # accumulator init (n[s] = 0.0)
    _lower_expr(ctx, stmt.value, Var.data(kind, name), kind)


def _as_var(ctx: _Ctx, e: ast.expr, scope: str, base: str = "t") -> Var:
    """Lower expression to a Var, materializing temporaries as needed."""
    v = _leaf_var(e, scope)
    if v is not None:
        return v
    out = Var.data(scope, ctx.tmp(base))
    _lower_expr(ctx, e, out, scope)
    return out


def _leaf_var(e: ast.expr, scope: str) -> Optional[Var]:
    if isinstance(e, ast.Attribute):
        if isinstance(e.value, ast.Attribute) and isinstance(
            e.value.value, ast.Name
        ):
            # e.src.feature / e.dst.x
            side = e.value.attr
            if side == "src":
                return Var.data("SRCNODE", e.attr)
            if side == "dst":
                return Var.data("DSTNODE", e.attr)
        if isinstance(e.value, ast.Name):
            who = e.value.id
            if who == "e":
                return Var.data("EDGEWISE", e.attr)
            if who == "n":
                return Var.data(scope if scope != "EDGEWISE" else "NODEWISE",
                                e.attr)
    if isinstance(e, ast.Subscript) and isinstance(e.value, ast.Name):
        s = e.slice
        if isinstance(s, ast.Attribute):
            if s.attr == "etype":
                return Var.weight(e.value.id, "EDGETYPE")
            if s.attr == "ntype":
                return Var.weight(e.value.id, "NODETYPE")
        if isinstance(s, ast.Constant):
            return Var.data("EDGEWISE", str(s.value))
    if isinstance(e, ast.Name) and e.id not in ("e", "n", "g"):
        # bare name: unsliced weight, or a weight temp from reordering
        return Var.weight(e.id, "NONE")
    return None


def _lower_expr(ctx: _Ctx, e: ast.expr, out: Var, scope: str) -> None:
    base = out.name
    if isinstance(e, ast.BinOp):
        # canonical grouping for a * b * W[etype] chains: the reference
        # groups the typed dense innermost — (a * b) * W -> a * (b * W)
        # (rgcn.inter-op-ssa: EdgeDense(feature, Wr) then
        # EdgeScalarVectorMul(norm_factor, ·)).  Scalar multiplication
        # commutes, so the reassociation is semantics-preserving.
        if (
            isinstance(e.op, ast.Mult)
            and isinstance(e.left, ast.BinOp)
            and isinstance(e.left.op, ast.Mult)
        ):
            rv = _leaf_var(e.right, scope)
            if rv is not None and rv.is_weight:
                regrouped = ast.BinOp(
                    left=e.left.left,
                    op=ast.Mult(),
                    right=ast.BinOp(
                        left=e.left.right, op=ast.Mult(), right=e.right
                    ),
                )
                _lower_expr(ctx, regrouped, out, scope)
                return
        left = _as_var(ctx, e.left, scope, base)
        right = _as_var(ctx, e.right, scope, base)
        if isinstance(e.op, ast.Mult):
            kind = _mul_kind(left, right, out)
            if kind == "NodeDense" and right.is_weight:
                ctx.emit(kind, {"input": left, "weight": right}, out)
            elif kind == "EdgeDense":
                ctx.emit(kind, {"input": left, "weight": right}, out)
            elif kind == "WeightDense":
                ctx.emit(kind, {"left": left, "right": right}, out)
            else:
                ctx.emit(kind, {"left": left, "right": right}, out)
        elif isinstance(e.op, ast.Add):
            ctx.emit("UnrealizedAdd", {"left": left, "right": right}, out)
        elif isinstance(e.op, ast.Div):
            ctx.emit("ScalarDivide", {"left": left, "right": right}, out)
        elif isinstance(e.op, ast.Sub):
            neg = Var.data(scope, ctx.tmp(base))
            ctx.emit("Negative", {"input": right}, neg)
            ctx.emit("UnrealizedAdd", {"left": left, "right": neg}, out)
        return
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Name):
        fname = e.func.id
        if fname in _UNARY_CALLS:
            v = _as_var(ctx, e.args[0], scope, base)
            ctx.emit(_UNARY_CALLS[fname], {"input": v}, out)
            return
        if fname == "concat":
            items = e.args[0]
            assert isinstance(items, ast.List) and len(items.elts) == 2
            l = _as_var(ctx, items.elts[0], scope, base)
            r = _as_var(ctx, items.elts[1], scope, base)
            ctx.emit("Concatenate", {"left": l, "right": r}, out)
            return
        if fname == "inner_product":
            l = _as_var(ctx, e.args[0], scope, base)
            r = _as_var(ctx, e.args[1], scope, base)
            ctx.emit("EdgeInnerProduct", {"left": l, "right": r}, out)
            return
        if fname == "linear":
            w = _as_var(ctx, e.args[0], scope, base)
            x = _as_var(ctx, e.args[1], scope, base)
            if w.is_weight and w.kind == "NODETYPE":
                ctx.emit("NodeLinear", {"weight": w, "input": x}, out)
            else:
                ctx.emit("EdgeDense", {"input": x, "weight": w}, out)
            return
        if fname == "transpose":
            v = _as_var(ctx, e.args[0], scope, base)
            ctx.emit("Transpose", {"input": v}, out)
            return
        raise ValueError(f"unknown DSL call {fname}")
    # plain copy of a leaf
    v = _leaf_var(e, scope)
    if v is not None:
        ctx.emit("Copy", {"input": v}, out)
        return
    raise ValueError(f"cannot lower expression {ast.dump(e)}")


def _mul_kind(left: Var, right: Var, out: Var) -> str:
    if left.is_weight and right.is_weight:
        return "WeightDense"
    if right.is_weight:
        # x * W : typed dense — reference spells the src/dst-gathered form
        # NodeDense in rgat.inter-op-ssa and EdgeDense in rgcn/single_dense;
        # we canonicalize on the input kind
        if left.kind in ("SRCNODE", "DSTNODE", "NODEWISE"):
            return "NodeDense"
        return "EdgeDense"
    if left.is_weight:
        return "EdgeDense"
    return "UnrealizedMul"
