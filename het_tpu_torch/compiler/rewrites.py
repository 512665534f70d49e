"""Graph-program rewrites: Hector's two signature optimizations at the IR
level.

* **Compact materialization** (paper §compact; runtime flag
  ``--compact_as_of_node_flag`` in the reference): an edge-wise typed dense
  whose input is a node variable computes one row per (relation, unique
  node) instead of per edge; consumers that are elementwise/inner-product
  chains stay in compact space and the expansion to edge space sinks past
  them (the reference realizes this inside CUDA kernels via
  CompactAsOfNodeKind; here it is a program transformation and the runtime
  compact index does the rest).

* **Linear-operator reordering** (runtime flag
  ``--multiply_among_weights_first_flag``; DSL golden
  rgat_attn.reordered.inter-op.ref): ``inner_product(a[etype], x·W[etype])``
  reassociates to ``inner_product(x, (W·a)[etype])`` when the dense result
  has no other consumer — the per-edge GEMM disappears into a tiny
  per-relation weight-weight product.

A copy of ``het_tpu/compiler/rewrites.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .ir import OP_DEFS, Op, Program, Var


def _use_counts(prog: Program) -> Dict[Tuple[str, str], int]:
    uses: Dict[Tuple[str, str], int] = {}
    for op in prog.ops:
        for v in op.inputs.values():
            uses[(v.kind, v.name)] = uses.get((v.kind, v.name), 0) + 1
    return uses


def reorder_linear_operators(prog: Program) -> int:
    """(x·W)·a -> x·(W·a).  Returns number of rewrites applied.

    Matches the attention-vector inner product with the EDGETYPE weight on
    EITHER side, and the typed dense with its input/weight slots in either
    order — the reference's reordered golden
    (hrt/pyctor/examples/inter-op-ssa/rgat_attn{,.reordered}.inter-op-ssa)
    writes ``NodeDense(input=(W,EDGETYPE), weight=(DSTNODE,...))`` for the
    destination side, so slot names alone don't identify the operands."""
    uses = _use_counts(prog)
    producers = prog.producers()
    n = 0
    new_ops: List[Op] = []
    removed: set = set()

    def _dense_operands(dense):
        """(node_input, edgetype_weight) of a typed dense, tolerating
        swapped input/weight slots; None if not the shape we rewrite."""
        a, b = dense.inputs.get("input"), dense.inputs.get("weight")
        if a is None or b is None:
            return None
        for x, W in ((a, b), (b, a)):
            if (
                W.is_weight
                and W.kind == "EDGETYPE"
                and not x.is_weight
                and x.kind in ("SRCNODE", "DSTNODE")
            ):
                return x, W
        return None

    for i, op in enumerate(prog.ops):
        if op.kind != "EdgeInnerProduct":
            continue
        lhs, rhs = op.inputs["left"], op.inputs["right"]
        for a, y in ((lhs, rhs), (rhs, lhs)):
            if not (a.is_weight and a.kind == "EDGETYPE") or y.is_weight:
                continue
            dense = producers.get((y.kind, y.name))
            if (
                dense is not None
                and dense.kind in ("NodeDense", "EdgeDense")
                and _dense_operands(dense) is not None
                and uses.get((y.kind, y.name), 0) == 1
            ):
                x, W = _dense_operands(dense)
                w_new = Var.weight(f"{W.name}_{a.name}_fused", "EDGETYPE")
                new_ops.append(
                    Op("WeightDense", {"left": W, "right": a}, (w_new,))
                )
                op.kind = "EdgeInnerProduct"
                op.inputs = {"left": x, "right": w_new}
                removed.add(id(dense))
                n += 1
                break
    if n:
        prog.ops = new_ops + [op for op in prog.ops if id(op) not in removed]
    return n


_COMPACT_SAFE_UNARY = ("LeakyRelu", "Exponential", "Tanh", "Negative")


def compact_materialization(prog: Program) -> int:
    """Rewrite edge-wise typed denses over node inputs to compact form and
    sink the expansion past elementwise consumers.  Returns rewrites
    applied."""
    n = 0
    out_ops: List[Op] = []
    # (kind, name) of edgewise var -> (compact var, side)
    compacted: Dict[Tuple[str, str], Tuple[Var, str]] = {}

    def compact_operand(v: Var):
        return compacted.get((v.kind, v.name))

    for op in prog.ops:
        if (
            op.kind in ("NodeDense", "EdgeDense")
            and op.inputs["weight"].kind == "EDGETYPE"
            and op.inputs["input"].kind in ("SRCNODE", "DSTNODE")
        ):
            side = "src" if op.inputs["input"].kind == "SRCNODE" else "dst"
            out = op.result
            cvar = Var.data("UNIQUE_NODE_ETYPE", f"{out.name}_compact")
            out_ops.append(
                Op(
                    "CompactDense",
                    {"input": op.inputs["input"],
                     "weight": op.inputs["weight"]},
                    (cvar,),
                    {"side": side},
                )
            )
            out_ops.append(
                Op("ExpandCompact", {"input": cvar}, (out,), {"side": side})
            )
            compacted[(out.kind, out.name)] = (cvar, side)
            n += 1
            continue
        # sink expansion through elementwise unary ops
        if op.kind in _COMPACT_SAFE_UNARY:
            src = compact_operand(op.inputs["input"])
            if src is not None:
                cvar, side = src
                out = op.result
                c_out = Var.data("UNIQUE_NODE_ETYPE", f"{out.name}_compact")
                out_ops.append(
                    Op(op.kind, {"input": cvar}, (c_out,), dict(op.attrs))
                )
                out_ops.append(
                    Op("ExpandCompact", {"input": c_out}, (out,),
                       {"side": side})
                )
                compacted[(out.kind, out.name)] = (c_out, side)
                continue
        # sink through inner products against edge-typed weights
        if op.kind == "EdgeInnerProduct":
            l, r = op.inputs["left"], op.inputs["right"]
            lc, rc = compact_operand(l), compact_operand(r)
            # direct node x edge-typed-weight SDDMM: computable once per
            # unique (rel, node) (e.g. the reordered er = <x[dst],
            # (W a_r)[rel]> — the hand-written multiply_first dst logit)
            if lc is None and rc is None:
                nv = wv = None
                if (
                    l.kind in ("SRCNODE", "DSTNODE")
                    and r.is_weight and r.kind == "EDGETYPE"
                ):
                    nv, wv = l, r
                elif (
                    r.kind in ("SRCNODE", "DSTNODE")
                    and l.is_weight and l.kind == "EDGETYPE"
                ):
                    nv, wv = r, l
                if nv is not None:
                    side = "src" if nv.kind == "SRCNODE" else "dst"
                    out = op.result
                    c_out = Var.data(
                        "UNIQUE_NODE_ETYPE", f"{out.name}_compact"
                    )
                    out_ops.append(
                        Op(
                            "EdgeInnerProduct",
                            {"left": nv, "right": wv},
                            (c_out,),
                            {"side": side, "compact": True},
                        )
                    )
                    out_ops.append(
                        Op("ExpandCompact", {"input": c_out}, (out,),
                           {"side": side})
                    )
                    compacted[(out.kind, out.name)] = (c_out, side)
                    n += 1
                    continue
            if (lc is not None and r.is_weight and r.kind == "EDGETYPE") or (
                rc is not None and l.is_weight and l.kind == "EDGETYPE"
            ):
                cv, side = lc if lc is not None else rc
                wv = r if lc is not None else l
                out = op.result
                c_out = Var.data("UNIQUE_NODE_ETYPE", f"{out.name}_compact")
                out_ops.append(
                    Op(
                        "EdgeInnerProduct",
                        {"left": cv, "right": wv},
                        (c_out,),
                        {"side": side, "compact": True},
                    )
                )
                out_ops.append(
                    Op("ExpandCompact", {"input": c_out}, (out,),
                       {"side": side})
                )
                compacted[(out.kind, out.name)] = (c_out, side)
                continue
        out_ops.append(op)
    if n:
        prog.ops = out_ops
        _prune_dead_expands(prog)
    return n


def _prune_dead_expands(prog: Program) -> None:
    uses = _use_counts(prog)
    read_names = {name for (_, name) in uses}
    final = []
    for op in prog.ops:
        if op.kind == "ExpandCompact":
            o = op.result
            if (o.kind, o.name) not in uses and o.name not in read_names:
                continue
        final.append(op)
    prog.ops = final
