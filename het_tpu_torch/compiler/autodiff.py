"""Reverse-mode autodiff over Inter-Op SSA programs.

The reference designed this (``Program.differentiate`` +
per-op ``differentiate()``, hrt/pyctor/ir/InterOpSSA/programs.py:174-185)
but left most op rules and the ``auto_differer`` pass as stubs
(operators.py:346-347, transforms/InterOpSSA/auto_differer.py); the
hand-written ``.bck.inter-op-ssa`` goldens document the intended output.
This module implements the rules for real, following the goldens' naming
grammar (``_delta``, ``_termN`` for summed contributions) but emitting
explicit primal-referencing gradient ops (e.g. ``ScalarMultiply(delta,
exp_primal)``) instead of the goldens' ``Inverse*`` markers, so the result
is executable; numerical validation is against ``torch.autograd`` of the
compiled forward closure (tests/test_torch_compiler.py).  A copy of
``het_tpu/compiler/autodiff.py``."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .ir import Op, Program, Var

NODE_KINDS = ("NODEWISE", "DSTNODE", "SRCNODE")


def _ckey(var: Var) -> Tuple[str, str]:
    """Canonical contribution key: SRCNODE/DSTNODE/NODEWISE reads of the
    same name are gathers of one node-space value, so their gradient
    contributions must merge (a dst-side read's delta is not a different
    variable's delta)."""
    kind = "NODE" if var.kind in NODE_KINDS else var.kind
    return (kind, var.name)


class _Diff:
    def __init__(self, fwd: Program):
        self.fwd = fwd
        self.bck = Program()
        # canonical key -> list of delta-contribution Vars
        self.contribs: Dict[Tuple[str, str], List[Var]] = {}
        self.tmp_n = 0

    def tmp(self, base: str) -> str:
        self.tmp_n += 1
        return f"{base}_tmp{self.tmp_n}"

    def emit(self, kind: str, inputs: Dict[str, Var], out: Var,
             **attrs) -> Var:
        self.bck.ops.append(Op(kind, inputs, (out,), dict(attrs)))
        return out

    def add_contrib(self, var: Var, delta: Var) -> None:
        self.contribs.setdefault(_ckey(var), []).append(delta)

    def delta_of(self, var: Var) -> Var:
        """Finalized delta for a forward variable (summing contributions)."""
        key = _ckey(var)
        cs = self.contribs.get(key, [])
        assert cs, f"no gradient flows into {var}"
        if len(cs) == 1:
            return cs[0]
        acc = cs[0]
        for i, c in enumerate(cs[1:], start=2):
            kind = "MatrixAdd" if var.is_weight else "VectorAdd"
            nxt = Var(acc.kind, f"{var.name}_delta_acc{i}")
            self.emit(kind, {"left": acc, "right": c}, nxt)
            acc = nxt
        self.contribs[key] = [acc]
        return acc

    def has_delta(self, var: Var) -> bool:
        return bool(self.contribs.get(_ckey(var)))


def _edge_delta(name: str, term: int = 0) -> Var:
    suffix = f"_term{term}" if term else ""
    return Var("EDGEWISE", f"{name}_delta{suffix}")


def differentiate(fwd: Program, outputs=None) -> Program:
    """Build the backward program.  Seeds: for every program output ``y``
    an input ``(same-kind, y_delta)``; results: ``x_delta`` for every
    forward input / weight that gradient reaches."""
    d = _Diff(fwd)
    produced = fwd.producers()
    if outputs is None:
        read = {v.name for op in fwd.ops for v in op.inputs.values()}
        outputs = [
            o for op in fwd.ops for o in op.outputs if o.name not in read
        ]
    for o in outputs:
        seed = Var(o.kind, f"{o.name}_delta")
        d.add_contrib(o, seed)
        d.bck.inputs.append(seed)

    term_count: Dict[str, int] = {}

    def fresh(var: Var, kind_override: str = None) -> Var:
        # always _termN (even the first): the finalization Copy below
        # writes the bare `{name}_delta`, which must stay unassigned until
        # then (a collision would be SSA-renamed and readers of the
        # canonical delta name would silently get only the first term)
        n = term_count.get(var.name, 0) + 1
        term_count[var.name] = n
        kind = kind_override or var.kind
        return Var(kind, f"{var.name}_delta_term{n}")

    for op in reversed(fwd.ops):
        out = op.outputs[0]
        if not any(d.has_delta(o) for o in op.outputs):
            continue
        k = op.kind
        if k in ("NodeDense", "EdgeDense", "CompactDense"):
            dy = d.delta_of(out)
            x, w = op.inputs["input"], op.inputs["weight"]
            wt = Var(w.kind, f"{w.name}_transposed")
            d.emit("Transpose", {"input": w}, wt)
            # Edge-mediated dense (typed weight or per-edge output):
            # dX = dY @ W^T edge-wise, then accumulate into x's space.
            # Node-space dense (unsliced weight, node output — e.g. rgcn's
            # W0 self-loop): backward stays in node space — routing it
            # through edges would scale the gradient by node degree.
            edge_mediated = (
                out.kind in ("EDGEWISE", "UNIQUE_NODE_ETYPE")
                or w.kind == "EDGETYPE"
            )
            if edge_mediated:
                dx_e = Var("EDGEWISE", d.tmp(f"{x.name}_delta"))
                d.emit("EdgeDense", {"input": dy, "weight": wt}, dx_e)
                if x.kind in NODE_KINDS:
                    dx = fresh(x)
                    d.emit("NodeSumAccumulation", {"input": dx_e}, dx)
                    d.add_contrib(x, dx)
                else:
                    d.add_contrib(x, dx_e)
            else:
                dx = fresh(x)
                d.emit("NodeDense", {"input": dy, "weight": wt}, dx)
                d.add_contrib(x, dx)
            # dW = sum x (outer) dy over the op's row space
            if w.kind in ("EDGETYPE", "NODETYPE"):
                t = Var("EDGEWISE", d.tmp(f"{w.name}_delta"))
                d.emit("EdgeOuterProduct", {"left": x, "right": dy}, t)
                dw = fresh(w)
                acc = (
                    "EdgeTypeSumAccumulation"
                    if w.kind == "EDGETYPE"
                    else "NodeTypeSumAccumulation"
                )
                d.emit(acc, {"input": t}, dw)
                d.add_contrib(w, dw)
            else:
                outer = (
                    "EdgeOuterProduct"
                    if edge_mediated
                    else "NodeOuterProduct"
                )
                space = "EDGEWISE" if edge_mediated else out.kind
                t = Var(space, d.tmp(f"{w.name}_delta"))
                d.emit(outer, {"left": x, "right": dy}, t)
                dw = fresh(w)
                d.emit("RowSumAccumulation", {"input": t}, dw)
                d.add_contrib(w, dw)
            continue
        if k == "NodeLinear":
            dy = d.delta_of(out)
            x, w = op.inputs["input"], op.inputs["weight"]
            wt = Var(w.kind, f"{w.name}_transposed")
            d.emit("Transpose", {"input": w}, wt)
            dx = fresh(x)
            d.emit("NodeLinear", {"weight": wt, "input": dy}, dx)
            d.add_contrib(x, dx)
            t = Var("NODEWISE", d.tmp(f"{w.name}_delta"))
            d.emit("NodeOuterProduct", {"left": x, "right": dy}, t)
            dw = fresh(w)
            d.emit("NodeTypeSumAccumulation", {"input": t}, dw)
            d.add_contrib(w, dw)
            continue
        if k == "NodeSumAccumulation":
            ds = d.delta_of(out)
            v = op.inputs["input"]
            dv = fresh(v, "EDGEWISE")
            d.emit("Copy", {"input": ds}, dv)  # node delta gathered per edge
            d.add_contrib(v, dv)
            continue
        if k == "EdgeTypeSumAccumulation":
            dw = d.delta_of(out)
            v = op.inputs["input"]
            dv = fresh(v, "EDGEWISE")
            d.emit("Copy", {"input": dw}, dv)  # weight delta per edge
            d.add_contrib(v, dv)
            continue
        if k == "EdgeInnerProduct":
            ds = d.delta_of(out)
            l, r = op.inputs["left"], op.inputs["right"]
            for a, b in ((l, r), (r, l)):
                t = Var("EDGEWISE", d.tmp(f"{a.name}_delta"))
                d.emit(
                    "EdgeScalarVectorMul", {"scalar": ds, "vector": b}, t
                )
                if a.is_weight:
                    da = fresh(a)
                    d.emit("EdgeTypeSumAccumulation", {"input": t}, da)
                    d.add_contrib(a, da)
                elif a.kind in NODE_KINDS:
                    da = fresh(a)
                    d.emit("NodeSumAccumulation", {"input": t}, da)
                    d.add_contrib(a, da)
                else:
                    d.add_contrib(a, t)
            continue
        if k == "EdgeScalarVectorMul":
            dy = d.delta_of(out)
            s, v = op.inputs["scalar"], op.inputs["vector"]
            ds = fresh(s, "EDGEWISE")
            d.emit("EdgeInnerProduct", {"left": dy, "right": v}, ds)
            d.add_contrib(s, ds)
            dv = Var("EDGEWISE", d.tmp(f"{v.name}_delta"))
            d.emit("EdgeScalarVectorMul", {"scalar": s, "vector": dy}, dv)
            if v.kind in NODE_KINDS:
                dvn = fresh(v)
                d.emit("NodeSumAccumulation", {"input": dv}, dvn)
                d.add_contrib(v, dvn)
            else:
                d.add_contrib(v, dv)
            continue
        if k == "ScalarDivide":
            dy = d.delta_of(out)
            a, b = op.inputs["left"], op.inputs["right"]
            da_e = Var("EDGEWISE", d.tmp(f"{a.name}_delta"))
            d.emit("ScalarDivide", {"left": dy, "right": b}, da_e)
            d.add_contrib(a, da_e)
            # db = -dy * y / b
            t1 = Var("EDGEWISE", d.tmp(f"{b.name}_delta"))
            d.emit("ScalarDivide", {"left": out, "right": b}, t1)
            t2 = Var("EDGEWISE", d.tmp(f"{b.name}_delta"))
            d.emit("ScalarMultiply", {"left": dy, "right": t1}, t2)
            t3 = Var("EDGEWISE", d.tmp(f"{b.name}_delta"))
            d.emit("Negative", {"input": t2}, t3)
            if b.kind in NODE_KINDS:
                db = fresh(b)
                d.emit("NodeSumAccumulation", {"input": t3}, db)
                d.add_contrib(b, db)
            else:
                d.add_contrib(b, t3)
            continue
        if k in ("ScalarAdd", "VectorAdd", "MatrixAdd"):
            dy = d.delta_of(out)
            for a in (op.inputs["left"], op.inputs["right"]):
                if a.kind in NODE_KINDS and out.kind == "EDGEWISE":
                    da = fresh(a)
                    d.emit("NodeSumAccumulation", {"input": dy}, da)
                    d.add_contrib(a, da)
                else:
                    d.add_contrib(a, dy)
            continue
        if k == "ScalarMultiply":
            dy = d.delta_of(out)
            a, b = op.inputs["left"], op.inputs["right"]
            for x1, x2 in ((a, b), (b, a)):
                t = Var("EDGEWISE", d.tmp(f"{x1.name}_delta"))
                d.emit("ScalarMultiply", {"left": dy, "right": x2}, t)
                if x1.kind in NODE_KINDS:
                    dx = fresh(x1)
                    d.emit("NodeSumAccumulation", {"input": t}, dx)
                    d.add_contrib(x1, dx)
                else:
                    d.add_contrib(x1, t)
            continue
        if k == "LeakyRelu":
            dy = d.delta_of(out)
            x = op.inputs["input"]
            dx = fresh(x, "EDGEWISE")
            d.emit("GradLeakyRelu", {"delta": dy, "primal": x}, dx)
            d.add_contrib(x, dx)
            continue
        if k == "Exponential":
            dy = d.delta_of(out)
            x = op.inputs["input"]
            dx = fresh(x, "EDGEWISE")
            d.emit("ScalarMultiply", {"left": dy, "right": out}, dx)
            d.add_contrib(x, dx)
            continue
        if k == "Tanh":
            dy = d.delta_of(out)
            x = op.inputs["input"]
            t1 = Var(out.kind, d.tmp(f"{x.name}_delta"))
            d.emit("ScalarMultiply", {"left": out, "right": out}, t1)
            t2 = Var(out.kind, d.tmp(f"{x.name}_delta"))
            d.emit("ScalarMultiply", {"left": dy, "right": t1}, t2)
            t3 = Var(out.kind, d.tmp(f"{x.name}_delta"))
            d.emit("Negative", {"input": t2}, t3)
            dx = fresh(x, out.kind)
            d.emit("ScalarAdd", {"left": dy, "right": t3}, dx)
            d.add_contrib(x, dx)
            continue
        if k == "Negative":
            dy = d.delta_of(out)
            x = op.inputs["input"]
            dx = fresh(x, out.kind)
            d.emit("Negative", {"input": dy}, dx)
            d.add_contrib(x, dx)
            continue
        if k == "Copy":
            dy = d.delta_of(out)
            x = op.inputs["input"]
            if x.kind in NODE_KINDS:
                dx = fresh(x)
                d.emit("NodeSumAccumulation", {"input": dy}, dx)
                d.add_contrib(x, dx)
            else:
                d.add_contrib(x, dy)
            continue
        if k == "Concatenate":
            dy = d.delta_of(out)
            l, r = op.inputs["left"], op.inputs["right"]
            dl = fresh(l, "EDGEWISE")
            dr = fresh(r, "EDGEWISE")
            d.bck.ops.append(Op("Split", {"input": dy}, (dl, dr)))
            for a, da in ((l, dl), (r, dr)):
                if a.is_weight:
                    daw = fresh(a)
                    d.emit("EdgeTypeSumAccumulation", {"input": da}, daw)
                    d.add_contrib(a, daw)
                elif a.kind in NODE_KINDS:
                    dan = fresh(a)
                    d.emit("NodeSumAccumulation", {"input": da}, dan)
                    d.add_contrib(a, dan)
                else:
                    d.add_contrib(a, da)
            continue
        if k == "Transpose":
            dy = d.delta_of(out)
            x = op.inputs["input"]
            dx = fresh(x)
            d.emit("Transpose", {"input": dy}, dx)
            d.add_contrib(x, dx)
            continue
        if k == "WeightDense":
            dy = d.delta_of(out)
            l, r = op.inputs["left"], op.inputs["right"]
            rt = Var(r.kind, f"{r.name}_transposed")
            d.emit("Transpose", {"input": r}, rt)
            dl = fresh(l)
            d.emit("WeightDense", {"left": dy, "right": rt}, dl)
            d.add_contrib(l, dl)
            lt = Var(l.kind, f"{l.name}_transposed")
            d.emit("Transpose", {"input": l}, lt)
            dr = fresh(r)
            d.emit("WeightDense", {"left": lt, "right": dy}, dr)
            d.add_contrib(r, dr)
            continue
        raise NotImplementedError(f"no gradient rule for {k}")

    # finalize deltas of forward inputs/weights under canonical names
    for v in list(fwd.inputs) + list(fwd.weights):
        if d.has_delta(v):
            final = d.delta_of(v)
            want = Var(final.kind, f"{v.name}_delta")
            if final.name != want.name:
                d.emit("Copy", {"input": final}, want)
    return d.bck
