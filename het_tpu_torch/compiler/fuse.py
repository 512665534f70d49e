"""Operator fusion pass.

The reference designed fusion containers (``TraversalFusedOp`` /
``GEMMFusedOp``, hrt/pyctor/ir/InterOpSSA/operators.py:1350-1401) but left
``OpFuserPass.run`` an empty stub (transforms/InterOpSSA/op_fuser.py:26-29).
Elementwise chains are cheap to leave apart; the fusion that actually
matters is the **edge-softmax-aggregate motif** — the one place where the
unfused form forces multiple HBM round trips over per-edge tensors and a
separate denominator reduction.  This pass pattern-matches the motif

    z    = Exponential(logits)
    s    = NodeSumAccumulation(z)
    attn = ScalarDivide(z, s)
    t    = EdgeScalarVectorMul(attn, msg)
    out  = NodeSumAccumulation(t)

and rewrites it into one ``FusedEdgeSoftmaxAgg(logits, msg)`` op, which the
lowering executes with the port's fused softmax aggregation
(``ops.edge_softmax_weighted_sum``: numerator and denominator from one
pass over the edges, each summed by the sorted segment sum).

A copy of ``het_tpu/compiler/fuse.py``, but for one check that
:func:`fuse_packed_projection` adds: it skips a pair whose projection is
read between the producer and the inner product, or whose producer an
earlier pair already took."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .ir import OP_DEFS, Op, OpDef, Program, Var

OP_DEFS.setdefault(
    "FusedEdgeSoftmaxAgg", OpDef(("logits", "msg"), None)
)


def _use_counts(prog: Program) -> Dict[Tuple[str, str], int]:
    uses: Dict[Tuple[str, str], int] = {}
    for op in prog.ops:
        for v in op.inputs.values():
            uses[(v.kind, v.name)] = uses.get((v.kind, v.name), 0) + 1
    return uses


def fuse_edge_softmax(prog: Program) -> int:
    """Apply the edge-softmax-aggregate fusion; returns rewrites applied."""
    producers = prog.producers()
    uses = _use_counts(prog)
    fused = 0
    remove: set = set()
    replacements: List[Tuple[Op, Op]] = []

    for op in prog.ops:
        # anchor on the final aggregation
        if op.kind != "NodeSumAccumulation":
            continue
        t = producers.get(
            (op.inputs["input"].kind, op.inputs["input"].name)
        )
        if t is None or t.kind != "EdgeScalarVectorMul":
            continue
        attn = producers.get(
            (t.inputs["scalar"].kind, t.inputs["scalar"].name)
        )
        if attn is None or attn.kind != "ScalarDivide":
            continue
        z_var = attn.inputs["left"]
        s_var = attn.inputs["right"]
        z = producers.get((z_var.kind, z_var.name))
        s = producers.get((s_var.kind, s_var.name))
        if z is None or z.kind != "Exponential":
            continue
        if s is None or s.kind != "NodeSumAccumulation":
            continue
        sz = s.inputs["input"]
        if (sz.kind, sz.name) != (z_var.kind, z_var.name):
            continue
        # the softmax intermediates must have no other consumers
        if uses.get((z_var.kind, z_var.name), 0) > 2:  # s-sum + divide
            continue
        if uses.get((s_var.kind, s_var.name), 0) > 1:
            continue
        logits = z.inputs["input"]
        msg = t.inputs["vector"]
        replacements.append(
            (
                op,
                Op(
                    "FusedEdgeSoftmaxAgg",
                    {"logits": logits, "msg": msg},
                    op.outputs,
                ),
            )
        )
        for dead in (t, attn, z, s):
            remove.add(id(dead))
        fused += 1

    if fused:
        rep = {id(old): new for old, new in replacements}
        prog.ops = [
            rep.get(id(o), o) for o in prog.ops if id(o) not in remove
        ]
    return fused


OP_DEFS.setdefault(
    "FusedEdgeSoftmaxAggCompact", OpDef(("logits", "msg"), None)
)


def fuse_compact_agg(prog: Program) -> int:
    """Sink a source-side compact expansion INTO the fused aggregation:

        FusedEdgeSoftmaxAgg(logits, msg=ExpandCompact(msg_c, side=src))
        -> FusedEdgeSoftmaxAggCompact(logits, msg_c)

    when the expanded per-edge message has no other consumer.  This is
    the compiler-side counterpart of the hand-written models' single-
    sided compact aggregation (the reference's ``..._compact_as_of_node_
    separate_coo_single_sided`` kernels): the per-edge message tensor
    never materializes."""
    producers = prog.producers()
    uses = _use_counts(prog)
    fused = 0
    remove: set = set()
    replacements: List[Tuple[Op, Op]] = []
    for op in prog.ops:
        if op.kind != "FusedEdgeSoftmaxAgg":
            continue
        msg = op.inputs["msg"]
        exp = producers.get((msg.kind, msg.name))
        if (
            exp is None
            or exp.kind != "ExpandCompact"
            or exp.attrs.get("side", "src") != "src"
            or uses.get((msg.kind, msg.name), 0) > 1
        ):
            continue
        replacements.append(
            (
                op,
                Op(
                    "FusedEdgeSoftmaxAggCompact",
                    {
                        "logits": op.inputs["logits"],
                        "msg": exp.inputs["input"],
                    },
                    op.outputs,
                ),
            )
        )
        remove.add(id(exp))
        fused += 1
    if fused:
        rep = {id(old): new for old, new in replacements}
        prog.ops = [
            rep.get(id(o), o) for o in prog.ops if id(o) not in remove
        ]
    return fused


OP_DEFS.setdefault(
    "FusedGatCompact", OpDef(("el", "er", "msg"), None)
)


def fuse_compact_gat(prog: Program) -> int:
    """Fuse the fully-compact GAT motif into one op — the compiler-side
    equivalent of the hand-written models' ``relational_fused_gat_compact``
    (logits AND messages stay on compact rows; per-edge tensors never
    materialize in either direction):

        FusedEdgeSoftmaxAgg(
            logits=LeakyRelu(ScalarAdd(Expand(el_c, src),
                                       Expand(er_c, dst))),
            msg=Expand(msg_c, src))
        -> FusedGatCompact(el_c, er_c, msg_c)
    """
    producers = prog.producers()
    uses = _use_counts(prog)

    def sole_expand(v: Var, side: str):
        p = producers.get((v.kind, v.name))
        if (
            p is not None
            and p.kind == "ExpandCompact"
            and p.attrs.get("side", "src") == side
            and uses.get((v.kind, v.name), 0) == 1
        ):
            return p
        return None

    fused = 0
    remove: set = set()
    replacements: List[Tuple[Op, Op]] = []
    for op in prog.ops:
        if op.kind != "FusedEdgeSoftmaxAgg":
            continue
        mexp = sole_expand(op.inputs["msg"], "src")
        if mexp is None:
            continue
        lr = producers.get(
            (op.inputs["logits"].kind, op.inputs["logits"].name)
        )
        if (
            lr is None or lr.kind != "LeakyRelu"
            or uses.get((op.inputs["logits"].kind,
                         op.inputs["logits"].name), 0) > 1
        ):
            continue
        add = producers.get(
            (lr.inputs["input"].kind, lr.inputs["input"].name)
        )
        if (
            add is None or add.kind != "ScalarAdd"
            or uses.get((lr.inputs["input"].kind,
                         lr.inputs["input"].name), 0) > 1
        ):
            continue
        lexp = sole_expand(add.inputs["left"], "src")
        rexp = sole_expand(add.inputs["right"], "dst")
        if lexp is None and rexp is None:
            # also accept swapped operand order
            lexp = sole_expand(add.inputs["right"], "src")
            rexp = sole_expand(add.inputs["left"], "dst")
        if lexp is None or rexp is None:
            continue
        replacements.append(
            (
                op,
                Op(
                    "FusedGatCompact",
                    {
                        "el": lexp.inputs["input"],
                        "er": rexp.inputs["input"],
                        "msg": mexp.inputs["input"],
                    },
                    op.outputs,
                    {"slope": lr.attrs.get("slope", 0.2)},
                ),
            )
        )
        for dead in (mexp, lr, add, lexp, rexp):
            remove.add(id(dead))
        fused += 1
    if fused:
        rep = {id(old): new for old, new in replacements}
        prog.ops = [
            rep.get(id(o), o) for o in prog.ops if id(o) not in remove
        ]
    return fused


OP_DEFS.setdefault("WeightPackColumn", OpDef(("vec", "mat"), None))
OP_DEFS.setdefault("SplitFirstColumn", OpDef(("input",), None))


def fuse_packed_projection(prog: Program) -> int:
    """Multi-output GEMM fusion: fold a projected-feature inner product
    into the projection matmul's output columns —

        zc = CompactDense(x, W)           # (U, D)
        el = EdgeInnerProduct(zc, a)      # (U,)   compact SDDMM
        ->
        wa   = WeightDense(W, a)          # (R, K)   W @ a per relation
        wcat = WeightPackColumn(wa, W)    # (R, K, 1+D)
        pk   = CompactDense(x, wcat)      # (U, 1+D)
        el, zc = SplitFirstColumn(pk)

    — ONE segment matmul + row gather instead of two passes over the
    compact rows.  This is the hand-written models' packed ``w_cat``
    projection (``models/rgat.py``, the compact multiply-first branch).

    A pair is skipped where an op between the producer and the inner
    product reads the projection (the fused pair defines it only at the
    inner product's place), or where an earlier pair already took the
    producer (a second pair would define the projection twice)."""
    producers = prog.producers()
    position = {id(op): i for i, op in enumerate(prog.ops)}
    fused = 0
    remove: set = set()
    insert_after: List[Tuple[int, List[Op]]] = []

    def read_between(first: int, last: int, name: str) -> bool:
        """Whether an op strictly between positions ``first`` and ``last``
        reads ``name``: the fused pair defines it only at ``last``."""
        return any(v.name == name for op in prog.ops[first + 1:last]
                   for v in op.inputs.values())

    for pos, ip in enumerate(prog.ops):
        if ip.kind != "EdgeInnerProduct" or not ip.attrs.get("compact"):
            continue
        zc_var = ip.inputs["left"]
        a_var = ip.inputs["right"]
        if not (a_var.is_weight and a_var.kind == "EDGETYPE"):
            continue
        cd = producers.get((zc_var.kind, zc_var.name))
        if (
            cd is None
            or cd.kind != "CompactDense"
            or cd.attrs.get("side", "src") != ip.attrs.get("side", "src")
        ):
            continue
        w_var = cd.inputs["weight"]
        if not (w_var.is_weight and w_var.kind == "EDGETYPE"):
            continue
        # het_tpu fuses these two pairs too and breaks the program: a
        # read of the projection before the pair's new definition, or a
        # second definition of it from a producer already taken
        if id(cd) in remove or read_between(position[id(cd)], pos,
                                            zc_var.name):
            continue
        el_var = ip.outputs[0]
        wa = Var.weight(f"{w_var.name}_{a_var.name}_packfused", "EDGETYPE")
        wcat = Var.weight(f"{w_var.name}_packcat_{a_var.name}", "EDGETYPE")
        pk = Var.data(zc_var.kind, f"{zc_var.name}_packed")
        new_ops = [
            Op("WeightDense", {"left": w_var, "right": a_var}, (wa,)),
            Op("WeightPackColumn", {"vec": wa, "mat": w_var}, (wcat,)),
            Op(
                "CompactDense",
                {"input": cd.inputs["input"], "weight": wcat},
                (pk,),
                dict(cd.attrs),
            ),
            Op("SplitFirstColumn", {"input": pk}, (el_var, zc_var)),
        ]
        insert_after.append((pos, new_ops))
        remove.add(id(cd))
        remove.add(id(ip))
        fused += 1

    if fused:
        out_ops: List[Op] = []
        ins = dict()
        for pos, new_ops in insert_after:
            ins[pos] = new_ops
        for pos, o in enumerate(prog.ops):
            if pos in ins:
                out_ops.extend(ins[pos])
            if id(o) not in remove:
                out_ops.append(o)
        prog.ops = out_ops
    return fused
