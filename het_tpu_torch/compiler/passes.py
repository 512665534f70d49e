"""Pass framework and analysis passes.

Reference: LLVM-style PassManager with prerequisite resolution and
invalidation (hrt/pyctor/transforms/pass_manager.py:16-68) and the
InterOpSSA passes — op sequencing, def-use analysis, value numbering,
worklist shape inference, binop realization
(hrt/pyctor/transforms/InterOpSSA/{value_numberer.py:44-113,
shape_inferer.py:9-62, binop_realizer.py:11-51}).  A copy of
``het_tpu/compiler/passes.py``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .ir import MATRIX, OP_DEFS, SCALAR, VECTOR, Op, Program, Var


@dataclass
class Pass:
    name: str
    run: Callable[[Program], None]
    prerequisites: Tuple[str, ...] = ()
    invalidates: Tuple[str, ...] = ()


class PassManager:
    """Runs passes resolving prerequisites; re-runs analyses a transform
    invalidated."""

    def __init__(self, passes: Sequence[Pass]):
        self.registry = {p.name: p for p in passes}
        self.valid: Set[str] = set()
        self.log: List[str] = []

    def run(self, prog: Program, names: Sequence[str]) -> None:
        for name in names:
            self._run_one(prog, name)

    def _run_one(self, prog: Program, name: str) -> None:
        p = self.registry[name]
        for pre in p.prerequisites:
            if pre not in self.valid:
                self._run_one(prog, pre)
        p.run(prog)
        self.log.append(name)
        self.valid.add(name)
        for inv in p.invalidates:
            self.valid.discard(inv)


# ------------------------------------------------------------- analyses


def ssa_rename(prog: Program) -> None:
    """Enforce single assignment: a redefinition of a live name (the
    frontend's accumulate-into-existing pattern, e.g. rgcn's raw_output)
    gets a versioned name ``_vN`` and subsequent reads follow it.  Without
    this, reverse-mode accumulates the pre- and post-redefinition deltas
    under one key and double-counts."""
    current: Dict[str, str] = {}
    version: Dict[str, int] = {}
    for op in prog.ops:
        op.inputs = {
            k: (
                Var(v.kind, current[v.name])
                if v.name in current and current[v.name] != v.name
                else v
            )
            for k, v in op.inputs.items()
        }
        new_out = []
        for o in op.outputs:
            if o.name in current:
                n = version.get(o.name, 1) + 1
                version[o.name] = n
                new_name = f"{o.name}_v{n}"
                current[o.name] = new_name
                o = Var(o.kind, new_name)
            else:
                current[o.name] = o.name
                version[o.name] = 1
            new_out.append(o)
        op.outputs = tuple(new_out)


def def_use(prog: Program) -> Dict[Tuple[str, str], List[int]]:
    """(kind, name) -> indices of ops that read it."""
    uses: Dict[Tuple[str, str], List[int]] = {}
    for i, op in enumerate(prog.ops):
        for v in op.inputs.values():
            uses.setdefault((v.kind, v.name), []).append(i)
    return uses


def value_number(prog: Program) -> None:
    """Discover program inputs and weights: variables read before any
    definition (reference ValueNumbererPass semantics)."""
    defined: Set[Tuple[str, str]] = set()
    inputs: List[Var] = []
    weights: List[Var] = []
    seen: Set[Tuple[str, str]] = set()
    for op in prog.ops:
        for v in op.inputs.values():
            key = (v.kind, v.name)
            # node-kind aliases: a SRCNODE/DSTNODE read of a NODEWISE or
            # DSTNODE definition is a gather of the same value
            alias_defined = key in defined or any(
                (k, v.name) in defined
                for k in ("NODEWISE", "DSTNODE", "SRCNODE")
            )
            if not alias_defined and key not in seen:
                seen.add(key)
                (weights if v.is_weight else inputs).append(v)
        for o in op.outputs:
            defined.add((o.kind, o.name))
    prog.inputs = inputs
    prog.weights = weights


def infer_shapes(prog: Program) -> None:
    """Worklist slice-type propagation.  Seeds: dense results are vectors,
    inner products scalars, outer products matrices; feature inputs default
    to vector, weights to matrix."""
    sh = prog.shapes
    for v in prog.inputs:
        sh.setdefault((v.kind, v.name), VECTOR)
    for v in prog.weights:
        sh.setdefault((v.kind, v.name), MATRIX)
    changed = True
    while changed:
        changed = False
        for op in prog.ops:
            d = OP_DEFS[op.kind]
            if d.result_slice is not None:
                st = d.result_slice
            else:
                first = next(iter(op.inputs.values()), None)
                st = sh.get((first.kind, first.name), VECTOR) if first else VECTOR
                # name-aliased lookup for gathered node reads
                if first is not None and (first.kind, first.name) not in sh:
                    for k in ("NODEWISE", "DSTNODE", "SRCNODE", "EDGEWISE"):
                        if (k, first.name) in sh:
                            st = sh[(k, first.name)]
                            break
            for o in op.outputs:
                if sh.get((o.kind, o.name)) != st:
                    sh[(o.kind, o.name)] = st
                    changed = True


def realize_binops(prog: Program) -> None:
    """UnrealizedAdd/Mul -> concrete ops using inferred slice types
    (reference BinopRealizerPass)."""
    sh = prog.shapes

    def slice_of(v: Var) -> str:
        if (v.kind, v.name) in sh:
            return sh[(v.kind, v.name)]
        for k in ("EDGEWISE", "NODEWISE", "DSTNODE", "SRCNODE"):
            if (k, v.name) in sh:
                return sh[(k, v.name)]
        return VECTOR

    for op in prog.ops:
        if op.kind == "UnrealizedAdd":
            st = slice_of(op.inputs["left"])
            op.kind = {
                SCALAR: "ScalarAdd",
                VECTOR: "VectorAdd",
                MATRIX: "MatrixAdd",
            }[st]
        elif op.kind == "UnrealizedMul":
            sl = slice_of(op.inputs["left"])
            sr = slice_of(op.inputs["right"])
            if SCALAR in (sl, sr) and VECTOR in (sl, sr):
                s, v = (
                    (op.inputs["left"], op.inputs["right"])
                    if sl == SCALAR
                    else (op.inputs["right"], op.inputs["left"])
                )
                op.kind = "EdgeScalarVectorMul"
                op.inputs = {"scalar": s, "vector": v}
            elif sl == SCALAR and sr == SCALAR:
                op.kind = "ScalarMultiply"
            else:
                op.kind = "EdgeInnerProduct"


def default_pipeline() -> PassManager:
    return PassManager(
        [
            Pass("ssa_rename", ssa_rename),
            Pass("value_number", value_number,
                 prerequisites=("ssa_rename",)),
            Pass("shape_inference", infer_shapes,
                 prerequisites=("value_number",)),
            Pass(
                "binop_realize",
                realize_binops,
                prerequisites=("shape_inference",),
                invalidates=("shape_inference",),
            ),
        ]
    )


def run_default(prog: Program, shape_hints: Optional[Dict[str, str]] = None
                ) -> Program:
    """``shape_hints``: variable name -> slice_type seeds.  The DSL has no
    shape syntax (the reference's lower() raises NotImplementedError at
    exactly this step — lower_to_InterOpSSA.py:26-29), so scalar-valued
    inputs like rgcn's ``norm_factor`` must be declared by the caller; the
    golden ``.inter-op-ssa`` Shape tables play this role in tests."""
    if shape_hints:
        from .ir import DATA_KINDS, WEIGHT_SLICES

        for name, st in shape_hints.items():
            for k in DATA_KINDS + WEIGHT_SLICES:
                prog.shapes.setdefault((k, name), st)
    default_pipeline().run(
        prog, ["value_number", "shape_inference", "binop_realize",
               "shape_inference"]
    )
    return prog
