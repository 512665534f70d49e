"""Inter-Op SSA IR: variables, operators, programs (a copy of
``het_tpu/compiler/ir.py``; the port imports nothing of het_tpu).

Re-design of the reference pyctor IR (hrt/pyctor/ir/InterOpSSA/
variables.py:6-158, operators.py:182-1401, programs.py:130-185).  The
reference models each operator as a class; here a single :class:`Op` record
plus a declarative ``OP_DEFS`` registry carries the same information
(operand names, result kinds, shape rules) with the execution and
differentiation rules attached — which is what lets the same table drive
serialization, shape inference, autodiff, and lowering to the port's ops.

Variable grammar matches the reference surface syntax:

* data variables: ``(EDGEWISE|SRCNODE|DSTNODE|NODEWISE|UNIQUE_NODE_ETYPE,
  "name")``
* weight variables: ``(name, EDGETYPE|NODETYPE|NONE)``
* suffix grammar ``_src/_dst/_delta/_term[0-9]/_tmp[0-9]/_transposed``
  (variables.py:109-158) is preserved by autodiff-generated names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DATA_KINDS = ("EDGEWISE", "SRCNODE", "DSTNODE", "NODEWISE", "UNIQUE_NODE_ETYPE")
WEIGHT_SLICES = ("EDGETYPE", "NODETYPE", "NONE")


@dataclass(frozen=True)
class Var:
    kind: str  # a DATA_KIND, or a WEIGHT_SLICE for weights
    name: str

    @property
    def is_weight(self) -> bool:
        return self.kind in WEIGHT_SLICES

    def __str__(self) -> str:
        if self.is_weight:
            return f"({self.name}, {self.kind})"
        return f'({self.kind}, "{self.name}")'

    @staticmethod
    def data(kind: str, name: str) -> "Var":
        assert kind in DATA_KINDS, kind
        return Var(kind, name)

    @staticmethod
    def weight(name: str, slice_: str = "EDGETYPE") -> "Var":
        assert slice_ in WEIGHT_SLICES, slice_
        return Var(slice_, name)


@dataclass
class Op:
    kind: str  # registry key, e.g. "NodeDense"
    inputs: Dict[str, Var]  # operand-name -> Var
    outputs: Tuple[Var, ...]
    attrs: Dict[str, object] = field(default_factory=dict)  # e.g. side=src

    @property
    def result(self) -> Var:
        assert len(self.outputs) == 1
        return self.outputs[0]

    def __str__(self) -> str:
        lhs = ", ".join(str(o) for o in self.outputs)
        args = ", ".join(f"{k} = {v}" for k, v in self.inputs.items())
        return f"{lhs} = {self.kind}({args});"


# --------------------------------------------------------------- registry

# slice_type lattice for shape inference (reference Shape.slice_type)
SCALAR, VECTOR, MATRIX = "scalar", "vector", "matrix"


@dataclass(frozen=True)
class OpDef:
    operands: Tuple[str, ...]  # canonical operand order
    # shape rule: (input slice_types...) -> output slice_type; None = same
    # as first operand
    result_slice: Optional[str] = None
    elementwise: bool = False  # pure per-element (safe in fusion regions)


OP_DEFS: Dict[str, OpDef] = {
    # typed linears (gather-GEMM): reference Node/EdgeDenseOp
    "NodeDense": OpDef(("input", "weight"), VECTOR),
    "EdgeDense": OpDef(("input", "weight"), VECTOR),
    "NodeLinear": OpDef(("weight", "input"), VECTOR),  # per-ntype linear
    "WeightDense": OpDef(("left", "right"), MATRIX),  # W @ W' (reordering)
    # movement / structure
    "Copy": OpDef(("input",)),
    "Concatenate": OpDef(("left", "right"), VECTOR),
    "Split": OpDef(("input",), VECTOR),
    "Transpose": OpDef(("input",), MATRIX),
    # products
    "EdgeInnerProduct": OpDef(("left", "right"), SCALAR),
    "EdgeOuterProduct": OpDef(("left", "right"), MATRIX),
    "NodeOuterProduct": OpDef(("left", "right"), MATRIX),
    "EdgeScalarVectorMul": OpDef(("scalar", "vector"), VECTOR),
    # elementwise unary
    "LeakyRelu": OpDef(("input",), elementwise=True),
    "Exponential": OpDef(("input",), elementwise=True),
    "Tanh": OpDef(("input",), elementwise=True),
    "Negative": OpDef(("input",), elementwise=True),
    # backward-marker unary (parsed for reference-file conformance; our
    # autodiff emits explicit primal-referencing forms instead)
    "InverseExponential": OpDef(("input",), elementwise=True),
    "InverseLeakyRelu": OpDef(("input",), elementwise=True),
    "InverseTanh": OpDef(("input",), elementwise=True),
    # explicit backward elementwise (ours)
    "GradLeakyRelu": OpDef(("delta", "primal"), elementwise=True),
    # elementwise binary
    "ScalarDivide": OpDef(("left", "right"), SCALAR, elementwise=True),
    "ScalarMultiply": OpDef(("left", "right"), SCALAR, elementwise=True),
    "ScalarAdd": OpDef(("left", "right"), SCALAR, elementwise=True),
    "VectorAdd": OpDef(("left", "right"), VECTOR, elementwise=True),
    "MatrixAdd": OpDef(("left", "right"), MATRIX, elementwise=True),
    # unrealized binops (realized after shape inference)
    "UnrealizedAdd": OpDef(("left", "right")),
    "UnrealizedMul": OpDef(("left", "right")),
    # aggregations
    "NodeSumAccumulation": OpDef(("input",)),
    "EdgeTypeSumAccumulation": OpDef(("input",)),
    "NodeTypeSumAccumulation": OpDef(("input",)),
    # sum over every row (dW of an unsliced weight)
    "RowSumAccumulation": OpDef(("input",)),
    # compact materialization (ours; reference realizes it in kernels)
    "CompactDense": OpDef(("input", "weight"), VECTOR),
    "ExpandCompact": OpDef(("input",)),
}


@dataclass
class Program:
    ops: List[Op] = field(default_factory=list)
    # (kind, name) -> slice_type; filled by shape inference or parsed from
    # the SHAPE section
    shapes: Dict[Tuple[str, str], str] = field(default_factory=dict)
    # declared graph inputs / weights (discovered by value numbering)
    inputs: List[Var] = field(default_factory=list)
    weights: List[Var] = field(default_factory=list)

    def producers(self) -> Dict[Tuple[str, str], Op]:
        out = {}
        for op in self.ops:
            for o in op.outputs:
                out[(o.kind, o.name)] = op
        return out

    def validate(self) -> None:
        for op in self.ops:
            assert op.kind in OP_DEFS, f"unknown op kind {op.kind}"

    def __str__(self) -> str:
        return "\n".join(str(op) for op in self.ops)
