"""Op-Spec SSA: the schedule level of the compiler.

The reference defines a second, lower IR level in which every Inter-Op SSA
op carries an explicit *schedule*: traversal ops get a loop-nest spec
(loop variable/bounds/step, scalar temporaries, per-op entries with
broadcast sources and accumulation sinks) and a type1/type2 grid mapping,
GEMM ops get tile sizes and gather/scatter access functions
(hrt/pyctor/ir/OpSpecSSA/op_specs.py:27-232, worked goldens in
hrt/pyctor/examples/op-spec-ssa/*.op-spec-ssa).  The reference parses this
format but never produces it from Inter-Op SSA (lower_to_OpSpecSSA.py is a
one-line stub).

This module implements the level for real, twice over:

* :func:`parse_opspec_ssa` / :func:`dumps_opspec` — round-trip of the
  reference text format, with the 8 reference golden files as conformance
  inputs (tests/test_compiler.py).
* :func:`schedule_program` — the lowering pass the reference stubbed:
  maps an analyzed Inter-Op SSA program to op specs with **reified GPU
  schedules**.  The loop-spec dialect is kept field for field as
  ``het_tpu/compiler/opspec.py`` writes it (it describes the abstract
  iteration space), and each spec additionally carries, in its ``gpu``
  dict, the port's op and plan that the lowering executes: for a GEMM
  ``segment_matmul`` on host offsets (one ``torch.matmul`` a relation) or
  on device offsets (the segment-matmul kernels, one launch over all
  relations), for an accumulation the sorted segment sum
  (``seg_sum_sorted``), for the fused softmax aggregation its packing.
  type1/type2 keep the reference's meaning — scalar-payload edge/node
  loops vs feature-parallel loops.

A copy of ``het_tpu/compiler/opspec.py`` whose ``tpu`` schedule dict (TPU
tile, block and chunk sizes) became the ``gpu`` dict.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from .ir import OP_DEFS, Op, Program, Var
from .serialize import _extract_section, _strip_comments, loads as load_ssa

# ---------------------------------------------------------------- specs


@dataclass
class SimpleSpec:
    """One operation inside a traversal loop body."""

    op: str  # "expf", "sum", "divide", "mul", ...
    inputs: List[List[str]]
    output: List[str]
    op_type: Optional[Union[str, Dict[str, str]]] = None
    broadcast: Optional[Dict[str, str]] = None

    def to_dict(self) -> dict:
        d: dict = {
            "op": self.op,
            "inputs": self.inputs,
            "output": self.output,
        }
        if self.op_type is not None:
            d["op_type"] = self.op_type
        if self.broadcast is not None:
            d["broadcast"] = self.broadcast
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SimpleSpec":
        return cls(
            op=d["op"],
            inputs=d["inputs"],
            output=d["output"],
            op_type=d.get("op_type"),
            broadcast=d.get("broadcast"),
        )


@dataclass
class LoopSpec:
    """A loop level of a traversal body (reference TraversalLoopOpSpec)."""

    loop_variable: str
    loop_begin: str
    loop_end: str
    loop_step: str
    loop_scalar_tmps: List[List[str]] = field(default_factory=list)
    operators: List[Union["LoopSpec", SimpleSpec]] = field(
        default_factory=list
    )

    def to_dict(self) -> dict:
        return {
            "loop_variable": self.loop_variable,
            "loop_begin": self.loop_begin,
            "loop_end": self.loop_end,
            "loop_step": self.loop_step,
            "loop_scalar_tmps": self.loop_scalar_tmps,
            "operators": _operators_dict(self.operators),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LoopSpec":
        return cls(
            loop_variable=d["loop_variable"],
            loop_begin=d["loop_begin"],
            loop_end=d["loop_end"],
            loop_step=d["loop_step"],
            loop_scalar_tmps=d.get("loop_scalar_tmps", []),
            operators=_operators_list(d["operators"]),
        )


def _operators_dict(operators) -> dict:
    out = {}
    for i, o in enumerate(operators):
        tag = "loop" if isinstance(o, LoopSpec) else "op"
        out[f"{i + 1}:{tag}"] = o.to_dict()
    return out


def _operators_list(d: dict) -> list:
    items = sorted(d.items(), key=lambda kv: int(kv[0].split(":")[0]))
    out = []
    for key, body in items:
        if key.split(":")[1] == "loop":
            out.append(LoopSpec.from_dict(body))
        else:
            out.append(SimpleSpec.from_dict(body))
    return out


@dataclass
class TraversalSpec:
    """Schedule of one (possibly fused) traversal op."""

    op_idx: int
    inputs: List[List[str]]
    outputs: List[List[str]]
    schedule: str  # "type1" | "type2"
    operators: List[Union[LoopSpec, SimpleSpec]]
    # reified GPU schedule (ours; absent when parsed from reference files)
    gpu: Optional[dict] = None

    def to_dict(self) -> dict:
        d: dict = {
            "inputs": self.inputs,
            "outputs": self.outputs,
            "schedule": self.schedule,
            "operators": _operators_dict(self.operators),
        }
        if self.gpu is not None:
            d["gpu"] = self.gpu
        return d

    @classmethod
    def from_dict(cls, d: dict, op_idx: int) -> "TraversalSpec":
        return cls(
            op_idx=d.get("op_idx", op_idx),
            inputs=d["inputs"],
            outputs=(
                d["outputs"]
                if d["outputs"] and isinstance(d["outputs"][0], list)
                else [d["outputs"]]
            ),
            schedule=d["schedule"],
            operators=_operators_list(d["operators"]),
            gpu=d.get("gpu"),
        )

    def to_string(self) -> str:
        return (
            f"traversal_{self.op_idx}{{\n"
            + json.dumps(self.to_dict(), indent=2)
            + "\n}"
        )


@dataclass
class GEMMSpec:
    """Schedule of one gather-GEMM-scatter op."""

    op_idx: int
    left: List[str]
    right: List[str]
    product: List[str]
    schedule: dict  # {"tile_sz": ...}
    access: dict  # {"left": [...], "right": [...], "product": [...]}
    edgewise_use_compaction: dict = field(default_factory=dict)
    gpu: Optional[dict] = None

    def to_dict(self) -> dict:
        d: dict = {
            "left": self.left,
            "right": self.right,
            "product": self.product,
            "schedule": self.schedule,
            "access": self.access,
        }
        if self.edgewise_use_compaction:
            d["edgewise_use_compaction"] = self.edgewise_use_compaction
        if self.gpu is not None:
            d["gpu"] = self.gpu
        return d

    @classmethod
    def from_dict(cls, d: dict, op_idx: int) -> "GEMMSpec":
        return cls(
            op_idx=d.get("op_idx", op_idx),
            left=d["left"],
            right=d["right"],
            product=d["product"],
            schedule=d["schedule"],
            access=d["access"],
            edgewise_use_compaction=d.get("edgewise_use_compaction", {}),
            gpu=d.get("gpu"),
        )

    def to_string(self) -> str:
        return (
            f"gemm_{self.op_idx}{{\n"
            + json.dumps(self.to_dict(), indent=2)
            + "\n}"
        )


@dataclass
class OpSpecProgram:
    """DAG (Inter-Op SSA level) + per-op schedule specs."""

    dag: Program
    specs: List[Union[TraversalSpec, GEMMSpec]]

    def traversals(self) -> List[TraversalSpec]:
        return [s for s in self.specs if isinstance(s, TraversalSpec)]

    def gemms(self) -> List[GEMMSpec]:
        return [s for s in self.specs if isinstance(s, GEMMSpec)]


# ---------------------------------------------------------------- parsing

_SPEC_HEAD_RE = re.compile(r"(traversal|gemm)_(\d+)\s*\{")


def _find_matching(text: str, start: int) -> int:
    depth, i = 1, start
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return i - 1


def parse_opspec_ssa(text: str) -> OpSpecProgram:
    """Parse a reference ``.op-spec-ssa`` document: VARIABLETABLE + DAG
    (Inter-Op SSA statements) + OPSPEC (per-op JSON schedules)."""
    clean = _strip_comments(text)
    dag = load_ssa(clean)  # tolerant: parses DAG + Shape table
    opspec = _extract_section(clean, "OPSPEC")
    specs: List[Union[TraversalSpec, GEMMSpec]] = []
    if opspec:
        pos = 0
        while True:
            m = _SPEC_HEAD_RE.search(opspec, pos)
            if not m:
                break
            end = _find_matching(opspec, m.end())
            body = opspec[m.end() : end].strip()
            d = json.loads(body)
            idx = int(m.group(2))
            if m.group(1) == "traversal":
                specs.append(TraversalSpec.from_dict(d, idx))
            else:
                specs.append(GEMMSpec.from_dict(d, idx))
            pos = end + 1
    return OpSpecProgram(dag=dag, specs=specs)


def dumps_opspec(prog: OpSpecProgram) -> str:
    """Emit the reference document layout (round-trips through
    :func:`parse_opspec_ssa`)."""
    from .serialize import dumps as dump_ssa

    parts = [dump_ssa(prog.dag), "", "///", "/// OPSPEC", "///", "OPSPEC{"]
    for s in prog.specs:
        parts.append(s.to_string())
    parts.append("}")
    return "\n".join(parts) + "\n"


# ------------------------------------------------- scheduling (the pass
# the reference stubbed: lower_to_OpSpecSSA)

GEMM_KINDS = ("NodeDense", "EdgeDense", "CompactDense", "NodeLinear")

# the port's op for each op kind of a generic traversal that is not
# elementwise PyTorch work ({"kernel": "torch_elementwise"})
_SUMS = {"kernel": "seg_sum_sorted"}
_GPU_KERNEL = {
    "NodeSumAccumulation": _SUMS,
    "EdgeTypeSumAccumulation": _SUMS,
    "NodeTypeSumAccumulation": _SUMS,
    "RowSumAccumulation": {"kernel": "torch_sum"},
    "ExpandCompact": {"kernel": "expand_compact"},
    "FusedGatCompact": {"kernel": "relational_fused_gat_compact",
                        "sums": "seg_sum_sorted"},
    "FusedEdgeSoftmaxAggCompact": {
        "kernel": "edge_softmax_weighted_sum_compact",
        "sums": "seg_sum_sorted"},
}

# InterOpSSA op kind -> loop-body opcode (reference spelling)
_SIMPLE_OPCODE = {
    "Exponential": "expf",
    "LeakyRelu": "leakyrelu",
    "Tanh": "tanhf",
    "Negative": "negative",
    "ScalarDivide": "divide",
    "ScalarMultiply": "multiply",
    "ScalarAdd": "add",
    "VectorAdd": "add",
    "MatrixAdd": "add",
    "EdgeScalarVectorMul": "mul",
    "EdgeInnerProduct": "dot",
    "NodeSumAccumulation": "sum",
    "EdgeTypeSumAccumulation": "sum",
    "NodeTypeSumAccumulation": "sum",
    "RowSumAccumulation": "sum",
    "Copy": "copy",
    "GradLeakyRelu": "grad_leakyrelu",
    "InverseExponential": "expf",
    "InverseLeakyRelu": "grad_leakyrelu",
    "InverseTanh": "grad_tanh",
    "Concatenate": "concat",
}


def _vlist(v: Var) -> List[str]:
    if v.is_weight:
        return ["W", v.kind] if v.name == "W" else [v.name, v.kind]
    return [v.kind, v.name]


def _slice_type(prog: Program, v: Var) -> str:
    return prog.shapes.get((v.kind, v.name), "vector")


def _broadcast_of(op: Op) -> Optional[Dict[str, str]]:
    """Mark node-valued operands consumed edge-wise (the reference's
    broadcast annotation: which operand is gathered per edge)."""
    for operand, v in op.inputs.items():
        if v.kind in ("DSTNODE", "SRCNODE", "NODEWISE"):
            others = [u for u in op.inputs.values() if u is not v]
            if any(
                u.kind in ("EDGEWISE", "UNIQUE_NODE_ETYPE") for u in others
            ):
                side = {
                    "DSTNODE": "dstnode",
                    "SRCNODE": "srcnode",
                    "NODEWISE": "nodewise",
                }[v.kind]
                pos = list(op.inputs).index(operand)
                name = (
                    "left"
                    if pos == 0 and len(op.inputs) > 1
                    else ("right" if len(op.inputs) > 1 else operand)
                )
                return {"operand": name, "source": side}
    return None


def _simple_spec(prog: Program, op: Op) -> SimpleSpec:
    out = op.outputs[0]
    op_type: Union[str, Dict[str, str]] = "elementwise"
    if op.kind == "NodeSumAccumulation":
        op_type = {"type": "accumulation", "sink": "node"}
    elif op.kind == "EdgeTypeSumAccumulation":
        op_type = {"type": "accumulation", "sink": "edgetype"}
    elif op.kind == "NodeTypeSumAccumulation":
        op_type = {"type": "accumulation", "sink": "nodetype"}
    elif op.kind == "RowSumAccumulation":
        op_type = {"type": "accumulation", "sink": "weight"}
    elif op.kind == "EdgeInnerProduct":
        op_type = {"type": "accumulation", "sink": "edge"}
    return SimpleSpec(
        op=_SIMPLE_OPCODE.get(op.kind, op.kind.lower()),
        inputs=[_vlist(v) for v in op.inputs.values()],
        output=_vlist(out),
        op_type=op_type,
        broadcast=_broadcast_of(op),
    )


def _edge_loop(body, scalar_tmps=None) -> LoopSpec:
    return LoopSpec(
        loop_variable="idx_edge",
        loop_begin="0",
        loop_end="num_edges",
        # het_tpu's dialect, kept field for field
        loop_step="edge_chunk*num_node_blocks",
        loop_scalar_tmps=scalar_tmps or [],
        operators=body,
    )


def _node_loop(body) -> LoopSpec:
    return LoopSpec(
        loop_variable="idx_node",
        loop_begin="0",
        loop_end="num_dst_nodes",
        loop_step="node_block",
        operators=body,
    )


def _feature_loop(body) -> LoopSpec:
    return LoopSpec(
        loop_variable="idx_feature",
        loop_begin="0",
        loop_end="num_features",
        loop_step="lane_width",
        operators=body,
    )


def schedule_program(prog: Program, tile: int = 128) -> OpSpecProgram:
    """Inter-Op SSA -> Op-Spec SSA: attach a reified schedule to every op.

    GEMM-class ops become :class:`GEMMSpec` with the segment-matmul
    plan the port runs by default (tile-aligned relation segments, one
    ``torch.matmul`` a relation on host offsets: ``"strategy":
    "host_offsets"``; ``"device_offsets"`` takes the segment-matmul
    kernels).  Everything else becomes a :class:`TraversalSpec` whose loop
    nest mirrors the reference dialect and whose ``gpu`` dict names the
    port's op: the sorted segment sum for an accumulation, the fused ops
    for the fused motifs, PyTorch elementwise work for the rest.
    """
    specs: List[Union[TraversalSpec, GEMMSpec]] = []
    idx = 0
    for op in prog.ops:
        idx += 1
        out = op.outputs[0]
        if op.kind in GEMM_KINDS:
            xv = op.inputs["input"]
            wv = op.inputs["weight"]
            compact = op.kind == "CompactDense" or out.kind == (
                "UNIQUE_NODE_ETYPE"
            )
            if op.kind == "NodeLinear" or wv.kind == "NODETYPE":
                gather = "GATHER(ntype_rows)"
                scatter = "SCATTER(row_idx)"
                seg = "ntype_seg"
            elif compact:
                gather = "GATHER(unique_node_idx)"
                scatter = (
                    "SCATTER(entry_idx_per_etype + "
                    "unique_etype_ptr[etype_idx])"
                )
                seg = "compact_seg"
            else:
                gather = "GATHER(row_idx)"
                scatter = (
                    "SCATTER(entry_idx_per_etype + etype_ptr[etype_idx])"
                )
                seg = "edge_rel_seg"
            specs.append(
                GEMMSpec(
                    op_idx=idx,
                    left=_vlist(xv),
                    right=_vlist(wv),
                    product=_vlist(out),
                    schedule={"tile_sz": tile},
                    access={
                        "left": [gather, "NO_TRANSPOSE"],
                        "right": ["WEIGHTS"],
                        "product": [scatter],
                    },
                    edgewise_use_compaction={str(xv): compact},
                    gpu={
                        # ops/linear.py::segment_matmul on host offsets;
                        # "device_offsets" (or het_tpu's "gather_einsum")
                        # takes the segment-matmul kernels
                        "kernel": "segment_matmul",
                        "strategy": "host_offsets",
                        "segments": seg,
                        "row_tile": tile,
                    },
                )
            )
            continue
        if op.kind == "FusedEdgeSoftmaxAgg":
            # packed single-pass softmax-aggregate: exp + two node-sink
            # accumulations in one edge traversal (denominator packed with
            # the numerator), then a node-space divide
            logits = _vlist(op.inputs["logits"])
            msg = _vlist(op.inputs["msg"])
            outv = _vlist(out)
            t1 = TraversalSpec(
                op_idx=idx,
                inputs=[logits, msg],
                outputs=[["DSTNODE", "attn_sum"], ["DSTNODE", "out_raw"]],
                schedule="type2",
                operators=[
                    _edge_loop(
                        [
                            SimpleSpec(
                                op="expf",
                                inputs=[logits],
                                output=["EDGEWISE", "loop_scalar_tmp1"],
                                op_type="elementwise",
                            ),
                            SimpleSpec(
                                op="sum",
                                inputs=[["EDGEWISE", "loop_scalar_tmp1"]],
                                output=["DSTNODE", "attn_sum"],
                                op_type={
                                    "type": "accumulation",
                                    "sink": "node",
                                },
                            ),
                            _feature_loop(
                                [
                                    SimpleSpec(
                                        op="mul",
                                        inputs=[
                                            ["EDGEWISE", "loop_scalar_tmp1"],
                                            msg,
                                        ],
                                        output=[
                                            "EDGEWISE",
                                            "loop_scalar_tmp2",
                                        ],
                                        broadcast={
                                            "operand": "left",
                                            "source": "edgewise",
                                        },
                                    ),
                                    SimpleSpec(
                                        op="sum",
                                        inputs=[
                                            ["EDGEWISE", "loop_scalar_tmp2"]
                                        ],
                                        output=["DSTNODE", "out_raw"],
                                        op_type={
                                            "type": "accumulation",
                                            "sink": "node",
                                        },
                                    ),
                                ]
                            ),
                        ],
                        scalar_tmps=[["EDGEWISE", "loop_scalar_tmp1"]],
                    )
                ],
                gpu={
                    "kernel": "fused_softmax_agg",
                    "sums": "seg_sum_sorted",
                    # "packed": the fused op (z and z*msg from one pass
                    # over the edges); flip to "split" for the unfused
                    # chain's two sums — honored by
                    # lower.compile_program(OpSpecProgram)
                    "packing": "packed",
                },
            )
            idx += 1
            t2 = TraversalSpec(
                op_idx=idx,
                inputs=[["DSTNODE", "out_raw"], ["DSTNODE", "attn_sum"]],
                outputs=[outv],
                schedule="type2",
                operators=[
                    _node_loop(
                        [
                            _feature_loop(
                                [
                                    SimpleSpec(
                                        op="divide",
                                        inputs=[
                                            ["DSTNODE", "out_raw"],
                                            ["DSTNODE", "attn_sum"],
                                        ],
                                        output=outv,
                                        broadcast={
                                            "operand": "right",
                                            "source": "dstnode",
                                        },
                                    )
                                ]
                            )
                        ]
                    )
                ],
                gpu={"kernel": "torch_elementwise"},
            )
            specs.extend([t1, t2])
            continue
        # generic single-op traversal
        st = _slice_type(prog, out)
        is_node_space = out.kind not in ("EDGEWISE", "UNIQUE_NODE_ETYPE") \
            and all(
                v.kind not in ("EDGEWISE", "UNIQUE_NODE_ETYPE")
                for v in op.inputs.values()
            )
        body = _simple_spec(prog, op)
        inner = [body] if st == "scalar" else [_feature_loop([body])]
        loop = _node_loop(inner) if is_node_space else _edge_loop(inner)
        gpu = dict(_GPU_KERNEL.get(op.kind, {"kernel": "torch_elementwise"}))
        specs.append(
            TraversalSpec(
                op_idx=idx,
                inputs=[_vlist(v) for v in op.inputs.values()],
                outputs=[_vlist(o) for o in op.outputs],
                schedule="type1" if st == "scalar" else "type2",
                operators=[loop],
                gpu=gpu,
            )
        )
    return OpSpecProgram(dag=prog, specs=specs)
