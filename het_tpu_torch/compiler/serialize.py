"""Text round-trip of the ``.inter-op-ssa`` program format.

Parses/emits the reference's serialized IR surface syntax (DAG section of
hrt/pyctor/examples/inter-op-ssa/*.inter-op-ssa; serializer counterpart:
hrt/pyctor/ir/InterOpSSA/program_serializer.py:16-160) so the reference's
example files work as conformance goldens.  The parser is tolerant of the
hand-written goldens' irregularities (missing quotes, stray comments,
multi-output statements).  A copy of ``het_tpu/compiler/serialize.py``."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from .ir import OP_DEFS, Op, Program, Var

_VAR_RE = re.compile(
    r"\(\s*([A-Za-z_][A-Za-z0-9_]*)\s*,\s*\"?([A-Za-z0-9_]+)\"?\s*\)"
)
_STMT_RE = re.compile(
    r"^(?P<lhs>.+?)=\s*(?P<op>[A-Za-z_][A-Za-z0-9_]*)\s*\((?P<args>.*)\)\s*;?\s*$"
)


def _parse_var(text: str) -> Optional[Var]:
    m = _VAR_RE.search(text)
    if not m:
        return None
    a, b = m.group(1), m.group(2)
    from .ir import DATA_KINDS, WEIGHT_SLICES

    if a in DATA_KINDS:
        return Var(a, b)
    if b in WEIGHT_SLICES:
        return Var(b, a)  # weight: (name, SLICE)
    # tolerate unquoted data names with known kind on either side
    if b in DATA_KINDS:
        return Var(b, a)
    return Var("NONE", a)  # fall back: weight with NONE slice


def _strip_comments(text: str) -> str:
    out = []
    for line in text.splitlines():
        idx = line.find("//")
        if idx >= 0:
            line = line[:idx]
        out.append(line)
    return "\n".join(out)


def _extract_section(text: str, name: str) -> Optional[str]:
    m = re.search(name + r"\s*\{", text)
    if not m:
        return None
    depth, i = 1, m.end()
    start = i
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    return text[start : i - 1]


def loads(text: str) -> Program:
    """Parse a ``.inter-op-ssa`` document (DAG + optional SHAPE table)."""
    clean = _strip_comments(text)
    dag = _extract_section(clean, "DAG")
    assert dag is not None, "no DAG section"
    prog = Program()

    # statements may be numbered ("1:(EDGEWISE, ...) = Op(...)") and may
    # contain nested fused scopes; flatten nested braces' contents first
    dag = dag.replace("{", " ").replace("}", " ")
    for raw in dag.split(";"):
        stmt = " ".join(raw.split())
        if not stmt:
            continue
        stmt = re.sub(r"^\d+\s*:\s*", "", stmt)
        m = _STMT_RE.match(stmt + ")") if stmt.endswith("(") else _STMT_RE.match(stmt)
        if m is None:
            m = _STMT_RE.match(stmt)
        if m is None:
            continue
        op_kind = m.group("op")
        if op_kind not in OP_DEFS and op_kind not in (
            "TraversalOp",
            "GEMMOp",
        ):
            continue
        outs = []
        for piece in m.group("lhs").split("),"):
            v = _parse_var(piece + ")")
            if v is not None:
                outs.append(v)
        args = {}
        # split args on commas at paren depth 0 between tuples
        for am in re.finditer(
            r"([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(\([^)]*\))", m.group("args")
        ):
            v = _parse_var(am.group(2))
            if v is not None:
                args[am.group(1)] = v
        if op_kind in ("TraversalOp", "GEMMOp"):
            continue  # fused container headers: contents parsed separately
        if outs:
            prog.ops.append(Op(op_kind, args, tuple(outs)))

    shape = _extract_section(clean, "Shape")
    if shape:
        for sm in re.finditer(
            r"\(\s*(\w+)\s*,\s*\"?(\w+)\"?\s*\)\s*:\s*\[\s*'(\w+)'\s*,\s*'(\w+)'\s*\]",
            shape,
        ):
            prog.shapes[(sm.group(1), sm.group(2))] = sm.group(4)
    return prog


def dumps(prog: Program) -> str:
    """Emit the program in the reference's document layout."""
    lines = [
        "///",
        "/// SHAPE INFORMATION",
        "///",
        "VARIABLETABLE{",
        "  Shape{",
    ]
    for (kind, name), st in sorted(prog.shapes.items()):
        purpose = kind.lower()
        lines.append(f"    ({kind}, \"{name}\"):['{purpose}','{st}']")
    lines += ["  }", "}", "", "///", "/// DAG", "///", "DAG{"]
    for op in prog.ops:
        lines.append(str(op))
    lines.append("}")
    return "\n".join(lines) + "\n"


def roundtrip_equal(a: Program, b: Program) -> bool:
    """Structural equality on the op list (order-sensitive)."""
    if len(a.ops) != len(b.ops):
        return False
    for x, y in zip(a.ops, b.ops):
        if x.kind != y.kind or x.outputs != y.outputs or x.inputs != y.inputs:
            return False
    return True
