"""het_tpu_torch.compiler — the two-level graph-program compiler of
``het_tpu/compiler`` ("pyctor" in the reference, hrt/pyctor/): Inter-Op
DSL -> Inter-Op SSA -> passes (value numbering, shape inference, binop
realization) -> rewrites (compact materialization, linear-operator
reordering) -> fusion -> autodiff -> Op-Spec schedules -> lowering (and
codegen) onto the port's ops, and so onto its hand-written CUDA kernels.

The front half (``ir``, ``frontend``, ``serialize``, ``passes``,
``rewrites``, ``fuse``, ``autodiff``) is het_tpu's, copied; ``opspec``
writes a ``gpu`` schedule dict where het_tpu's writes a ``tpu`` one;
``lower`` and ``codegen`` target ``het_tpu_torch.ops``.
"""

from .ir import Op, Program, Var  # noqa: F401
from .frontend import parse_dsl  # noqa: F401
from .serialize import dumps, loads  # noqa: F401
from .passes import PassManager, Pass, run_default  # noqa: F401
from .autodiff import differentiate  # noqa: F401
from .fuse import fuse_edge_softmax  # noqa: F401
from .lower import compile_program  # noqa: F401
from .codegen import compile_emitted, emit_python  # noqa: F401
from .opspec import (  # noqa: F401
    dumps_opspec,
    parse_opspec_ssa,
    schedule_program,
)


def compile_dsl(source: str, outputs=None, shape_hints=None):
    """DSL source -> (forward closure, analyzed Program)."""
    prog = run_default(parse_dsl(source), shape_hints=shape_hints)
    return compile_program(prog, outputs=outputs), prog


def grad_program(fwd: Program) -> Program:
    """Forward + reverse ops in one executable program: feed primal inputs
    plus ``<output>_delta`` seeds, read ``<input/weight>_delta`` results."""
    bck = differentiate(fwd)
    combined = Program(ops=list(fwd.ops) + list(bck.ops))
    run_default(combined)
    return combined
