"""The least work of one call of a port kernel, from its operands as the
program's ``kernel:`` spans record them (``args``: each operand's element
type and shape, as JSON), counted here so that a change to the program
cannot move the yardstick.

Each input element read once (the rows walked, their indices, the row
pointer or the segment offsets, the weight), each output element written
once; one add (or max) an element walked, two operations a multiply-add.
The segment matmuls' outputs (and the dW) are f32.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, Tuple

from benchmark.costs.common import F32

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
            "int64": 8}


def _bytes(operand) -> int:
    dtype, shape = operand
    return ITEMSIZE[dtype] * math.prod(shape)


def _reduce(vals, row_ptr, perm=None, out_dtype="float32"):
    (walked, c) = (perm[1][0] if perm else vals[1][0]), vals[1][1]
    n = row_ptr[1][0] - 1
    read = walked * c * ITEMSIZE[vals[0]] + _bytes(row_ptr) + (
        _bytes(perm) if perm else 0)
    return read + n * c * ITEMSIZE[out_dtype], walked * c


def _copy(x):
    return 2 * _bytes(x), 0


def _fwd(x, w, seg_ptrs):
    n, (_, h, k, o) = x[1][0], w[1]
    return (_bytes(x) + _bytes(w) + _bytes(seg_ptrs) + F32 * n * h * o,
            2 * n * h * k * o)


def _dx(ct, w, seg_ptrs, x_heads):
    n, (_, h, k, o) = ct[1][0], w[1]
    return (_bytes(ct) + _bytes(w) + _bytes(seg_ptrs) + F32 * n * x_heads * k,
            2 * n * h * o * k)


def _dw(x, ct, w_shape, seg_ptrs):
    n, (s, h, k, o) = x[1][0], w_shape
    return (_bytes(x) + _bytes(ct) + _bytes(seg_ptrs) + F32 * s * h * k * o,
            2 * n * h * k * o)


WORK: Dict[str, Callable[..., Tuple[int, int]]] = {
    "seg_sum_sorted": _reduce, "seg_max_sorted": _reduce,
    "force_rowmajor": _copy, "segment_matmul_fwd": _fwd,
    "segment_matmul_dx": _dx, "segment_matmul_dw": _dw,
}


def call_work(kernel: str, args: str) -> Tuple[int, int]:
    """(bytes, operations) of one call of ``kernel`` (a wrapper's name)
    with the operands ``args`` (a ``kernel:`` span's JSON key)."""
    return WORK[kernel](**json.loads(args))
