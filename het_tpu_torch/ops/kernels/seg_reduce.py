"""Sorted segment reductions and a row copy: the hand-written CUDA kernels
and their plain versions.

* :func:`seg_sum_sorted`, counterpart of
  ``het_tpu/ops/pallas/seg_reduce.py::_seg_sum_wl`` (reached there through
  ``seg_sum_sorted_packed``)::

      out[r] = sum_{e in [row_ptr[r], row_ptr[r+1])} vals[perm[e] if perm else e]

* :func:`seg_max_sorted`, counterpart of ``seg_max_dst_pallas_raw``: the
  same walk with max, 0 where the max is not finite (an empty segment);
  the destination max of the exact max-subtracted edge softmax;
* :func:`force_rowmajor`, counterpart of ``force_rowmajor``: a strided
  view copied into a contiguous tensor.  het_tpu has no caller for it, and
  neither has the port.

The segment sum takes the (rows, output) element types of
:data:`SUM_DTYPES`, the pairs het_tpu's ``seg_sum_sorted_packed`` sums in
f32 and bf16 training (its payload ``parts`` cast to ``pack_dt``, its
``out_dtype``): f32 rows into f32 sums, and bf16 rows into f32 or into
bf16 sums, each a sum in f32 rounded once, as het_tpu's "cast of the f32
result".  Anything else raises ``TypeError``.

Rows of ``vals`` outside ``[row_ptr[0], row_ptr[n])`` (through ``perm``
when given) are never read, which is how padding edges and padding
compact rows drop out.  The kernels are ``csrc/seg_reduce.cu``; its
header says what bounds them and how.

The device of ``vals`` picks the implementation (``_dispatch.takes_plain``):
a CUDA tensor launches the kernel (or raises), a CPU tensor takes
:func:`seg_sum_sorted_plain`, and ``impl="plain"`` asks for the plain
version on the card as well; nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...utils import spans
from . import _dispatch

# the segment sum's (rows, output) element types
SUM_DTYPES = ((torch.float32, torch.float32),
              (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16))


def seg_sum_sorted_plain(vals: torch.Tensor, row_ptr: torch.Tensor,
                         perm: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: segment ids by ``repeat_interleave``, then
    ``index_add_`` in f64, rounded once to ``out_dtype`` (f32 by
    default): on the card the adds are atomic, in no fixed order, and a
    hub row of 10^5 edges summed so in f32 strays further from the exact
    sum than the kernel's limit."""
    n = row_ptr.numel() - 1
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(n, device=vals.device), counts, output_size=hi - lo
    )
    idx = torch.arange(lo, hi, device=vals.device)
    if perm is not None:
        idx = perm[lo:hi].long()
    out = torch.zeros(n, vals.shape[1], dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, seg, vals.index_select(0, idx).double())
    return out.to(out_dtype or torch.float32)


def seg_max_sorted_plain(vals: torch.Tensor,
                         row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: segment ids by ``repeat_interleave``, then
    ``scatter_reduce_`` ("amax") into -inf, non-finite results to 0.  A
    NaN is read as +inf, which ends at 0 just the same, so the result does
    not rest on how the scatter's max treats NaN on either device."""
    n = row_ptr.numel() - 1
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(n, device=vals.device), counts, output_size=hi - lo
    )
    C = vals.shape[1]
    out = torch.full((n, C), float("-inf"), dtype=torch.float32,
                     device=vals.device)
    v = vals[lo:hi].float()
    v = torch.where(torch.isnan(v), float("inf"), v)
    out.scatter_reduce_(0, seg[:, None].expand(-1, C), v, "amax")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def force_rowmajor_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a contiguous copy."""
    return x.clone(memory_format=torch.contiguous_format)


def _check(vals, row_ptr, perm, out_dtype=torch.float32,
           pairs=((torch.float32, torch.float32),)):
    if (vals.dtype, out_dtype) not in pairs or vals.dim() != 2:
        raise TypeError(
            f"vals {vals.dtype} {tuple(vals.shape)} into {out_dtype}: the "
            "kernel takes 2-D " + ", ".join(
                f"{str(a)[6:]} -> {str(b)[6:]}" for a, b in pairs))
    if not vals.is_contiguous():
        raise ValueError("vals must be contiguous")
    for name, t in (("row_ptr", row_ptr), ("perm", perm)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D int32 tensor")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on "
                             f"{vals.device}")
    if row_ptr.numel() < 1:
        raise ValueError("row_ptr needs at least one entry")


def split_len(C: int) -> int:
    """Edges a task of the kernel walks at most (see its header): rows
    longer than this are split over helper tasks.  Narrow rows have fewer
    lanes a task, so they take shorter pieces; wider ones longer pieces
    and fewer helpers."""
    return 64 if C <= 4 else 128 if C <= 16 else 256


def split_helpers(rows_bound: int, L: int) -> int:
    """Helper tasks for at most ``rows_bound`` edges (vals' rows, or
    perm's length) split at the multiples of ``L``: one a multiple below
    the bound, known without reading the row pointer's end back from the
    card; helpers past the real edges record no partial."""
    return max(1, -(-rows_bound // L))


_SUM_SYMBOLS = {
    (torch.float32, torch.float32): "het_seg_sum_sorted_f32",
    (torch.bfloat16, torch.float32): "het_seg_sum_sorted_bf16_f32",
    (torch.bfloat16, torch.bfloat16): "het_seg_sum_sorted_bf16_bf16",
}


def _seg_reduce_cuda(symbol, what, vals, row_ptr, perm,
                     out_dtype=torch.float32):
    """Launch ``symbol`` (the sum or the max) with its scratch: a row id
    and a (C,) f32 partial a helper, and for a bf16 output the f32 first
    part of each split row.  Returns the output."""
    args = [ctypes.c_void_p, ctypes.c_void_p] + (
        [ctypes.c_void_p] if what == "seg_sum_sorted" else [])
    head_arg = [ctypes.c_void_p] if out_dtype == torch.bfloat16 else []
    fn = _dispatch.bind("seg_reduce", symbol, args + [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p] + head_arg + [
        ctypes.c_void_p])
    n = row_ptr.numel() - 1
    C = vals.shape[1]
    out = torch.empty(n, C, dtype=out_dtype, device=vals.device)
    if n == 0 or C == 0:
        return out
    L = split_len(C)
    helpers = split_helpers(perm.numel() if perm is not None
                            else vals.shape[0], L)
    carry_row = torch.empty(helpers, dtype=torch.int32, device=vals.device)
    carry = torch.empty(helpers, C, dtype=torch.float32, device=vals.device)
    scratch = [carry_row.data_ptr(), carry.data_ptr()]
    if head_arg:
        head = torch.empty(helpers, C, dtype=torch.float32,
                           device=vals.device)
        scratch.append(head.data_ptr())
    ptrs = [vals.data_ptr(), row_ptr.data_ptr()]
    if what == "seg_sum_sorted":
        ptrs.append(perm.data_ptr() if perm is not None else None)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(*ptrs, out.data_ptr(), n, C, L, helpers, *scratch, stream)
    _dispatch.check_launch("seg_reduce", err, what)
    return out


def _reduce_work(vals, row_ptr, perm=None, out_dtype=torch.float32):
    """A segment reduction's least bytes and operations, from the shapes:
    each row it walks (``perm``'s entries, else ``vals``' rows) read once
    with its index, the row pointer read once, each output element written
    once, and one add (or max) an element walked."""
    C = vals.shape[1]
    walked = perm.numel() if perm is not None else vals.shape[0]
    n = row_ptr.numel() - 1
    nbytes = (walked * C * vals.element_size()
              + (walked * perm.element_size() if perm is not None else 0)
              + row_ptr.numel() * row_ptr.element_size()
              + n * C * out_dtype.itemsize)
    return nbytes, walked * C


def _copy_work(x):
    """A copy's least bytes and operations: read once, written once."""
    return 2 * x.numel() * x.element_size(), 0


def dtype_key(*dtypes: torch.dtype) -> str:
    """"bf16->f32"-style name of an instantiation's element types."""
    short = {torch.float32: "f32", torch.bfloat16: "bf16"}
    return "->".join(short[d] for d in dtypes)


def _seg_sum_sorted_cuda(vals, row_ptr, perm, out_dtype=torch.float32):
    out = _seg_reduce_cuda(_SUM_SYMBOLS[vals.dtype, out_dtype],
                           "seg_sum_sorted", vals, row_ptr, perm, out_dtype)
    if out.numel():
        seg_sum_sorted.launches += 1
        key = dtype_key(vals.dtype, out_dtype)
        by = seg_sum_sorted.launches_by_dtype
        by[key] = by.get(key, 0) + 1
    return out


def _seg_max_sorted_cuda(vals, row_ptr):
    out = _seg_reduce_cuda("het_seg_max_sorted_f32", "seg_max_sorted", vals,
                           row_ptr, None)
    if out.numel():
        seg_max_sorted.launches += 1
    return out


def _force_rowmajor_cuda(x):
    fn = _dispatch.bind("seg_reduce", "het_strided_copy_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p])
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if x.dim() == 2:
        (R, B), (s0, s2) = x.shape, x.stride()
        A, s1 = 1, 0
    else:
        (R, A, B), (s0, s1, s2) = x.shape, x.stride()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), R, A, B, s0, s1, s2, stream)
    _dispatch.check_launch("seg_reduce", err, "force_rowmajor")
    force_rowmajor.launches += 1
    return out


def seg_sum_sorted(vals: torch.Tensor, row_ptr: torch.Tensor,
                   perm: Optional[torch.Tensor] = None, *,
                   out_dtype: Optional[torch.dtype] = None,
                   impl: str = "kernel") -> torch.Tensor:
    """Sum rows of ``vals`` (rows, C) f32 or bf16 over the sorted
    segmentation ``row_ptr`` (n + 1,) int32, reading row ``perm[e]`` for
    edge ``e`` when ``perm`` (int32) is given.  Returns (n, C) in
    ``out_dtype`` (f32 by default; bf16 for bf16 rows): a pair of
    :data:`SUM_DTYPES`, summed in f32."""
    plain = _dispatch.takes_plain(vals, impl, "seg_sum_sorted")
    out_dtype = out_dtype or torch.float32
    _check(vals, row_ptr, perm, out_dtype, SUM_DTYPES)
    with spans.kernel(seg_sum_sorted, _reduce_work, vals=vals,
                      row_ptr=row_ptr, perm=perm, out_dtype=out_dtype):
        if plain:
            return seg_sum_sorted_plain(vals, row_ptr, perm, out_dtype)
        return _seg_sum_sorted_cuda(vals, row_ptr, perm, out_dtype)


# launches of the CUDA kernel since the count was last set to 0, in all
# and by (rows -> sums) element types
seg_sum_sorted.launches = 0
seg_sum_sorted.launches_by_dtype = {}


def seg_max_sorted(vals: torch.Tensor, row_ptr: torch.Tensor, *,
                   impl: str = "kernel") -> torch.Tensor:
    """Column-wise max of rows of ``vals`` (rows, C) f32 over the sorted
    segmentation ``row_ptr`` (n + 1,) int32; 0 where a segment's max is
    not finite (empty, +-inf or NaN).  Returns (n, C) f32, equal to the
    plain version bit for bit."""
    plain = _dispatch.takes_plain(vals, impl, "seg_max_sorted")
    _check(vals, row_ptr, None)
    with spans.kernel(seg_max_sorted, _reduce_work, vals=vals,
                      row_ptr=row_ptr):
        if plain:
            return seg_max_sorted_plain(vals, row_ptr)
        return _seg_max_sorted_cuda(vals, row_ptr)


seg_max_sorted.launches = 0


def force_rowmajor(x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
    """``x`` (R, W) or (R, A, B) f32 of any strides, copied into a
    contiguous tensor of the same shape."""
    plain = _dispatch.takes_plain(x, impl, "force_rowmajor")
    if x.dtype != torch.float32 or x.dim() not in (2, 3):
        raise TypeError(f"x must be 2-D or 3-D float32, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if math.prod(x.shape[1:]) >= 2**31:
        raise ValueError(f"rows of {tuple(x.shape[1:])} elements are too "
                         "wide for the kernel's int32 columns")
    with spans.kernel(force_rowmajor, _copy_work, x=x):
        if plain:
            return force_rowmajor_plain(x)
        return _force_rowmajor_cuda(x)


force_rowmajor.launches = 0
