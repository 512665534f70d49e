"""Grouped weight gradient of the relation-segmented matmul: the
hand-written CUDA kernel and its plain version.

    dW[s, h, k, o] = sum_{i in segment s} x[i, h if Hx > 1 else 0, k]
                                          * ct[i, h, o]

Counterpart of ``het_tpu/ops/pallas/segment_mm.py::segment_matmul_rows_dw``
(its resident form ``_dw_resident`` and its streamed form, one CUDA kernel
for both).  Every row of a segment is summed, valid or not, as there; a
caller that must drop padding rows zeroes their ``ct``.  A segment that
owns no rows gives zeros.  The kernel is ``csrc/segment_mm.cu``; its
header says what bounds it and how.

The device of ``x_rows`` picks the implementation (``_dispatch.takes_plain``):
a CUDA tensor launches the kernel (or raises), a CPU tensor takes
:func:`segment_matmul_dw_plain`, and ``impl="plain"`` asks for the plain
version on the card as well.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _dispatch


def _operands(x_rows, ct_rows, w_shape) -> Tuple[torch.Tensor, torch.Tensor,
                                                  int]:
    """x (n_rows, Hx*K) and ct (n_rows, H*O) as 2-D views, and Hx."""
    S, H, K, O = w_shape
    n = x_rows.shape[0]
    x2 = x_rows.reshape(n, math.prod(x_rows.shape[1:]))
    ct2 = ct_rows.reshape(ct_rows.shape[0], math.prod(ct_rows.shape[1:]))
    Hx = x2.shape[1] // K if K else 1
    if x2.shape[1] != Hx * K or Hx not in (1, H):
        raise ValueError(f"x_rows {tuple(x_rows.shape)} is not (n_rows, Hx*K)"
                         f" with Hx in (1, {H}), K={K}")
    if ct2.shape != (n, H * O):
        raise ValueError(f"ct_rows {tuple(ct_rows.shape)} is not "
                         f"({n}, {H}*{O})")
    return x2, ct2, Hx


def segment_matmul_dw_plain(x_rows: torch.Tensor, ct_rows: torch.Tensor,
                            w_shape, seg) -> torch.Tensor:
    """Plain PyTorch version: one f32 ``einsum`` per segment over the host
    slices ``seg.seg_ptrs_static``."""
    S, H, K, O = w_shape
    x2, ct2, Hx = _operands(x_rows, ct_rows, w_shape)
    ptrs = seg.seg_ptrs_static
    out = torch.zeros(S, H, K, O, dtype=torch.float32, device=x2.device)
    for s in range(S):
        lo, hi = ptrs[s], ptrs[s + 1]
        if hi > lo:
            xs = x2[lo:hi].float().view(hi - lo, Hx, K)
            cs = ct2[lo:hi].float().view(hi - lo, H, O)
            if Hx == 1:
                out[s] = torch.einsum("nk,nho->hko", xs[:, 0], cs)
            else:
                out[s] = torch.einsum("nhk,nho->hko", xs, cs)
    return out


def _segment_matmul_dw_cuda(x2, ct2, w_shape, Hx, seg_ptrs):
    S, H, K, O = w_shape
    n_rows = x2.shape[0]
    fn = _dispatch.bind("segment_mm", "het_segment_matmul_dw_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    chunks = _dispatch.bind("segment_mm", "het_segment_matmul_dw_max_chunks",
                         [ctypes.c_int64, ctypes.c_int], ctypes.c_int64)
    dev = x2.device
    out = torch.empty(S, H, K, O, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # scratch: the chunk plan and each chunk's partial (H, K, O) sums
    chunk_ptr = torch.empty(S + 1, dtype=torch.int32, device=dev)
    partial = torch.empty(chunks(n_rows, S) * H * K * O, dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x2.data_ptr(), ct2.data_ptr(), seg_ptrs.data_ptr(),
                 chunk_ptr.data_ptr(), partial.data_ptr(), out.data_ptr(),
                 n_rows, S, H, Hx, K, O, stream)
    _dispatch.check_launch("segment_mm", err, "segment_matmul_dw")
    segment_matmul_dw.launches += 1
    return out


def segment_matmul_dw(x_rows: torch.Tensor, ct_rows: torch.Tensor, w_shape,
                      seg, *, impl: str = "kernel") -> torch.Tensor:
    """dW (S, H, K, O) f32 of ``y[i, h] = x_rows[i, h|0] @ W[seg(i), h]``
    for the cotangent ``ct_rows``.  ``x_rows`` is (n_rows, K),
    (n_rows, Hx*K) or (n_rows, Hx, K) with Hx in {1, H}; ``ct_rows`` is
    (n_rows, H*O) or (n_rows, H, O); both f32 in the row space of the
    :class:`~het_tpu_torch.graph.structures.Segments` ``seg``."""
    S = w_shape[0]
    plain = _dispatch.takes_plain(x_rows, impl, "segment_matmul_dw")
    if x_rows.dtype != torch.float32 or ct_rows.dtype != torch.float32:
        raise TypeError(f"x_rows and ct_rows must be float32, got "
                        f"{x_rows.dtype} and {ct_rows.dtype}")
    x2, ct2, Hx = _operands(x_rows, ct_rows, w_shape)
    if seg.n_segments != S or seg.seg_ptrs.numel() != S + 1:
        raise ValueError(f"seg has {seg.n_segments} segments, w_shape {S}")
    if seg.seg_ptrs_static and seg.seg_ptrs_static[-1] > x2.shape[0]:
        raise ValueError("seg_ptrs reach past the last row")
    if plain:
        return segment_matmul_dw_plain(x2, ct2, w_shape, seg)
    for name, t in (("x_rows", x2), ("ct_rows", ct2),
                    ("seg.seg_ptrs", seg.seg_ptrs)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x_rows on "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seg.seg_ptrs.dtype != torch.int32:
        raise TypeError("seg.seg_ptrs must be int32")
    return _segment_matmul_dw_cuda(x2, ct2, w_shape, Hx, seg.seg_ptrs)


# launches of the CUDA kernel since the count was last set to 0 (one a
# call: the plan, chunk and reduce passes of csrc/segment_mm.cu)
segment_matmul_dw.launches = 0
