"""Sorted segment sum: the hand-written CUDA kernel and its plain version.

    out[r] = sum_{e in [row_ptr[r], row_ptr[r+1])} vals[perm[e] if perm else e]

Counterpart of ``het_tpu/ops/pallas/seg_reduce.py::_seg_sum_wl`` (reached
there through ``seg_sum_sorted_packed``).  Rows of ``vals`` outside
``[row_ptr[0], row_ptr[n])`` (through ``perm`` when given) are never read,
which is how padding edges and padding compact rows drop out.  The kernel
is ``csrc/seg_reduce.cu``; its header says what bounds it and how.

The device of ``vals`` picks the implementation (``_dispatch.takes_plain``):
a CUDA tensor launches the kernel (or raises), a CPU tensor takes
:func:`seg_sum_sorted_plain`, and ``impl="plain"`` asks for the plain
version on the card as well; nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _dispatch


def seg_sum_sorted_plain(vals: torch.Tensor, row_ptr: torch.Tensor,
                         perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: segment ids by ``repeat_interleave``, then
    ``index_add_`` in f32."""
    n = row_ptr.numel() - 1
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(n, device=vals.device), counts, output_size=hi - lo
    )
    idx = torch.arange(lo, hi, device=vals.device)
    if perm is not None:
        idx = perm[lo:hi].long()
    out = torch.zeros(n, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, seg, vals.index_select(0, idx).float())


def _check(vals, row_ptr, perm):
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise TypeError(f"vals must be 2-D float32, got {vals.dtype} "
                        f"{tuple(vals.shape)}")
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


def _seg_sum_sorted_cuda(vals, row_ptr, perm):
    fn = _dispatch.bind("seg_reduce", "het_seg_sum_sorted_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    n = row_ptr.numel() - 1
    C = vals.shape[1]
    out = torch.empty(n, C, dtype=torch.float32, device=vals.device)
    if n == 0 or C == 0:
        return out
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(vals.data_ptr(), row_ptr.data_ptr(),
                 perm.data_ptr() if perm is not None else None,
                 out.data_ptr(), n, C, stream)
    _dispatch.check_launch("seg_reduce", err, "seg_sum_sorted")
    seg_sum_sorted.launches += 1
    return out


def seg_sum_sorted(vals: torch.Tensor, row_ptr: torch.Tensor,
                   perm: Optional[torch.Tensor] = None, *,
                   impl: str = "kernel") -> torch.Tensor:
    """Sum rows of ``vals`` (rows, C) f32 over the sorted segmentation
    ``row_ptr`` (n + 1,) int32, reading row ``perm[e]`` for edge ``e`` when
    ``perm`` (int32) is given.  Returns (n, C) f32."""
    plain = _dispatch.takes_plain(vals, impl, "seg_sum_sorted")
    _check(vals, row_ptr, perm)
    if plain:
        return seg_sum_sorted_plain(vals, row_ptr, perm)
    return _seg_sum_sorted_cuda(vals, row_ptr, perm)


# launches of the CUDA kernel since the count was last set to 0
seg_sum_sorted.launches = 0
