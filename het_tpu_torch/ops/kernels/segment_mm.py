"""Relation-segmented matmul: the hand-written CUDA kernels and their
plain versions.

    y[i, h]  = x[i, h if Hx > 1 else 0] @ W[seg(i), h]          forward
    dx[i, h] = sum_o ct[i, h, o] W[seg(i), h, :, o]  (per head, Hx = H;
               summed over the heads when Hx = 1)                 dX
    dW[s, h, k, o] = sum_{i in segment s} x[i, h|0, k] ct[i, h, o]  dW

with ``seg(i)`` the segment whose rows ``seg_ptrs[s]:seg_ptrs[s+1]`` hold
row ``i``, read on the device: these kernels serve the segmentations whose
offsets have no host copy (``Segments.seg_ptrs_static is None``, the
shards of a partitioned graph), and the dW also the attention-vector
gradients of the plain RGAT.  Counterparts of
``het_tpu/ops/pallas/segment_mm.py``: :func:`segment_matmul_fwd` of
``segment_matmul_rows_fwd`` (``_fwd_resident`` and ``_fwd_streamed``),
:func:`segment_matmul_dx` of ``segment_matmul_rows_dx`` (``_dx_resident``
and the streamed form), :func:`segment_matmul_dw` of
``segment_matmul_rows_dw`` (``_dw_resident`` and the streamed form).  One
wrapper call covers each pair, whatever the size of W: the forward's
narrow or wide column tile picked by :func:`fwd_plan`, the dX on the same
walk with W read transposed (:func:`dx_plan`), the dW's chunk and reduce
passes planned by :func:`dw_plan`.  Every row
of a segment is summed in the dW, valid or not, as there; a caller that
must drop padding rows zeroes their ``ct``.  A segment that owns no rows
gives zeros, and the forward and dX write zeros on rows outside
``[seg_ptrs[0], seg_ptrs[S])``.  The kernels are ``csrc/segment_mm.cu``;
its header says what bounds them.

The device of the first operand picks the implementation
(``_dispatch.takes_plain``): a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version, and ``impl="plain"`` asks
for the plain version on the card as well.  Only the plain versions read
the offsets on the host.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ...utils import spans
from . import _dispatch


def host_seg_ptrs(seg) -> Tuple[int, ...]:
    """The segment offsets on the host: ``seg_ptrs_static``, or a copy of
    ``seg_ptrs`` where the offsets live only on the device (a sync; the
    plain versions alone read it)."""
    if seg.seg_ptrs_static is not None:
        return seg.seg_ptrs_static
    return tuple(seg.seg_ptrs.tolist())


def _rows2d(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], math.prod(t.shape[1:]))


def _heads_of(x2: torch.Tensor, H: int, K: int, what: str) -> int:
    """Hx of an (n_rows, Hx*K) operand, Hx in {1, H}."""
    Hx = x2.shape[1] // K if K else 1
    if x2.shape[1] != Hx * K or Hx not in (1, H):
        raise ValueError(f"{what} {tuple(x2.shape)} is not (n_rows, Hx*K) "
                         f"with Hx in (1, {H}), K={K}")
    return Hx


def _operands(x_rows, ct_rows, w_shape) -> Tuple[torch.Tensor, torch.Tensor,
                                                  int]:
    """x (n_rows, Hx*K) and ct (n_rows, H*O) as 2-D views, and Hx."""
    S, H, K, O = w_shape
    n = x_rows.shape[0]
    x2, ct2 = _rows2d(x_rows), _rows2d(ct_rows)
    Hx = _heads_of(x2, H, K, "x_rows")
    if ct2.shape != (n, H * O):
        raise ValueError(f"ct_rows {tuple(ct_rows.shape)} is not "
                         f"({n}, {H}*{O})")
    return x2, ct2, Hx


def segment_matmul_dw_plain(x_rows: torch.Tensor, ct_rows: torch.Tensor,
                            w_shape, seg) -> torch.Tensor:
    """Plain PyTorch version: one f32 ``einsum`` per segment over the host
    slices of the offsets (:func:`host_seg_ptrs`), bf16 operands widened
    to f32 first (exactly)."""
    S, H, K, O = w_shape
    x2, ct2, Hx = _operands(x_rows, ct_rows, w_shape)
    ptrs = host_seg_ptrs(seg)
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


# the narrow kernel's ct columns (an x column meets NC <= 16 of them) and
# the wide kernel's column tiles; csrc/segment_mm.cu instantiates these
NARROW_COLS = (1, 4, 8, 12, 16)
WIDE_COLS = (64, 80, 96)
WIDE_K = 64  # k extent of a wide tile
MIN_CHUNK_ROWS = 256  # rows a block walks at least, to hide its start
PARTIAL_SHARE = 16  # partials at most 1/16 of the input bytes


class DwPlan(NamedTuple):
    """How ``csrc/segment_mm.cu`` computes one grouped dW: the chunk
    kernel (``wide`` or narrow), its ct columns (``cols``: narrow, NC
    rounded up to :data:`NARROW_COLS`; wide, the column tile of
    :data:`WIDE_COLS`), the narrow kernel's ``lanes`` a row, 16-byte loads
    of x (``vec``) and of ct (``ct_vec``), the blocks along y (``tiles``),
    the rows a chunk and the grid's bound on the chunks."""
    wide: bool
    cols: int
    lanes: int
    vec: bool
    ct_vec: bool
    tiles: int
    chunk_rows: int = 0
    chunks: int = 0


def dw_plan(n_rows: int, S: int, H: int, Hx: int, K: int, O: int,
            x_aligned: bool, ct_aligned: bool, sms: int,
            resident: Callable[[DwPlan], int], bf16: bool = False) -> DwPlan:
    """The launch plan of the dW kernel for x (n_rows, Hx*K) and ct
    (n_rows, H*O), f32 or (``bf16``) bf16, whose first rows are 16-byte
    aligned or not, on a card with ``sms`` SMs, where ``resident(plan)``
    is the number of blocks of the plan's chunk kernel one SM holds at
    once.  The narrow kernel reads 4 elements a load where it can (16
    bytes of f32, 8 of bf16); the wide kernel's copies are 16 bytes, 4 f32
    or 8 bf16.

    NC, the ct columns an x column meets, is O per head (Hx = H) or H*O
    (Hx = 1): up to 16 take the narrow kernel, more the wide one, whose
    column tile covers NC in as few passes as 96-column tiles would.  Rows
    a chunk: the chunks of the fewest waves of resident blocks that leave
    room for half a wave past the one extra chunk a segment may cut, but
    at least :data:`MIN_CHUNK_ROWS` rows, and enough that the partials
    stay within 1/:data:`PARTIAL_SHARE` of the inputs; a multiple of 32
    (the wide kernel's stage)."""
    per_head = Hx > 1
    nc = O if per_head else H * O
    xw = Hx * K
    if nc <= NARROW_COLS[-1]:
        cols = next(c for c in NARROW_COLS if c >= nc)
        vec = xw % 4 == 0 and x_aligned
        vectors = xw // 4 if vec else xw
        lanes = min(32, 1 << max(vectors - 1, 0).bit_length())
        ct_vec = (not per_head and nc == cols and nc % 4 == 0
                  and ct_aligned)
        plan = DwPlan(False, cols, lanes, vec, ct_vec, 1)
    else:
        passes = -(-nc // WIDE_COLS[-1])
        cols = next(c for c in WIDE_COLS if c >= -(-nc // passes))
        m = 8 if bf16 else 4
        vec = (K % m == 0 and nc % m == 0 and (H * O) % m == 0
               and x_aligned and ct_aligned)
        tiles = (H if per_head else 1) * -(-K // WIDE_K) * -(-nc // cols)
        plan = DwPlan(True, cols, 0, vec, False, tiles)
    per_wave = max(1, sms * max(1, resident(plan)) // plan.tiles)
    waves = 1
    while waves * per_wave - S < per_wave // 2:
        waves += 1
    rows = -(-n_rows // (waves * per_wave - S))
    floor = -(-PARTIAL_SHARE * H * K * O // (xw + H * O))
    rows = -(-max(rows, floor, MIN_CHUNK_ROWS) // 32) * 32
    return plan._replace(chunk_rows=rows, chunks=-(-n_rows // rows) + S)


_PLANS: Dict[tuple, DwPlan] = {}


def _resident(index: int, plan: DwPlan, per_head: bool, bf16: bool) -> int:
    """Blocks of ``plan``'s chunk kernel one SM of device ``index`` holds
    (CUDA's occupancy calculator)."""
    fn = _dispatch.bind("segment_mm", "het_segment_matmul_dw_resident",
                        [ctypes.c_int] * 6)
    with torch.cuda.device(index):
        return fn(int(plan.wide), plan.cols, int(plan.vec), int(plan.ct_vec),
                  int(per_head), int(bf16))


def card_dw_plan(x_rows: torch.Tensor, ct_rows: torch.Tensor,
                 w_shape) -> DwPlan:
    """:func:`dw_plan` for these CUDA operands on their card."""
    S, H, K, O = w_shape
    x2, ct2, Hx = _operands(x_rows, ct_rows, w_shape)
    dev = x2.device
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    bf16 = x2.dtype == torch.bfloat16
    key = (index, x2.shape[0], S, H, Hx, K, O, x2.data_ptr() % 16 == 0,
           ct2.data_ptr() % 16 == 0)
    plan = _PLANS.get(key + (bf16,))
    if plan is None:  # a training step asks for the same few each time
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        plan = _PLANS[key + (bf16,)] = dw_plan(
            *key[1:], sms, lambda p: _resident(index, p, Hx > 1, bf16), bf16)
    return plan


def _segment_matmul_dw_cuda(x2, ct2, w_shape, Hx, seg_ptrs):
    S, H, K, O = w_shape
    n_rows = x2.shape[0]
    symbol = ("het_segment_matmul_dw_bf16" if x2.dtype == torch.bfloat16
              else "het_segment_matmul_dw_f32")
    fn = _dispatch.bind("segment_mm", symbol, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    dev = x2.device
    out = torch.empty(S, H, K, O, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = card_dw_plan(x2, ct2, w_shape)
    # scratch: the chunk prefix and each chunk's partial (H, K, O) sums
    chunk_ptr = torch.empty(S + 1, dtype=torch.int32, device=dev)
    partial = torch.empty(plan.chunks * H * K * O, dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x2.data_ptr(), ct2.data_ptr(), seg_ptrs.data_ptr(),
                 chunk_ptr.data_ptr(), partial.data_ptr(), out.data_ptr(),
                 n_rows, S, H, Hx, K, O, plan.chunk_rows, plan.chunks,
                 int(plan.wide), plan.cols, plan.lanes, int(plan.vec),
                 int(plan.ct_vec), stream)
    _dispatch.check_launch("segment_mm", err, "segment_matmul_dw")
    segment_matmul_dw.launches += 1
    key = "bf16" if x2.dtype == torch.bfloat16 else "f32"
    by = segment_matmul_dw.launches_by_dtype
    by[key] = by.get(key, 0) + 1
    return out


# A segment matmul's least bytes and operations, from the call's operands:
# each input element read once (the rows, the weight, the S + 1 offsets),
# each f32 output element written once, two operations a multiply-add.


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fwd_work(x, w, seg_ptrs):
    n, (S, H, K, O) = x.shape[0], w.shape
    return (_nbytes(x) + _nbytes(w) + _nbytes(seg_ptrs) + 4 * n * H * O,
            2 * n * H * K * O)


def _dx_work(ct, w, seg_ptrs, x_heads):
    n, (S, H, K, O) = ct.shape[0], w.shape
    return (_nbytes(ct) + _nbytes(w) + _nbytes(seg_ptrs)
            + 4 * n * x_heads * K, 2 * n * H * O * K)


def _dw_work(x, ct, w_shape, seg_ptrs):
    n, (S, H, K, O) = x.shape[0], w_shape
    return (_nbytes(x) + _nbytes(ct) + _nbytes(seg_ptrs) + 4 * S * H * K * O,
            2 * n * H * K * O)


def _check_seg(seg, S: int, n_rows: int) -> None:
    if seg.n_segments != S or seg.seg_ptrs.numel() != S + 1:
        raise ValueError(f"seg has {seg.n_segments} segments, the weight {S}")
    if seg.n_rows > n_rows:  # seg.n_rows is seg_ptrs[S], known on the host
        raise ValueError(f"seg spans {seg.n_rows} rows, the operand "
                         f"{n_rows}")


def _check_cuda(operands, seg) -> None:
    """What a kernel takes: contiguous operands and int32 offsets on the
    first operand's device."""
    dev = operands[0][1].device
    for name, t in operands + (("seg.seg_ptrs", seg.seg_ptrs),):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seg.seg_ptrs.dtype != torch.int32:
        raise TypeError("seg.seg_ptrs must be int32")


def _check_f32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


# the grouped dW's operand element types (x and ct alike; dW is f32):
# het_tpu's ``_dw_resident`` meets both, bf16 in bf16 training
DW_DTYPES = (torch.float32, torch.bfloat16)


def _check_dw_dtypes(x_rows, ct_rows) -> None:
    if x_rows.dtype != ct_rows.dtype or x_rows.dtype not in DW_DTYPES:
        raise TypeError(f"x_rows {x_rows.dtype} and ct_rows {ct_rows.dtype}:"
                        " the dW takes both float32 or both bfloat16")


def segment_matmul_dw(x_rows: torch.Tensor, ct_rows: torch.Tensor, w_shape,
                      seg, *, impl: str = "kernel") -> torch.Tensor:
    """dW (S, H, K, O) f32 of ``y[i, h] = x_rows[i, h|0] @ W[seg(i), h]``
    for the cotangent ``ct_rows``.  ``x_rows`` is (n_rows, K),
    (n_rows, Hx*K) or (n_rows, Hx, K) with Hx in {1, H}; ``ct_rows`` is
    (n_rows, H*O) or (n_rows, H, O); both f32 or both bf16
    (:data:`DW_DTYPES`; each product exact in f32, the sums f32) in the
    row space of the :class:`~het_tpu_torch.graph.structures.Segments`
    ``seg``."""
    plain = _dispatch.takes_plain(x_rows, impl, "segment_matmul_dw")
    _check_dw_dtypes(x_rows, ct_rows)
    x2, ct2, Hx = _operands(x_rows, ct_rows, w_shape)
    _check_seg(seg, w_shape[0], x2.shape[0])
    with spans.kernel(segment_matmul_dw, _dw_work, x=x2, ct=ct2,
                      w_shape=tuple(w_shape), seg_ptrs=seg.seg_ptrs):
        if plain:
            return segment_matmul_dw_plain(x2, ct2, w_shape, seg)
        _check_cuda((("x_rows", x2), ("ct_rows", ct2)), seg)
        return _segment_matmul_dw_cuda(x2, ct2, w_shape, Hx, seg.seg_ptrs)


# launches of the CUDA kernel since the count was last set to 0 (one a
# call: the chunk and reduce passes of csrc/segment_mm.cu), in all and by
# the operands' element type
segment_matmul_dw.launches = 0
segment_matmul_dw.launches_by_dtype = {}


# ------------------------------------------------------------ forward, dX


def segment_matmul_fwd_plain(x_rows: torch.Tensor, w: torch.Tensor,
                             seg) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_matmul_fwd`: one f32
    ``torch.matmul`` per segment over the host slices of the offsets."""
    S, H, K, O = w.shape
    x2 = _rows2d(x_rows)
    Hx = _heads_of(x2, H, K, "x_rows")
    out = torch.zeros(x2.shape[0], H, O, dtype=torch.float32,
                      device=x2.device)
    ptrs = host_seg_ptrs(seg)
    for s in range(S):
        lo, hi = ptrs[s], ptrs[s + 1]
        if hi == lo:
            continue
        xs = x2[lo:hi].float().view(hi - lo, Hx, K).transpose(0, 1)
        # (Hx, n, K) @ (H, K, O) -> (H, n, O), x broadcast over the heads
        out[lo:hi] = torch.matmul(xs, w[s].float()).transpose(0, 1)
    return out


def segment_matmul_dx_plain(ct_rows: torch.Tensor, w: torch.Tensor, seg,
                            x_heads: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_matmul_dx`: one f32
    ``torch.matmul`` per segment over the host slices of the offsets."""
    S, H, K, O = w.shape
    ct2 = _rows2d(ct_rows)
    out = torch.zeros(ct2.shape[0], x_heads * K, dtype=torch.float32,
                      device=ct2.device)
    ptrs = host_seg_ptrs(seg)
    for s in range(S):
        lo, hi = ptrs[s], ptrs[s + 1]
        if hi == lo:
            continue
        cs = ct2[lo:hi].float()
        wt = w[s].float().transpose(1, 2)  # (H, O, K)
        if x_heads == 1:
            out[lo:hi] = cs @ wt.reshape(H * O, K)
        else:
            per_head = torch.matmul(cs.view(hi - lo, H, O).transpose(0, 1),
                                    wt)  # (H, n, K)
            out[lo:hi] = per_head.transpose(0, 1).reshape(hi - lo, H * K)
    return out


# the forward's column tiles: narrow (Cg <= 16 output columns a group,
# four lanes a row) and wide (8 x 4 outputs a thread); the dX rows tile's
# reductions (R <= 16 ct columns, rounded up to 4) and dx columns a pass;
# csrc/segment_mm.cu instantiates these
FWD_NARROW_COLS = (4, 8, 12, 16)
DX_ROWS_DEPTHS = (4, 8, 12, 16)
DX_ROWS_COLS = 64
FWD_ROWS = 64  # rows a tile


class FwdPlan(NamedTuple):
    """How ``csrc/segment_mm.cu`` computes one forward or dX: the column
    tile (``cols``: narrow, Cg rounded up to :data:`FWD_NARROW_COLS`;
    wide, one of :data:`WIDE_COLS`; the dX rows tile's
    :data:`DX_ROWS_COLS`), the dX rows tile's reduction (``depth``, one of
    :data:`DX_ROWS_DEPTHS`; 0 for the forward's kernels), 16-byte loads of
    x (``vec``) and the grid: ``blocks`` by ``tiles`` (the groups times the
    column passes), each block taking ``rows`` rows."""
    cols: int
    vec: bool
    tiles: int
    blocks: int = 0
    rows: int = 0
    depth: int = 0


def _one_wave(plan: FwdPlan, n_rows: int, sms: int,
              resident: Callable[[FwdPlan], int]) -> FwdPlan:
    """``plan`` with blocks that fill one wave of resident blocks and
    share the rows in whole tiles."""
    per_wave = max(1, sms * max(1, resident(plan)) // plan.tiles)
    blocks = max(1, min(per_wave, -(-n_rows // FWD_ROWS)))
    per_block = -(-n_rows // blocks)
    rows = max(1, -(-per_block // FWD_ROWS)) * FWD_ROWS
    return plan._replace(blocks=max(1, -(-n_rows // rows)), rows=rows)


def fwd_plan(n_rows: int, H: int, Hx: int, K: int, O: int,
             x_aligned: bool, sms: int,
             resident: Callable[[FwdPlan], int]) -> FwdPlan:
    """The launch plan of the forward kernel for x (n_rows, Hx*K) whose
    first row is 16-byte aligned or not, on a card with ``sms`` SMs, where
    ``resident(plan)`` is the number of blocks of the plan's kernel one SM
    holds at once.

    Cg, the output columns a group of K x columns meets, is O per head (Hx
    = H) or H*O (Hx = 1).  Up to 16 take a narrow column tile (Cg rounded
    up to a multiple of 4), more a wide one that covers Cg in as few passes
    as 96-column tiles would.  The blocks fill one wave of resident blocks
    and share the rows in whole tiles."""
    cg = O if Hx > 1 else H * O
    if cg <= FWD_NARROW_COLS[-1]:
        cols = next(c for c in FWD_NARROW_COLS if c >= cg)
    else:
        passes = -(-cg // WIDE_COLS[-1])
        cols = next(c for c in WIDE_COLS if c >= -(-cg // passes))
    plan = FwdPlan(cols, K % 4 == 0 and x_aligned,
                   (H if Hx > 1 else 1) * -(-cg // cols))
    return _one_wave(plan, n_rows, sms, resident)


def dx_dims(H: int, Hx: int, K: int, O: int) -> Tuple[int, int, int, int]:
    """The forward's (H, Hx, K, O) that computes the dX of a weight (S, H,
    K, O) into (n_rows, Hx*K): ct's K' columns a group against dx's K, with
    W read transposed (``csrc/segment_mm.cu``'s header).  All H*O columns
    of ct are one group where dx is summed over the heads (Hx = 1), O a
    head otherwise."""
    return (H, H, O, K) if Hx > 1 else (1, 1, H * O, K)


def dx_plan(n_rows: int, H: int, Hx: int, K: int, O: int,
            ct_aligned: bool, sms: int,
            resident: Callable[[FwdPlan], int]) -> FwdPlan:
    """The launch plan of the dX of a weight (S, H, K, O) for ct (n_rows,
    H*O) whose first row is 16-byte aligned or not, in the forward's
    dimensions (:func:`dx_dims`): a reduction of R = H*O (or O a head) ct
    columns against K dx columns a group, 16-byte loads where R is a
    multiple of 4.  A narrow reduction (0 < R <= 16) against K > 16 takes
    the dX rows tile (R rounded up to 4, passes of 64 columns); every other
    shape :func:`fwd_plan`'s kernels.  Hx times the column passes along
    y."""
    dims = dx_dims(H, Hx, K, O)
    R = dims[2]
    if not 0 < R <= DX_ROWS_DEPTHS[-1] or K <= FWD_NARROW_COLS[-1]:
        return fwd_plan(n_rows, *dims, ct_aligned, sms, resident)
    plan = FwdPlan(DX_ROWS_COLS, R % 4 == 0 and ct_aligned,
                   Hx * -(-K // DX_ROWS_COLS), depth=-(-R // 4) * 4)
    return _one_wave(plan, n_rows, sms, resident)


_FWD_PLANS: Dict[tuple, FwdPlan] = {}


def card_fwd_plan(a2: torch.Tensor, w_shape, Hx: int,
                  dx: bool = False) -> FwdPlan:
    """:func:`fwd_plan` (or, with ``dx``, :func:`dx_plan`) for the CUDA
    operand ``a2`` (x, or ct for the dX) and a weight of shape ``w_shape``
    on its card."""
    _, H, K, O = w_shape
    dev = a2.device
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, a2.shape[0], H, Hx, K, O, a2.data_ptr() % 16 == 0, dx)
    plan = _FWD_PLANS.get(key)
    if plan is None:  # a training step asks for the same few each time
        fn = _dispatch.bind("segment_mm", "het_segment_matmul_fwd_resident",
                            [ctypes.c_int] * 4)
        sms = torch.cuda.get_device_properties(index).multi_processor_count

        def resident(p):
            with torch.cuda.device(index):
                return fn(p.cols, p.depth, int(p.vec), int(dx))

        plan = _FWD_PLANS[key] = (dx_plan if dx else fwd_plan)(
            *key[1:-1], sms, resident)
    return plan


def _segment_matmul_cuda(a2, w, seg_ptrs, out, Hx, dx):
    """One launch of the forward (``a2`` is x) or, with ``dx``, the dX
    (``a2`` is ct) into ``out``; False where there is nothing to write."""
    fn = _dispatch.bind("segment_mm", "het_segment_matmul_fwd_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p])
    S, H, K, O = w.shape
    if out.numel() == 0:
        return False
    plan = card_fwd_plan(a2, w.shape, Hx, dx)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(a2.data_ptr(), w.data_ptr(), seg_ptrs.data_ptr(),
                 out.data_ptr(), a2.shape[0], S, H, Hx, K, O, int(dx),
                 plan.cols, plan.depth, int(plan.vec), plan.blocks,
                 plan.tiles, plan.rows, stream)
    _dispatch.check_launch("segment_mm", err,
                           "segment_matmul_dx" if dx else "segment_matmul_fwd")
    return True


def segment_matmul_fwd(x_rows: torch.Tensor, w: torch.Tensor, seg, *,
                       impl: str = "kernel") -> torch.Tensor:
    """(n_rows, H, O) f32: row ``i`` of segment ``s`` times ``w[s]``.

    ``x_rows`` is (n_rows, K), (n_rows, Hx*K) or (n_rows, Hx, K) f32 with
    Hx in {1, H} (one input row for every head, or one a head); ``w`` is
    (S, H, K, O) f32; ``seg`` the
    :class:`~het_tpu_torch.graph.structures.Segments` of the rows, whose
    offsets the kernel reads on the device."""
    plain = _dispatch.takes_plain(x_rows, impl, "segment_matmul_fwd")
    _check_f32(x_rows=x_rows, w=w)
    if w.dim() != 4:
        raise ValueError(f"w must be (S, H, K, O), got {tuple(w.shape)}")
    S, H, K, O = w.shape
    x2 = _rows2d(x_rows)
    Hx = _heads_of(x2, H, K, "x_rows")
    _check_seg(seg, S, x2.shape[0])
    with spans.kernel(segment_matmul_fwd, _fwd_work, x=x2, w=w,
                      seg_ptrs=seg.seg_ptrs):
        if plain:
            return segment_matmul_fwd_plain(x2, w, seg)
        _check_cuda((("x_rows", x2), ("w", w)), seg)
        out = torch.empty(x2.shape[0], H, O, dtype=torch.float32,
                          device=x2.device)
        if _segment_matmul_cuda(x2, w, seg.seg_ptrs, out, Hx, False):
            segment_matmul_fwd.launches += 1
        return out


def segment_matmul_dx(ct_rows: torch.Tensor, w: torch.Tensor, seg,
                      x_heads: int = 1, *,
                      impl: str = "kernel") -> torch.Tensor:
    """(n_rows, x_heads*K) f32, the input gradient of
    :func:`segment_matmul_fwd` for the cotangent ``ct_rows`` ((n_rows,
    H*O) or (n_rows, H, O) f32): per head when the input had one row a head
    (``x_heads = H``), summed over the heads when it had one for all
    (``x_heads = 1``)."""
    plain = _dispatch.takes_plain(ct_rows, impl, "segment_matmul_dx")
    _check_f32(ct_rows=ct_rows, w=w)
    if w.dim() != 4:
        raise ValueError(f"w must be (S, H, K, O), got {tuple(w.shape)}")
    S, H, K, O = w.shape
    ct2 = _rows2d(ct_rows)
    if ct2.shape[1] != H * O or x_heads not in (1, H):
        raise ValueError(f"ct_rows {tuple(ct_rows.shape)} is not (n_rows, "
                         f"{H}*{O}), or x_heads={x_heads} not in (1, {H})")
    _check_seg(seg, S, ct2.shape[0])
    with spans.kernel(segment_matmul_dx, _dx_work, ct=ct2, w=w,
                      seg_ptrs=seg.seg_ptrs, x_heads=x_heads):
        if plain:
            return segment_matmul_dx_plain(ct2, w, seg, x_heads)
        _check_cuda((("ct_rows", ct2), ("w", w)), seg)
        out = torch.empty(ct2.shape[0], x_heads * K, dtype=torch.float32,
                          device=ct2.device)
        if _segment_matmul_cuda(ct2, w, seg.seg_ptrs, out, x_heads, True):
            segment_matmul_dx.launches += 1
        return out


# launches of each CUDA kernel since its count was last set to 0
segment_matmul_fwd.launches = 0
segment_matmul_dx.launches = 0
