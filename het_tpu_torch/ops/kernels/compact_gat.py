"""The packed compact GAT op's per-edge terms inside sorted segment walks:
the hand-written CUDA kernels and their plain versions.

With ``fe2d`` (UCs, H*(1+D)) the packed source compact rows (per head
``[el | feat]``), ``er_c`` (UCd, H) the destination compact rows,
``src_map`` / ``dst_map`` each canonical edge's compact rows and ``act``
a leaky ReLU of ``slope``, clipped at +-``clip`` where given, an edge
``e`` into ``v`` has ``raw_e = el[src_map[e]] + er_c[dst_map[e]]`` and
``z_e = exp(act(raw_e))`` per head:

* :func:`compact_gat_packed_fwd`, over the destination CSR ``row_ptr``:
  ``s[v] = sum z_e`` and ``out[v] = sum z_e feat_e / s[v]`` (0 where
  ``s[v] = 0``);
* :func:`compact_gat_packed_bwd_dst`, the same walk: ``alpha_e = z_e /
  s[v]`` and ``draw_e = alpha_e (<feat_e, ct[v]> - <out[v], ct[v]>)
  act'(raw_e)`` (EP, H) each, in canonical order;
* :func:`compact_gat_packed_bwd_src`, over the source compact rows
  (``edge_row_ptr`` through ``edge_sort_perm``): ``d_fe[r]`` per head
  ``[sum draw_e | sum alpha_e ct[dst[e]]]``, in ``fe2d``'s layout.

Together they do the work of
``het_tpu/ops/pallas/fused_agg.py::_make_compact_fused_packed_op``'s
``_fwd`` and its backward rule around ``_seg_sum_wl``, with no (EP, H*D)
tensor in device memory: ``ops/fused_agg.py::CompactFusedGATPacked``
takes them for f32 operands on the card under ``stable`` "raw" or "clip".
The kernels are ``csrc/compact_gat.cu``; its header says what bounds them
and how.

Only edges in ``[row_ptr[0], row_ptr[n])`` (through ``perm`` in the
third) are read; ``draw`` and ``alpha`` are written on those edges only
(the plain version leaves zeros elsewhere), which is where the caller's
sums read them.  The device of the first operand picks the implementation
(``_dispatch.takes_plain``).  The wrappers open no ``spans.kernel`` span:
their time shows under the calling op's span.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _dispatch
from .seg_reduce import seg_sum_sorted_plain, split_helpers

# widest head the kernels take: a head's lanes (8 columns each) fit in a
# warp
MAX_D = 256
# edges a task of the walks takes at most: rows longer than this are split
# over helper tasks
SPLIT_LEN = 128


def act(raw, slope: float, clip: Optional[float]):
    """The attention activation: a leaky ReLU of ``slope``, then a clip at
    +-``clip`` where given (the fused ops' and these walks')."""
    a = torch.where(raw >= 0, raw, slope * raw)
    return a if clip is None else a.clamp(-clip, clip)


def act_deriv(raw, slope: float, clip: Optional[float]):
    """Derivative of :func:`act`: zero outside the clip."""
    d = torch.where(raw >= 0, torch.ones_like(raw),
                    torch.full_like(raw, slope))
    if clip is None:
        return d
    inner = torch.where(raw >= 0, raw, slope * raw)
    return torch.where(inner.abs() <= clip, d, torch.zeros_like(d))


def _walked(row_ptr):
    """``(lo, hi, row ids (hi - lo,))`` of the edges ``row_ptr`` covers."""
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(row_ptr.numel() - 1, device=row_ptr.device), counts,
        output_size=hi - lo)
    return lo, hi, rows


def _edge_terms(fe2d, er_c, src_map, dst_map, lo, hi):
    """``raw`` (m, H) and the features (m, H, D) of edges ``lo:hi``."""
    H = er_c.shape[1]
    ge = fe2d.index_select(0, src_map[lo:hi].long()).view(hi - lo, H, -1)
    raw = ge[..., 0] + er_c.index_select(0, dst_map[lo:hi].long())
    return raw, ge[..., 1:]


def compact_gat_packed_fwd_plain(fe2d, er_c, src_map, dst_map, row_ptr,
                                 slope: float, clip: Optional[float]
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the edges' terms, then ``z`` and ``z*feat``
    summed by :func:`~.seg_reduce.seg_sum_sorted_plain` (f64, rounded
    once).  Returns ``(s (n, H), out (n, H, D))``."""
    lo, hi, _ = _walked(row_ptr)
    raw, feat = _edge_terms(fe2d, er_c, src_map, dst_map, lo, hi)
    z = torch.exp(act(raw, slope, clip))
    m, H, D = feat.shape
    ptr = row_ptr - lo
    s = seg_sum_sorted_plain(z, ptr)
    num = seg_sum_sorted_plain((z[..., None] * feat).reshape(m, H * D), ptr)
    ok = s[..., None] != 0
    out = torch.where(ok, num.view(-1, H, D)
                      / torch.where(ok, s[..., None], 1.0), 0.0)
    return s, out


def compact_gat_packed_bwd_dst_plain(fe2d, er_c, src_map, dst_map, row_ptr,
                                     s, out, ct, slope: float,
                                     clip: Optional[float]
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the edges' terms beside their destinations'
    ``s``, ``ct`` and ``<out, ct>``.  Returns ``(draw, alpha)`` (EP, H),
    zero outside the walked edges."""
    lo, hi, rows = _walked(row_ptr)
    raw, feat = _edge_terms(fe2d, er_c, src_map, dst_map, lo, hi)
    z = torch.exp(act(raw, slope, clip))
    s_d = s.index_select(0, rows)
    alpha_w = torch.where(s_d != 0, z / torch.where(s_d != 0, s_d, 1.0), 0.0)
    t1 = (feat * ct.index_select(0, rows)).sum(-1)
    t2 = (out * ct).sum(-1).index_select(0, rows)
    EP, H = src_map.numel(), er_c.shape[1]
    draw = torch.zeros(EP, H, dtype=torch.float32, device=fe2d.device)
    alpha = torch.zeros_like(draw)
    draw[lo:hi] = alpha_w * (t1 - t2) * act_deriv(raw, slope, clip)
    alpha[lo:hi] = alpha_w
    return draw, alpha


def compact_gat_packed_bwd_src_plain(draw, alpha, ct, dst, row_ptr, perm
                                     ) -> torch.Tensor:
    """Plain PyTorch version: per walked edge ``[draw | alpha * ct[dst]]``
    per head, summed over ``row_ptr`` by
    :func:`~.seg_reduce.seg_sum_sorted_plain`.  Returns ``d_fe`` (n,
    H*(1+D))."""
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    edges = perm[lo:hi].long()
    H, D = ct.shape[1], ct.shape[2]
    ct_e = ct.index_select(0, dst.index_select(0, edges).long())
    pay = torch.cat([draw.index_select(0, edges)[..., None],
                     alpha.index_select(0, edges)[..., None] * ct_e], dim=2)
    return seg_sum_sorted_plain(pay.view(hi - lo, H * (1 + D)), row_ptr - lo)


def _check_index(t, name, device):
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous 1-D int32 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the operands on {device}")


def _check_f32(t, name, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name} must be float32 {tuple(shape)}, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the operands on {device}")


def _check_rows(fe2d, er_c, src_map, dst_map, row_ptr):
    """Checks of the first two walks' operands; returns ``(H, D)``."""
    if fe2d.dim() != 2 or er_c.dim() != 2:
        raise TypeError("fe2d and er_c must be 2-D")
    H = er_c.shape[1]
    if H == 0 or fe2d.shape[1] % H or fe2d.shape[1] // H < 2:
        raise ValueError(f"fe2d's {fe2d.shape[1]} columns are not H = {H} "
                         "heads of [el | feat]")
    D = fe2d.shape[1] // H - 1
    if D > MAX_D:
        raise ValueError(f"D = {D} is wider than the kernels' {MAX_D}")
    dev = fe2d.device
    _check_f32(fe2d, "fe2d", fe2d.shape, dev)
    _check_f32(er_c, "er_c", er_c.shape, dev)
    for name, t in (("src_map", src_map), ("dst_map", dst_map),
                    ("row_ptr", row_ptr)):
        _check_index(t, name, dev)
    if src_map.numel() != dst_map.numel():
        raise ValueError("src_map and dst_map must cover the same edges")
    if row_ptr.numel() < 1:
        raise ValueError("row_ptr needs at least one entry")
    return H, D


def _clip_args(clip: Optional[float]):
    return (ctypes.c_int(0), ctypes.c_float(0.0)) if clip is None else (
        ctypes.c_int(1), ctypes.c_float(clip))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)


def _fwd_cuda(fe2d, er_c, src_map, dst_map, row_ptr, slope, clip, H, D):
    fn = _dispatch.bind("compact_gat", "het_compact_gat_packed_fwd", [
        _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _I64, _F, _INT, _F,
        _I64, _I64, _P, _P, _P])
    n = row_ptr.numel() - 1
    s = torch.empty(n, H, dtype=torch.float32, device=fe2d.device)
    out = torch.empty(n, H, D, dtype=torch.float32, device=fe2d.device)
    if n == 0:
        return s, out
    edges = src_map.numel()
    helpers = split_helpers(edges, SPLIT_LEN)
    carry_row = torch.empty(helpers, dtype=torch.int32, device=fe2d.device)
    carry = torch.empty(helpers, H * (1 + D), dtype=torch.float32,
                        device=fe2d.device)
    with torch.cuda.device(fe2d.device):
        err = fn(fe2d.data_ptr(), er_c.data_ptr(), src_map.data_ptr(),
                 dst_map.data_ptr(), row_ptr.data_ptr(), s.data_ptr(),
                 out.data_ptr(), n, H, D, edges, slope, *_clip_args(clip),
                 SPLIT_LEN, helpers, carry_row.data_ptr(), carry.data_ptr(),
                 _stream(fe2d))
    _dispatch.check_launch("compact_gat", err, "compact_gat_packed_fwd")
    compact_gat_packed_fwd.launches += 1
    return s, out


def _bwd_dst_cuda(fe2d, er_c, src_map, dst_map, row_ptr, s, out, ct, slope,
                  clip, H, D):
    fn = _dispatch.bind("compact_gat", "het_compact_gat_packed_bwd_dst", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _I64, _F,
        _INT, _F, _I64, _I64, _P])
    n = row_ptr.numel() - 1
    edges = src_map.numel()
    draw = torch.empty(edges, H, dtype=torch.float32, device=fe2d.device)
    alpha = torch.empty_like(draw)
    if n == 0:
        return draw, alpha
    with torch.cuda.device(fe2d.device):
        err = fn(fe2d.data_ptr(), er_c.data_ptr(), src_map.data_ptr(),
                 dst_map.data_ptr(), row_ptr.data_ptr(), s.data_ptr(),
                 out.data_ptr(), ct.data_ptr(), draw.data_ptr(),
                 alpha.data_ptr(), n, H, D, edges, slope, *_clip_args(clip),
                 SPLIT_LEN, split_helpers(edges, SPLIT_LEN), _stream(fe2d))
    _dispatch.check_launch("compact_gat", err, "compact_gat_packed_bwd_dst")
    compact_gat_packed_bwd_dst.launches += 1
    return draw, alpha


def _bwd_src_cuda(draw, alpha, ct, dst, row_ptr, perm, H, D):
    fn = _dispatch.bind("compact_gat", "het_compact_gat_packed_bwd_src", [
        _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _I64, _I64, _I64, _P,
        _P, _P])
    n = row_ptr.numel() - 1
    d_fe = torch.empty(n, H * (1 + D), dtype=torch.float32,
                       device=draw.device)
    if n == 0:
        return d_fe
    edges = perm.numel()
    helpers = split_helpers(edges, SPLIT_LEN)
    carry_row = torch.empty(helpers, dtype=torch.int32, device=draw.device)
    carry = torch.empty(helpers, H * (1 + D), dtype=torch.float32,
                        device=draw.device)
    with torch.cuda.device(draw.device):
        err = fn(draw.data_ptr(), alpha.data_ptr(), ct.data_ptr(),
                 dst.data_ptr(), row_ptr.data_ptr(), perm.data_ptr(),
                 d_fe.data_ptr(), n, H, D, edges, SPLIT_LEN, helpers,
                 carry_row.data_ptr(), carry.data_ptr(), _stream(draw))
    _dispatch.check_launch("compact_gat", err, "compact_gat_packed_bwd_src")
    compact_gat_packed_bwd_src.launches += 1
    return d_fe


def compact_gat_packed_fwd(fe2d: torch.Tensor, er_c: torch.Tensor,
                           src_map: torch.Tensor, dst_map: torch.Tensor,
                           row_ptr: torch.Tensor, slope: float,
                           clip: Optional[float] = None, *,
                           impl: str = "kernel"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward walk over the destination CSR ``row_ptr`` (n + 1,):
    ``fe2d`` (UCs, H*(1+D)) and ``er_c`` (UCd, H) f32, ``src_map`` and
    ``dst_map`` (EP,) int32.  Returns ``(s (n, H), out (n, H, D))`` f32."""
    plain = _dispatch.takes_plain(fe2d, impl, "compact_gat_packed_fwd")
    H, D = _check_rows(fe2d, er_c, src_map, dst_map, row_ptr)
    if plain:
        return compact_gat_packed_fwd_plain(fe2d, er_c, src_map, dst_map,
                                            row_ptr, slope, clip)
    return _fwd_cuda(fe2d, er_c, src_map, dst_map, row_ptr, slope, clip, H,
                     D)


def compact_gat_packed_bwd_dst(fe2d: torch.Tensor, er_c: torch.Tensor,
                               src_map: torch.Tensor, dst_map: torch.Tensor,
                               row_ptr: torch.Tensor, s: torch.Tensor,
                               out: torch.Tensor, ct: torch.Tensor,
                               slope: float, clip: Optional[float] = None,
                               *, impl: str = "kernel"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's destination walk, the forward's operands with its
    ``s`` (n, H) and ``out`` (n, H, D) and the cotangent ``ct`` (n, H, D),
    f32.  Returns ``(draw, alpha)`` (EP, H) f32 on the walked edges."""
    plain = _dispatch.takes_plain(fe2d, impl, "compact_gat_packed_bwd_dst")
    H, D = _check_rows(fe2d, er_c, src_map, dst_map, row_ptr)
    n = row_ptr.numel() - 1
    _check_f32(s, "s", (n, H), fe2d.device)
    _check_f32(out, "out", (n, H, D), fe2d.device)
    _check_f32(ct, "ct", (n, H, D), fe2d.device)
    if plain:
        return compact_gat_packed_bwd_dst_plain(fe2d, er_c, src_map, dst_map,
                                                row_ptr, s, out, ct, slope,
                                                clip)
    return _bwd_dst_cuda(fe2d, er_c, src_map, dst_map, row_ptr, s, out, ct,
                         slope, clip, H, D)


def compact_gat_packed_bwd_src(draw: torch.Tensor, alpha: torch.Tensor,
                               ct: torch.Tensor, dst: torch.Tensor,
                               row_ptr: torch.Tensor, perm: torch.Tensor, *,
                               impl: str = "kernel") -> torch.Tensor:
    """The backward's source walk over ``row_ptr`` (n + 1,) through
    ``perm`` (int32): ``draw`` and ``alpha`` (EP, H) and ``ct`` (N, H, D)
    f32, ``dst`` (EP,) int32.  Returns ``d_fe`` (n, H*(1+D)) f32."""
    plain = _dispatch.takes_plain(draw, impl, "compact_gat_packed_bwd_src")
    if ct.dim() != 3:
        raise TypeError(f"ct must be (N, H, D), got {tuple(ct.shape)}")
    N, H, D = ct.shape
    if D > MAX_D:
        raise ValueError(f"D = {D} is wider than the kernels' {MAX_D}")
    dev = draw.device
    _check_f32(draw, "draw", (draw.shape[0], H), dev)
    _check_f32(alpha, "alpha", draw.shape, dev)
    _check_f32(ct, "ct", ct.shape, dev)
    for name, t in (("dst", dst), ("row_ptr", row_ptr), ("perm", perm)):
        _check_index(t, name, dev)
    if row_ptr.numel() < 1:
        raise ValueError("row_ptr needs at least one entry")
    if plain:
        return compact_gat_packed_bwd_src_plain(draw, alpha, ct, dst,
                                                row_ptr, perm)
    return _bwd_src_cuda(draw, alpha, ct, dst, row_ptr, perm, H, D)


# launches of each CUDA kernel (a walk and its fix-up) since its count was
# last set to 0
compact_gat_packed_fwd.launches = 0
compact_gat_packed_bwd_dst.launches = 0
compact_gat_packed_bwd_src.launches = 0
