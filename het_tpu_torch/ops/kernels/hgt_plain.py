"""HGT's plain layer core inside sorted segment walks: the hand-written
CUDA kernels and their plain versions.

With ``v2d`` and ``k2d`` (src_space, H*dk) and ``q2d`` (n, H*dk) node
rows, ``w_msg`` and ``w_att`` (R, H, dk, dk) and ``mu`` (R, H), an edge
``e = (u -> v, relation r)`` has, per head, ``score_e = <q[v] W_att[r],
k[u]>``, ``raw_e = score_e * mu[r]``, ``z_e = exp(clip(raw_e))`` and
``msg_e = v[u] W_msg[r]``:

* :func:`hgt_plain_fwd`, over the destination CSR ``row_ptr``: ``s[v] =
  sum z_e``, ``out[v] = sum z_e msg_e / s[v]`` (0 where ``s[v] = 0``) and
  ``score`` (EP, H) in canonical order, 0 on the edges it does not walk;
* :func:`hgt_plain_bwd_dst`, the same walk from the cotangent ``ct``:
  ``alpha_e = z_e / s[v]``, ``draw_e = alpha_e (<msg_e, ct[v]> - <out[v],
  ct[v]>) clip'(raw_e)`` (EP, H) each, ``d_q`` and both weights'
  gradients (``dscore_e = draw_e mu[r]``), and ``score`` and ``draw`` again
  in the relation-sorted edge rows (at ``inv[e]``), where ``mu``'s
  gradient reads them;
* :func:`hgt_plain_bwd_src`, over the source CSR through a permutation of
  canonical edge ids: ``d_k[u] = sum dscore_e q[v] W_att[r]`` and
  ``d_v[u] = sum alpha_e ct[v] W_msg[r]^T``.

Together they do the work of
``het_tpu/ops/pallas/fused_agg.py::_make_hgt_plain_full_op``'s ``_fwd``
and its backward rule ``_bwd`` with no (EP, H*dk) tensor in device
memory: ``ops/fused_agg.py::HGTPlainFull`` takes them for f32 operands on
the card with ``dk`` in :data:`WIDTHS` and ``H <= MAX_H``.  The kernels
are ``csrc/hgt_plain.cu``; its header says what bounds them and how.  The
card's walks apply the linear maps once a run of one relation: the
destination walk's runs are the (dst, rel) runs of canonical order
(:func:`dst_runs`), whose rows go to the grouped dW
(:func:`~.segment_mm.segment_matmul_dw`) for the weights' gradients; the
source walk reads each source's edges in (source, relation) order
(:func:`src_rel_perm`).  The plain versions take the maps edge by edge
and sum in f64, rounded once.

Only edges in ``[row_ptr[0], row_ptr[n])`` (through ``perm`` in the
third) are walked; ``draw`` and ``alpha`` are written on those edges only
(the plain version leaves zeros elsewhere).  The device of the first
operand picks the implementation (``_dispatch.takes_plain``).  The
wrappers open no ``spans.kernel`` span (the grouped dWs they call open
theirs): their time shows under the calling op's span.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _dispatch
from .compact_gat import (_check_f32, _check_index, _clip_args, _stream,
                          _walked, act, act_deriv)
from .seg_reduce import split_helpers
from .segment_mm import segment_matmul_dw

# the head widths dk the kernels take (a lane holds a head's dk columns)
WIDTHS = (1, 2, 4, 8, 16)
MAX_H = 32  # heads a slot of a warp's lanes holds
# edges a task of the walks takes at most: rows longer than this are split
# over helper tasks
SPLIT_LEN = 128
# edges the plain versions take at a time, so that their per-edge terms
# stay a block's size at the benchmark's 21.1M edges
BLOCK_EDGES = 1 << 21


class RunSegments(NamedTuple):
    """The (dst, rel) runs' rows in relation order, segmented by relation,
    as :func:`~.segment_mm.segment_matmul_dw` reads a segmentation."""
    n_segments: int
    n_rows: int
    seg_ptrs: torch.Tensor  # (R + 1,) int32 on the card
    seg_ptrs_static: Tuple[int, ...]


class DstWalk(NamedTuple):
    """What :func:`hgt_plain_bwd_dst` returns."""
    draw: torch.Tensor  # (EP, H), on the walked edges
    alpha: torch.Tensor  # (EP, H), on the walked edges
    d_q: torch.Tensor  # (n, H*dk)
    d_w_msg: torch.Tensor  # (R, H, dk, dk)
    d_w_att: torch.Tensor  # (R, H, dk, dk)
    score_rows: torch.Tensor  # (n_rows, H): score at inv[e], 0 elsewhere
    draw_rows: torch.Tensor  # (n_rows, H): draw at inv[e], 0 elsewhere


class Runs(NamedTuple):
    """The runs of one destination and one relation in canonical order,
    over the edges of a destination CSR: run ``j`` starts at edge
    ``run_ptr[j]``, row ``v``'s first run is ``row_run[v]``, and run
    ``j``'s rows go to row ``run_slot[j]`` of the relation-ordered row
    space ``seg``."""
    run_ptr: torch.Tensor  # (runs + 1,) int32
    row_run: torch.Tensor  # (n + 1,) int32
    run_slot: torch.Tensor  # (runs,) int32
    seg: RunSegments


def dst_runs(rel: torch.Tensor, row_ptr: torch.Tensor,
             num_rels: int) -> Runs:
    """The (row, relation) runs of the edges ``row_ptr`` covers, whose
    relations are ``rel`` (EP,) int32: maximal stretches of one row and
    one relation (one per (dst, rel) pair where a row's edges are sorted
    by relation, as canonical order is).  Reads the run count back from
    the card."""
    lo, hi, rows = _walked(row_ptr)
    r = rel[lo:hi].long()
    start = torch.ones(hi - lo, dtype=torch.bool, device=rel.device)
    start[1:] = (rows[1:] != rows[:-1]) | (r[1:] != r[:-1])
    first = start.nonzero().squeeze(1) + lo
    run_rel = rel.index_select(0, first).long()
    run_ptr = torch.cat([first, first.new_full((1,), hi)]).int()
    row_run = torch.searchsorted(first, row_ptr.long()).int()
    order = torch.sort(run_rel, stable=True).indices
    run_slot = torch.empty_like(order)
    run_slot[order] = torch.arange(order.numel(), device=rel.device)
    ptrs = torch.zeros(num_rels + 1, dtype=torch.int64, device=rel.device)
    ptrs[1:] = torch.bincount(run_rel, minlength=num_rels).cumsum(0)
    static = tuple(ptrs.tolist())
    return Runs(run_ptr, row_run, run_slot.int(),
                RunSegments(num_rels, static[-1], ptrs.int(), static))


def src_rel_perm(src: torch.Tensor, rel: torch.Tensor,
                 row_ptr: torch.Tensor, perm: torch.Tensor,
                 num_rels: int) -> torch.Tensor:
    """``perm`` (EP,) int32, the canonical edges in source order over the
    source CSR ``row_ptr``, with each source's edges stably sorted by
    relation, so that a walk meets each (source, relation) run whole;
    positions outside ``[row_ptr[0], row_ptr[n])`` kept."""
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    edges = perm[lo:hi].long()
    key = (src.index_select(0, edges).long() * num_rels
           + rel.index_select(0, edges).long())
    out = perm.clone()
    out[lo:hi] = edges[torch.sort(key, stable=True).indices].int()
    return out


# ------------------------------------------------------------------ plain


def _blocks(lo: int, hi: int):
    for a in range(lo, hi, BLOCK_EDGES):
        yield a, min(a + BLOCK_EDGES, hi)


def _heads(x2d, idx, H):
    """Rows ``idx`` of ``x2d`` as (m, H, dk) f32."""
    return x2d.index_select(0, idx).float().view(idx.numel(), H, -1)


def _by_rel(x, w, r, transpose: bool = False):
    """``x[e] W[r[e]]`` per head (``x[e] W[r[e]]^T`` where
    ``transpose``), ``x`` (m, H, dk): one product a relation present."""
    out = torch.empty_like(x)
    for rr in torch.unique(r).tolist():
        m = (r == rr).nonzero().squeeze(1)
        eq = "mhj,hij->mhi" if transpose else "mhi,hij->mhj"
        out[m] = torch.einsum(eq, x.index_select(0, m), w[rr].float())
    return out


def _outer_by_rel(acc, x, y, r):
    """``acc[r] += sum_e x[e]^T y[e]`` per head, in f64: acc (R, H, dk,
    dk), x and y (m, H, dk)."""
    for rr in torch.unique(r).tolist():
        m = (r == rr).nonzero().squeeze(1)
        acc[rr] += torch.einsum("mhi,mhj->hij", x.index_select(0, m).double(),
                                y.index_select(0, m).double())


def hgt_plain_fwd_plain(v2d, q2d, k2d, w_msg, w_att, mu, src, rel, row_ptr,
                        clip: Optional[float]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: each edge's terms, ``z`` and ``z*msg``
    summed into their rows in f64, rounded once.  Returns ``(s (n, H), out
    (n, H, dk), score (EP, H))``."""
    lo, hi, rows = _walked(row_ptr)
    n, H = row_ptr.numel() - 1, mu.shape[1]
    HD = q2d.shape[1]
    s = torch.zeros(n, H, dtype=torch.float64, device=q2d.device)
    num = torch.zeros(n, HD, dtype=torch.float64, device=q2d.device)
    score = torch.zeros(src.numel(), H, dtype=torch.float32,
                        device=q2d.device)
    for a, b in _blocks(lo, hi):
        rw = rows[a - lo:b - lo]
        u, r = src[a:b].long(), rel[a:b].long()
        attq = _by_rel(_heads(q2d, rw, H), w_att, r)
        sc = (attq * _heads(k2d, u, H)).sum(-1)
        del attq
        z = torch.exp(act(sc * mu.float().index_select(0, r), 1.0, clip))
        msg = _by_rel(_heads(v2d, u, H), w_msg, r)
        s.index_add_(0, rw, z.double())
        num.index_add_(0, rw, (z[..., None] * msg).reshape(-1, HD).double())
        score[a:b] = sc
    s, num = s.float(), num.float().view(n, H, -1)
    ok = s[..., None] != 0
    out = torch.where(ok, num / torch.where(ok, s[..., None], 1.0), 0.0)
    return s, out, score


def hgt_plain_bwd_dst_plain(v2d, q2d, k2d, w_msg, w_att, mu, src, rel,
                            row_ptr, score, s, out, ct, clip: Optional[float],
                            inv, n_rows: int) -> DstWalk:
    """Plain PyTorch version: each edge's terms beside its destination's
    ``s``, ``ct`` and ``<out, ct>``; ``d_q`` and the weights' gradients
    summed in f64, rounded once.  ``draw`` and ``alpha`` are zero outside
    the walked edges."""
    lo, hi, rows = _walked(row_ptr)
    n, H = row_ptr.numel() - 1, mu.shape[1]
    HD = q2d.shape[1]
    dev = q2d.device
    EP = src.numel()
    draw = torch.zeros(EP, H, dtype=torch.float32, device=dev)
    alpha = torch.zeros_like(draw)
    d_q = torch.zeros(n, HD, dtype=torch.float64, device=dev)
    d_wa = torch.zeros(w_att.shape, dtype=torch.float64, device=dev)
    d_wm = torch.zeros_like(d_wa)
    t2 = (out * ct).sum(-1)
    for a, b in _blocks(lo, hi):
        rw = rows[a - lo:b - lo]
        u, r = src[a:b].long(), rel[a:b].long()
        mu_e = mu.float().index_select(0, r)
        raw = score[a:b] * mu_e
        z = torch.exp(act(raw, 1.0, clip))
        s_d = s.index_select(0, rw)
        al = torch.where(s_d != 0, z / torch.where(s_d != 0, s_d, 1.0), 0.0)
        ve, ctd = _heads(v2d, u, H), ct.index_select(0, rw)
        t1 = (_by_rel(ve, w_msg, r) * ctd).sum(-1)
        dr = al * (t1 - t2.index_select(0, rw)) * act_deriv(raw, 1.0, clip)
        draw[a:b], alpha[a:b] = dr, al
        kd = (dr * mu_e)[..., None] * _heads(k2d, u, H)
        d_q.index_add_(0, rw, _by_rel(kd, w_att, r, transpose=True)
                       .reshape(-1, HD).double())
        _outer_by_rel(d_wa, _heads(q2d, rw, H), kd, r)
        _outer_by_rel(d_wm, al[..., None] * ve, ctd, r)
    score_rows = torch.zeros(n_rows, H, dtype=torch.float32, device=dev)
    draw_rows = torch.zeros_like(score_rows)
    at = inv[lo:hi].long()
    score_rows[at], draw_rows[at] = score[lo:hi], draw[lo:hi]
    return DstWalk(draw, alpha, d_q.float(), d_wm.float(), d_wa.float(),
                   score_rows, draw_rows)


def hgt_plain_bwd_src_plain(q2d, ct, w_msg, w_att, mu, dst, rel, row_ptr,
                            perm, draw, alpha
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: each walked edge's ``dscore q[v] W_att[r]``
    and ``alpha ct[v] W_msg[r]^T`` summed into its source row in f64,
    rounded once.  Returns ``(d_k, d_v)`` (n, H*dk)."""
    lo, hi, rows = _walked(row_ptr)
    n, H = row_ptr.numel() - 1, mu.shape[1]
    HD = q2d.shape[1]
    d_k = torch.zeros(n, HD, dtype=torch.float64, device=q2d.device)
    d_v = torch.zeros_like(d_k)
    ct2d = ct.reshape(ct.shape[0], HD)
    for a, b in _blocks(lo, hi):
        rw = rows[a - lo:b - lo]
        e = perm[a:b].long()
        vd, r = dst.index_select(0, e).long(), rel.index_select(0, e).long()
        ds = draw.index_select(0, e) * mu.float().index_select(0, r)
        d_k.index_add_(0, rw, _by_rel(ds[..., None] * _heads(q2d, vd, H),
                                      w_att, r).reshape(-1, HD).double())
        d_v.index_add_(0, rw, _by_rel(
            alpha.index_select(0, e)[..., None] * _heads(ct2d, vd, H),
            w_msg, r, transpose=True).reshape(-1, HD).double())
    return d_k.float(), d_v.float()


# ---------------------------------------------------------------- checks


def _check_weights(q2d, w_msg, w_att, mu) -> Tuple[int, int, int]:
    """Checks of the weights and the head layout; returns ``(H, dk, R)``."""
    if mu.dim() != 2 or q2d.dim() != 2:
        raise TypeError("mu and q2d must be 2-D")
    R, H = mu.shape
    if H == 0 or q2d.shape[1] % H:
        raise ValueError(f"q2d's {q2d.shape[1]} columns are not H = {H} "
                         "heads")
    dk = q2d.shape[1] // H
    if dk not in WIDTHS or H > MAX_H:
        raise ValueError(f"dk = {dk}, H = {H}: the kernels take dk in "
                         f"{WIDTHS} and H <= {MAX_H}")
    dev = q2d.device
    for name, t in (("w_msg", w_msg), ("w_att", w_att)):
        _check_f32(t, name, (R, H, dk, dk), dev)
    _check_f32(mu, "mu", (R, H), dev)
    _check_f32(q2d, "q2d", q2d.shape, dev)
    return H, dk, R


def _check_nodes(v2d, k2d, q2d):
    dev = q2d.device
    _check_f32(k2d, "k2d", (k2d.shape[0], q2d.shape[1]), dev)
    _check_f32(v2d, "v2d", k2d.shape, dev)


def _check_edges(row_ptr, *named):
    dev = row_ptr.device
    for name, t in named + (("row_ptr", row_ptr),):
        _check_index(t, name, dev)
    if row_ptr.numel() < 1:
        raise ValueError("row_ptr needs at least one entry")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data does not start on 16 bytes (the
    kernels' row loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ------------------------------------------------------------------ cuda


_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)


def _fwd_cuda(v2d, q2d, k2d, w_msg, w_att, mu, src, rel, row_ptr, clip, H,
              dk, R):
    fn = _dispatch.bind("hgt_plain", "het_hgt_plain_fwd", [_P] * 12 + [
        _I64, _INT, _INT, _INT, _I64, _INT, _F, _I64, _I64, _P, _P, _P])
    n, edges, dev = row_ptr.numel() - 1, src.numel(), q2d.device
    s = torch.empty(n, H, dtype=torch.float32, device=dev)
    out = torch.empty(n, H, dk, dtype=torch.float32, device=dev)
    score = torch.empty(edges, H, dtype=torch.float32, device=dev)
    helpers = split_helpers(edges, SPLIT_LEN)
    carry_row = torch.empty(helpers, dtype=torch.int32, device=dev)
    carry = torch.empty(helpers, H * (1 + dk), dtype=torch.float32,
                        device=dev)
    v2d, q2d, k2d = _aligned(v2d), _aligned(q2d), _aligned(k2d)
    with torch.cuda.device(dev):
        err = fn(v2d.data_ptr(), q2d.data_ptr(), k2d.data_ptr(),
                 w_att.data_ptr(), w_msg.data_ptr(), mu.data_ptr(),
                 src.data_ptr(), rel.data_ptr(), row_ptr.data_ptr(),
                 s.data_ptr(), out.data_ptr(), score.data_ptr(), n, H, dk, R,
                 edges, *_clip_args(clip), SPLIT_LEN, helpers,
                 carry_row.data_ptr(), carry.data_ptr(), _stream(q2d))
    _dispatch.check_launch("hgt_plain", err, "hgt_plain_fwd")
    hgt_plain_fwd.launches += 1
    return s, out, score


def _bwd_dst_cuda(v2d, q2d, k2d, w_msg, w_att, mu, src, rel, row_ptr, runs,
                  score, s, out, ct, clip, inv, n_rows, H, dk, R):
    fn = _dispatch.bind("hgt_plain", "het_hgt_plain_bwd_dst", [_P] * 26 + [
        _I64, _INT, _INT, _INT, _I64, _INT, _F, _I64, _I64, _P, _P, _P, _P])
    n, edges, dev = row_ptr.numel() - 1, src.numel(), q2d.device
    HD = H * dk
    n_runs = runs.run_slot.numel()
    draw = torch.empty(edges, H, dtype=torch.float32, device=dev)
    alpha = torch.empty_like(draw)
    # rows no walked edge holds (padding) stay 0
    rows = torch.zeros(2, n_rows, H, dtype=torch.float32, device=dev)
    d_q = torch.empty(n, HD, dtype=torch.float32, device=dev)
    run_rows = torch.empty(4, n_runs, HD, dtype=torch.float32, device=dev)
    helpers = split_helpers(edges, SPLIT_LEN)
    carry_row = torch.empty(2, helpers, dtype=torch.int32, device=dev)
    carry = torch.empty(helpers, 3 * HD, dtype=torch.float32, device=dev)
    v2d, q2d, k2d = _aligned(v2d), _aligned(q2d), _aligned(k2d)
    out, ct = _aligned(out), _aligned(ct)
    with torch.cuda.device(dev):
        err = fn(v2d.data_ptr(), q2d.data_ptr(), k2d.data_ptr(),
                 w_att.data_ptr(), w_msg.data_ptr(), mu.data_ptr(),
                 src.data_ptr(), rel.data_ptr(), row_ptr.data_ptr(),
                 runs.run_ptr.data_ptr(), runs.row_run.data_ptr(),
                 runs.run_slot.data_ptr(), score.data_ptr(), s.data_ptr(),
                 out.data_ptr(), ct.data_ptr(), inv.data_ptr(),
                 draw.data_ptr(), alpha.data_ptr(), rows[0].data_ptr(),
                 rows[1].data_ptr(), d_q.data_ptr(), run_rows[0].data_ptr(),
                 run_rows[1].data_ptr(), run_rows[2].data_ptr(),
                 run_rows[3].data_ptr(), n, H, dk, R, edges,
                 *_clip_args(clip), SPLIT_LEN, helpers,
                 carry_row[0].data_ptr(), carry_row[1].data_ptr(),
                 carry.data_ptr(), _stream(q2d))
    _dispatch.check_launch("hgt_plain", err, "hgt_plain_bwd_dst")
    hgt_plain_bwd_dst.launches += 1
    del carry
    # the weights' gradients: the grouped dW over the runs' rows, a
    # relation a segment (q^T kd for W_att, va^T ct for W_msg)
    run_q, run_ct, run_kd, run_va = run_rows
    shape = (R, H, dk, dk)
    if n_runs == 0:
        d_wm = d_wa = torch.zeros(shape, dtype=torch.float32, device=dev)
    else:
        d_wa = segment_matmul_dw(run_q, run_kd, shape, runs.seg)
        d_wm = segment_matmul_dw(run_va, run_ct, shape, runs.seg)
    return DstWalk(draw, alpha, d_q, d_wm, d_wa, rows[0], rows[1])


def _bwd_src_cuda(q2d, ct, w_msg, w_att, mu, dst, rel, row_ptr, perm, draw,
                  alpha, H, dk, R):
    fn = _dispatch.bind("hgt_plain", "het_hgt_plain_bwd_src", [_P] * 13 + [
        _I64, _INT, _INT, _INT, _I64, _I64, _I64, _P, _P, _P])
    n, edges, dev = row_ptr.numel() - 1, perm.numel(), q2d.device
    HD = H * dk
    d_k = torch.empty(n, HD, dtype=torch.float32, device=dev)
    d_v = torch.empty_like(d_k)
    if n == 0:
        return d_k, d_v
    helpers = split_helpers(edges, SPLIT_LEN)
    carry_row = torch.empty(helpers, dtype=torch.int32, device=dev)
    carry = torch.empty(helpers, 2 * HD, dtype=torch.float32, device=dev)
    q2d, ct = _aligned(q2d), _aligned(ct)
    with torch.cuda.device(dev):
        err = fn(q2d.data_ptr(), ct.data_ptr(), w_att.data_ptr(),
                 w_msg.data_ptr(), mu.data_ptr(), dst.data_ptr(),
                 rel.data_ptr(), row_ptr.data_ptr(), perm.data_ptr(),
                 draw.data_ptr(), alpha.data_ptr(), d_k.data_ptr(),
                 d_v.data_ptr(), n, H, dk, R, edges, SPLIT_LEN, helpers,
                 carry_row.data_ptr(), carry.data_ptr(), _stream(q2d))
    _dispatch.check_launch("hgt_plain", err, "hgt_plain_bwd_src")
    hgt_plain_bwd_src.launches += 1
    return d_k, d_v


# -------------------------------------------------------------- wrappers


def hgt_plain_fwd(v2d: torch.Tensor, q2d: torch.Tensor, k2d: torch.Tensor,
                  w_msg: torch.Tensor, w_att: torch.Tensor, mu: torch.Tensor,
                  src: torch.Tensor, rel: torch.Tensor,
                  row_ptr: torch.Tensor, clip: Optional[float] = None, *,
                  impl: str = "kernel"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward walk over the destination CSR ``row_ptr`` (n + 1,):
    ``v2d``, ``k2d`` (src_space, H*dk), ``q2d`` (n, H*dk), ``w_msg``,
    ``w_att`` (R, H, dk, dk) and ``mu`` (R, H) f32, ``src`` and ``rel``
    (EP,) int32.  Returns ``(s (n, H), out (n, H, dk), score (EP, H))``
    f32."""
    plain = _dispatch.takes_plain(q2d, impl, "hgt_plain_fwd")
    H, dk, R = _check_weights(q2d, w_msg, w_att, mu)
    _check_nodes(v2d, k2d, q2d)
    _check_edges(row_ptr, ("src", src), ("rel", rel))
    if row_ptr.numel() - 1 != q2d.shape[0]:
        raise ValueError("row_ptr must have a row for each row of q2d")
    if plain:
        return hgt_plain_fwd_plain(v2d, q2d, k2d, w_msg, w_att, mu, src, rel,
                                   row_ptr, clip)
    return _fwd_cuda(v2d, q2d, k2d, w_msg, w_att, mu, src, rel, row_ptr,
                     clip, H, dk, R)


def hgt_plain_bwd_dst(v2d: torch.Tensor, q2d: torch.Tensor,
                      k2d: torch.Tensor, w_msg: torch.Tensor,
                      w_att: torch.Tensor, mu: torch.Tensor,
                      src: torch.Tensor, rel: torch.Tensor,
                      row_ptr: torch.Tensor, score: torch.Tensor,
                      s: torch.Tensor, out: torch.Tensor, ct: torch.Tensor,
                      clip: Optional[float], inv: torch.Tensor, n_rows: int,
                      runs: Optional[Runs] = None, *,
                      impl: str = "kernel") -> DstWalk:
    """The backward's destination walk: the forward's operands with its
    ``score`` (EP, H), ``s`` (n, H) and ``out`` (n, H, dk), the cotangent
    ``ct`` (n, H, dk), f32; ``inv`` (EP,) int32 each edge's row of the
    relation-sorted edge rows (``edge_rel_seg.inv``), ``n_rows`` their
    number; on the card the walk's :class:`Runs` (:func:`dst_runs` of
    ``rel`` and ``row_ptr`` where None).  Returns a :class:`DstWalk`,
    f32."""
    plain = _dispatch.takes_plain(q2d, impl, "hgt_plain_bwd_dst")
    H, dk, R = _check_weights(q2d, w_msg, w_att, mu)
    _check_nodes(v2d, k2d, q2d)
    _check_edges(row_ptr, ("src", src), ("rel", rel), ("inv", inv))
    n, dev = row_ptr.numel() - 1, q2d.device
    if n != q2d.shape[0]:
        raise ValueError("row_ptr must have a row for each row of q2d")
    _check_f32(score, "score", (src.numel(), H), dev)
    _check_f32(s, "s", (n, H), dev)
    _check_f32(out, "out", (n, H, dk), dev)
    _check_f32(ct, "ct", (n, H, dk), dev)
    if plain:
        return hgt_plain_bwd_dst_plain(v2d, q2d, k2d, w_msg, w_att, mu, src,
                                       rel, row_ptr, score, s, out, ct, clip,
                                       inv, n_rows)
    if runs is None:
        runs = dst_runs(rel, row_ptr, R)
    return _bwd_dst_cuda(v2d, q2d, k2d, w_msg, w_att, mu, src, rel, row_ptr,
                         runs, score, s, out, ct, clip, inv, n_rows, H, dk,
                         R)


def hgt_plain_bwd_src(q2d: torch.Tensor, ct: torch.Tensor,
                      w_msg: torch.Tensor, w_att: torch.Tensor,
                      mu: torch.Tensor, dst: torch.Tensor, rel: torch.Tensor,
                      row_ptr: torch.Tensor, perm: torch.Tensor,
                      draw: torch.Tensor, alpha: torch.Tensor, *,
                      impl: str = "kernel"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's source walk over ``row_ptr`` (n + 1,) through
    ``perm`` (EP,) int32 canonical edge ids (on the card each source's
    edges sorted by relation, :func:`src_rel_perm`): ``q2d`` (N, H*dk),
    ``ct`` (N, H, dk), the weights, ``draw`` and ``alpha`` (EP, H) f32,
    ``dst`` and ``rel`` (EP,) int32.  Returns ``(d_k, d_v)`` (n, H*dk)
    f32."""
    plain = _dispatch.takes_plain(q2d, impl, "hgt_plain_bwd_src")
    H, dk, R = _check_weights(q2d, w_msg, w_att, mu)
    dev = q2d.device
    _check_f32(ct, "ct", (q2d.shape[0], H, dk), dev)
    _check_f32(draw, "draw", (draw.shape[0], H), dev)
    _check_f32(alpha, "alpha", draw.shape, dev)
    _check_edges(row_ptr, ("dst", dst), ("rel", rel), ("perm", perm))
    if plain:
        return hgt_plain_bwd_src_plain(q2d, ct, w_msg, w_att, mu, dst, rel,
                                       row_ptr, perm, draw, alpha)
    return _bwd_src_cuda(q2d, ct, w_msg, w_att, mu, dst, rel, row_ptr, perm,
                         draw, alpha, H, dk, R)


# launches of each CUDA kernel (a walk and its fix-up) since its count was
# last set to 0
hgt_plain_fwd.launches = 0
hgt_plain_bwd_dst.launches = 0
hgt_plain_bwd_src.launches = 0
