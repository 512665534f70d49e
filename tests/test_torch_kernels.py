"""The port's CUDA kernels against their plain versions on the card.

This file imports neither JAX nor het_tpu, so it also runs where only
PyTorch is installed, on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_kernels.py

Without a GPU every test skips."""

import numpy as np
import pytest
import torch

from het_tpu_torch.graph import random_heterograph
from het_tpu_torch.graph.build import build_heterograph
from het_tpu_torch.ops import kernels
from het_tpu_torch.ops.fused_agg import CLIP_LOGIT, CompactFusedGATPacked
from het_tpu_torch.ops.kernels import (compact_gat_packed_bwd_dst,
                                       compact_gat_packed_bwd_dst_plain,
                                       compact_gat_packed_bwd_src,
                                       compact_gat_packed_bwd_src_plain,
                                       compact_gat_packed_fwd,
                                       compact_gat_packed_fwd_plain,
                                       force_rowmajor, force_rowmajor_plain,
                                       seg_max_sorted, seg_max_sorted_plain,
                                       seg_sum_sorted, seg_sum_sorted_plain,
                                       segment_matmul_dw,
                                       segment_matmul_dw_plain,
                                       segment_matmul_dx,
                                       segment_matmul_dx_plain,
                                       segment_matmul_fwd,
                                       segment_matmul_fwd_plain)

DW_TOL = 1e-6  # segment_matmul_dw: times sum |x| |ct| per output
MM_TOL = 1e-5  # forward and dX: times sum |x| |W| per output


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 3, 4, 12, 64, 68, 200])
def test_seg_sum_kernel_matches_plain(cuda, C):
    """Narrow, scalar, vector and wide payloads, with and without perm, on
    a hub-heavy graph.  Tolerance: rtol 1e-5, atol 1e-5 * max|out| (f32
    sums in another order)."""
    g = random_heterograph(num_nodes=300, num_edges=5000, num_rels=4,
                           power_law=True).to(cuda)
    info = g.compact_src
    gen = torch.Generator(device=cuda).manual_seed(C)
    vals = torch.randn(g.num_padded_edges, C, device=cuda, generator=gen)
    for ptr, perm in ((g.in_row_ptr, None),
                      (info.edge_row_ptr, info.edge_sort_perm)):
        seg_sum_sorted.launches = 0
        got = seg_sum_sorted(vals, ptr, perm)
        torch.cuda.synchronize()
        assert seg_sum_sorted.launches == 1
        want = seg_sum_sorted_plain(vals, ptr, perm)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


def _hub_rows(dev, C, hub=100_000, seed=0, perm=False):
    """One hub row of ``hub`` edges among 5000 rows of 1-3 edges, the
    row pointer starting at 7, NaN rows before it and past its end (the
    kernel must read neither)."""
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, 4, (5000,), generator=gen)
    lengths[1234] = hub
    ptr = torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)]) + 7
    rows = int(ptr[-1]) + 11
    vals = torch.randn(rows, C, generator=gen)
    order = (torch.randperm(rows, generator=gen) if perm
             else torch.arange(rows))
    vals[order[:7]] = float("nan")
    vals[order[int(ptr[-1]):]] = float("nan")
    return (vals.to(dev), ptr.to(torch.int32).to(dev),
            order.to(torch.int32).to(dev) if perm else None)


@pytest.mark.gpu
@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("C", [1, 3, 4, 12, 64, 68, 200])
def test_seg_sum_kernel_hub_and_short_rows(cuda, C, perm):
    """A hub row split over many workers and short rows packed into one,
    with and without perm; rtol 1e-5, atol 1e-5 * max|out|."""
    vals, ptr, order = _hub_rows(cuda, C, perm=perm)
    seg_sum_sorted.launches = 0
    got = seg_sum_sorted(vals, ptr, order)
    torch.cuda.synchronize()
    assert seg_sum_sorted.launches == 1
    want = seg_sum_sorted_plain(vals, ptr, order)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 68])
def test_seg_sum_kernel_hub_row_is_deterministic(cuda, C):
    vals, ptr, _ = _hub_rows(cuda, C, hub=300_000, seed=1)
    a = seg_sum_sorted(vals, ptr)
    b = seg_sum_sorted(vals, ptr)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_seg_sum_kernel_is_deterministic(cuda):
    g = random_heterograph(num_nodes=200, num_edges=4000, num_rels=3,
                           power_law=True).to(cuda)
    vals = torch.randn(g.num_padded_edges, 68, device=cuda)
    a = seg_sum_sorted(vals, g.in_row_ptr)
    b = seg_sum_sorted(vals, g.in_row_ptr)
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_seg_sum_rejects_cpu_index_for_cuda_values(cuda):
    vals = torch.randn(10, 4, device=cuda)
    ptr = torch.tensor([0, 3, 10], dtype=torch.int32)
    with pytest.raises(ValueError):
        seg_sum_sorted(vals, ptr)


def _bf16_ulp(t):
    """One bf16 unit in the last place of each entry of ``t`` (8
    significant bits; the smallest normal's for zeros)."""
    _, e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _check_sum(vals, ptr, perm=None, out_dtype=torch.float32):
    """One segment-sum launch against the plain version (the same rows
    summed in f64, rounded once to ``out_dtype``).  f32 sums: rtol 1e-5,
    atol 1e-5 * max|out|.  bf16 sums: within one bf16 ulp of the plain
    version's rounded sum past that f32 limit, since each is a sum in f32
    rounded once.  Returns the kernel's result."""
    seg_sum_sorted.launches = 0
    got = seg_sum_sorted(vals, ptr, perm, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert seg_sum_sorted.launches == 1 and got.dtype == out_dtype
    want = seg_sum_sorted_plain(vals, ptr, perm, out_dtype)
    g, w = got.float(), want.float()
    limit = 1e-5 * w.abs() + 1e-5 * w.abs().max().item()
    if out_dtype == torch.bfloat16:
        limit = limit + torch.maximum(_bf16_ulp(g), _bf16_ulp(w))
    assert got.shape == want.shape
    assert ((g - w).abs() <= limit).all(), (g - w).abs().max()
    return got


# the segment sum's (rows, sums) element types
SUM_PAIRS = [pytest.param((torch.float32, torch.float32), id="f32-f32"),
             pytest.param((torch.bfloat16, torch.float32), id="bf16-f32"),
             pytest.param((torch.bfloat16, torch.bfloat16), id="bf16-bf16")]


@pytest.mark.gpu
@pytest.mark.parametrize("pair", SUM_PAIRS)
@pytest.mark.parametrize("C", [1, 4, 8, 16, 64, 68, 256])
def test_seg_sum_kernel_dtype_pairs_match_plain(cuda, C, pair):
    """Every (rows, sums) pair at the widths the models give (C = 1-8 the
    narrow terms, 16 and 64 the wide ones, 68 a row of 17 four-element
    loads, 256 GAT's), over the destination CSR (empty rows included) and
    through ``perm``, then a hub row of 100,000 edges among short rows,
    with NaN rows outside the row pointer that the kernel must not read.
    Twice each, bit for bit."""
    in_dt, out_dt = pair
    g = random_heterograph(num_nodes=300, num_edges=5000, num_rels=4,
                           power_law=True).to(cuda)
    counts = g.in_row_ptr[1:] - g.in_row_ptr[:-1]
    assert (counts == 0).any()  # empty rows
    info = g.compact_src
    gen = torch.Generator(device=cuda).manual_seed(C)
    vals = torch.randn(g.num_padded_edges, C, device=cuda,
                       generator=gen).to(in_dt)
    for ptr, perm in ((g.in_row_ptr, None),
                      (info.edge_row_ptr, info.edge_sort_perm)):
        got = _check_sum(vals, ptr, perm, out_dt)
        assert torch.equal(got, seg_sum_sorted(vals, ptr, perm,
                                               out_dtype=out_dt))
    for perm in (False, True):
        hv, hp, order = _hub_rows(cuda, C, perm=perm)
        hv = hv.to(in_dt)
        got = _check_sum(hv, hp, order, out_dt)
        assert torch.isfinite(got).all()
        assert torch.equal(got, seg_sum_sorted(hv, hp, order,
                                               out_dtype=out_dt))


@pytest.mark.gpu
@pytest.mark.parametrize("pair", SUM_PAIRS[1:])
@pytest.mark.parametrize("C", [1, 3, 4, 6, 12, 64, 68])
def test_seg_sum_kernel_unaligned_bf16_rows(cuda, C, pair):
    """bf16 rows that start 2 bytes into their storage (a contiguous
    view), so the loads narrow to what the address allows (C % 8 != 0
    and unaligned bases: 8-, 4- or 2-byte loads), into f32 or bf16 sums."""
    in_dt, out_dt = pair
    g = random_heterograph(num_nodes=300, num_edges=5000, num_rels=4,
                           power_law=True).to(cuda)
    n = g.num_padded_edges
    gen = torch.Generator(device=cuda).manual_seed(C)
    flat = torch.randn(n * C + 1, device=cuda, generator=gen).to(in_dt)
    vals = flat[1:].view(n, C)
    assert vals.is_contiguous() and vals.data_ptr() % 4 != 0
    _check_sum(vals, g.in_row_ptr, None, out_dt)
    _check_sum(vals, g.compact_src.edge_row_ptr, g.compact_src.edge_sort_perm,
               out_dt)


def test_seg_sum_rejects_other_dtype_pairs():
    """The pairs outside SUM_DTYPES raise before any launch: f32 rows into
    bf16 sums, f16 or f64 rows, f32 sums of f64."""
    ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    for dt, out in ((torch.float32, torch.bfloat16),
                    (torch.float16, None), (torch.float64, None),
                    (torch.bfloat16, torch.float16)):
        with pytest.raises(TypeError):
            seg_sum_sorted(torch.ones(3, 4, dtype=dt), ptr, out_dtype=out)


def _tf32(t):
    """``t`` rounded to TF32 (10-bit mantissa, to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _segments(sizes, tile):
    """Segments over rows grouped by the given per-segment row counts."""
    import numpy as np
    from het_tpu_torch.graph.build import build_segments

    seg_of_row = np.repeat(np.arange(len(sizes)), sizes)
    return build_segments(seg_of_row, len(sizes), tile)


def _check_dw(x, ct, w_shape, seg, sizes=()):
    """One dW launch against the plain version.  Tolerance: DW_TOL *
    sum |x| |ct| per output (f32 sums in another order), which the plain
    version on inputs rounded to TF32 fails; empty segments are exactly
    zero.  Returns the kernel's result."""
    segment_matmul_dw.launches = 0
    got = segment_matmul_dw(x, ct, w_shape, seg)
    torch.cuda.synchronize()
    assert segment_matmul_dw.launches == 1
    want = segment_matmul_dw_plain(x, ct, w_shape, seg)
    scale = segment_matmul_dw_plain(x.abs(), ct.abs(), w_shape, seg)
    assert got.shape == want.shape
    assert ((got - want).abs() <= DW_TOL * scale).all()
    if scale.any():
        tf32 = segment_matmul_dw_plain(_tf32(x), _tf32(ct), w_shape, seg)
        assert not ((tf32 - want).abs() <= DW_TOL * scale).all()
    for s, size in enumerate(sizes):
        if size == 0:
            assert (got[s] == 0).all()
    return got


def _chunk_rows(n_rows, S, H, Hx, K, O, dev):
    """Rows a chunk of the dW kernel's plan for such operands."""
    from het_tpu_torch.ops.kernels.segment_mm import card_dw_plan

    return card_dw_plan(torch.zeros(n_rows, Hx * K, device=dev),
                        torch.zeros(n_rows, H * O, device=dev),
                        (S, H, K, O)).chunk_rows


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,H,Hx,K,O", [
    ((5000, 0, 3000, 17), 4, 4, 16, 1),  # the attention-vector shape
    ((5000, 0, 3000, 17), 4, 4, 2, 1),  # H*K = 8: two float4 a row
    ((5000, 0, 3000, 17), 2, 1, 8, 1),  # head-broadcast x
    ((4100, 0, 70, 9000), 1, 1, 64, 64),  # segment-matmul dW
    ((4100, 0, 70, 9000), 2, 2, 70, 5),  # ragged k and o tiles
    ((4100, 0, 70, 9000), 4, 1, 64, 17),  # shared x: 68 columns, one pass
    ((5000, 0, 3000, 17), 3, 1, 70, 30),  # shared x, heads across tiles
    ((0, 0, 0), 2, 2, 3, 1),  # every segment empty
    ((300,), 1, 1, 1, 1),  # one segment, K = O = 1
    ((40, 7), 1, 1, 1, 65),  # K = 1, O past one tile
    ((5000, 0, 3000, 17), 4, 1, 64, 1),  # W.a_r on a shard: NC = 4
    ((5000, 0, 3000, 17), 4, 1, 64, 3),  # [W.a_l | W] at layer 1: NC = 12
    ((5000, 0, 3000, 17), 4, 1, 64, 2),  # edge-row W at layer 1: NC = 8
    ((5000, 0, 3000, 17), 4, 1, 64, 16),  # edge-row W at layer 0: NC = 64
    ((2000, 33, 0, 900), 4, 1, 64, 17),  # x not 16-byte aligned
    ((2000, 33, 0, 900), 4, 1, 64, 3),  # x not 16-byte aligned, narrow
    ((2000, 33, 0, 900), 4, 4, 16, 1),  # x not 16-byte aligned, per head
    ("chunk+1", 4, 1, 64, 17),  # one segment a row past a chunk, wide
    ("chunk+1", 4, 1, 64, 1),  # the same, narrow
    # HGT's per-head typed linears (a row a head, d_k = 16 and 2) and its
    # layer-2 output projection a_linears (8 x 8)
    ((5000, 0, 3000, 17), 4, 4, 16, 16),
    ((5000, 0, 3000, 17), 4, 4, 2, 2),
    ((2000, 33, 0, 900), 4, 4, 2, 2),  # x not 16-byte aligned, K = 2
    ((5000, 0, 3000, 17), 1, 1, 8, 8),
])
def test_segment_matmul_dw_kernel_matches_plain(cuda, sizes, H, Hx, K, O):
    """Every kernel and load width the plan picks (narrow NC <= 16, wide
    NC > 16; float4 and scalar rows), against the plain version."""
    tile = 8
    if sizes == "chunk+1":  # rows a chunk, from the plan for ~that size
        tile = 1  # no padding: the segment is exactly one row past
        rows = _chunk_rows(3000, 2, H, Hx, K, O, cuda)
        sizes = (rows + 1, 3000 - rows - 1)
        assert _chunk_rows(3000, 2, H, Hx, K, O, cuda) == rows
    seg = _segments(sizes, tile=tile).to(cuda)
    n = seg.n_rows
    gen = torch.Generator(device=cuda).manual_seed(n + K + O)
    x = torch.randn(n, Hx * K, device=cuda, generator=gen)
    if 33 in sizes:  # a contiguous view one float into its storage
        x = torch.randn(n * Hx * K + 1, device=cuda,
                        generator=gen)[1:].view(n, Hx * K)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    ct = torch.randn(n, H * O, device=cuda, generator=gen)
    _check_dw(x, ct, (len(sizes), H, K, O), seg, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hx,K,O", [(4, 1, 64, 17), (4, 1, 64, 1),
                                      (4, 4, 16, 1), (1, 1, 64, 64)])
def test_segment_matmul_dw_kernel_reads_no_row_outside(cuda, H, Hx, K, O):
    """Rows before seg_ptrs[0] and past seg_ptrs[S] hold NaN: the result is
    finite and within the limit of the plain version (which reads only
    the segments' rows)."""
    import dataclasses

    lead, tail = 37, 45
    base = _segments((3000, 0, 1500, 9), tile=1)
    ptrs = tuple(p + lead for p in base.seg_ptrs_static)
    seg = dataclasses.replace(
        base, n_rows=ptrs[-1], seg_ptrs=torch.tensor(ptrs, dtype=torch.int32),
        seg_ptrs_static=ptrs).to(cuda)
    n = ptrs[-1] + tail
    gen = torch.Generator(device=cuda).manual_seed(K + O)
    x = torch.randn(n, Hx * K, device=cuda, generator=gen)
    ct = torch.randn(n, H * O, device=cuda, generator=gen)
    for t in (x, ct):
        t[:lead] = float("nan")
        t[ptrs[-1]:] = float("nan")
    got = _check_dw(x, ct, (4, H, K, O), seg, (3000, 0, 1500, 9))
    assert torch.isfinite(got).all()


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hx,K,O", [(4, 4, 16, 1), (4, 1, 64, 17)])
def test_segment_matmul_dw_kernel_is_deterministic(cuda, H, Hx, K, O):
    """Segments of several chunks each: three calls, bit for bit."""
    seg = _segments((30000, 100, 20000), tile=128).to(cuda)
    assert _chunk_rows(seg.n_rows, 3, H, Hx, K, O, cuda) < 20000
    x = torch.randn(seg.n_rows, Hx * K, device=cuda)
    ct = torch.randn(seg.n_rows, H * O, device=cuda)
    a = segment_matmul_dw(x, ct, (3, H, K, O), seg)
    for _ in range(2):
        assert torch.equal(a, segment_matmul_dw(x, ct, (3, H, K, O), seg))


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,H,Hx,K,O", [
    ((5000, 0, 3000, 17), 4, 4, 16, 1),  # plain RGAT's a_l/a_r, layer 0
    ((5000, 0, 3000, 17), 4, 4, 2, 1),  # the same at layer 1
    ((5000, 0, 3000, 17), 4, 4, 1, 1),  # HGT's relation_pri: K = O = 1
    ((4100, 0, 70, 9000), 1, 1, 64, 64),  # the general K = O = 64, S = 4
    ((4100, 0, 70, 9000), 2, 2, 70, 5),  # ragged k tiles, 2-byte copies
    ((5000, 0, 3000, 17), 4, 1, 64, 17),  # 68 columns: 2-byte copies
    ((5000, 0, 3000, 17), 4, 1, 64, 3),  # shared x, narrow, NC = 12
    ((2000, 33, 0, 900), 4, 4, 16, 1),  # x not 16-byte aligned, per head
    ((2000, 33, 0, 900), 1, 1, 64, 64),  # x not 16-byte aligned, wide
    ((0, 0, 0), 2, 2, 3, 1),  # every segment empty
])
def test_segment_matmul_dw_bf16_kernel_matches_plain(cuda, sizes, H, Hx, K,
                                                     O):
    """bf16 x and ct into the f32 dW, against the plain version (the
    operands widened to f32 exactly).  Tolerance DW_TOL * sum |x| |ct| as
    for f32: each product of two bf16 values is exact in f32.  (The TF32
    control of f32 does not apply: bf16 values are exact in TF32.)  Twice
    each, bit for bit."""
    seg = _segments(sizes, tile=8).to(cuda)
    n = seg.n_rows
    gen = torch.Generator(device=cuda).manual_seed(n + K + O)
    x = torch.randn(n, Hx * K, device=cuda, generator=gen).bfloat16()
    if 33 in sizes:  # a contiguous view one element into its storage
        x = torch.randn(n * Hx * K + 1, device=cuda,
                        generator=gen).bfloat16()[1:].view(n, Hx * K)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    ct = torch.randn(n, H * O, device=cuda, generator=gen).bfloat16()
    w_shape = (len(sizes), H, K, O)
    segment_matmul_dw.launches = 0
    got = segment_matmul_dw(x, ct, w_shape, seg)
    torch.cuda.synchronize()
    assert segment_matmul_dw.launches == 1 and got.dtype == torch.float32
    want = segment_matmul_dw_plain(x, ct, w_shape, seg)
    scale = segment_matmul_dw_plain(x.abs(), ct.abs(), w_shape, seg)
    assert ((got - want).abs() <= DW_TOL * scale).all()
    for s, size in enumerate(sizes):
        if size == 0:
            assert (got[s] == 0).all()
    assert torch.equal(got, segment_matmul_dw(x, ct, w_shape, seg))


def test_segment_matmul_dw_rejects_mixed_dtypes():
    """x and ct must share f32 or bf16."""
    import numpy as np
    from het_tpu_torch.graph.build import build_segments

    seg = build_segments(np.repeat(np.arange(2), (3, 5)), 2, 8)
    x = torch.ones(seg.n_rows, 4)
    for a, b in ((x, x.bfloat16()), (x.bfloat16(), x), (x.half(), x.half())):
        with pytest.raises(TypeError):
            segment_matmul_dw(a, b[:, :1], (2, 1, 4, 1), seg)


# 200 segments of 0-19 rows (padded to 0-24): 64-row tiles cross many
SHORT_SEGMENTS = tuple(i * 7 % 20 for i in range(200))


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,H,Hx,K,O", [
    ((5000, 0, 3000, 17), 4, 1, 64, 17),  # compact multiply-first source
    ((5000, 0, 3000, 17), 4, 1, 64, 1),  # attention-vector columns
    ((5000, 0, 3000, 17), 4, 4, 16, 5),  # per-head x; dX: narrow, K = 16
    ((4100, 0, 70, 9000), 1, 1, 64, 64),  # general shape
    ((200, 300, 0, 100), 4, 1, 700, 100),  # W past 4 MB: 1.1e6 floats
    ((0, 0, 0), 2, 2, 3, 1),  # every segment empty
    ((300,), 1, 1, 1, 1),  # one segment, K = O = 1
    ((40, 7), 1, 1, 1, 65),  # K = 1, O past one column tile
    ((5000, 0, 3000, 17), 4, 1, 64, 2),  # edge-row W at layer 1: C = 8
    ((5000, 0, 3000, 17), 4, 1, 64, 3),  # [W.a_l | W] at layer 1: C = 12
    ((5000, 0, 3000, 17), 4, 1, 64, 16),  # edge-row W at layer 0: C = 64
    ((3000, 0, 900), 2, 1, 64, 100),  # C = 200: three wide passes
    ((2000, 33, 0, 900), 4, 1, 64, 17),  # x and ct not 16-byte aligned, wide
    ((2000, 33, 0, 900), 4, 1, 64, 1),  # x and ct not 16-byte aligned, narrow
    ((3000, 0, 900), 4, 1, 63, 17),  # K = 63: 4-byte loads, wide
    ((3000, 0, 900), 4, 1, 63, 1),  # K = 63: 4-byte loads, narrow
    ((3000, 0, 900), 4, 1, 130, 1),  # narrow, three k tiles, 4-byte loads
    ((3000, 0, 900), 2, 2, 100, 3),  # narrow per head, two k tiles
    (SHORT_SEGMENTS, 4, 1, 64, 17),  # tiles across many segments, wide
    (SHORT_SEGMENTS, 4, 1, 64, 3),  # tasks across many segments, narrow
    # the dX's reduction (R = H*O, or O a head) and output (K) axes
    ((5000, 0, 3000, 17), 4, 1, 64, 4),  # R = 16
    ((5000, 0, 3000, 17), 1, 1, 64, 17),  # R = 17: 4-byte ct loads
    ((5000, 0, 3000, 17), 1, 1, 64, 3),  # R = 3: a ct row of 12 bytes
    ((5000, 0, 3000, 17), 4, 4, 17, 5),  # per head, K = 17: wide output
    ((5000, 0, 3000, 17), 4, 4, 16, 4),  # per head, K = 16, float4 ct
    ((2000, 33, 0, 900), 4, 1, 64, 3),  # ct not 16-byte aligned, R = 12
    (SHORT_SEGMENTS, 4, 1, 16, 3),  # narrow dX across many segments
    # HGT's per-head typed linears (d_k = 16 and 2) and a_linears (8 x 8)
    ((5000, 0, 3000, 17), 4, 4, 16, 16),
    ((5000, 0, 3000, 17), 4, 4, 2, 2),
    ((2000, 33, 0, 900), 4, 4, 2, 2),  # not 16-byte aligned, K = O = 2
    (SHORT_SEGMENTS, 4, 4, 2, 2),  # per head across many segments
    ((5000, 0, 3000, 17), 1, 1, 8, 8),
])
def test_segment_matmul_fwd_dx_kernels_match_plain(cuda, sizes, H, Hx, K,
                                                   O):
    """Forward and dX on offsets held only on the device: the forward's
    narrow (C <= 16) and wide kernels, 16- and 4-byte loads, and the dX on
    the same kernels (K output columns a group, a reduction of H*O or O
    columns).  Tolerance: MM_TOL * sum |x| |W| per output (f32 sums in
    another order), which the plain version on inputs rounded to TF32
    fails.  Rows before and past the segments hold NaN in both operands:
    they are written as zeros and never read.  A second call is bit for
    bit the same."""
    import dataclasses

    lead, tail = 5, 8
    base = _segments(sizes, tile=8)
    ptrs = tuple(p + lead for p in base.seg_ptrs_static)
    seg = dataclasses.replace(
        base, n_rows=ptrs[-1], seg_ptrs=torch.tensor(ptrs, dtype=torch.int32),
        seg_ptrs_static=None).to(cuda)
    n = ptrs[-1] + tail
    gen = torch.Generator(device=cuda).manual_seed(n + K + O)
    w = torch.randn(len(sizes), H, K, O, device=cuda, generator=gen)
    operands = []
    for width in (Hx * K, H * O):
        if 33 in sizes:  # a contiguous view one float into its storage
            a = torch.randn(n * width + 1, device=cuda,
                            generator=gen)[1:].view(n, width)
            assert a.is_contiguous() and a.data_ptr() % 16 != 0
        else:
            a = torch.randn(n, width, device=cuda, generator=gen)
        a[:lead] = float("nan")
        a[ptrs[-1]:] = float("nan")
        operands.append(a)
    x, ct = operands
    for fn, plain, a, extra in (
            (segment_matmul_fwd, segment_matmul_fwd_plain, x, ()),
            (segment_matmul_dx, segment_matmul_dx_plain, ct, (Hx,))):
        fn.launches = 0
        got = fn(a, w, seg, *extra)
        torch.cuda.synchronize()
        assert fn.launches == (1 if got.numel() else 0)
        assert torch.isfinite(got).all()
        assert torch.equal(got, fn(a, w, seg, *extra))
        want = plain(a, w, seg, *extra)
        scale = plain(a.abs(), w.abs(), seg, *extra)  # reads no NaN row
        assert got.shape == want.shape
        assert ((got - want).abs() <= MM_TOL * scale).all()
        assert (got[:lead] == 0).all() and (got[ptrs[-1]:] == 0).all()
        if scale.any():
            tf32 = plain(_tf32(a), _tf32(w), seg, *extra)
            assert not ((tf32 - want).abs() <= MM_TOL * scale).all()


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hx,K,O", [(4, 1, 64, 17), (4, 1, 64, 1),
                                      (4, 4, 16, 5), (1, 1, 64, 64)])
def test_segment_matmul_fwd_kernel_reads_no_row_outside(cuda, H, Hx, K, O):
    """Rows of x before seg_ptrs[0] and past seg_ptrs[S] hold NaN: the
    forward never reads them and writes zeros there; the segments' rows
    are within MM_TOL * sum |x| |W| of the plain version."""
    import dataclasses

    lead, tail = 37, 45
    base = _segments((3000, 0, 1500, 9), tile=1)
    ptrs = tuple(p + lead for p in base.seg_ptrs_static)
    seg = dataclasses.replace(
        base, n_rows=ptrs[-1], seg_ptrs=torch.tensor(ptrs, dtype=torch.int32),
        seg_ptrs_static=None).to(cuda)
    n = ptrs[-1] + tail
    gen = torch.Generator(device=cuda).manual_seed(K + O)
    x = torch.randn(n, Hx * K, device=cuda, generator=gen)
    w = torch.randn(4, H, K, O, device=cuda, generator=gen)
    x[:lead] = float("nan")
    x[ptrs[-1]:] = float("nan")
    got = segment_matmul_fwd(x, w, seg)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got[:lead] == 0).all() and (got[ptrs[-1]:] == 0).all()
    inside = slice(lead, ptrs[-1])
    want = segment_matmul_fwd_plain(x, w, seg)[inside]
    scale = segment_matmul_fwd_plain(x[inside].abs(), w.abs(),
                                     base.to(cuda))
    assert ((got[inside] - want).abs() <= MM_TOL * scale).all()


@pytest.mark.gpu
@pytest.mark.parametrize("H,Hx,K,O", [(4, 1, 64, 17), (4, 1, 64, 3),
                                      (1, 1, 64, 64)])
def test_segment_matmul_fwd_kernel_is_deterministic(cuda, H, Hx, K, O):
    """Blocks over many tiles and segments: three calls, bit for bit."""
    seg = _segments((30000, 100, 20000) + SHORT_SEGMENTS, tile=1).to(cuda)
    x = torch.randn(seg.n_rows, Hx * K, device=cuda)
    w = torch.randn(seg.n_segments, H, K, O, device=cuda)
    a = segment_matmul_fwd(x, w, seg)
    for _ in range(2):
        assert torch.equal(a, segment_matmul_fwd(x, w, seg))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 3, 4, 8, 68])
@pytest.mark.parametrize("values", ["normal", "negative", "inf_nan"])
def test_seg_max_kernel_equals_plain(cuda, C, values):
    """Bit for bit: max is exact.  Destination segments of a hub-heavy
    graph, plus the run segments; empty segments, +-inf and NaN give 0."""
    g = random_heterograph(num_nodes=300, num_edges=5000, num_rels=4,
                           power_law=True).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(C)
    vals = torch.randn(g.num_padded_edges, C, device=cuda, generator=gen)
    if values == "negative":
        vals = -vals.abs() - 1.0
    elif values == "inf_nan":
        hit = torch.rand(vals.shape, device=cuda, generator=gen)
        vals[hit < 0.03] = float("inf")
        vals[hit > 0.95] = float("-inf")
        vals[(hit > 0.5) & (hit < 0.505)] = float("nan")
    for ptr in (g.in_row_ptr, g.compact_dst.canon_ptr):
        seg_max_sorted.launches = 0
        got = seg_max_sorted(vals, ptr)
        torch.cuda.synchronize()
        assert seg_max_sorted.launches == 1
        assert torch.equal(got, seg_max_sorted_plain(vals, ptr))


@pytest.mark.gpu
@pytest.mark.parametrize("ptr", [[0, 0, 5, 5, 12, 30, 30], [3, 4, 4, 5, 40],
                                 [9, 9, 9], [7]])
def test_seg_max_kernel_edge_cases(cuda, ptr):
    vals = torch.randn(40, 4, device=cuda)
    ptr = torch.tensor(ptr, dtype=torch.int32, device=cuda)
    got = seg_max_sorted(vals, ptr)
    torch.cuda.synchronize()
    assert got.shape == (ptr.numel() - 1, 4)
    assert torch.equal(got, seg_max_sorted_plain(vals, ptr))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 4, 12])
def test_seg_max_kernel_nan_in_another_chunk(cuda, C):
    """A hub row with a NaN in one worker's chunk and a +inf in another's
    (both map to 0 only after the partials meet), a -inf that the rest of
    its column outweighs: bit for bit."""
    vals, ptr, _ = _hub_rows(cuda, C)
    hub = int(ptr[1234])
    vals[hub + 1000, 0] = float("nan")
    vals[hub + 90_000, C - 1] = float("inf")
    vals[hub + 50_000] = float("-inf")
    got = seg_max_sorted(vals, ptr)
    torch.cuda.synchronize()
    want = seg_max_sorted_plain(vals, ptr)
    assert torch.equal(got, want)
    assert got[1234, 0] == 0 and got[1234, C - 1] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["fe_lanes", "transposed", "contiguous",
                                  "column_slice", "empty", "odd_rows",
                                  "odd_3d"])
def test_force_rowmajor_kernel_equals_plain(cuda, view):
    gen = torch.Generator(device=cuda).manual_seed(1)
    if view == "fe_lanes":  # the feature lanes of a packed (UC, H, 1+D)
        x = torch.randn(3001, 4, 17, device=cuda, generator=gen)[..., 1:]
    elif view == "transposed":
        x = torch.randn(68, 4001, device=cuda, generator=gen).t()
    elif view == "contiguous":
        x = torch.randn(2000, 33, device=cuda, generator=gen)
    elif view == "column_slice":
        x = torch.randn(999, 70, device=cuda, generator=gen)[:, 3:67]
    elif view == "odd_rows":  # W % 4 != 0: rows not 16-byte aligned
        x = torch.randn(1001, 70, device=cuda, generator=gen)[:, 2:9]
    elif view == "odd_3d":  # W = 3 * 5, total not a multiple of 4
        x = torch.randn(333, 3, 8, device=cuda, generator=gen)[..., 1:6]
    else:
        x = torch.randn(0, 16, device=cuda)
    force_rowmajor.launches = 0
    got = force_rowmajor(x)
    torch.cuda.synchronize()
    assert force_rowmajor.launches == (1 if x.numel() else 0)
    assert got.is_contiguous() and torch.equal(got, force_rowmajor_plain(x))


# ------------------------------------------------- packed compact GAT walks

WALKS = ("compact_gat_packed_fwd", "compact_gat_packed_bwd_dst",
         "compact_gat_packed_bwd_src")


def _skewed_graph(dev, num_nodes=2000, num_edges=40_000, num_rels=3):
    """Destinations by 1 / (1 + id): node 0's run of about 4,900 edges
    spans many of the walks' chunks, node 5 has no in-edge; a quarter of
    the edges leave node 7, whose source compact rows run past a chunk;
    padding edges and padding compact rows (tile 8)."""
    rng = np.random.default_rng(3)
    w = 1.0 / (1.0 + np.arange(num_nodes))
    w[5] = 0.0
    dst = rng.choice(num_nodes, size=num_edges, p=w / w.sum())
    src = rng.integers(0, num_nodes, size=num_edges)
    src[: num_edges // 4] = 7
    rel = rng.integers(0, num_rels, size=num_edges)
    return build_heterograph(src, dst, rel, num_nodes, num_rels,
                             tile=8).to(dev)


def _walk_inputs(g, H, D, stable, dev):
    """fe2d, er_c and ct; under "clip" logits far past the clip (both
    signs), under "raw" moderate ones."""
    gen = torch.Generator(device=dev).manual_seed(H * 100 + D)
    scale = 60.0 if stable == "clip" else 1.0
    UCs, UCd = g.compact_src.seg.n_rows, g.compact_dst.seg.n_rows
    fe = torch.randn(UCs, H, 1 + D, device=dev, generator=gen)
    fe[..., 0] *= scale
    er = torch.randn(UCd, H, device=dev, generator=gen) * scale
    ct = torch.randn(g.num_nodes, H, D, device=dev, generator=gen)
    return fe.reshape(UCs, -1), er, ct


def _close(got, want):
    """f32 sums in another order: rtol 1e-5, atol 1e-5 * max|want|."""
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.fixture(scope="module")
def skewed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return _skewed_graph(torch.device("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("stable", ["raw", "clip"])
@pytest.mark.parametrize("H,D", [(1, 8), (8, 8), (1, 64), (8, 64)])
def test_compact_gat_walks_match_plain(cuda, skewed, H, D, stable):
    """Each walk against its plain version on the same inputs (the
    backward walks on the plain forward's s and out, the source walk on
    the plain draw and alpha), one launch each, and a second launch equal
    bit for bit."""
    g = skewed
    fe2d, er, ct = _walk_inputs(g, H, D, stable, cuda)
    clip = CLIP_LOGIT if stable == "clip" else None
    src, dst = g.compact_src, g.compact_dst
    rows = (src.edge_map, dst.edge_map, g.in_row_ptr)
    kernels.reset_launches()
    s, out = compact_gat_packed_fwd(fe2d, er, *rows, 0.2, clip)
    s_p, out_p = compact_gat_packed_fwd_plain(fe2d, er, *rows, 0.2, clip)
    torch.cuda.synchronize()
    _close(s, s_p)
    _close(out, out_p)
    assert (s[5] == 0).all() and (out[5] == 0).all()
    draw, alpha = compact_gat_packed_bwd_dst(fe2d, er, *rows, s_p, out_p,
                                             ct, 0.2, clip)
    draw_p, alpha_p = compact_gat_packed_bwd_dst_plain(
        fe2d, er, *rows, s_p, out_p, ct, 0.2, clip)
    E = g.num_edges
    torch.cuda.synchronize()
    _close(draw[:E], draw_p[:E])
    _close(alpha[:E], alpha_p[:E])
    walk3 = (ct, g.dst, src.edge_row_ptr, src.edge_sort_perm)
    d_fe = compact_gat_packed_bwd_src(draw_p, alpha_p, *walk3)
    torch.cuda.synchronize()
    _close(d_fe, compact_gat_packed_bwd_src_plain(draw_p, alpha_p, *walk3))
    assert {k: kernels.launch_counts()[k] for k in WALKS} == dict.fromkeys(
        WALKS, 1)
    again = (compact_gat_packed_fwd(fe2d, er, *rows, 0.2, clip),
             compact_gat_packed_bwd_dst(fe2d, er, *rows, s_p, out_p, ct,
                                        0.2, clip),
             compact_gat_packed_bwd_src(draw_p, alpha_p, *walk3))
    assert all(torch.equal(a, b) for a, b in zip(again[0], (s, out)))
    assert torch.equal(again[1][0][:E], draw[:E])
    assert torch.equal(again[2], d_fe)


def _op(g, fe2d, er, ct, stable, impl):
    """The op's output and the gradients of <out, ct>, with the launches
    of the forward and of the backward."""
    fe2d = fe2d.clone().requires_grad_()
    er = er.clone().requires_grad_()
    kernels.reset_launches()
    out = CompactFusedGATPacked.apply(fe2d, er, g, 0.2, stable, impl)
    torch.cuda.synchronize()
    fwd = {k: n for k, n in kernels.launch_counts().items() if n}
    kernels.reset_launches()
    d_fe, d_er = torch.autograd.grad((out * ct.to(out.dtype)).sum(),
                                     (fe2d, er))
    torch.cuda.synchronize()
    bwd = {k: n for k, n in kernels.launch_counts().items() if n}
    return (out.detach(), d_fe, d_er), fwd, bwd


@pytest.mark.gpu
@pytest.mark.parametrize("stable", ["raw", "clip"])
@pytest.mark.parametrize("H,D", [(1, 8), (8, 8), (1, 64), (8, 64)])
def test_compact_gat_op_walks_match_its_chain(cuda, skewed, H, D, stable):
    """The op on the card in f32 takes the walks: out, d_fe and d_er
    against its chain (impl="plain"); a forward launches the forward walk,
    a backward the two backward walks and d_er's segment sum."""
    g = skewed
    fe2d, er, ct = _walk_inputs(g, H, D, stable, cuda)
    got, fwd, bwd = _op(g, fe2d, er, ct, stable, "kernel")
    want, _, _ = _op(g, fe2d, er, ct, stable, "plain")
    for a, b in zip(got, want):
        _close(a, b)
    assert fwd == {"compact_gat_packed_fwd": 1}
    assert bwd == {"compact_gat_packed_bwd_dst": 1,
                   "compact_gat_packed_bwd_src": 1, "seg_sum_sorted": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bf16", "max"])
def test_compact_gat_op_bf16_and_max_keep_the_chain(cuda, skewed, case):
    g = skewed
    fe2d, er, ct = _walk_inputs(g, 8, 8, "raw", cuda)
    if case == "bf16":
        fe2d, er = fe2d.bfloat16(), er.bfloat16()
    _, fwd, bwd = _op(g, fe2d, er, ct, "max" if case == "max" else "clip",
                      "kernel")
    assert not (set(fwd) | set(bwd)) & set(WALKS)
    assert fwd["seg_sum_sorted"] == 2 and bwd["seg_sum_sorted"] > 1
