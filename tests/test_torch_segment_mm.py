"""The port's segment-matmul kernels' plain versions (what a CPU tensor
runs) against het_tpu's Pallas kernels in interpret mode: the grouped dW
against ``segment_matmul_rows_dw`` and the XLA ``segment_sum`` formula,
the forward and dX against ``segment_matmul_rows_fwd`` and
``segment_matmul_rows_dx``, on segmentations with an empty segment, for
head-broadcast and per-head x, O = 1 and O = 5, on the resident branch
and on the streamed one (W past its 4 MB VMEM budget, few rows); and
``segment_matmul`` on offsets that live only on the device against
``jax.vjp`` of ``segment_matmul_rows_pallas``.
Tolerance: rtol 1e-4 / atol 2e-4 (the repo's forward parity one; f32 sums
in another order).  Also checks that the kernel-vs-plain limit on the card,
1e-6 * sum |x| |ct| per output, holds for f32 and fails for TF32 inputs."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from het_tpu.graph.build import build_segments as j_build_segments
from het_tpu.ops.pallas.segment_mm import (W_RESIDENT_BYTES,
                                           segment_matmul_rows_dw,
                                           segment_matmul_rows_dx,
                                           segment_matmul_rows_fwd,
                                           segment_matmul_rows_pallas)
from het_tpu_torch.graph.build import build_segments as t_build_segments
from het_tpu_torch.ops import segment_matmul
from het_tpu_torch.ops.kernels import (segment_matmul_dw,
                                       segment_matmul_dw_plain,
                                       segment_matmul_dx, segment_matmul_fwd)
from het_tpu_torch.ops.kernels.segment_mm import dx_dims

TOL = dict(rtol=1e-4, atol=2e-4)
S, H, EMPTY = 4, 2, 1  # segment 1 owns no rows


def _case(Hx, O, branch):
    """x, ct, w_shape and both packages' Segments: 3 of 4 segments own
    rows (tile 8), segment ``EMPTY`` none."""
    rng = np.random.default_rng(Hx * 10 + O)
    # past the VMEM budget only through K: the row count stays small
    K = 12 if branch == "resident" else W_RESIDENT_BYTES // (S * H * O * 4) + 8
    seg_of_row = rng.choice([0, 2, 3], size=21)
    jseg = j_build_segments(seg_of_row, S, 8)
    tseg = t_build_segments(seg_of_row, S, 8)
    n = jseg.n_rows
    x = rng.standard_normal((n, Hx * K)).astype(np.float32)
    ct = rng.standard_normal((n, H * O)).astype(np.float32)
    w_shape = (S, H, K, O)
    resident = np.prod(w_shape) * 4 <= W_RESIDENT_BYTES
    assert resident == (branch == "resident")
    return x, ct, w_shape, jseg, tseg


def _formula(x, ct, w_shape, jseg):
    """dW by XLA: per-row outer products summed by ``segment_sum``."""
    S_, H_, K, O = w_shape
    x3 = jnp.asarray(x).reshape(x.shape[0], -1, K)
    x3 = jnp.broadcast_to(x3, (x.shape[0], H_, K))
    ct3 = jnp.asarray(ct).reshape(ct.shape[0], H_, O)
    outer = jnp.einsum("nhk,nho->nhko", x3, ct3)
    return np.asarray(jax.ops.segment_sum(
        outer, jnp.asarray(jseg.row_seg), num_segments=S_,
        indices_are_sorted=True))


@pytest.mark.parametrize("branch", ["resident", "streamed"])
@pytest.mark.parametrize("O", [1, 5, 17])  # 17: NC = H*O past 16 at Hx = 1
@pytest.mark.parametrize("Hx", [1, H])
def test_plain_dw_matches_pallas_and_formula(Hx, O, branch):
    x, ct, w_shape, jseg, tseg = _case(Hx, O, branch)
    got = segment_matmul_dw(torch.from_numpy(x), torch.from_numpy(ct),
                            w_shape, tseg).numpy()
    assert got.shape == w_shape and got.dtype == np.float32
    np.testing.assert_allclose(got, _formula(x, ct, w_shape, jseg), **TOL)
    assert (got[EMPTY] == 0).all()
    # het_tpu reads per-head x only in its 3-D (n_rows, Hx, K) form
    x_j = x.reshape(x.shape[0], Hx, -1) if Hx > 1 else x
    pallas = np.asarray(segment_matmul_rows_dw(
        jnp.asarray(x_j), jnp.asarray(ct), w_shape, jseg, interpret=True))
    owned = [s for s in range(S) if s != EMPTY]
    np.testing.assert_allclose(got[owned], pallas[owned], **TOL)
    if branch == "resident":
        np.testing.assert_allclose(got[EMPTY], pallas[EMPTY], **TOL)
    # the streamed TPU kernel never writes the block of a segment with no
    # row tile (ROADMAP.md section 3): the port gives the formula's zeros


def test_plain_dw_takes_3d_rows_and_rejects_bad_shapes():
    x, ct, w_shape, _, tseg = _case(H, 5, "resident")
    n, K = x.shape[0], w_shape[2]
    flat = segment_matmul_dw_plain(torch.from_numpy(x), torch.from_numpy(ct),
                                   w_shape, tseg)
    heads = segment_matmul_dw(torch.from_numpy(x).view(n, H, K),
                              torch.from_numpy(ct).view(n, H, 5), w_shape,
                              tseg)
    assert torch.equal(flat, heads)
    with pytest.raises(ValueError):
        segment_matmul_dw(torch.zeros(n, 3 * K), torch.from_numpy(ct),
                          w_shape, tseg)
    with pytest.raises(ValueError):
        segment_matmul_dw(torch.from_numpy(x), torch.from_numpy(ct),
                          (S + 1,) + w_shape[1:], tseg)
    with pytest.raises(ValueError, match="impl"):
        segment_matmul_dw(torch.from_numpy(x), torch.from_numpy(ct),
                          w_shape, tseg, impl="cuda")


def _tf32(t):
    """``t`` rounded to TF32 (10-bit mantissa, to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


@pytest.mark.parametrize("H_,Hx,K,O", [
    (4, 4, 16, 1), (1, 1, 64, 64),
    # the shapes of the kernel's narrow and wide regimes on the paths
    (4, 1, 64, 17), (4, 1, 64, 3), (4, 1, 64, 1), (4, 1, 64, 16),
    (4, 1, 64, 2), (4, 4, 2, 1)])
def test_dw_limit_tells_f32_from_tf32(H_, Hx, K, O):
    """The limit 1e-6 * sum |x| |ct| that holds the CUDA dW against its
    plain version: the f32 plain version stays inside it against a float64
    sum, and the same sum of TF32-rounded inputs (what a tensor-core dW
    would compute) does not."""
    rng = np.random.default_rng(K + O)
    tseg = t_build_segments(np.repeat([0, 2, 3], [12000, 3000, 500]), S, 128)
    n = tseg.n_rows
    x = torch.from_numpy(rng.standard_normal((n, Hx * K)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((n, H_ * O)).astype(np.float32))
    w_shape = (S, H_, K, O)
    exact = torch.zeros(w_shape, dtype=torch.float64)
    ptrs = tseg.seg_ptrs_static
    for s in range(S):  # float64, one einsum per segment
        xs = x[ptrs[s]:ptrs[s + 1]].double().view(-1, Hx, K)
        cs = ct[ptrs[s]:ptrs[s + 1]].double().view(-1, H_, O)
        exact[s] = torch.einsum("nhk,nho->hko", xs.expand(-1, H_, K), cs)
    limit = 1e-6 * segment_matmul_dw_plain(x.abs(), ct.abs(), w_shape, tseg)
    f32 = segment_matmul_dw(x, ct, w_shape, tseg)
    tf32 = segment_matmul_dw(_tf32(x), _tf32(ct), w_shape, tseg)
    assert ((f32.double() - exact).abs() <= limit).all()
    assert not ((tf32.double() - exact).abs() <= limit).all()


# ------------------------------------------------------------ forward, dX


def _fwd_case(Hx, O, branch):
    """x (n, Hx*K), ct (n, H*O), w (S, H, K, O) and both packages'
    Segments on :func:`_case`'s rows (segment ``EMPTY`` owns none).  The
    streamed branch passes the VMEM budget through K and O together
    (O = K), so neither direction sums over more than a few hundred
    terms."""
    rng = np.random.default_rng(Hx * 10 + (O or 0))
    if branch == "resident":
        K = 12
    else:
        K = O = math.isqrt(W_RESIDENT_BYTES // (S * H * 4)) + 8
    seg_of_row = rng.choice([0, 2, 3], size=21)
    jseg = j_build_segments(seg_of_row, S, 8)
    tseg = t_build_segments(seg_of_row, S, 8)
    n = jseg.n_rows
    x = rng.standard_normal((n, Hx * K)).astype(np.float32)
    ct = rng.standard_normal((n, H * O)).astype(np.float32)
    w = rng.standard_normal((S, H, K, O)).astype(np.float32)
    assert (w.nbytes <= W_RESIDENT_BYTES) == (branch == "resident")
    return x, ct, w, jseg, tseg


@pytest.mark.parametrize("branch,O", [("resident", 1), ("resident", 5),
                                      ("streamed", None)])
@pytest.mark.parametrize("Hx", [1, H])
def test_plain_fwd_and_dx_match_pallas(Hx, branch, O):
    """The plain forward and dX (what a CPU tensor runs) against
    het_tpu's ``segment_matmul_rows_fwd`` / ``segment_matmul_rows_dx``
    (Pallas, interpret mode), on the resident and the streamed branch;
    the forward also against the per-row formula in float64."""
    x, ct, w, jseg, tseg = _fwd_case(Hx, O, branch)
    n, K, O = x.shape[0], w.shape[2], w.shape[3]
    x_j = x.reshape(n, Hx, K) if Hx > 1 else x
    y = segment_matmul_fwd(torch.from_numpy(x), torch.from_numpy(w), tseg)
    assert y.shape == (n, H, O)
    y_j = segment_matmul_rows_fwd(jnp.asarray(x_j), jnp.asarray(w), jseg,
                                  interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    x3 = np.broadcast_to(x.reshape(n, Hx, K), (n, H, K)).astype(np.float64)
    formula = np.einsum("nhk,nhko->nho", x3, w[np.asarray(jseg.row_seg)])
    np.testing.assert_allclose(y.numpy(), formula, **TOL)

    dx = segment_matmul_dx(torch.from_numpy(ct), torch.from_numpy(w), tseg,
                           Hx)
    assert dx.shape == (n, Hx * K)
    dx_j = segment_matmul_rows_dx(jnp.asarray(ct), jnp.asarray(w), jseg,
                                  Hx > 1, Hx, interpret=True)
    np.testing.assert_allclose(dx.numpy(),
                               np.asarray(dx_j).reshape(n, Hx * K), **TOL)


def test_plain_fwd_and_dx_zero_rows_outside_the_segments():
    """Rows past ``seg_ptrs[S]`` (the operand may be longer than the
    segment space) come out as zeros in both directions."""
    tseg = t_build_segments(np.array([0, 0, 2, 2, 2]), 3, 4)
    n = tseg.n_rows + 5
    w = torch.randn(3, 2, 3, 4)
    y = segment_matmul_fwd(torch.randn(n, 3), w, tseg)
    dx = segment_matmul_dx(torch.randn(n, 8), w, tseg, 2)
    assert (y[tseg.n_rows:] == 0).all() and (dx[tseg.n_rows:] == 0).all()
    assert y[:tseg.n_rows].abs().sum() > 0
    with pytest.raises(ValueError):
        segment_matmul_dx(torch.randn(n, 8), w, tseg, 3)
    with pytest.raises(ValueError):
        segment_matmul_fwd(torch.randn(2, 3), w, tseg)


def _device_only(seg):
    """``seg`` with its offsets on the device only, as on a shard."""
    return dataclasses.replace(seg, seg_ptrs_static=None)


@pytest.mark.parametrize("Hx", [1, H])
def test_plain_dw_reads_device_offsets(Hx):
    """With ``seg_ptrs_static = None`` the plain dW reads ``seg_ptrs``
    and gives what it gives with the host copy."""
    x, ct, w_shape, _, tseg = _case(Hx, 5, "resident")
    xt, ctt = torch.from_numpy(x), torch.from_numpy(ct)
    want = segment_matmul_dw_plain(xt, ctt, w_shape, tseg)
    got = segment_matmul_dw_plain(xt, ctt, w_shape, _device_only(tseg))
    assert torch.equal(got, want)
    assert want.abs().sum() > 0


def test_segment_matmul_on_device_offsets_matches_pallas_vjp():
    """The port's ``segment_matmul`` on a segmentation without host
    offsets (the kernels' autograd path, plain versions on the CPU):
    output and both gradients against ``jax.vjp`` of het_tpu's
    ``segment_matmul_rows_pallas``."""
    x, ct, w, jseg, tseg = _fwd_case(1, 5, "resident")
    jseg_dev = dataclasses.replace(jseg, seg_ptrs_static=None)
    y_j, vjp = jax.vjp(lambda a, b: segment_matmul_rows_pallas(a, b,
                                                               jseg_dev),
                       jnp.asarray(x), jnp.asarray(w))
    n = x.shape[0]
    ct3 = ct.reshape(n, H, 5)
    dx_j, dw_j = vjp(jnp.asarray(ct3))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = segment_matmul(xt, wt, _device_only(tseg))
    y.backward(torch.from_numpy(ct3))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), **TOL)
    # and the same values as the host-offset path (per-relation matmuls)
    y_static = segment_matmul(torch.from_numpy(x), torch.from_numpy(w), tseg)
    np.testing.assert_allclose(y_static.numpy(), y.detach().numpy(), **TOL)


# (n_rows, S, H, Hx, K, O): the dW shapes of the training paths (rank 0's
# shard in the data-parallel runs) and the general and edge shapes
PLAN_SHAPES = [
    (527360, 4, 4, 1, 64, 17), (527360, 4, 4, 1, 64, 3),
    (312064, 4, 4, 1, 64, 1), (1056896, 4, 4, 1, 64, 16),
    (1056896, 4, 4, 1, 64, 2), (1056896, 4, 4, 4, 16, 1),
    (2112384, 4, 4, 4, 2, 1), (674176, 4, 4, 4, 16, 1),
    (1000192, 4, 1, 1, 64, 64), (1034496, 535, 1, 1, 64, 64),
    (960, 3, 3, 1, 70, 30), (47, 2, 1, 1, 1, 65), (960, 3, 2, 2, 70, 5),
    (0, 3, 2, 2, 4, 3), (304, 1, 1, 1, 64, 64), (40, 4, 2, 2, 8, 1),
    # HGT's per-head typed linears on rank 0's shard: compact and edge
    # rows, d_k = 16 and 2
    (527360, 4, 4, 4, 16, 16), (312064, 4, 4, 4, 2, 2),
    (1056896, 4, 4, 4, 16, 16), (1056896, 4, 4, 4, 2, 2),
]


def _resident(plan):
    """A stand-in for the card's occupancy: blocks an SM holds."""
    return 4 if plan.wide else 7


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_dw_plan_covers_the_operands(shape, aligned):
    """The dW kernel's launch plan (``dw_plan``): narrow for NC <= 16 ct
    columns an x column meets, wide past it with column tiles that cover
    NC in as few passes as 96-wide ones would; a narrow row team covers a
    row of x in one pass where 32 lanes can; 16-byte loads only on aligned
    rows; chunks that fit the grid's bound, a multiple of the wide
    kernel's 32-row stage, partials within 1/16 of the inputs."""
    from het_tpu_torch.ops.kernels.segment_mm import (NARROW_COLS, WIDE_COLS,
                                                      WIDE_K, dw_plan)
    n, S_, H_, Hx, K, O = shape
    p = dw_plan(n, S_, H_, Hx, K, O, aligned, aligned, 132, _resident)
    nc = O if Hx > 1 else H_ * O
    xw = Hx * K
    assert p.wide == (nc > 16)
    if p.wide:
        assert p.cols in WIDE_COLS and not p.ct_vec
        assert p.cols * -(-nc // p.cols) >= nc
        assert -(-nc // p.cols) == -(-nc // 96)  # no extra column pass
        assert p.tiles == ((H_ if Hx > 1 else 1) * -(-K // WIDE_K)
                           * -(-nc // p.cols))
        assert p.vec == (aligned and K % 4 == 0 and nc % 4 == 0
                         and H_ * O % 4 == 0)
    else:
        assert p.cols in NARROW_COLS and p.cols >= nc
        assert p.cols == min(c for c in NARROW_COLS if c >= nc)
        assert p.tiles == 1
        assert p.vec == (aligned and xw % 4 == 0)
        assert p.ct_vec == (aligned and Hx == 1 and nc % 4 == 0)
        width = xw // 4 if p.vec else xw  # loads a row
        assert p.lanes & (p.lanes - 1) == 0 and 1 <= p.lanes <= 32
        assert p.lanes >= min(width, 32) and p.lanes < 2 * max(width, 1)
    assert p.chunk_rows % 32 == 0 and p.chunk_rows >= 256
    assert p.chunks == -(-n // p.chunk_rows) + S_
    partial = (p.chunks - S_) * H_ * K * O
    assert partial <= max(n, p.chunk_rows) * (xw + H_ * O) / 16 + H_ * K * O


def test_dw_plan_fills_whole_waves():
    """The chunk pass's blocks fill the card's resident slots for a whole
    number of waves: on the training paths' shapes one wave, whose chunks
    (one extra a segment at most) all start at once and fill at least
    three quarters of it; at S = 535, two."""
    from het_tpu_torch.ops.kernels.segment_mm import dw_plan
    for n, S_, H_, Hx, K, O in PLAN_SHAPES[:10]:
        p = dw_plan(n, S_, H_, Hx, K, O, True, True, 132, _resident)
        slots = 132 * _resident(p)
        waves = 2 if S_ == 535 else 1
        assert 0.75 * waves * slots <= p.chunks * p.tiles <= waves * slots, (
            n, O, p)
    # x at K = 64 shared by 4 heads: one row of x for all 68 columns
    assert dw_plan(527360, 4, 4, 1, 64, 17, True, True, 132,
                   _resident).tiles == 1


# (n_rows, S, H, Hx, K, O): the forward shapes of the data-parallel runs
# (rank 0's shard), the general shapes and edge cases
FWD_PLAN_SHAPES = [
    (527360, 4, 4, 1, 64, 17), (312064, 4, 4, 1, 64, 1),
    (527360, 4, 4, 1, 64, 3), (1056896, 4, 4, 1, 64, 16),
    (1056896, 4, 4, 1, 64, 2), (1000192, 4, 1, 1, 64, 64),
    (1034496, 535, 1, 1, 64, 64), (64, 4, 2, 1, 8, 3), (304, 1, 1, 1, 64, 64),
    (960, 3, 1, 1, 1, 64), (960, 3, 2, 1, 8, 1), (1208, 3, 4, 4, 16, 5),
    (0, 3, 2, 2, 3, 1), (4000, 3, 4, 1, 63, 17), (4000, 3, 4, 1, 63, 1),
    (4000, 3, 2, 1, 64, 100), (1000, 3, 4, 1, 700, 100), (7, 1, 3, 3, 129, 2),
    # HGT's per-head typed linears (d_k = 16 and 2)
    (527360, 4, 4, 4, 16, 16), (312064, 4, 4, 4, 2, 2),
    (1056896, 4, 4, 4, 2, 2),
]


def _fwd_resident(plan):
    """A stand-in for the card's occupancy: blocks an SM holds."""
    return 6 if plan.depth else 3 if plan.cols > 16 else 4


@pytest.mark.parametrize("shape", FWD_PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_fwd_plan_covers_the_operands(shape, aligned):
    """The forward's launch plan (``fwd_plan``): a narrow column tile for
    Cg <= 16 output columns a group (Cg rounded up to a multiple of 4), a
    wide one past it that covers Cg in as few passes as 96-wide ones
    would; 16-byte loads only on aligned rows of a K that is a multiple of
    4; a grid of whole tiles that covers every row and stays within one
    wave of resident blocks, with no idle block."""
    from het_tpu_torch.ops.kernels.segment_mm import (FWD_NARROW_COLS,
                                                      FWD_ROWS, WIDE_COLS,
                                                      fwd_plan)
    n, _, H_, Hx, K, O = shape
    p = fwd_plan(n, H_, Hx, K, O, aligned, 132, _fwd_resident)
    cg = O if Hx > 1 else H_ * O
    assert p.vec == (aligned and K % 4 == 0)
    assert (p.cols in WIDE_COLS) == (cg > 16)
    if cg > 16:
        assert p.cols in WIDE_COLS
        assert -(-cg // p.cols) == -(-cg // 96)  # no extra column pass
    else:
        assert p.cols == min(c for c in FWD_NARROW_COLS if c >= cg)
    assert p.tiles == (H_ if Hx > 1 else 1) * -(-cg // p.cols)
    assert p.rows % FWD_ROWS == 0 and p.blocks >= 1
    assert p.blocks * p.rows >= n  # every row, zeros included
    assert (p.blocks - 1) * p.rows < max(n, 1)  # no idle block
    assert p.blocks * p.tiles <= max(132 * _fwd_resident(p), p.tiles)


def test_fwd_plan_reads_x_once_on_the_paths():
    """On the data-parallel shapes x is read in one pass: a narrow tile
    for the attention and layer-1 columns (C = 4, 8, 12), one wide column
    pass for C = 64 and C = 68 (an 80-column tile), with float4 loads;
    and each fills at least three quarters of one wave of resident
    blocks."""
    from het_tpu_torch.ops.kernels.segment_mm import fwd_plan
    want = {1: 4, 3: 12, 2: 8, 16: 64, 17: 80}
    for n, _, H_, Hx, K, O in FWD_PLAN_SHAPES[:5]:
        p = fwd_plan(n, H_, Hx, K, O, True, 132, _fwd_resident)
        assert p.cols == want[O] and p.tiles == 1 and p.vec
        slots = 132 * _fwd_resident(p)
        assert 0.75 * slots <= p.blocks <= slots


# (n_rows, S, H, Hx, K, O) of the dX: the data-parallel runs' shapes
# (rank 0's shard; R = H*O = 12, 4, 8 against K = 64), the general shapes
# and the kernel tests' reduction and output axes
DX_PLAN_SHAPES = [
    (527360, 4, 4, 1, 64, 3), (312064, 4, 4, 1, 64, 1),
    (1056896, 4, 4, 1, 64, 2), (1000192, 4, 1, 1, 64, 64),
    (1034496, 535, 1, 1, 64, 64), (4000, 3, 4, 1, 64, 4),
    (4000, 3, 1, 1, 64, 17), (4000, 3, 1, 1, 64, 3), (1208, 3, 4, 4, 16, 5),
    (1208, 3, 4, 4, 17, 5), (4000, 3, 4, 1, 130, 1), (4000, 3, 2, 1, 64, 100),
    (4000, 3, 4, 1, 63, 17), (47, 2, 1, 1, 1, 65), (0, 3, 2, 2, 3, 1),
    (7, 1, 3, 3, 129, 2),
    # HGT's per-head typed linears (d_k = 16 and 2)
    (527360, 4, 4, 4, 16, 16), (1056896, 4, 4, 4, 2, 2),
]


@pytest.mark.parametrize("shape", DX_PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_dx_plan_covers_the_operands(shape, aligned):
    """The dX's launch plan (``dx_plan``) on the mapped dimensions
    (``dx_dims``): one group of all H*O ct columns against dx's K where dx
    is summed over the heads, O against K a head otherwise.  A reduction R
    of 1-16 columns against K > 16 takes the dX rows tile (R rounded up to
    4, passes of 64 columns); every other shape is ``fwd_plan`` on those
    dimensions (narrow for K <= 16, wide passes past it, k tiles past R =
    64).  16-byte loads where R is a multiple of 4 on an aligned ct,
    whatever K is; Hx times the column passes along y; a grid of whole
    tiles within one wave."""
    from het_tpu_torch.ops.kernels.segment_mm import (DX_ROWS_COLS,
                                                      FWD_NARROW_COLS,
                                                      FWD_ROWS, WIDE_COLS,
                                                      dx_plan, fwd_plan)
    n, _, H_, Hx, K, O = shape
    R = O if Hx > 1 else H_ * O
    dims = dx_dims(H_, Hx, K, O)
    assert dims == ((H_, H_, O, K) if Hx > 1 else (1, 1, H_ * O, K))
    p = dx_plan(n, H_, Hx, K, O, aligned, 132, _fwd_resident)
    assert p.vec == (aligned and R % 4 == 0)
    if 0 < R <= 16 and K > 16:
        assert p.depth == -(-R // 4) * 4 and p.cols == DX_ROWS_COLS
    else:
        assert p == fwd_plan(n, *dims, aligned, 132, _fwd_resident)
        assert p.depth == 0
        if K > 16:
            assert p.cols in WIDE_COLS
            assert -(-K // p.cols) == -(-K // 96)  # no extra column pass
        else:
            assert p.cols == min(c for c in FWD_NARROW_COLS if c >= K)
    assert p.tiles == Hx * -(-K // p.cols)
    assert p.rows % FWD_ROWS == 0 and p.blocks * p.rows >= n
    assert (p.blocks - 1) * p.rows < max(n, 1)  # no idle block
    assert p.blocks * p.tiles <= max(132 * _fwd_resident(p), p.tiles)


def test_dx_plan_on_the_paths():
    """The data-parallel dX shapes (R = 12, 4, 8 ct columns against K =
    64) take the dX rows tile in one 64-column pass with float4 loads of
    ct, and fill at least three quarters of one wave of resident blocks."""
    from het_tpu_torch.ops.kernels.segment_mm import dx_plan
    for n, _, H_, Hx, K, O in DX_PLAN_SHAPES[:3]:
        p = dx_plan(n, H_, Hx, K, O, True, 132, _fwd_resident)
        assert p.depth == 4 * O and p.cols == 64 and p.tiles == 1 and p.vec
        slots = 132 * _fwd_resident(p)
        assert 0.75 * slots <= p.blocks <= slots


def _dx_weight(w, H_, Hx, K, O):
    """W' (S, H', K', O') in the forward's dimensions of the dX, entry by
    entry from the flat W as ``csrc/segment_mm.cu``'s ``w_entry<true>``
    addresses it: W'[s, g, k, c] = W[s, j / O, c, j % O], j = g K' + k."""
    S_ = w.shape[0]
    H2, G, K2, O2 = dims = dx_dims(H_, Hx, K, O)
    flat = w.reshape(-1)
    out = np.empty((S_, H2, K2, O2), np.float32)
    for s in range(S_):
        for g in range(H2):
            for k in range(K2):
                j = g * K2 + k
                h = j // O
                for c in range(O2):
                    out[s, g, k, c] = flat[s * G * K2 * O2 + (h * O2 + c) * O
                                           + (j - h * O)]
    return out, dims


@pytest.mark.parametrize("H_,Hx,K,O", [(4, 1, 8, 3), (4, 4, 8, 3),
                                       (2, 1, 5, 1), (3, 3, 17, 2)])
def test_dx_is_the_forward_with_w_read_transposed(H_, Hx, K, O):
    """The kernels' dX mapping: het_tpu's Pallas forward
    (``segment_matmul_rows_fwd``, interpret mode) of ct against W' as the
    dX kernel addresses it (``_dx_weight``) equals het_tpu's Pallas dX
    (``segment_matmul_rows_dx``) and the port's plain dX, within TOL."""
    rng = np.random.default_rng(K * 10 + O)
    seg_of_row = rng.choice([0, 2, 3], size=21)
    jseg = j_build_segments(seg_of_row, S, 8)
    tseg = t_build_segments(seg_of_row, S, 8)
    n = jseg.n_rows
    ct = rng.standard_normal((n, H_ * O)).astype(np.float32)
    w = rng.standard_normal((S, H_, K, O)).astype(np.float32)
    w2, (H2, G, K2, O2) = _dx_weight(w, H_, Hx, K, O)
    ct_j = ct.reshape(n, G, K2) if G > 1 else ct
    y_j = segment_matmul_rows_fwd(jnp.asarray(ct_j), jnp.asarray(w2), jseg,
                                  interpret=True)
    dx_j = segment_matmul_rows_dx(jnp.asarray(ct), jnp.asarray(w), jseg,
                                  Hx > 1, Hx, interpret=True)
    np.testing.assert_allclose(np.asarray(y_j).reshape(n, Hx * K),
                               np.asarray(dx_j).reshape(n, Hx * K), **TOL)
    dx = segment_matmul_dx(torch.from_numpy(ct), torch.from_numpy(w), tseg,
                           Hx)
    np.testing.assert_allclose(np.asarray(y_j).reshape(n, Hx * K),
                               dx.numpy(), **TOL)
