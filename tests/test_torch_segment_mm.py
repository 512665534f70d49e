"""The port's grouped dW (plain version, which is what a CPU tensor runs)
against het_tpu's ``segment_matmul_rows_dw`` (Pallas, interpret mode) and
the XLA ``segment_sum`` formula, on segmentations with an empty segment,
for head-broadcast and per-head x, O = 1 and O = 5, on the resident
branch and on the streamed one (W past its 4 MB VMEM budget, few rows).
Tolerance: rtol 1e-4 / atol 2e-4 (the repo's forward parity one; f32 sums
in another order).  Also checks that the kernel-vs-plain limit on the card,
1e-6 * sum |x| |ct| per output, holds for f32 and fails for TF32 inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from het_tpu.graph.build import build_segments as j_build_segments
from het_tpu.ops.pallas.segment_mm import (W_RESIDENT_BYTES,
                                           segment_matmul_rows_dw)
from het_tpu_torch.graph.build import build_segments as t_build_segments
from het_tpu_torch.ops.kernels import (segment_matmul_dw,
                                       segment_matmul_dw_plain)

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
@pytest.mark.parametrize("O", [1, 5])
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


@pytest.mark.parametrize("H_,Hx,K,O", [(4, 4, 16, 1), (1, 1, 64, 64)])
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
