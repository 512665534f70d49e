"""The port's sorted segment sum (plain version, which is what a CPU
tensor runs) against het_tpu's ``seg_sum_sorted_packed`` (Pallas,
interpret mode) and a numpy loop, on every segmentation the RGAT training
step reduces over.  Tolerance 1e-5: f32 sums in a different order.

The segment max against het_tpu's ``seg_max_dst_pallas_raw`` (interpret
mode) and ``_segment_max_dst`` (XLA), and the row copy against
``force_rowmajor`` (interpret mode): both exactly, max being exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.graph.build import build_tile_tables
from het_tpu.ops.pallas.seg_reduce import (force_rowmajor as j_rowmajor,
                                           seg_max_dst_pallas_raw,
                                           seg_sum_sorted_packed)
from het_tpu.ops.spmm import _segment_max_dst
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.ops.kernels import (force_rowmajor, force_rowmajor_plain,
                                       seg_max_sorted, seg_max_sorted_plain,
                                       seg_sum_sorted, seg_sum_sorted_plain)
from het_tpu_torch.ops.kernels.seg_reduce import split_helpers, split_len

TOL = dict(rtol=1e-5, atol=1e-5)


def _loop(vals, ptr, perm=None):
    n = len(ptr) - 1
    out = np.zeros((n, vals.shape[1]), np.float64)
    for r in range(n):
        for e in range(ptr[r], ptr[r + 1]):
            out[r] += vals[perm[e] if perm is not None else e]
    return out


def _segmentations(jg, tg):
    """(name, rows of vals, jax args, torch ptr, torch perm) for the four
    segmentations of the compact multiply-first RGAT step."""
    EP, E = jg.num_padded_edges, jg.num_edges
    jS, jD = jg.compact_src, jg.compact_dst
    tS, tD = tg.compact_src, tg.compact_dst
    n_runs = int(jD.canon_ptr.shape[0]) - 1
    return {
        "in": (EP, (jg.in_row_ptr, jg.num_nodes, EP, E, jg.in_tables, None),
               tg.in_row_ptr, None),
        "canon": (EP, (jD.canon_ptr, n_runs, EP, E, jD.canon_tables, None),
                  tD.canon_ptr, None),
        "edge_src": (EP, (jS.edge_row_ptr, jS.seg.n_rows, EP, E,
                          jS.edge_tables, jS.edge_sort_perm),
                     tS.edge_row_ptr, tS.edge_sort_perm),
        "node_dst": (jD.seg.n_rows,
                     (jD.node_row_ptr, jg.num_nodes, jD.seg.n_rows,
                      jD.seg.n_src, jD.node_tables, jD.node_sort_perm),
                     tD.node_row_ptr, tD.node_sort_perm),
    }


@pytest.fixture(scope="module")
def graphs():
    kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=2, tile=8)
    return j_random_heterograph(**kw), t_random_heterograph(**kw)


@pytest.mark.parametrize("C", [1, 4, 12, 68])
@pytest.mark.parametrize("seg", ["in", "canon", "edge_src", "node_dst"])
def test_plain_matches_pallas_and_loop(graphs, seg, C):
    jg, tg = graphs
    rows, (ptr, n, EP, E, tables, perm), t_ptr, t_perm = \
        _segmentations(jg, tg)[seg]
    vals = np.random.default_rng(C).standard_normal((rows, C)).astype(
        np.float32)
    want = seg_sum_sorted_packed(
        [jnp.asarray(vals)], C, jnp.float32, ptr, n, EP, E, tables,
        perm=perm,
    )[:, :C]
    got = seg_sum_sorted(torch.from_numpy(vals), t_ptr, t_perm)
    assert got.shape == (n, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    loop = _loop(vals, t_ptr.numpy(),
                 None if t_perm is None else t_perm.numpy())
    np.testing.assert_allclose(got.numpy(), loop, **TOL)


@pytest.mark.parametrize("case", ["empty_rows", "all_empty", "one_segment",
                                  "perm_padding"])
def test_edge_cases(case):
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    perm = None
    if case == "empty_rows":
        ptr = [0, 0, 5, 5, 5, 12, 30, 30]
    elif case == "all_empty":
        ptr = [0, 0, 0, 0]
    elif case == "one_segment":
        ptr = [0, 40]
    else:  # perm entries past ptr[n] point at rows that must not be read
        perm = rng.permutation(40).astype(np.int32)
        ptr = [0, 4, 9, 20]
        vals[perm[20:]] = np.nan
    ptr = np.asarray(ptr, np.int32)
    got = seg_sum_sorted(
        torch.from_numpy(vals), torch.from_numpy(ptr),
        None if perm is None else torch.from_numpy(perm),
    )
    np.testing.assert_allclose(got.numpy(), _loop(vals, ptr, perm), **TOL)
    # and het_tpu agrees where its packed entry takes the shape
    if case == "empty_rows":
        n = len(ptr) - 1
        want = seg_sum_sorted_packed(
            [jnp.asarray(vals)], 3, jnp.float32, jnp.asarray(ptr), n, 40,
            int(ptr[-1]), build_tile_tables(ptr, n),
        )[:, :3]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_is_the_cpu_path_and_launches_nothing():
    vals = torch.randn(10, 4)
    ptr = torch.tensor([0, 3, 10], dtype=torch.int32)
    seg_sum_sorted.launches = 0
    a = seg_sum_sorted(vals, ptr)
    b = seg_sum_sorted(vals, ptr, impl="plain")
    torch.testing.assert_close(a, seg_sum_sorted_plain(vals, ptr))
    torch.testing.assert_close(a, b)
    assert seg_sum_sorted.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "ptr_dtype", "noncontig", "impl"])
def test_wrapper_rejects_bad_arguments(bad):
    vals = torch.randn(10, 4)
    ptr = torch.tensor([0, 3, 10], dtype=torch.int32)
    kw = {}
    if bad == "dtype":
        vals = vals.double()
    elif bad == "ptr_dtype":
        ptr = ptr.long()
    elif bad == "noncontig":
        vals = torch.randn(4, 10).t()
    else:
        kw["impl"] = "fast"
    with pytest.raises((TypeError, ValueError)):
        seg_sum_sorted(vals, ptr, **kw)


def _max_loop(vals, ptr):
    """Column max per segment, 0 where it is not finite."""
    n = len(ptr) - 1
    out = np.zeros((n, vals.shape[1]), np.float32)
    for r in range(n):
        if ptr[r + 1] > ptr[r]:
            m = vals[ptr[r]:ptr[r + 1]].max(0)
            out[r] = np.where(np.isfinite(m), m, 0.0)
    return out


@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("values", ["normal", "negative", "inf"])
def test_seg_max_matches_pallas_and_xla(C, values):
    """Destination max over ``in_row_ptr`` on a hub-heavy graph, with the
    padding edges masked to -inf for het_tpu's kernels (the port's never
    reads them), as ``tests/test_pallas_seg_reduce.py`` runs them."""
    kw = dict(num_nodes=50, num_edges=600, num_rels=4, seed=C, tile=8,
              power_law=True)
    jg, tg = j_random_heterograph(**kw), t_random_heterograph(**kw)
    rng = np.random.default_rng(C)
    vals = rng.standard_normal((jg.num_padded_edges, C)).astype(np.float32)
    if values == "negative":
        vals = -np.abs(vals) - 1.0
    elif values == "inf":
        hit = rng.random(vals.shape)
        vals[hit < 0.05] = np.inf
        vals[hit > 0.9] = -np.inf
    masked = np.where(np.asarray(jg.edge_valid)[:, None], vals, -np.inf)
    got = seg_max_sorted(torch.from_numpy(vals), tg.in_row_ptr)
    assert got.shape == (jg.num_nodes, C) and got.dtype == torch.float32
    pallas = seg_max_dst_pallas_raw(jg, jnp.asarray(masked), interpret=True,
                                    nb=16, chunk=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    xla = _segment_max_dst(jg, jnp.asarray(masked))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(),
                                  _max_loop(vals, tg.in_row_ptr.numpy()))


@pytest.mark.parametrize("case", ["empty_rows", "single_edge", "nan",
                                  "n0", "all_empty"])
def test_seg_max_edge_cases(case):
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((40, 3)).astype(np.float32)
    ptr = {"empty_rows": [0, 0, 5, 5, 12, 30, 30],
           "single_edge": [3, 4, 4, 5, 40],
           "nan": [0, 6, 20, 40],
           "n0": [7],
           "all_empty": [9, 9, 9]}[case]
    if case == "nan":  # a NaN met is kept, then mapped to 0
        vals[2, 1] = np.nan
    ptr = np.asarray(ptr, np.int32)
    got = seg_max_sorted(torch.from_numpy(vals), torch.from_numpy(ptr))
    assert got.shape == (len(ptr) - 1, 3)
    want = _max_loop(vals, ptr)
    if case == "nan":
        assert want[0, 1] == 0.0 and got[0, 1] == 0.0
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(got, seg_max_sorted_plain(
        torch.from_numpy(vals), torch.from_numpy(ptr)), rtol=0, atol=0)


@pytest.mark.parametrize("view", ["fe_lanes", "transposed", "contiguous",
                                  "column_slice"])
def test_force_rowmajor_matches_pallas(view):
    """The copy of a strided view equals het_tpu's ``force_rowmajor`` on
    the same values (which takes them row-major, as a JAX array is)."""
    gen = torch.Generator().manual_seed(5)
    if view == "fe_lanes":  # the per-head feature lanes of a packed fe
        x = torch.randn(37, 4, 17, generator=gen)[..., 1:]
    elif view == "transposed":
        x = torch.randn(68, 45, generator=gen).t()
    elif view == "contiguous":
        x = torch.randn(50, 12, generator=gen)
    else:
        x = torch.randn(29, 70, generator=gen)[:, 3:67]
    got = force_rowmajor(x)
    assert got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, force_rowmajor_plain(x))
    flat = x.reshape(x.shape[0], -1).numpy()
    want = j_rowmajor(jnp.asarray(flat), interpret=True)
    np.testing.assert_array_equal(got.reshape(x.shape[0], -1).numpy(),
                                  np.asarray(want))


def test_max_and_copy_plain_on_the_cpu_launch_nothing():
    vals = torch.randn(10, 4)
    ptr = torch.tensor([0, 3, 10], dtype=torch.int32)
    seg_max_sorted.launches = force_rowmajor.launches = 0
    assert torch.equal(seg_max_sorted(vals, ptr),
                       seg_max_sorted(vals, ptr, impl="plain"))
    empty = force_rowmajor(torch.zeros(0, 5))
    assert empty.shape == (0, 5)
    assert seg_max_sorted.launches == force_rowmajor.launches == 0
    with pytest.raises(TypeError):
        force_rowmajor(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(TypeError):
        force_rowmajor(torch.zeros(3))
    with pytest.raises((TypeError, ValueError)):
        seg_max_sorted(vals.double(), ptr)


# ------------------------------------------- the kernel's split, modelled


def _split_model(vals, ptr, perm, L, op, empty, finish):
    """numpy model of ``csrc/seg_reduce.cu``, task by task: each row's
    task (its edges up to the first multiple of ``L`` past its start where
    the row is longer than ``L``, stored raw then), the helpers (edges
    [h L, (h + 1) L) of a longer row that began before h L, found by a
    search of the row pointer, left raw in ``carry``) and the combine
    pass.  The output starts as NaN, as the kernel's does not
    start at all, so a row nobody stores shows."""
    ptr = np.asarray(ptr, np.int64)
    n, lo = len(ptr) - 1, int(ptr[0])
    m = int(ptr[n]) - lo
    C = vals.shape[1]
    helpers = split_helpers(len(perm) if perm is not None else len(vals), L)
    assert helpers * L >= m
    out = np.full((n, C), np.nan, np.float32)
    carry_row = np.full(helpers, -7, np.int64)
    carry = np.full((helpers, C), np.nan, np.float32)

    def walk(a, b):
        acc = np.full(C, empty, np.float32)
        for k in range(a, b):
            acc = op(acc, vals[perm[lo + k] if perm is not None else lo + k])
        return acc

    for h in range(helpers):
        e = h * L
        carry_row[h] = -1
        if e >= m:
            continue
        r = int(np.searchsorted(ptr[1:] - lo, e, side="right"))
        start, end = int(ptr[r]) - lo, int(ptr[r + 1]) - lo
        if end - start > L and e > start:
            carry_row[h] = r
            carry[h] = walk(e, min(e + L, end))
    for r in range(n):
        start, end = int(ptr[r]) - lo, int(ptr[r + 1]) - lo
        split = end - start > L
        acc = walk(start, min(end, (start // L + 1) * L) if split else end)
        out[r] = acc if split else finish(acc)
    for h in range(helpers):
        r = carry_row[h]
        if r < 0 or (h > 0 and carry_row[h - 1] == r):
            continue
        acc, k = out[r], h
        while k < helpers and carry_row[k] == r:
            acc = op(acc, carry[k])
            k += 1
        out[r] = finish(acc)
    return out


def _sum(a, b):
    return (a + b).astype(np.float32)


def _max(a, b):
    return np.where(np.isnan(a) | (a >= b), a, b).astype(np.float32)


def _finite(a):
    return np.where(np.isfinite(a), a, 0).astype(np.float32)


def _hub_problem(seed, with_perm):
    """A hub row of 300 edges among rows of 0-3 edges, row_ptr[0] = 5,
    NaN rows past row_ptr[n] (and before row_ptr[0] without perm)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 4, 60)
    lengths[17] = 300
    ptr = np.concatenate([[0], np.cumsum(lengths)]) + 5
    rows = int(ptr[-1]) + 9
    vals = rng.standard_normal((rows, 3)).astype(np.float32)
    perm = None
    if with_perm:
        perm = rng.permutation(rows).astype(np.int32)
        vals[perm[:5]] = np.nan
        vals[perm[int(ptr[-1]):]] = np.nan
    else:
        vals[:5] = np.nan
        vals[int(ptr[-1]):] = np.nan
    return vals, ptr.astype(np.int32), perm


@pytest.mark.parametrize("L", [1, 3, 8, 64, 256])
@pytest.mark.parametrize("with_perm", [False, True])
def test_split_model_sums_hub_and_short_rows(L, with_perm):
    """The kernel's split, modelled in numpy, equals the plain segment sum
    (TOL: f32 sums in another order) and repeats exactly, however the
    multiples of L cut the hub row (and, for small L, the short ones)."""
    vals, ptr, perm = _hub_problem(L, with_perm)
    got = _split_model(vals, ptr, perm, L, _sum, 0.0, lambda a: a)
    want = seg_sum_sorted_plain(
        torch.from_numpy(vals), torch.from_numpy(ptr),
        None if perm is None else torch.from_numpy(perm)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    again = _split_model(vals, ptr, perm, L, _sum, 0.0, lambda a: a)
    assert np.array_equal(got, again)


@pytest.mark.parametrize("L", [1, 4, 16, 64])
def test_split_model_max_keeps_nan_and_inf_of_other_chunks(L):
    """A hub row holding a NaN in one helper's chunk and a +inf in
    another's, a row whose only non-finite value is -inf: the modelled
    split equals the plain max bit for bit (the final map runs once, after
    the parts meet)."""
    vals, ptr, _ = _hub_problem(2, False)
    hub = int(ptr[17])
    vals[hub + 40, 0] = np.nan
    vals[hub + 250, 1] = np.inf
    vals[hub + 120:hub + 130, 2] = -np.inf
    got = _split_model(vals, ptr, None, L, _max, -np.inf, _finite)
    want = seg_max_sorted_plain(torch.from_numpy(vals),
                                torch.from_numpy(ptr)).numpy()
    assert np.array_equal(got, want)
    assert got[17, 0] == 0 and got[17, 1] == 0 and np.isfinite(got[17, 2])


@pytest.mark.parametrize("C", [1, 4, 12, 64, 68, 200])
@pytest.mark.parametrize("bound", [0, 1, 63, 64, 65, 1000, 21 * 10**6])
def test_split_helpers_cover_every_edge(bound, C):
    L = split_len(C)
    h = split_helpers(bound, L)
    assert h >= 1 and h * L >= bound
    assert (h - 1) * L < max(bound, 1)
