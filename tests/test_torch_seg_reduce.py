"""The port's sorted segment sum (plain version, which is what a CPU
tensor runs) against het_tpu's ``seg_sum_sorted_packed`` (Pallas,
interpret mode) and a numpy loop, on every segmentation the RGAT training
step reduces over.  Tolerance 1e-5: f32 sums in a different order."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu.graph.build import build_tile_tables
from het_tpu.ops.pallas.seg_reduce import seg_sum_sorted_packed
from het_tpu_torch.graph import random_heterograph as t_random_heterograph
from het_tpu_torch.ops.kernels import seg_sum_sorted, seg_sum_sorted_plain

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
