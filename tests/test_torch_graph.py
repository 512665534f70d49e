"""The port's graph builder and synthetic loaders against het_tpu's: every
field the port keeps, and the planted labels and split, must be exactly
equal."""

import dataclasses

import numpy as np
import pytest

from het_tpu.data import loaders as jl
from het_tpu.graph import random_heterograph as j_random_heterograph
from het_tpu_torch.data import loaders as tl
from het_tpu_torch.graph import random_heterograph as t_random_heterograph


# the port's own fields, which het_tpu has not: the boundary halo
# exchange's backward as a sorted segment sum (tests/test_torch_partition.py
# checks them against halo_back_index)
PORT_ONLY = {"halo_back_perm", "halo_back_ptr"}


def _assert_same(t_obj, j_obj, where):
    """Every field of the port's dataclass equals het_tpu's field of the
    same name (tensors exactly, including dtype; None where None), apart
    from ``PORT_ONLY``."""
    for f in dataclasses.fields(t_obj):
        if f.name in PORT_ONLY:
            continue
        tv, jv = getattr(t_obj, f.name), getattr(j_obj, f.name)
        name = f"{where}.{f.name}"
        if dataclasses.is_dataclass(tv):
            _assert_same(tv, jv, name)
        elif hasattr(tv, "numpy"):
            jv = np.asarray(jv)
            tv = tv.numpy()
            assert tv.dtype == jv.dtype, (name, tv.dtype, jv.dtype)
            np.testing.assert_array_equal(tv, jv, err_msg=name)
        else:
            assert tv == jv, (name, tv, jv)


@pytest.mark.parametrize("power_law", [False, True])
def test_random_heterograph_matches(power_law):
    kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=3, tile=8,
              power_law=power_law)
    _assert_same(t_random_heterograph(**kw), j_random_heterograph(**kw), "g")


def test_synthetic_mag_matches():
    t = tl._synthetic("mag", scale=0.002, seed=1)
    j = jl._synthetic("mag", scale=0.002, seed=1)
    _assert_same(t.graph, j.graph, "mag")
    for f in ("labels", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert t.num_classes == j.num_classes


def test_npy_shards_match(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "toy"
    root.mkdir()
    for r in range(3):
        coo = rng.integers(0, 40, size=(2, 60 + 10 * r)).astype(np.int32)
        np.save(root / f"r{r}_coo_.npy", coo)
    t = tl.load_dataset("toy", data_roots=(str(tmp_path),), tile=8)
    j = jl.load_dataset("toy", data_roots=(str(tmp_path),), tile=8)
    _assert_same(t.graph, j.graph, "toy")
    for f in ("labels", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def test_padding_invariants():
    g = t_random_heterograph(num_nodes=30, num_edges=200, num_rels=3)
    E, EP, N = g.num_edges, g.num_padded_edges, g.num_nodes
    assert (g.dst[E:] == N).all() and (g.dst[:E] < N).all()
    assert (g.compact_src.edge_map[E:] == 0).all()
    for info in (g.compact_src, g.compact_dst):
        assert int(info.edge_row_ptr[-1]) == E
        assert (info.edge_sort_perm[E:].numpy() == np.arange(E, EP)).all()
        n_real = int(info.seg.row_valid.sum())
        assert int(info.node_row_ptr[-1]) == n_real
    assert int(g.compact_dst.canon_ptr[-1]) == E


def _coo(seed, n=48, e=400, r=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.integers(0, r, e), n, r)


@pytest.mark.parametrize("forced", [False, True])
def test_union_compact_matches(forced):
    """Union-list compact rows equal het_tpu's field for field: one
    unique (relation, node) row space over sources and destinations, the
    destination view sharing the source view's segments and node ids."""
    from het_tpu.graph import build_heterograph as j_build
    from het_tpu_torch.graph import build_heterograph as t_build

    src, dst, rel, n, r = _coo(7)
    kw = dict(tile=8, compact_union=True)
    if forced:  # padded sizes, as a caller fixing shapes passes them
        kw["force_sizes"] = {"compact_src_rows": 512,
                             "compact_src_pairs": 440}
    t = t_build(src, dst, rel, n, r, **kw)
    j = j_build(src, dst, rel, n, r, **kw)
    _assert_same(t, j, "union")
    assert t.compact_shared and t.compact_dst.seg is t.compact_src.seg
    assert (t.compact_dst.node_ids == t.compact_src.node_ids).all()
    for side in ("src", "dst"):
        assert t.compact_duplication(side) == j.compact_duplication(side)
    assert "union-list compact" in t.describe()


def test_union_compact_needs_one_node_space():
    """As in het_tpu, a shard's separate source space takes the dual-list
    kind only."""
    from het_tpu.graph import build_heterograph as j_build
    from het_tpu_torch.graph import build_heterograph as t_build

    src, dst, rel, n, r = _coo(8)
    with pytest.raises(ValueError, match="one node space"):
        t_build(src, dst, rel, n, r, tile=8, compact_union=True,
                src_space=n + 8)
    with pytest.raises(AssertionError):
        j_build(src, dst, rel, n, r, tile=8, compact_union=True,
                src_space=n + 8)


@pytest.mark.parametrize("union", [False, True])
def test_synthetic_mag_union_matches(union):
    t = tl._synthetic("mag", scale=0.002, seed=2, compact_union=union)
    j = jl._synthetic("mag", scale=0.002, seed=2, compact_union=union)
    _assert_same(t.graph, j.graph, "mag")
    assert t.graph.compact_shared == union
