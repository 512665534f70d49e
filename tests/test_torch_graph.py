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


def test_csr_conversions_match():
    """``coo_to_csr``, ``csr_to_coo``, ``transpose_csr`` and
    ``integrated_coo_to_separate_coo`` give het_tpu's arrays bit for bit,
    and transposing twice gives the input back, each row's entries ordered
    by column."""
    from het_tpu.graph import convert as jc
    from het_tpu_torch.graph import convert as tc

    rng = np.random.default_rng(4)
    n, e, r = 30, 250, 5
    row = rng.integers(0, n, e)
    col = rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    data = np.stack([col, rel], 1)

    def same(a, b):
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)

    same(tc.coo_to_csr(row, col, data, n), jc.coo_to_csr(row, col, data, n))
    ptr, c, _ = tc.coo_to_csr(row, col, data, n)
    same(tc.csr_to_coo(ptr, c), jc.csr_to_coo(ptr, c))
    eids = np.arange(e)
    t = tc.transpose_csr(ptr, c, eids, rel, n)
    same(t, jc.transpose_csr(ptr, c, eids, rel, n))
    back = tc.transpose_csr(t[0], t[1], t[2], t[3], n)
    np.testing.assert_array_equal(back[0], ptr)
    row_of = np.repeat(np.arange(n), np.diff(ptr))
    order = np.lexsort((c, row_of))
    np.testing.assert_array_equal(back[1], c[order])
    np.testing.assert_array_equal(back[2], eids[order])
    same(tc.integrated_coo_to_separate_coo(row, col, rel, r),
         jc.integrated_coo_to_separate_coo(row, col, rel, r))


@pytest.mark.parametrize("compact", [False, True])
def test_reverse_heterograph_matches(compact):
    from het_tpu.graph.build import reverse_heterograph as j_reverse
    from het_tpu_torch.graph import reverse_heterograph as t_reverse

    kw = dict(num_nodes=48, num_edges=400, num_rels=4, seed=3, tile=8)
    t_g = t_reverse(t_random_heterograph(**kw), build_compact=compact)
    j_g = j_reverse(j_random_heterograph(**kw), build_compact=compact)
    _assert_same(t_g, j_g, "reversed")
    # reversed twice: the same canonical edges as the graph itself
    g = t_random_heterograph(**kw)
    again = t_reverse(t_g, build_compact=compact)
    for f in ("src", "dst", "rel", "in_row_ptr", "out_row_ptr"):
        assert (getattr(again, f) == getattr(g, f)).all(), f


@pytest.mark.parametrize("files", ["labels", "labels+train",
                                   "labels+train+test+features"])
def test_label_split_feature_files_match(tmp_path, files):
    """Labels, split and features read beside COO shards as het_tpu reads
    them; the port's loader leaves those files out of its shards."""
    rng = np.random.default_rng(1)
    root = tmp_path / "toy"
    root.mkdir()
    for r in range(3):
        coo = rng.integers(0, 40, size=(2, 60)).astype(np.int32)
        coo[:, 0] = 39  # node 39 exists
        np.save(root / f"r{r}_coo_.npy", coo)
    np.save(root / "labels.npy", rng.integers(0, 5, 40))
    if "train" in files:
        np.save(root / "train_idx.npy", np.arange(0, 40, 3))
    if "test" in files:
        np.save(root / "test_idx.npy", np.arange(1, 40, 7))
    if "features" in files:
        np.save(root / "features.npy", rng.standard_normal((40, 6)))
    t = tl.load_dataset("toy", data_roots=(str(tmp_path),), tile=8, seed=2)
    j = jl.load_dataset("toy", data_roots=(str(tmp_path),), tile=8, seed=2)
    _assert_same(t.graph, j.graph, "toy")
    for f in ("labels", "train_idx", "test_idx", "features"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert t.num_classes == j.num_classes
    assert t.meta["synthetic_labels"] is False
    # shards without the _coo_ infix: the side files are not relations
    for r in range(3):
        (root / f"r{r}_coo_.npy").rename(root / f"rel{r}.npy")
    plain = tl.load_dataset("toy", data_roots=(str(tmp_path),), tile=8,
                            seed=2)
    assert plain.graph.num_rels == 3
    np.testing.assert_array_equal(plain.labels, t.labels)


def test_label_count_checked(tmp_path):
    root = tmp_path / "toy"
    root.mkdir()
    np.save(root / "r0_coo_.npy", np.asarray([[0, 1, 2], [1, 2, 3]]))
    np.save(root / "labels.npy", np.zeros(3, dtype=np.int64))
    with pytest.raises(ValueError, match="labels.npy has 3 rows for 4"):
        tl.load_dataset("toy", data_roots=(str(tmp_path),), tile=8)
