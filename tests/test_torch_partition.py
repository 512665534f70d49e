"""The port's destination-range partitioner and the graph-build options
it needs (``force_sizes``, ``src_space``, ``node_ntype``) against het_tpu's:
every shard field exactly (het_tpu's stacked shard ``p`` against the
port's shard ``p``), the ``PartitionInfo``, the halo index arrays, and
``seg_ptrs_static`` dropped to None in exactly the same places."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from het_tpu.graph.build import build_heterograph as j_build
from het_tpu.parallel import partition_by_dst as j_partition
from het_tpu_torch.graph.build import build_heterograph as t_build
from het_tpu_torch.ops.kernels import seg_sum_sorted_plain
from het_tpu_torch.parallel import halo_back_index
from het_tpu_torch.parallel import partition_by_dst as t_partition
from tests.test_torch_graph import _assert_same


def _coo(seed=0, n=200, e=900, r=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.integers(0, r, e), n, r)


def _compare_partitions(args, **kw):
    jsg, jinfo = j_partition(*args, **kw)
    tparts, tinfo = t_partition(*args, **kw)
    n_parts = args[-1]
    assert len(tparts) == n_parts
    for f in dataclasses.fields(tinfo):
        assert getattr(tinfo, f.name) == getattr(jinfo, f.name), f.name
    for p, tg in enumerate(tparts):
        jg = jax.tree.map(lambda a: a[p], jsg)
        _assert_same(tg, jg, f"shard{p}")
    return tparts, tinfo


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("halo", ["gather", "boundary", "auto"])
@pytest.mark.parametrize("balance", ["nodes", "edges"])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_partition_matches_het_tpu(n_parts, balance, halo, compact):
    src, dst, rel, n, r = _coo(seed=n_parts)
    parts, info = _compare_partitions(
        (src, dst, rel, n, r, n_parts), tile=8, build_compact=compact,
        balance=balance, halo=halo)
    # shards share every shape, and each real edge lands in one shard
    assert len({g.num_padded_edges for g in parts}) == 1
    assert sum(int((g.dst < g.num_nodes).sum()) for g in parts) == len(src)
    boundary = parts[0].halo_send_idx is not None
    assert boundary == (halo == "boundary" or (
        halo == "auto" and parts[0].src_space < info.num_padded_global_nodes))
    for g in parts:
        if not boundary:
            assert g.halo_back_ptr is None and g.halo_back_perm is None
            continue
        # every real slot sits in its row's segment, in slot order, and
        # the rest (padding, all row 0) past the end
        rows = np.concatenate([g.halo_self_idx.numpy(),
                               g.halo_send_idx.numpy().ravel()])
        ptr, perm = g.halo_back_ptr.numpy(), g.halo_back_perm.numpy()
        assert sorted(perm) == list(range(len(rows)))
        seg = np.repeat(np.arange(g.num_nodes), np.diff(ptr))
        assert (rows[perm[:ptr[-1]]] == seg).all()
        assert (np.diff(perm[:ptr[-1]])[np.diff(seg) == 0] > 0).all()
        assert (rows[perm[ptr[-1]:]] == 0).all()
    # relation sizes differ between these shards: the offsets move to the
    # device, which is what sends a shard's typed linears to the kernels
    assert parts[0].edge_rel_seg.seg_ptrs_static is None
    if compact:
        assert parts[0].compact_src.seg.seg_ptrs_static is None


def test_partition_with_node_types_matches_het_tpu():
    """Node-type ranges that a shard's destination range spans."""
    src, dst, rel, n, r = _coo(seed=7)
    parts, _ = _compare_partitions(
        (src, dst, rel, n, r, 2), tile=8, build_compact=True,
        ntype_offsets=(0, 70, 150, n), balance="edges", halo="boundary")
    assert parts[0].num_ntypes == 3


def test_build_options_match_het_tpu():
    """``force_sizes``, ``src_space`` and ``node_ntype`` on their own."""
    rng = np.random.default_rng(3)
    n, space, e, r = 40, 90, 300, 3
    src, dst = rng.integers(0, space, e), rng.integers(0, n, e)
    rel = rng.integers(0, r, e)
    node_ntype = rng.integers(0, 2, n)
    kw = dict(tile=8, src_space=space, node_ntype=node_ntype,
              ntype_offsets=(0, 0, n))
    base = t_build(src, dst, rel, n, r, **kw)
    force = {"num_padded_edges": base.num_padded_edges + 256,
             "edge_rel_rows": base.edge_rel_seg.n_rows + 512,
             "ntype_rows": base.ntype_seg.n_rows + 16,
             "compact_src_pairs": base.compact_src.seg.n_src + 5,
             "compact_dst_pairs": base.compact_dst.seg.n_src + 3}
    force["compact_src_rows"] = base.compact_src.seg.n_rows + 64
    force["compact_dst_rows"] = base.compact_dst.seg.n_rows + 64
    tg = t_build(src, dst, rel, n, r, force_sizes=force, **kw)
    jg = j_build(src, dst, rel, n, r, force_sizes=force, **kw)
    _assert_same(tg, jg, "g")
    assert tg.src_space == space and tg.out_row_ptr.numel() == space + 1
    assert (tg.src[tg.num_edges:] == space).all()
    assert tg.edge_rel_seg.n_rows == force["edge_rel_rows"]
    with pytest.raises(ValueError, match="force_rows"):
        t_build(src, dst, rel, n, r, force_sizes={"edge_rel_rows": 8}, **kw)


def test_partition_rejects_bad_options():
    src, dst, rel, n, r = _coo()
    with pytest.raises(ValueError, match="balance"):
        t_partition(src, dst, rel, n, r, 2, balance="degree")
    with pytest.raises(ValueError, match="halo"):
        t_partition(src, dst, rel, n, r, 2, halo="ring")


@pytest.mark.parametrize("mark_padding", [False, True])
def test_halo_backward_index_sums_every_slot_in_order(mark_padding):
    """P = 3: local row 3 goes to two peers, row 2 is both an own source
    and sent, and zero-padded slots point at row 0, either summed there
    or (marked) never read.  The segment sum over ``halo_back_index``
    equals a float64 sum of the slots' cotangents (rtol 1e-6), and
    repeats bit for bit."""
    n, width = 7, 5
    self_idx = np.array([0, 2, 5, 0])  # last slot padding
    send_idx = np.array([[0, 0, 0],  # to itself: padding
                         [2, 3, 0],  # peer 1, last slot padding
                         [1, 3, 6]])  # peer 2
    rows = np.concatenate([self_idx, send_idx.ravel()])
    pad = np.zeros(len(rows), bool)
    pad[[3, 4, 5, 6, 9]] = True
    rng = np.random.default_rng(0)
    ct = rng.standard_normal((len(rows), width)).astype(np.float32)
    ct[pad] = 0.0  # no edge reads a padding slot
    ptr, perm = halo_back_index(self_idx, send_idx, n,
                                ~pad if mark_padding else None)
    assert ptr.dtype == perm.dtype == torch.int32
    # stable: each row's slots in buffer order
    if mark_padding:
        assert ptr.tolist() == [0, 1, 2, 4, 6, 6, 7, 8]
        assert perm.tolist() == [0, 10, 1, 7, 8, 11, 2, 12, 3, 4, 5, 6, 9]
    else:
        assert ptr.tolist() == [0, 6, 7, 9, 11, 11, 12, 13]
        assert perm.tolist() == [0, 3, 4, 5, 6, 9, 10, 1, 7, 8, 11, 2, 12]
    got = seg_sum_sorted_plain(torch.from_numpy(ct), ptr, perm)
    want = np.zeros((n, width))
    np.add.at(want, rows, ct.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    again = seg_sum_sorted_plain(torch.from_numpy(ct), ptr, perm)
    assert torch.equal(got, again)
