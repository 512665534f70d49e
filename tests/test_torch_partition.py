"""The port's destination-range partitioner and the graph-build options
it needs (``force_sizes``, ``src_space``, ``node_ntype``) against het_tpu's:
every shard field exactly (het_tpu's stacked shard ``p`` against the
port's shard ``p``), the ``PartitionInfo``, the halo index arrays, and
``seg_ptrs_static`` dropped to None in exactly the same places."""

import dataclasses

import numpy as np
import jax
import pytest

from het_tpu.graph.build import build_heterograph as j_build
from het_tpu.parallel import partition_by_dst as j_partition
from het_tpu_torch.graph.build import build_heterograph as t_build
from het_tpu_torch.parallel import partition_by_dst as t_partition


def _assert_same(t_obj, j_obj, where):
    """Every field of the port's dataclass equals het_tpu's field of the
    same name (tensors exactly, including dtype; None where None)."""
    for f in dataclasses.fields(t_obj):
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
