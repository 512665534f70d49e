"""The port's neighbour sampler (``het_tpu_torch/data/sampling.py``)
against het_tpu's ``NeighborSampler`` and the native sampler's contract.

The port's ``draw`` runs in its host library from het_tpu's random
stream, so ``sample`` gives het_tpu's (native) ``sample`` field for field,
``node_map`` too, at any fanout.  ``draw_plain``, the numpy version, has
its own stream: it equals the native draw where the fanout reaches every
in-degree, and with random draws both keep the contract of
``tests/test_train.py::test_native_sampler_contract``: each node's
sampled in-edges are distinct in-edges of it, at most ``fanout``.
Duplicate seeds are de-duplicated in first-seen order, as the native
sampler does (het_tpu's Python fallback gives a duplicated seed its last
index)."""

import numpy as np
import pytest

from het_tpu.data.sampling import NeighborSampler as JSampler
from het_tpu.graph import native
from het_tpu.graph import random_heterograph
from het_tpu_torch.data.sampling import NeighborSampler
from tests.test_torch_graph import _assert_same
from tests.test_torch_minibatch import het_tpu_native_loaded

DRAWS = ("draw", "draw_plain")


def _edges(seed=5, n=60, e=300, r=3):
    g = random_heterograph(num_nodes=n, num_edges=e, num_rels=r, seed=seed,
                           tile=8)
    E = g.num_edges
    return (np.asarray(g.src)[:E], np.asarray(g.dst)[:E],
            np.asarray(g.rel)[:E], g.num_nodes, g.num_rels)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("pad", [False, True])
def test_full_fanout_matches_het_tpu(compact, pad):
    src, dst, rel, n, r = _edges()
    fanout = int(np.bincount(dst, minlength=n).max())
    kw = dict(fanout=fanout, num_hops=2, seed=1)
    seeds = np.asarray([3, 7, 11, 19, 42])
    sizes = dict(pad_edges_to=2048, pad_nodes_to=128) if pad else {}
    j_sub, j_map = JSampler(src, dst, rel, n, r, **kw).sample(
        seeds, tile=8, build_compact=compact, **sizes)
    t = NeighborSampler(src, dst, rel, n, r, **kw)
    t_sub, t_map = t.sample(seeds, tile=8, build_compact=compact, **sizes)
    np.testing.assert_array_equal(t_map, j_map)
    _assert_same(t_sub, j_sub, "sub")
    # the draw, then the build, equal sample's result
    drawn = t.draw(seeds, **({"max_edges": 2048, "max_nodes": 128}
                             if pad else {}))
    _assert_same(t.finalize(*drawn, tile=8, build_compact=compact,
                            **sizes)[0], j_sub, "finalize")


@pytest.mark.parametrize("caps", [(40, 10 ** 6), (10 ** 6, 12), (25, 9),
                                  (0, 3)])
def test_caps_match_native(caps):
    """The edge and node caps cut a draw where the native sampler cuts
    it."""
    src, dst, rel, n, r = _edges()
    t = NeighborSampler(src, dst, rel, n, r, fanout=100, num_hops=2)
    seeds = np.asarray([3, 7, 11, 19, 3, 7])
    assert het_tpu_native_loaded()
    want = native.sample_fanout(t.ptr, t.nbr_src, t.nbr_rel, seeds, 100,
                                2, 1, n, *caps)
    for draw in DRAWS:
        got = getattr(t, draw)(seeds, max_edges=caps[0], max_nodes=caps[1])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=draw)
        es, _, _, node_map = got
        assert len(es) <= caps[0] and len(node_map) <= caps[1]


@pytest.mark.parametrize("fanout,hops", [(3, 2), (1, 3), (5, 1)])
def test_random_draw_contract(fanout, hops):
    src, dst, rel, n, r = _edges()
    edge_set = {(int(s), int(d), int(k)) for s, d, k in zip(src, dst, rel)}
    t = NeighborSampler(src, dst, rel, n, r, fanout=fanout, num_hops=hops,
                        seed=1)
    seeds = np.asarray([3, 7, 11, 19])
    for draw in DRAWS * 3:
        es, ed, er, node_map = getattr(t, draw)(seeds)
        assert list(node_map[:len(seeds)]) == list(seeds)
        assert len(np.unique(node_map)) == len(node_map)
        triples = [(int(node_map[a]), int(node_map[b]), int(k))
                   for a, b, k in zip(es, ed, er)]
        assert set(triples) <= edge_set
        # per destination: at most the fanout, and no in-edge twice (the
        # graph may hold parallel edges, so count CSR positions)
        for v in np.unique(ed):
            mine = [tr for tr, d in zip(triples, ed) if d == v]
            assert len(mine) <= fanout
            avail = {}
            for tr in edge_set:
                if tr[1] == node_map[v]:
                    avail[tr] = sum(1 for s, d, k in zip(src, dst, rel)
                                    if (s, d, k) == tr)
            for tr in set(mine):
                assert mine.count(tr) <= avail[tr]
        sub, padded = t.finalize(es, ed, er, node_map, tile=8,
                                 pad_edges_to=2048, pad_nodes_to=128)
        assert sub.num_padded_edges == 2048 and sub.num_nodes == 128
        assert (padded[len(node_map):] == 0).all()


def test_uniform_choice():
    """A node of in-degree 6 at fanout 2 takes each in-edge a third of the
    time."""
    src = np.arange(1, 7)
    dst = np.zeros(6, dtype=np.int64)
    t = NeighborSampler(src, dst, np.zeros(6), 7, 1, fanout=2, num_hops=1,
                        seed=3)
    trials = 3000
    for draw in DRAWS:
        counts = np.zeros(7)
        for _ in range(trials):
            es, ed, _, node_map = getattr(t, draw)(np.asarray([0]))
            assert len(es) == 2 and len(set(node_map[es])) == 2
            counts[node_map[es]] += 1
        np.testing.assert_allclose(counts[1:] / trials, 1 / 3, atol=0.04,
                                   err_msg=draw)


def test_duplicate_seeds():
    """Repeated seeds keep their first local id; every local id is one
    node, and the edges are the draw of the distinct seeds."""
    src, dst, rel, n, r = _edges()
    fanout = int(np.bincount(dst, minlength=n).max())
    t = NeighborSampler(src, dst, rel, n, r, fanout=fanout, num_hops=2)
    assert het_tpu_native_loaded()
    want = native.sample_fanout(t.ptr, t.nbr_src, t.nbr_rel,
                                np.asarray([1, 2, 3, 1, 1]), fanout, 2,
                                0, n, 10 ** 6, 10 ** 6)
    for draw in DRAWS:
        dup = getattr(t, draw)(np.asarray([1, 2, 3, 1, 1]))
        once = getattr(t, draw)(np.asarray([1, 2, 3]))
        for a, b, c in zip(dup, once, want):
            np.testing.assert_array_equal(a, b, err_msg=draw)
            np.testing.assert_array_equal(a, c, err_msg=draw)
        assert list(dup[3][:3]) == [1, 2, 3]
        assert len(np.unique(dup[3])) == len(dup[3])


@pytest.mark.parametrize("compact", [False, True])
def test_random_sample_matches_het_tpu(compact):
    """At a fanout below most in-degrees, the same ``seed`` and the same
    calls, the port's ``sample`` gives het_tpu's native ``sample`` batch
    for batch, field for field, ``node_map`` included."""
    assert het_tpu_native_loaded()
    src, dst, rel, n, r = _edges(seed=9, n=80, e=900)
    assert np.median(np.bincount(dst, minlength=n)) > 3
    kw = dict(fanout=3, num_hops=2, seed=11)
    j, t = JSampler(src, dst, rel, n, r, **kw), NeighborSampler(
        src, dst, rel, n, r, **kw)
    for seeds in ([3, 7, 11, 19, 42], [0, 5, 5, 64], [79]):
        seeds = np.asarray(seeds)
        sizes = dict(tile=8, build_compact=compact, pad_edges_to=2048,
                     pad_nodes_to=128)
        j_sub, j_map = j.sample(seeds, **sizes)
        t_sub, t_map = t.sample(seeds, **sizes)
        np.testing.assert_array_equal(t_map, j_map)
        _assert_same(t_sub, j_sub, "sub")
    # the draws were random: a draw from another seed differs
    other = NeighborSampler(src, dst, rel, n, r, **dict(kw, seed=12))
    assert not np.array_equal(other.draw(np.asarray([3, 7, 11]))[0],
                              t.draw(np.asarray([3, 7, 11]))[0])
