"""The port's host library (``het_tpu_torch/csrc/graphops.cpp`` through
``het_tpu_torch/graph/native.py``) against het_tpu's native library and
against the port's plain (numpy) versions, bit for bit: the six functions
on random keys, no keys, one key and keys at their bound; keys out of
range raise; a failed build raises instead of falling back; and graphs
built through the library equal the plain build and het_tpu's, field for
field."""

import os
import stat

import numpy as np
import pytest

from het_tpu.graph import native as jn
from het_tpu.graph.build import build_heterograph as j_build
from het_tpu_torch.data.sampling import NeighborSampler
from het_tpu_torch.graph import convert as tc
from het_tpu_torch.graph import native as tn
from het_tpu_torch.graph.build import build_heterograph as t_build
from het_tpu_torch.ops.kernels import _build
from tests.test_torch_graph import _assert_same
from tests.test_torch_minibatch import het_tpu_native_loaded

FUNCTIONS = ("canonical_sort", "counting_argsort", "bincount",
             "unique_pairs", "degree_sort", "sample_fanout")
CASES = ("random", "empty", "one", "at_bound")


def _coo(case):
    """``(src, dst, rel, num_nodes, num_rels)`` of one case."""
    rng = np.random.default_rng(CASES.index(case))
    n, r, e = {"random": (50, 4, 600), "empty": (5, 2, 0), "one": (7, 3, 1),
               "at_bound": (40, 3, 300)}[case]
    src, dst, rel = (rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.integers(0, r, e))
    if case == "one":
        src[:], dst[:], rel[:] = 6, 6, 2
    if case == "at_bound":  # the largest keys, many times over
        src[::3], dst[1::3], rel[2::3] = n - 1, n - 1, r - 1
        dst[::7] = 0
    return src, dst, rel, n, r


def _same(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == np.int64 and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}[{i}]")


@pytest.fixture(scope="module")
def het_tpu_native():
    assert het_tpu_native_loaded()
    return jn


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_matches_het_tpu_and_plain(het_tpu_native, fn, case):
    src, dst, rel, n, r = _coo(case)
    if fn == "canonical_sort":
        got = tn.canonical_sort(src, dst, rel, n, r)
        _same(got, jn.canonical_sort(src, dst, rel, n, r), "het_tpu")
        _same(got, tc.canonical_sort(src, dst, rel), "plain")
    elif fn == "counting_argsort":
        for keys, bound in ((dst, n), (rel, r), (src * r + rel, n * r)):
            got = tn.counting_argsort(keys, bound)
            _same(got, jn.counting_argsort(keys, bound), "het_tpu")
            _same(got, tc.counting_argsort(keys), "plain")
    elif fn == "bincount":
        got = tn.bincount(dst, n)
        _same(got, jn.bincount(dst, n), "het_tpu")
        _same(got, np.bincount(dst, minlength=n), "plain")
    elif fn == "unique_pairs":
        got = tn.unique_pairs(rel, src, n, r)
        _same(got, jn.unique_pairs(rel, src, n, r), "het_tpu")
        _same(got, tc.unique_pairs(rel, src, n), "plain")
    elif fn == "degree_sort":
        deg = np.bincount(dst, minlength=n)
        got = tn.degree_sort(deg)
        _same(got, jn.degree_sort(deg), "het_tpu")
        _same(got, np.argsort(-deg, kind="stable"), "plain")
    else:
        t = NeighborSampler(src, dst, rel, n, r, fanout=2, num_hops=2)
        seeds = np.unique(dst)[:6] if len(dst) else np.asarray([0, 1])
        csr = (t.ptr, t.nbr_src, t.nbr_rel, seeds)
        # random draws (fanout 2), uncapped and capped, and the draw at
        # full fanout, which the plain version must give too
        for fanout, seed, caps in ((2, 5, (10 ** 4, 10 ** 4)),
                                   (2, 6, (7, 9)), (10 ** 3, 0, (500, 500))):
            got = tn.sample_fanout(*csr, fanout, 2, seed, n, *caps)
            _same(got, jn.sample_fanout(*csr, fanout, 2, seed, n, *caps),
                  f"het_tpu fanout {fanout}")
            if fanout > len(dst):
                t.fanout = fanout
                _same(got, t.draw_plain(seeds, max_edges=caps[0],
                                        max_nodes=caps[1]), "plain")


@pytest.mark.parametrize("fn", [f for f in FUNCTIONS if f != "degree_sort"])
def test_keys_out_of_range_raise(fn):
    src, dst, rel, n, r = _coo("random")
    bad = dst.copy()
    bad[5] = n  # one past the bound
    neg = dst.copy()
    neg[7] = -1
    calls = {
        "canonical_sort": [lambda: tn.canonical_sort(bad, dst, rel, n, r),
                           lambda: tn.canonical_sort(src, neg, rel, n, r),
                           lambda: tn.canonical_sort(src, dst, rel, n, r - 1)],
        "counting_argsort": [lambda: tn.counting_argsort(bad, n),
                             lambda: tn.counting_argsort(neg, n)],
        "bincount": [lambda: tn.bincount(bad, n),
                     lambda: tn.bincount(neg, n)],
        "unique_pairs": [lambda: tn.unique_pairs(rel, bad, n, r),
                         lambda: tn.unique_pairs(rel + 1, dst, n, r)],
    }
    if fn == "sample_fanout":
        t = NeighborSampler(src, dst, rel, n, r, fanout=2)
        with pytest.raises(ValueError):
            t.draw(np.asarray([3, n]))
        with pytest.raises(ValueError):
            t.draw(np.asarray([-1]))
        nbr = t.nbr_src.copy()
        nbr[0] = n
        calls[fn] = [
            lambda: tn.sample_fanout(t.ptr, nbr, t.nbr_rel, [1], 2, 2, 0, n,
                                     10, 10),
            lambda: tn.sample_fanout(t.ptr[:-1], t.nbr_src, t.nbr_rel, [1],
                                     2, 2, 0, n, 10, 10),
            lambda: tn.sample_fanout(t.ptr, t.nbr_src, t.nbr_rel, [1], 2, 2,
                                     0, n, 10, 10,
                                     local=np.full(n, -1, np.int32))]
    for call in calls[fn]:
        with pytest.raises(ValueError):
            call()


def _fake_compiler(tmp_path, kind):
    if kind == "missing":
        return str(tmp_path / "no-such-g++")
    path = tmp_path / "failing-g++"
    path.write_text("#!/bin/sh\necho 'graphops.cpp:1: fake compile error'\n"
                    "exit 1\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.mark.parametrize("kind", ["missing", "failing"])
def test_failed_build_raises(monkeypatch, tmp_path, kind):
    """A compiler that is not there, or that fails, raises
    ``RuntimeError`` from the first call (with the compiler's output);
    nothing falls back to numpy and the package's build directory is not
    touched."""
    build_dir = tmp_path / "build"
    cxx = _fake_compiler(tmp_path, kind)
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_build, "cxx_path", lambda: cxx)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tn, "_LIB", None)
    src, dst, rel, n, r = _coo("random")
    match = "cannot start" if kind == "missing" else "fake compile error"
    with pytest.raises(RuntimeError, match=match):
        tn.canonical_sort(src, dst, rel, n, r)
    with pytest.raises(RuntimeError, match=match):
        NeighborSampler(src, dst, rel, n, r, fanout=2).draw([1, 2])
    assert tn._LIB is None and not os.listdir(build_dir)


def test_library_build():
    """The host library is built by g++ for any x86-64 host, under a name
    hashing its source and flags, and is no CUDA source."""
    tn.library()
    path = _build._lib_path("graphops")
    assert os.path.exists(path) and os.path.dirname(path) == _build.BUILD_DIR
    assert "graphops" not in _build.SOURCES
    assert not any(f.startswith("-march") for f in _build.CXX_FLAGS)
    assert os.path.basename(_build._command("graphops", "x")[0]).endswith(
        "g++")


def _shard_kw(n):
    return dict(src_space=n + 24, force_sizes={
        "num_padded_edges": 4096, "edge_rel_rows": 4160, "ntype_rows": 256,
        "compact_src_pairs": 1200, "compact_src_rows": 2048,
        "compact_dst_pairs": 1200, "compact_dst_rows": 2048},
        node_ntype=np.arange(n) % 3)


BUILDS = {
    "plain": dict(build_compact=False),
    "dual": dict(),
    "union": dict(compact_union=True),
    "node_types": dict(ntype_offsets=(0, 20, 35, 50)),
    "shard": "shard",
}


@pytest.mark.parametrize("kind", list(BUILDS))
def test_native_build_matches_plain_and_het_tpu(het_tpu_native, kind):
    src, dst, rel, n, r = _coo("random")
    kw = _shard_kw(n) if kind == "shard" else BUILDS[kind]
    if kind == "shard":  # sources index a larger space than destinations
        src = src.copy()
        src[::5] = n + 23
    native = t_build(src, dst, rel, n, r, tile=8, **kw)
    _assert_same(native, t_build(src, dst, rel, n, r, tile=8, sorts="plain",
                                 **kw), "plain")
    _assert_same(native, j_build(src, dst, rel, n, r, tile=8, **kw),
                 "het_tpu")
    with pytest.raises(ValueError, match="sorts"):
        t_build(src, dst, rel, n, r, tile=8, sorts="numpy", **kw)
