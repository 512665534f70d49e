"""``save_heterograph`` / ``load_heterograph`` (``het_tpu_torch/graph/
persist.py``): every graph kind round-trips field for field (dtype, shape,
values, ``None``s, static sizing, the union-list views' shared segments),
and the loaded graph still equals het_tpu's built graph.  The file loads
with ``torch.load(weights_only=True)`` and holds no pickled code."""

import dataclasses
import pickletools
import zipfile

import jax
import numpy as np
import pytest
import torch

from het_tpu.graph.build import build_heterograph as j_build
from het_tpu.parallel import partition_by_dst as j_partition
from het_tpu_torch.graph import load_heterograph, save_heterograph
from het_tpu_torch.graph.build import build_heterograph as t_build
from het_tpu_torch.parallel import partition_by_dst as t_partition
from tests.test_torch_graph import _assert_same

KINDS = ("plain", "dual", "union", "shard")


def _coo(n=60, e=500, r=3):
    rng = np.random.default_rng(2)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.integers(0, r, e), n, r)


@pytest.fixture(scope="module")
def graphs():
    """Each kind built once: the port's graph and het_tpu's."""
    src, dst, rel, n, r = _coo()
    out = {}
    for kind, kw in (("plain", dict(build_compact=False)), ("dual", {}),
                     ("union", dict(compact_union=True))):
        out[kind] = (t_build(src, dst, rel, n, r, tile=8, **kw),
                     j_build(src, dst, rel, n, r, tile=8, **kw))
    # rank 1's shard of a boundary-halo partition: a separate source
    # space, forced sizes, the halo index fields and the port's own
    # halo_back_* fields, offsets dropped to None
    kw = dict(tile=8, build_compact=True, balance="edges", halo="boundary")
    parts, _ = t_partition(src, dst, rel, n, r, 2, **kw)
    jsg, _ = j_partition(src, dst, rel, n, r, 2, **kw)
    out["shard"] = (parts[1], jax.tree.map(lambda a: a[1], jsg))
    return out


def _equal(a, b, where):
    """``a`` and ``b`` equal field for field, the port's own fields too."""
    assert type(a) is type(b), where
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        name = f"{where}.{f.name}"
        if dataclasses.is_dataclass(x):
            _equal(x, y, name)
        elif isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor), name
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x, y), name
        else:
            assert x == y and type(x) is type(y), (name, x, y)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(graphs, kind, tmp_path):
    g, jg = graphs[kind]
    path = tmp_path / "g.pt"
    save_heterograph(str(path), g)
    loaded = load_heterograph(str(path))
    _equal(loaded, g, kind)
    _assert_same(loaded, jg, kind)
    assert [p.name for p in tmp_path.iterdir()] == ["g.pt"]
    if kind == "union":
        assert loaded.compact_dst.seg is loaded.compact_src.seg
    if kind == "shard":
        assert loaded.halo_send_idx is not None
        assert loaded.halo_back_perm is not None
        assert loaded.edge_rel_seg.seg_ptrs_static is None
    if kind == "plain":
        assert loaded.compact_src is None and loaded.compact_dst is None
    # the loaded graph saves and loads again to the same graph
    again = tmp_path / "again.pt"
    save_heterograph(str(again), loaded)
    _equal(load_heterograph(str(again)), g, kind)


def test_file_holds_no_code(graphs, tmp_path):
    """The pickle inside the file names only torch's tensor rebuilders and
    storages and ``OrderedDict``: no class of the package, no function."""
    path = tmp_path / "g.pt"
    save_heterograph(str(path), graphs["union"][0])
    with zipfile.ZipFile(path) as z:
        data = z.read(next(n for n in z.namelist()
                           if n.endswith("data.pkl")))
    globals_ = {arg for op, arg, _ in pickletools.genops(data)
                if op.name == "GLOBAL"}
    assert globals_ <= {"collections OrderedDict", "torch BoolStorage",
                        "torch IntStorage", "torch._utils _rebuild_tensor_v2"
                        }, globals_
    assert not any(op.name == "STACK_GLOBAL"
                   for op, _, _ in pickletools.genops(data))
    blob = torch.load(path, weights_only=True)
    assert set(blob) == {"format", "tree", "tensors"}


def test_not_a_graph_raises(tmp_path):
    path = tmp_path / "x.pt"
    torch.save({"weights": torch.zeros(3)}, path)
    with pytest.raises(ValueError, match="save_heterograph"):
        load_heterograph(str(path))
