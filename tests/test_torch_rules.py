"""Rules of the port: it imports nothing of JAX or of het_tpu, its entry
points run on the GPU unless told otherwise, and the CPU path launches no
kernel."""

import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "het_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "het_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_het_tpu():
    files = list(_port_files())
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_default_device_is_cuda_and_raises_without_gpu(monkeypatch):
    from het_tpu_torch.train import TrainConfig, train
    from het_tpu_torch.utils.misc import resolve_device

    assert TrainConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(TrainConfig(model="RGAT", dataset="mag", dataset_scale=0.0,
                          compact=True, multiply_first=True, num_epochs=1))
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_training_launches_no_kernel():
    from het_tpu_torch.ops.kernels import seg_sum_sorted, segment_matmul_dw
    from het_tpu_torch.train import TrainConfig, train

    seg_sum_sorted.launches = segment_matmul_dw.launches = 0
    m = train(TrainConfig(model="RGAT", dataset="aifb", dataset_scale=0.01,
                          n_infeat=8, hidden=8, num_heads=2, num_layers=2,
                          compact=True, multiply_first=True, num_epochs=1,
                          device="cpu"), log=lambda s: None)
    assert len(m["loss_list"]) == 1
    assert seg_sum_sorted.launches == 0
    assert segment_matmul_dw.launches == 0


def test_cpu_plain_rgat_training_launches_no_kernel():
    """The plain RGAT step reaches both kernels' wrappers (the segment sum
    and the grouped dW); on CPU tensors they run their plain versions."""
    from het_tpu_torch.ops.kernels import seg_sum_sorted, segment_matmul_dw
    from het_tpu_torch.train import TrainConfig, train

    seg_sum_sorted.launches = segment_matmul_dw.launches = 0
    m = train(TrainConfig(model="RGAT", dataset="mag", dataset_scale=0.001,
                          n_infeat=8, hidden=8, num_heads=2, num_layers=2,
                          num_epochs=1, device="cpu"), log=lambda s: None)
    assert m["flags"]["compact"] is False and len(m["loss_list"]) == 1
    assert seg_sum_sorted.launches == 0
    assert segment_matmul_dw.launches == 0


def test_kernel_wrappers_raise_on_unknown_impl():
    import torch
    from het_tpu_torch.graph import random_heterograph
    from het_tpu_torch.ops.kernels import seg_sum_sorted, segment_matmul_dw

    g = random_heterograph(num_nodes=10, num_edges=30, num_rels=2)
    seg = g.edge_rel_seg
    with pytest.raises(ValueError, match="impl"):
        seg_sum_sorted(torch.zeros(g.num_padded_edges, 2), g.in_row_ptr,
                       impl="auto")
    with pytest.raises(ValueError, match="impl"):
        segment_matmul_dw(torch.zeros(seg.n_rows, 3),
                          torch.zeros(seg.n_rows, 1), (2, 1, 3, 1), seg,
                          impl="auto")


def test_unported_branches_name_their_roadmap_item():
    """Union-list compact and ``stable="max"`` raise, naming the ROADMAP
    item that ports them."""
    import numpy as np
    from het_tpu_torch.graph import build_heterograph
    from het_tpu_torch.train import TrainConfig, train

    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, 'The rest of RGAT: the "
                             "union-compact branch'"):
        build_heterograph(np.array([0]), np.array([1]), np.array([0]), 2,
                          compact_union=True)
    for compact in (False, True):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md, 'The rest of RGAT: "
                                 "stable=max'"):
            train(TrainConfig(model="RGAT", dataset="aifb",
                              dataset_scale=0.01, num_heads=2, num_layers=1,
                              compact=compact, multiply_first=True,
                              stable_softmax="max", num_epochs=1,
                              device="cpu"), log=lambda s: None)


def test_unported_model_raises():
    from het_tpu_torch.train import TrainConfig, train

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(TrainConfig(model="HGT", dataset="aifb", dataset_scale=0.01,
                          compact=True, multiply_first=True, num_epochs=1,
                          device="cpu"), log=lambda s: None)


def test_parallel_modules_follow_the_rules(monkeypatch):
    """The data-parallel modules are among the files the import rule
    walks, and their entry points take the card unless told otherwise:
    without one they raise before opening a process group."""
    import inspect

    from het_tpu_torch.parallel import dp, launch, partition

    files = set(_port_files())
    for mod in (dp, launch, partition):
        assert os.path.abspath(mod.__file__) in files
    assert inspect.signature(dp.setup_rank).parameters[
        "device"].default == "cuda"
    assert inspect.signature(launch.spawn_ranks).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.setup_rank(0, 1, init_method="file:///nonexistent/rendezvous")
    assert not torch.distributed.is_initialized()
