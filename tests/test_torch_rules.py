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
    from het_tpu_torch.ops.kernels import seg_sum_sorted
    from het_tpu_torch.train import TrainConfig, train

    seg_sum_sorted.launches = 0
    m = train(TrainConfig(model="RGAT", dataset="aifb", dataset_scale=0.01,
                          n_infeat=8, hidden=8, num_heads=2, num_layers=2,
                          compact=True, multiply_first=True, num_epochs=1,
                          device="cpu"), log=lambda s: None)
    assert len(m["loss_list"]) == 1
    assert seg_sum_sorted.launches == 0


def test_unported_model_raises():
    from het_tpu_torch.train import TrainConfig, train

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(TrainConfig(model="HGT", dataset="aifb", dataset_scale=0.01,
                          compact=True, multiply_first=True, num_epochs=1,
                          device="cpu"), log=lambda s: None)
