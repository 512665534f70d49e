"""Rules of the port: it imports nothing of JAX or of het_tpu, its entry
points run on the GPU unless told otherwise, and the CPU path launches no
kernel."""

import ast
import math
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "het_tpu")


def _port_scripts():
    """The port's scripts under ``scripts/``: those that name its
    package (het_tpu's own scripts there import ``het_tpu``)."""
    d = os.path.join(ROOT, "scripts")
    for f in sorted(os.listdir(d)):
        path = os.path.join(d, f)
        if f.endswith(".py"):
            with open(path) as fh:
                if "het_tpu_torch" in fh.read():
                    yield path


def _port_files():
    pkg = os.path.join(ROOT, "het_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield from _port_scripts()


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


def test_port_scripts_and_bench_modules_are_checked():
    """The import rule walks the bench modules (part of the package) and
    the port's scripts under ``scripts/``."""
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for script in ("bench_dw", "bench_fwd", "bench_gat", "bench_minibatch",
                   "bench_seg_sum", "bench_turns"):
        assert f"scripts/{script}.py" in names, script
    for mod in ("common", "step", "models", "infer", "compiled", "sweep",
                "fullscale", "segmm_strategies", "skew", "breakdown",
                "scaling", "halo_bytes"):
        assert f"het_tpu_torch/bench/{mod}.py" in names, mod
    assert "het_tpu_torch/entry.py" in names
    assert "scripts/bench_models.py" not in names  # het_tpu's


def _docstrings(tree):
    """The docstring nodes of a module, its classes and functions."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                yield first.value


def test_port_writes_nothing_under_docs_and_reads_no_bench_scale():
    """het_tpu's bench scripts write ``docs/*_r2.json`` / ``*_r5.json``
    and ``bench.py`` reads ``HET_BENCH_SCALE``; no string the port's code
    uses (its docstrings aside) names ``docs`` or that variable."""
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        skip = {id(d) for d in _docstrings(tree)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in skip):
                v = node.value
                assert "HET_BENCH_SCALE" not in v, (path, v)
                assert v != "docs" and "docs/" not in v and \
                    "docs" + os.sep not in v, (path, v)


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


@pytest.mark.parametrize("flags", [
    ["--compact_as_of_node_flag", "--compact_union_flag",
     "--multiply_among_weights_first_flag"],
    ["--compact_as_of_node_flag", "--compact_union_flag",
     "--stable_softmax", "max"],
    ["--stable_softmax", "max"],
    ["--compact_as_of_node_flag", "--multiply_among_weights_first_flag",
     "--stable_softmax", "max"],
])
def test_union_and_max_train_through_the_cli(monkeypatch, capsys, flags):
    """``--compact_union_flag`` and ``--stable_softmax max`` train through
    ``python -m het_tpu_torch.train`` (on the CPU here); no RGAT branch and
    no softmax mode raises ``NotImplementedError`` any more."""
    import json
    import sys

    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train.__main__ import main

    kernels.reset_launches()
    monkeypatch.setattr(sys, "argv", [
        "het_tpu_torch.train", "--model", "RGAT", "-d", "mag",
        "--dataset_scale", "0.002", "--num_heads", "2", "--num_layers", "2",
        "--n_infeat", "8", "--hidden", "8", "-e", "2", "--device", "cpu",
        *flags])
    main()
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(metrics["loss_list"]) == 2
    assert all(map(math.isfinite, metrics["loss_list"]))
    assert metrics["flags"]["compact_union"] == ("--compact_union_flag"
                                                 in flags)
    assert metrics["flags"]["stable_softmax"] == (
        "max" if "max" in flags else "clip")
    assert not any(kernels.launch_counts().values())
    for rel in ("models/rgat.py", "ops/spmm.py", "ops/fused_agg.py",
                "graph/build.py"):
        with open(os.path.join(ROOT, "het_tpu_torch", rel)) as f:
            assert "NotImplementedError" not in f.read(), rel


@pytest.mark.parametrize("flags", [[], ["--compact_as_of_node_flag"]])
def test_rgcn_trains_through_the_cli(monkeypatch, capsys, flags):
    """``--model RGCN`` trains through ``python -m het_tpu_torch.train`` (on
    the CPU here, so no kernel launches); the RGAT-only flags are taken
    and ignored, as het_tpu's trainer ignores them."""
    import json
    import sys

    from het_tpu_torch.models import rgcn
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train.__main__ import main

    assert os.path.abspath(rgcn.__file__) in set(_port_files())
    kernels.reset_launches()
    monkeypatch.setattr(sys, "argv", [
        "het_tpu_torch.train", "--model", "RGCN", "-d", "mag",
        "--dataset_scale", "0.002", "--num_heads", "4", "--num_layers", "3",
        "--multiply_among_weights_first_flag", "--n_infeat", "8",
        "--hidden", "8", "-e", "2", "--device", "cpu", *flags])
    main()
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["model"] == "RGCN" and len(metrics["loss_list"]) == 2
    assert all(map(math.isfinite, metrics["loss_list"]))
    assert metrics["flags"]["compact"] == bool(flags)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("flags", [[], ["--compact_as_of_node_flag"],
                                   ["--compact_as_of_node_flag",
                                    "--stable_softmax", "max"]])
def test_hgt_trains_through_the_cli(monkeypatch, capsys, flags):
    """``--model HGT`` trains through ``python -m het_tpu_torch.train`` (on
    the CPU here, so no kernel launches), plain, compact and compact with
    the exact softmax; ``--multiply_among_weights_first_flag`` is taken
    and ignored, as het_tpu's trainer ignores it for HGT."""
    import json
    import sys

    from het_tpu_torch.models import hgt
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train.__main__ import main

    assert os.path.abspath(hgt.__file__) in set(_port_files())
    kernels.reset_launches()
    monkeypatch.setattr(sys, "argv", [
        "het_tpu_torch.train", "--model", "HGT", "-d", "mag",
        "--dataset_scale", "0.002", "--num_heads", "4", "--num_layers", "2",
        "--multiply_among_weights_first_flag", "--n_infeat", "8",
        "--hidden", "8", "-e", "2", "--device", "cpu", *flags])
    main()
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["model"] == "HGT" and len(metrics["loss_list"]) == 2
    assert all(map(math.isfinite, metrics["loss_list"]))
    assert metrics["flags"]["compact"] == bool(flags)
    assert not any(kernels.launch_counts().values())


def test_unported_model_raises():
    """Every family het_tpu trains is ported; a model name of none of them
    raises, naming the four."""
    from het_tpu_torch.train import TrainConfig, train

    with pytest.raises(ValueError, match="RGAT, RGCN, HGT or GAT"):
        train(TrainConfig(model="GCN", dataset="aifb", dataset_scale=0.01,
                          compact=True, multiply_first=True, num_epochs=1,
                          device="cpu"), log=lambda s: None)


def test_parallel_modules_follow_the_rules(monkeypatch):
    """The data-parallel modules are among the files the import rule
    walks, and their entry points take the card unless told otherwise:
    without one they raise before opening a process group."""
    import inspect

    from het_tpu_torch import entry
    from het_tpu_torch.parallel import dp, launch, partition

    files = set(_port_files())
    for mod in (dp, launch, partition, entry):
        assert os.path.abspath(mod.__file__) in files
    for fn in (dp.setup_rank, launch.spawn_ranks, entry.entry,
               entry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.setup_rank(0, 1, init_method="file:///nonexistent/rendezvous")
    for fn in (entry.entry, lambda: entry.dryrun_multichip(2),
               lambda: entry.main(["--ranks", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert not torch.distributed.is_initialized()


def test_port_builds_its_own_host_library():
    """No file of the port names het_tpu's native library
    (``libhetgraphops``) or loads anything from ``native/``: only
    ``ops/kernels/_build.py`` loads a library, from the package's own
    build directory, and the host library it loads is the port's."""
    from het_tpu_torch.graph import native
    from het_tpu_torch.ops.kernels import _build

    pkg = os.path.join(ROOT, "het_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, names in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        files += [os.path.join(d, f) for f in names]
    assert any(f.endswith("graphops.cpp") for f in files)
    loaders = ("CDLL", "LoadLibrary", "dlopen", "PyDLL")
    for path in files:
        with open(path, errors="replace") as f:
            text = f.read()
        assert "libhetgraphops" not in text, path
        if not path.endswith(".py"):
            continue
        for node in ast.walk(ast.parse(text, path)):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "native/" not in node.value, (path, node.value)
            if isinstance(node, ast.Call):
                fn = node.func
                name = getattr(fn, "attr", getattr(fn, "id", ""))
                if name in loaders:
                    assert path.endswith(os.path.join("kernels", "_build.py")
                                         ), (path, name)
                if name == "join":
                    assert not any(isinstance(a, ast.Constant)
                                   and a.value == "native"
                                   for a in node.args), path
    lib = native.library()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert _build.BUILD_DIR.startswith(pkg + os.sep)
