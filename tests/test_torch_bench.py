"""The port's benchmark entry points (``het_tpu_torch.bench``) on the CPU.

``bench.step``'s step function against ``bench.py``'s ``make_step`` (het_tpu
on its pallas backend in interpret mode, jitted as bench.py runs it) with
the same weights, carried by
``params_from_jax``: the loss within rtol 1e-4 / atol 2e-4, every gradient
within rtol 5e-3 / atol 2e-4 (the repo's backend-parity tolerances).  Each
module runs at its smallest form through its command line and prints JSON
with its keys; a share past 100%, a failed variant and a kernel that
disagrees with its plain version raise; the sweep records a failed case
and exits non-zero.  The launch counts a step that ``chip_smoke.py``
asserts are held to a CPU stand-in that counts what a CUDA tensor would
launch.  Each graph is built once for the file (``step.load`` is
memoized)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from het_tpu import ops as jops
from het_tpu.data import loaders as jl
from het_tpu.models import RGATModel as JRGATModel
from het_tpu.utils.misc import nll_loss as j_nll_loss
from het_tpu_torch.bench import (common, compiled, fullscale, infer, models,
                                 scaling, segmm_strategies, skew, step,
                                 sweep)
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.ops import kernels
from het_tpu_torch.ops.kernels import _dispatch
from het_tpu_torch.utils import profiling as tp

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
SCALE = 1e-5  # synthetic ogbn-mag: 64 nodes, 256 edges
TINY = "0.0001"  # each module's smallest CPU form: 193 nodes, 2,111 edges


@pytest.fixture(scope="module")
def _loaded():
    return functools.lru_cache(maxsize=None)(step.load)


@pytest.fixture(autouse=True)
def _load_once(_loaded, monkeypatch):
    """Every ``step.load`` of the file shares its graph and inputs."""
    monkeypatch.setattr(step, "load", _loaded)


@pytest.fixture
def port_data():
    return step.load(SCALE, torch.device("cpu"))


@pytest.fixture(scope="module")
def jax_graph():
    return jl._synthetic("mag", scale=SCALE, num_classes=step.CLASSES,
                         seed=0, tile=128).graph


def _j_make_step(model, g, labels):
    """``bench.py``'s ``make_step``: the loss and gradients of the
    parameters at the inputs ``x``."""
    def make_step(params):
        @jax.jit
        def run(x):
            def loss_fn(p):
                return j_nll_loss(model.apply(p, g, x), labels)
            return jax.value_and_grad(loss_fn)(params)
        return run
    return make_step


@pytest.mark.parametrize("compact_multfirst", [False, True],
                         ids=["plain", "compact_multfirst"])
def test_step_matches_bench_py(port_data, jax_graph, compact_multfirst):
    data, g, x, labels = port_data
    jmodel = JRGATModel(
        in_feat=step.F_IN, hidden=step.HIDDEN, num_classes=step.CLASSES,
        num_rels=jax_graph.num_rels, num_heads=step.HEADS, num_layers=1,
        dropout=0.0, stable_softmax="clip", compact=compact_multfirst,
        multiply_first=compact_multfirst)
    xj = jnp.asarray(x.numpy())
    jops.set_backend("xla")  # init needs shapes only
    params = jax.jit(lambda key: jmodel.init(key, jax_graph, xj))(
        jax.random.PRNGKey(1))
    jops.set_backend("pallas")
    try:
        jloss, jgrads = _j_make_step(
            jmodel, jax_graph, jnp.asarray(labels.numpy()))(params)(xj)
    finally:
        jops.set_backend("xla")

    def state(tree):
        flat = params_from_jax({"embed": {"params": {"embed": np.zeros(1)}},
                                "model": jax.tree.map(np.asarray, tree)})
        return {k[len("model."):]: v for k, v in flat.items()
                if k.startswith("model.")}

    net = step.model(data, "kernel", compact_multfirst)
    net.load_state_dict(state(params))
    got = common.first_step(net, common.make_step(net, g, x, labels))
    np.testing.assert_allclose(got["loss"], float(jloss), **VAL)
    want = state(jgrads)
    assert set(got["grads"]) == set(want)
    for name, grad in got["grads"].items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD)


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


# module, its smallest command line, the keys of its rows (the last row
# where it prints a summary)
MODULES = {
    "step": (step, ["--scale", TINY, "--warmup", "0", "--steps", "1"],
             ["metric", "value", "unit", "vs_baseline", "detail"]),
    "models": (models, ["--scale", TINY, "--cases", "RGAT+flags",
                        "--warmup", "0", "--steps", "1"],
               ["case", "ms", "bf16_ms", "peak_mem_mb", "bf16_peak_mem_mb",
                "kernel_vs_plain_max_rel", "card", "clock"]),
    "infer": (infer, ["--scale", TINY, "--cases", "GAT", "--warmup", "0",
                      "--steps", "1"],
              ["case", "ms_per_infer", "allclose_vs_plain", "peak_mem_mb",
               "plain_ms_per_infer", "card", "clock"]),
    "compiled": (compiled, ["--scale", TINY, "--cases", "rgcn+compact",
                            "--warmup", "0", "--steps", "1"],
                 ["case", "compiled_ms", "handwritten_ms", "ratio",
                  "compiled_peak_mem_mb", "handwritten_peak_mem_mb"]),
    "sweep": (sweep, ["--grid", "quick", "--max_cases", "1",
                      "--dataset_scale", "0.01", "--num_epochs", "1"],
              ["case", "mean_training_time", "max_memory_usage (mb)",
               "train_acc", "test_acc", "kernel_vs_plain_max_rel"]),
    "fullscale": (fullscale, ["--scale", TINY, "--warmup", "0", "--steps",
                              "1"],
                  ["scale", "edges", "dtype", "step_ms", "Medges_per_s",
                   "graph_build_s", "peak_mem_mb",
                   "pct_of_roofline_strict_bf16"]),
    "segmm_strategies": (segmm_strategies, ["--cases", "mag_like",
                                            "--scale", "0.001", "--reps",
                                            "1"],
                         ["case", "R", "bound_ms", "kernel_fwd_ms",
                          "static_mix_fwd_dx_dw_ms", "gathered_w_fwd_ms",
                          "plain_fwd_ms", "peak_mem_mb", "card"]),
    "skew": (skew, ["--kinds", "one_hub", "--nodes", "300", "--edges",
                    "3000", "--reps", "1"],
             ["kind", "max_in_degree", "reduce_ms", "plain_ms", "bound_ms",
              "pct_of_bound", "peak_mem_mb", "card"]),
    "scaling": (scaling, ["--ranks", "1", "2", "--scale", "0.0005",
                          "--steps", "1"],
                ["world", "step_ms", "edges_per_s", "scaling_efficiency",
                 "kernel_vs_plain_max_rel", "backend", "card"]),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_runs_on_cpu(name, capsys, tmp_path):
    mod, argv, keys = MODULES[name]
    out = tmp_path / "rows.jsonl"
    assert mod.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    rows = _lines(capsys)
    assert rows and rows == [json.loads(line) for line in
                             out.read_text().splitlines()]
    row = rows[0]
    assert set(keys) <= set(row), set(keys) - set(row)
    for r in rows:
        if "card" in r:
            assert r["clock"] == "host_perf_counter"
    if name == "step":
        d = row["detail"]
        assert d["clock"] == "host_perf_counter"
        assert {f"t_{n}_ms" for n in step.VARIANTS} <= set(d)
        for key in ("pct_of_roofline_strict_f32", "pct_of_traffic_bound_f32",
                    "pct_of_roofline_strict_bf16",
                    "pct_of_traffic_bound_bf16"):
            assert 0 < d[key] <= 100
    if name == "models":
        assert rows[-1]["compact_duplication_src"] > 1
    if name == "sweep":
        assert rows[-1]["failed"] == 0 and rows[-1]["cases"] == 1
    if name == "scaling":  # two gloo ranks spawned on the CPU
        last = rows[-1]
        assert last["note"] == scaling.HOST and last["skipped_worlds"] == []
        assert [r["world"] for r in last["results"]] == [1, 2]
        assert last["results"][0]["scaling_efficiency"] == 1.0
        assert all(r["backend"] == "gloo" and r["device"] == "cpu"
                   for r in rows[:-1])


@pytest.mark.parametrize("name", list(MODULES))
def test_module_runs_on_the_card_by_default(name, monkeypatch):
    """Without ``--device cpu`` a module asks for the card, and raises
    where there is none, before it builds anything."""
    mod, argv, _ = MODULES[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_peaks_of_reads_the_card(monkeypatch):
    """On the card the bounds count with ``device_peaks()``'s row, which
    raises for any card but an H100 SXM; ``peaks=`` overrides it."""
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 PCIe")
    with pytest.raises(ValueError, match="H100 PCIe"):
        common.peaks_of(cuda)
    mine = {"hbm_gbps": 1.0, "f32_tflops": 1.0, "bf16_tflops": 1.0}
    assert common.peaks_of(cuda, mine) is mine
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert common.peaks_of(cuda) == tp.H100_SXM
    assert common.peaks_of(torch.device("cpu")) == tp.H100_SXM


def test_share_over_100_raises():
    assert common.share_pct(1.0, 2.0, "x") == 50.0
    with pytest.raises(common.BenchFailure, match="outside"):
        common.share_pct(2.0, 1.0, "x")
    slow_card = {"hbm_gbps": 1e-9, "f32_tflops": 1e-9, "bf16_tflops": 1e-9}
    with pytest.raises(common.BenchFailure, match="outside"):
        step.run(float(TINY), "cpu", warmup=0, steps=1,
                 variants=("kernel_compact_multfirst",), peaks=slow_card)


def test_failed_variant_raises(monkeypatch):
    made = common.make_step

    def failing(model, g, x, labels, dtype=torch.float32):
        if dtype == torch.bfloat16:
            raise RuntimeError("bf16 variant failed")
        return made(model, g, x, labels, dtype)

    monkeypatch.setattr(common, "make_step", failing)
    with pytest.raises(RuntimeError, match="bf16 variant failed"):
        step.run(SCALE, "cpu", warmup=0, steps=1,
                 variants=("kernel_compact_multfirst",
                           "kernel_bf16_compact_multfirst"))


def test_disagreement_raises(monkeypatch):
    """A kernel variant on other parameters than its plain variant's."""
    made = common.model_of

    def other_seed(data, impl, *, seed=1, **cfg):
        return made(data, impl, seed=seed + (impl == "kernel"), **cfg)

    monkeypatch.setattr(common, "model_of", other_seed)
    with pytest.raises(common.BenchFailure, match="kernel against plain"):
        step.run(float(TINY), "cpu", warmup=0, steps=1,
                 variants=("plain", "kernel"))


def test_sweep_records_a_failed_case_and_exits_nonzero(monkeypatch, capsys):
    """The sweep's bookkeeping around a case (a case's training is
    ``test_module_runs_on_cpu[sweep]``'s)."""
    def flaky(case, *args):
        if case[4]:  # the compact case
            raise common.BenchFailure("kernel loss off")
        return {"mean_training_time": 1.0}

    monkeypatch.setattr(sweep, "run_case", flaky)
    assert sweep.main(["--grid", "quick", "--max_cases", "2",
                       "--dataset_scale", "0.01", "--num_epochs", "1",
                       "--device", "cpu"]) == 1
    rows = _lines(capsys)
    assert "error" not in rows[0] and "kernel loss off" in rows[1]["error"]
    assert rows[-1]["failed"] == 1 and rows[-1]["cases"] == 2


def test_step_launches_match_chip_smokes_count(monkeypatch):
    """The launches a step ``chip_smoke.py`` asserts (``LAUNCHES_A_STEP``),
    counted on the CPU by a stand-in that bumps a kernel's count wherever
    a CUDA tensor would launch it and runs the plain version, and that
    answers an op's route as the card would (``_dispatch.launches``)."""
    plain = _dispatch.takes_plain

    def counted(t, impl, what):
        if impl == "kernel":
            getattr(kernels, what).launches += 1
        return plain(t, "plain", what)

    monkeypatch.setattr(_dispatch, "takes_plain", counted)
    monkeypatch.setattr(_dispatch, "launches",
                        lambda t, impl: impl == "kernel")
    kernels.reset_launches()
    res = step.run(SCALE, "cpu", warmup=0, steps=1)
    got = res["detail"]["launches_a_step"]
    assert got == {n: step.LAUNCHES_A_STEP.get(n, {}) for n in step.VARIANTS}
    totals = kernels.launch_counts()
    for k in kernels.KERNELS:
        assert totals[k] == 2 * sum(v.get(k, 0) for v in
                                    step.LAUNCHES_A_STEP.values())
    kernels.reset_launches()
