"""The port's per-op breakdown (``het_tpu_torch.bench.breakdown``) on the
CPU: it runs through its command line at a tiny scale, its row labels are
``scripts/breakdown.py``'s (read from that file's text, with its
``[pallas]`` / ``[xla]`` and ``pallas`` / ``xla`` read as the port's
``kernel`` / ``plain``), each row's bound is a hand count of its byte and
operation model on that graph, a share past 100% and a kernel that
disagrees with its plain version raise, and the launches a call that
``chip_smoke.py`` asserts are held to a CPU stand-in that counts what a
CUDA tensor would launch.  Each graph is built once for the file
(``step.load`` is memoized), and each row is timed once: the file
counts, it does not time."""

import functools
import json
import pathlib
import re

import pytest
import torch

from het_tpu_torch import ops
from het_tpu_torch.bench import breakdown, common, step
from het_tpu_torch.ops import kernels
from het_tpu_torch.ops.kernels import _dispatch
from het_tpu_torch.utils import profiling as tp

TINY = 0.0001  # synthetic ogbn-mag: 193 nodes, 2,111 edges
SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "breakdown.py"


@pytest.fixture(scope="module")
def _loaded():
    return functools.lru_cache(maxsize=None)(step.load)


def _light(mp, loaded):
    """Each graph built once for the file, and one timed call a row (the
    module's constants; ``time_call_ms`` still makes its two untimed
    calls): the file's runs are counted, not timed."""
    mp.setattr(step, "load", loaded)
    mp.setattr(breakdown, "REPS", 1)
    mp.setattr(breakdown, "QUICK_REPS", 1)


@pytest.fixture(autouse=True)
def _load_once(_loaded, monkeypatch):
    _light(monkeypatch, _loaded)


@pytest.fixture(scope="module")
def counted_run(_loaded):
    """One full run (both impls, every end-to-end row) with a stand-in
    that bumps a kernel's count wherever a CUDA tensor would launch it and
    runs the plain version, and that answers an op's route as the card
    would (``_dispatch.launches``)."""
    plain = _dispatch.takes_plain

    def counted(t, impl, what):
        if impl == "kernel":
            getattr(kernels, what).launches += 1
        return plain(t, "plain", what)

    with pytest.MonkeyPatch.context() as mp:
        _light(mp, _loaded)
        mp.setattr(_dispatch, "takes_plain", counted)
        mp.setattr(_dispatch, "launches", lambda t, impl: impl == "kernel")
        kernels.reset_launches()
        try:
            return breakdown.run(TINY, "cpu", quick=False)
        finally:
            kernels.reset_launches()


def _script_labels():
    """breakdown.py's op labels (after its backend tag) and its
    end-to-end labels, in the port's words."""
    text = SCRIPT.read_text()
    op = re.findall(r'add\(tag \+ "([^"]+)"', text)
    e2e = re.findall(r'add_e2e\("([^"]+)"', text)
    port = [re.sub(r"^pallas ", "kernel ", re.sub(r"^xla ", "plain ", e))
            for e in e2e]
    return op, port


def _graph_and_inputs():
    _, g, x, _ = step.load(TINY, torch.device("cpu"))
    return g, breakdown.inputs(g, x, torch.device("cpu"))


def test_labels_match_breakdown_py():
    op, e2e = _script_labels()
    assert len(op) == 16 and len(e2e) == 4
    assert [r.label for r in breakdown.op_rows(
        *_graph_and_inputs(), "kernel")] == op
    assert list(breakdown.E2E) == e2e


def test_quick_runs_through_its_command_line(capsys, tmp_path):
    """``--device cpu --quick``: the kernel rows with breakdown.py's
    labels, its two quick end-to-end rows, a closing line; the same lines
    in ``--out``."""
    out = tmp_path / "rows.jsonl"
    assert breakdown.main(["--device", "cpu", "--quick", "--scale",
                           str(TINY), "--out", str(out)]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert rows == [json.loads(line) for line in
                    out.read_text().splitlines()]
    op, e2e = _script_labels()
    assert [r["op"] for r in rows[:16]] == [f"[kernel] {o}" for o in op]
    assert [r["config"] for r in rows[16:-1]] == e2e[:2]
    for r in rows[:-1]:
        assert r["clock"] == "host_perf_counter" and "card" in r
        assert r["ms"] > 0 and r["kernel_vs_plain_max_rel"] == 0.0
    for r in rows[:16]:
        assert 0 < r["share_pct"] <= 100
    assert rows[-1]["rows"] == 18 and rows[-1]["quick"] is True


def _hand_count(s):
    """breakdown.py's byte (f32) and operation counts, written out row by
    row from the graph's sizes."""
    EP, N, U = s["EP"], s["N"], s["UCs"]
    H, D, F = 4, 16, 64
    C = H * D
    gat = (EP * C + 2 * EP * H + N * C + N * H) * 4
    hgt = (3 * N * C + 3 * EP * C + N * H) * 4
    return {
        "compact_typed_linear src fwd": ((N * F + U * F + U * C) * 4,
                                         2 * U * H * F * D),
        "compact_typed_linear src grad": (
            (N * F + 3 * U * F + 3 * U * C) * 4, 6 * U * H * F * D),
        "edge_typed_linear src fwd": ((N * F + EP * F + EP * C) * 4,
                                      2 * EP * H * F * D),
        "edge_typed_linear src grad": (
            (N * F + 3 * EP * F + 3 * EP * C) * 4, 6 * EP * H * F * D),
        "compact_typed_linear dW (wrt w)": (
            (N * F + U * F + 2 * U * C) * 4, 4 * U * H * F * D),
        "compact wa-logit dW (wrt wa)": ((N * F + U * F + 2 * U * H) * 4,
                                         4 * U * H * F),
        "compact wa-logit fwd (el_c)": ((N * F + U * F + U * H) * 4,
                                        2 * U * H * F),
        "expand_compact el (EP,H) fwd+grad": (
            (N * F + 3 * U * F + 4 * EP * H) * 4, 0),
        "expand_compact (UC,H,D)->(EP,H,D) fwd": ((U * C + EP * C) * 4, 0),
        "expand_compact grad (scatter into compact)": (
            (3 * U * C + 2 * EP * C) * 4, 0),
        "relational_fused_gat fwd": (gat, 0),
        "relational_fused_gat grad": (3 * gat, 0),
        "hgt_plain_attention fwd": (hgt, 2 * EP * H * D * D + 2 * EP * C),
        "hgt_plain_attention grad": (3 * hgt, 6 * EP * H * D * D),
        "scatter_sum_dst packed (EP,H+HD)": ((EP + N) * (C + H) * 4, 0),
        "gather x[src] (EP,F_IN)": ((N * F + EP * F) * 4, 0),
    }


def test_bounds_are_hand_counts(counted_run):
    """Each row's bytes, operations and bound on the tiny graph, both
    impls, against the hand count at the H100 SXM's peaks."""
    rows = counted_run
    summary = rows[-1]
    want = _hand_count(summary)
    ops_rows = [r for r in rows if "op" in r]
    assert len(ops_rows) == 32
    peaks = tp.H100_SXM
    for r in ops_rows:
        label = r["op"].split("] ", 1)[1]
        nbytes, flops = want[label]
        assert (r["bytes"], r["flops"]) == (nbytes, flops), label
        t_mem = nbytes / (peaks["hbm_gbps"] * 1e9) * 1e3
        t_ops = flops / (peaks["f32_tflops"] * 1e12) * 1e3
        assert r["bound_ms"] == pytest.approx(max(t_mem, t_ops), rel=1e-12)
        assert r["bound_by"] == ("bytes" if t_mem >= t_ops
                                 else "operations")
        assert r["share_pct"] == pytest.approx(
            100 * r["bound_ms"] / r["ms"], rel=1e-12)
    assert [r["config"] for r in rows if "medges_per_s" in r] == \
        list(breakdown.E2E)
    assert {r["impl"] for r in ops_rows} == {"kernel", "plain"}


def test_share_past_100_raises():
    slow_card = {"hbm_gbps": 1e-9, "f32_tflops": 1e-9, "bf16_tflops": 1e-9}
    with pytest.raises(common.BenchFailure, match="outside"):
        breakdown.run(TINY, "cpu", quick=True, peaks=slow_card)


def test_disagreement_raises(monkeypatch):
    """A kernel row whose output is off its plain row's (the HGT rows
    alone, so that the run stops at its first row)."""
    made, rows = ops.hgt_plain_attention, breakdown.op_rows

    def off(*args, impl="kernel", **kw):
        out = made(*args, impl=impl, **kw)
        return out * 1.01 if impl == "kernel" else out

    monkeypatch.setattr(ops, "hgt_plain_attention", off)
    monkeypatch.setattr(breakdown, "op_rows", lambda *a: [
        r for r in rows(*a) if r.label.startswith("hgt_plain_attention")])
    with pytest.raises(common.BenchFailure, match="kernel against plain"):
        breakdown.run(TINY, "cpu", quick=True)


def test_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        breakdown.main(["--quick"])


def test_launches_match_chip_smokes_count(counted_run):
    """The launches a call ``chip_smoke.py`` asserts
    (``LAUNCHES_A_CALL``), counted on the CPU (:func:`counted_run`), and
    the run's totals: each kernel row's calls are its hold's and
    ``time_call_ms``'s (two untimed, then the timed ones)."""
    rows = counted_run
    want_total = {}
    calls = 3 + rows[-1]["config"]["reps"]
    for r in rows[:-1]:
        label = r.get("op", r.get("config"))
        key = label.split("] ", 1)[-1]
        per = breakdown.LAUNCHES_A_CALL.get(key, {}) \
            if r["impl"] == "kernel" else {}
        assert r["launches_a_call"] == per, label
        for k, n in per.items():
            want_total[k] = want_total.get(k, 0) + n * calls
    got = {k: n for k, n in rows[-1]["launches"].items() if n}
    assert got == want_total


def test_time_call_on_the_cpu():
    """``common.time_call`` off the card: two untimed calls, then
    ``reps`` timed ones on the host clock, with no enqueue to hide."""
    calls = []
    r = common.time_call(lambda: calls.append(1), torch.device("cpu"), 3)
    assert len(calls) == 5
    assert r["host_ms"] is None and r["spin_ms"] == 0.0
    assert r["host_hidden"] and r["ms"] >= 0
