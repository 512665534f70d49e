"""A run end to end on the CPU at a tiny size, the refusal to measure
without a card, and a cell made of new files only."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import compare, run
from benchmark.tests.tiny import CELLS, CPU, tiny_spec

REPO = Path(run.ROOT)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_cpu_run_is_correct_and_reports_no_device_metric(cell, trace):
    spec = tiny_spec(cell)
    result, notes = run.run_cell(spec, 2**31 + 3, 0.2, trace, CPU)
    assert result["correct"] is True
    assert result["failed"] == 0
    steps = notes["ctx"]["window_steps"]
    assert result["attempted"] == run.SETUP_STEPS + steps
    ctx = notes["ctx"]  # the harness's own marks, one pair a window step
    assert len(ctx["forward_ms"]) == len(ctx["backward_adam_ms"]) == steps
    assert min(ctx["forward_ms"] + ctx["backward_adam_ms"]) > 0
    assert result["metrics"] == {} and result["device"] is None
    assert "breakdown" not in result
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(spec.limits) <= set(compare.NUMBERS)
    for c in result["checks"].values():
        assert 0 <= c["value"] <= c["limit"]


def test_command_refuses_without_a_card(capsys):
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


def test_cell_spec_refuses_an_unknown_cell():
    with pytest.raises(run.CellError):
        run.cell_spec("no.such.cell")


NEW_CELL = """
import sys, torch
from benchmark import run
spec = run.cell_spec("rgat.tiny.plain")
result, notes = run.run_cell(spec, 9, 0.2, False, torch.device("cpu"))
print(spec.config["hidden"], spec.traffic["flags"], result["correct"],
      notes["ctx"]["window_steps"] > 0)
"""


def test_a_cell_of_new_files_only_is_found_and_run(tmp_path):
    """A copy of the benchmark's folder plus a configuration, a traffic
    mix and a cell file that no code names, and one entry a list in
    ``BENCHMARK.json``: the harness runs the new cell unchanged."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "rgat2_h8_64.json").read_text())
    cfg["hidden"] = 32
    (b / "configs" / "rgat2_h4_32.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "mag_plain.json").read_text())
    traffic["graph"] = {
        "node_types": [["paper", 60], ["author", 40]],
        "relations": [["writes", "author", "paper", 300],
                      ["cites", "paper", "paper", 200]],
        "train_nodes": {"type": "paper", "count": 30}}
    traffic["flags"] = ["--multiply_among_weights_first_flag"]
    (b / "traffic" / "tiny_plain_mf.json").write_text(json.dumps(traffic))
    (b / "cells" / "rgat.tiny.plain.json").write_text(
        (b / "cells" / "rgat.mag.compact_mf.json").read_text())
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="rgat2_h4_32",
                                 file="benchmark/configs/rgat2_h4_32.json"))
    bench["workloads"].append({"name": "rgat.tiny.plain",
                               "config": "rgat2_h4_32",
                               "traffic": "tiny_plain_mf", "chips": 1,
                               "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", NEW_CELL], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "32", "['--multiply_among_weights_first_flag']", "True", "True"]
