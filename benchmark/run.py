"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (its file of widths, and the family
whose plain reference and step count live in ``reference/<family>.py``
and ``costs/<family>.py``) and a traffic mix (``traffic/<name>.json``: a
graph generator of ``graphs/``, its parameters and the trainer's flags);
its limits are ``cells/<cell>.json``'s and each per-layer metric has a
reader, ``metrics/<metric>.py``.  A run:

1. makes the graph's COO, the labels, the training nodes (the
   generator) and the parameters (``params.py``) from ``--seed`` on the
   card;
2. builds the port's graph (``build_heterograph``, timed apart as
   ``graph_build_s``), moves it to the card, builds the trainer's model
   (``build_model``) and loads the parameters into it;
3. drives the port's training loop (``train_steps``: forward, the NLL on
   the training nodes, backward, Adam; f32, TF32 off) through
   ``SETUP_STEPS`` steps, whose losses, first gradients (from Adam's
   first moment after one step) and parameters after the last are the
   program's readings, then on through the measured window until
   ``--seconds`` have passed on the host clock; each window step is
   marked by the harness's own CUDA events (the forward's start and the
   loss in ``step_loss``, the end of Adam in an optimizer hook); with
   ``--trace 1`` the window is traced by ``torch.profiler``;
4. frees the program's state, runs the plain reference over the same
   steps from the same inputs and compares (``compare.py``);
5. prints the numbers compared beside their limits on standard error,
   and one JSON line on standard output.

Set-up (``setup_s``) is from the process's start to the window's: every
kernel library is built or loaded and every shape run in it.  It exits
with another code than 0 and prints no result without enough CUDA cards,
and when JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the wall clock (``/proc``: its start in
    clock ticks after boot against the seconds since boot); now where
    ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T0 = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare  # noqa: E402

SETUP_STEPS = 3  # steps before the window; the reference follows them
FORBIDDEN = ("jax", "jaxlib", "flax", "het_tpu")


class _Marks:
    """Marks of the window's steps: CUDA events on the card's stream, the
    host clock on the CPU; each step's forward (its start to the loss)
    and rest (the loss to the end of Adam) in ms."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.steps: list = []  # [start, loss, adam_done] a step

    def _now(self):
        if not self.on_card:
            return time.perf_counter()
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def mark(self, i: int) -> None:
        if i == 0:
            self.steps.append([])
        self.steps[-1].append(self._now())

    def ms(self):
        done = [s for s in self.steps if len(s) == 3]
        if self.on_card:
            if done:
                done[-1][2].synchronize()
            return ([a.elapsed_time(b) for a, b, _ in done],
                    [b.elapsed_time(c) for _, b, c in done])
        return ([(b - a) * 1e3 for a, b, _ in done],
                [(c - b) * 1e3 for _, b, c in done])


class CellError(ValueError):
    """A cell that ``BENCHMARK.json`` and its files do not define."""


def load(kind: str, name: str):
    """Module ``<kind>/<name>.py`` of the benchmark's folder."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise CellError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise CellError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str) -> SimpleNamespace:
    """Everything ``BENCHMARK.json`` and the benchmark's files say of cell
    ``workload``."""
    bench = _read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"no config {cell['config']!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    limits = _read_json(BENCH / "cells" / f"{workload}.json")["limits"]
    if not limits or set(limits) - set(compare.NUMBERS):
        raise CellError(f"{workload}: limits {sorted(limits)} are not a "
                        f"set of {compare.NUMBERS}")
    return SimpleNamespace(
        name=workload, chips=int(cell["chips"]), limits=limits,
        config=_read_json(ROOT / configs[cell["config"]]["file"]),
        traffic=_read_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]))


def trainer_config(cfg: Dict[str, Any], flags):
    """The port's ``TrainConfig`` for the configuration and the traffic's
    trainer flags, through the trainer's own argument parser."""
    from het_tpu_torch.train.config import add_args, config_from_args
    if cfg["dtype"] != "float32" or cfg["tf32"]:
        raise CellError("the harness runs f32 with TF32 off only")
    p = argparse.ArgumentParser()
    add_args(p)
    args = ["--model", cfg["model"], "--num_layers", str(cfg["num_layers"]),
            "--n_infeat", str(cfg["n_infeat"]), "--hidden",
            str(cfg["hidden"]), "--num_heads", str(cfg["num_heads"]),
            "--num_classes", str(cfg["num_classes"]), "--dropout",
            str(cfg["dropout"]), "--stable_softmax", cfg["stable_softmax"],
            "--dtype", cfg["dtype"], "--lr", str(cfg["lr"]), *flags]
    return config_from_args(p.parse_args(args))


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device, t0: float = T0):
    """One run of ``spec``'s cell on ``device``: the result (its keys, on
    a card the metrics, and last the numbers compared, ``checks``) and
    notes for the log (each side's readings, the reference's seconds)."""
    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from benchmark import params
    from benchmark import trace as tracing
    from benchmark.reference import common as refc
    from het_tpu_torch.graph.build import build_heterograph
    from het_tpu_torch.train.driver import build_model
    from het_tpu_torch.train.loop import train_steps
    from het_tpu_torch.utils import misc

    on_card = device.type == "cuda"
    phases = {"imported": time.time() - t0}
    if on_card:
        torch.zeros(1, device=device)
        phases["cuda"] = time.time() - t0
    cfg, traffic = spec.config, spec.traffic
    tcfg = trainer_config(cfg, traffic["flags"])
    ref_mod = load("reference", cfg["family"])
    inp = load("graphs", traffic["generator"]).generate(
        traffic["graph"], cfg["num_classes"], seed, device)
    N, R = inp["num_nodes"], inp["num_rels"]
    T = len(inp["ntype_offsets"]) - 1
    phases["generated"] = time.time() - t0
    coo = [inp[k].cpu().numpy() for k in ("src", "dst", "rel")]
    t = time.perf_counter()
    g = build_heterograph(*coo, N, R, ntype_offsets=inp["ntype_offsets"],
                          rel_names=inp["rel_names"], tile=tcfg.tile,
                          build_compact=tcfg.compact,
                          compact_union=tcfg.compact_union)
    graph_build_s = time.perf_counter() - t
    del coo
    phases["built"] = time.time() - t0
    g = g.to(device)
    shapes = ref_mod.param_shapes(cfg, N, R, T)
    with torch.device(device):
        net = build_model(tcfg, SimpleNamespace(graph=g, num_classes=cfg[
            "num_classes"]), generator=torch.Generator(device=device))
    net.load_state_dict(params.seeded_params(shapes, seed, device))
    net.train()
    misc.exact_matmuls()
    names = [n for n, _ in net.named_parameters()]
    labels, train_idx = inp["labels"], inp["train_idx"]
    train_labels = labels[train_idx]
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    phases["model"] = time.time() - t0

    rec: Dict[str, Any] = {"losses": []}
    marks = _Marks(on_card)

    def step_loss():
        if "t0" in rec:
            marks.mark(0)
        loss = misc.nll_loss(net(g)[train_idx], train_labels)
        if "t0" in rec:
            marks.mark(1)
        return loss, loss

    def adam_done(opt, args, kwargs):
        if "t0" in rec and "t1" not in rec:
            marks.mark(2)

    def stop(epoch, loss, snapshot):
        rec["losses"].append(loss)
        if epoch < SETUP_STEPS:
            phases[f"step{epoch + 1}"] = time.time() - t0
        if epoch == 0:  # Adam's first moment after one step is 0.1 g
            opt = snapshot()["optimizer"]
            b1 = opt["param_groups"][0]["betas"][0]
            st = opt["state"]
            rec["grad_norms"] = {
                n: refc.leaf_norm(st[i]["exp_avg"]) / (1 - b1)
                for i, n in enumerate(names)}
        if epoch == SETUP_STEPS - 1:
            rec["after"] = {n: p.detach().to("cpu", copy=True)
                            for n, p in net.named_parameters()}
            if trace:
                rec["prof"] = tracing.start(on_card)
            rec["wall0"] = time.time()
            rec["t0"] = time.perf_counter()
            return False
        if epoch >= SETUP_STEPS:
            now = time.perf_counter()
            if now - rec["t0"] >= seconds:
                rec["t1"] = now
                return True
        return False

    hook = register_optimizer_step_post_hook(adam_done)
    try:
        out = train_steps(net, step_loss, steps=2**62, lr=tcfg.lr,
                          device=device, stop=stop)
    finally:
        hook.remove()
    n_win = out["epochs_done"] - SETUP_STEPS
    window_s = rec["t1"] - rec["t0"]
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    prof = rec.pop("prof", None)
    if prof is not None:
        prof.stop()
    forward_ms, rest_ms = marks.ms()
    prog = {"losses": out["loss_list"][:SETUP_STEPS],
            "grad_norms": rec["grad_norms"]}
    del net, g, step_loss
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        phases["held_after_free_bytes"] = torch.cuda.memory_allocated(device)
    summary = tracing.summarize(prof) if prof is not None else None
    del prof

    # the reference, from the same inputs and none of the program's state
    t = time.perf_counter()
    start = params.seeded_params(shapes, seed, device)
    prog["change_norms"] = {
        n: refc.leaf_norm(rec["after"][n].to(device) - start[n])
        for n in names}
    del rec["after"]
    rg = refc.ref_graph(inp["src"], inp["dst"], inp["rel"], N, R,
                        inp["ntype_offsets"])
    ref = refc.train_readings(
        lambda p, gr: ref_mod.forward(p, gr, cfg), start, rg, labels,
        train_idx, lr=tcfg.lr, steps=SETUP_STEPS)
    reference_s = time.perf_counter() - t
    del start, rg

    got = compare.gaps(prog, ref)
    losses = out["loss_list"]
    failed = sum(1 for x in losses if not math.isfinite(x))
    correct = failed == 0 and all(
        math.isfinite(got[k]) and got[k] <= lim
        for k, lim in spec.limits.items())
    ctx = {"setup_s": rec["wall0"] - t0, "graph_build_s": graph_build_s,
           "edges": int(inp["src"].numel()), "window_steps": n_win,
           "window_s": window_s,
           "forward_ms": forward_ms, "backward_adam_ms": rest_ms,
           "peak_bytes": peak, "trace": summary,
           "device_name": (torch.cuda.get_device_name(device) if on_card
                           else None),
           "cost": (load("costs", cfg["family"]).step_cost(
               cfg, step_sizes(inp, shapes)) if trace else None)}
    result: Dict[str, Any] = {"correct": correct, "attempted": len(losses),
                              "failed": failed, "metrics": {},
                              "device": None}
    if on_card:
        result["device"] = {"platform": "gpu", "kind": ctx["device_name"],
                            "count": spec.chips, "memory_peak_bytes": peak}
        result["metrics"] = cell_metrics(spec, trace, ctx)
        if summary is not None:
            result["device"]["busy_s"] = summary["busy_s"]
            result["device"]["window_s"] = window_s
            result["breakdown"] = summary["breakdown"]
    result["checks"] = {k: {"value": got[k], "limit": lim}
                        for k, lim in spec.limits.items()}
    notes = {"reference_s": reference_s, "written_bytes": _written(),
             "uncompared": compare.uncompared(ref), "numbers": got,
             "program": prog, "reference": ref, "ctx": ctx,
             "phases": phases}
    return result, notes


def cell_metrics(spec: SimpleNamespace, trace: bool,
                 ctx: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    ones (True), each from its reader, ``metrics/<name>.py``; a metric
    whose reader finds nothing is left out."""
    out = {}
    for m in spec.per_layer if trace else spec.end_to_end:
        v = load("metrics", m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _written() -> Optional[int]:
    """Bytes this process has caused to be written to storage."""
    try:
        with open("/proc/self/io") as f:
            return int(dict(line.split(": ") for line in f.read()
                            .splitlines())["write_bytes"])
    except (OSError, KeyError, ValueError):
        return None


def step_sizes(inp: Dict[str, Any], shapes) -> Dict[str, int]:
    """The sizes a step count reads: the graph's, the unique (relation,
    source) and (relation, destination) pairs worked out from the COO,
    the training rows and the parameters."""
    import torch
    N = inp["num_nodes"]
    rel = inp["rel"]

    def pairs(node):
        return int(torch.unique(rel * N + node).numel())

    return {"num_nodes": N, "num_edges": int(rel.numel()),
            "num_rels": inp["num_rels"],
            "num_ntypes": len(inp["ntype_offsets"]) - 1,
            "unique_src_pairs": pairs(inp["src"]),
            "unique_dst_pairs": pairs(inp["dst"]),
            "train_nodes": int(inp["train_idx"].numel()),
            "num_params": sum(math.prod(s) for s in shapes.values())}


def loaded_forbidden() -> list:
    """The modules of JAX or the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"benchmark: {spec.name} needs {spec.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, notes = run_cell(spec, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 4
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
