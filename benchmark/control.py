"""The readings that set a cell's limits from above: the plain reference
put in the program's place, computed in the precision below the
configuration's (TF32 for f32 with TF32 off), and with the faults a
training run can have planted in it, each against the reference itself.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 \
        [--program SECONDS] [--variants NAME ...]

prints one JSON line a seed: the reference's readings, and each
variant's readings and ``compare.gaps`` against them.  With
``--program`` it first makes a whole run of the cell on each seed in
this process (``run.run_cell``, a window of ``SECONDS``) and prints its
numbers, so that a dozen seeds share one process's start.

The variants (all by default; ``--variants`` with no name runs none):
``control_tf32``; ``fault_half_batch`` (the loss's mean over the first
half of the training rows); ``fault_altered_answer`` (the logits of every
node altered by ``ALTER`` in their first class); ``fault_frozen_leaf``
(one reading a leaf, Adam leaving that leaf unchanged while it moves the
others).  A step that leaves the whole state unchanged reads 1 in
``change_gap`` by the measure itself and needs no run; one card has no
exchange between cards to leave out.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict

import torch

from benchmark import compare, params
from benchmark.reference import common as refc
from benchmark.run import SETUP_STEPS, cell_spec, load, run_cell

ALTER = 0.1
VARIANTS = ("control_tf32", "fault_half_batch", "fault_altered_answer",
            "fault_frozen_leaf")


def _readings(spec, inp, shapes, ref_mod, seed: int, device,
              variant: str = "", frozen=()) -> Dict:
    cfg = spec.config
    start = params.seeded_params(shapes, seed, device)
    rg = refc.ref_graph(inp["src"], inp["dst"], inp["rel"],
                        inp["num_nodes"], inp["num_rels"],
                        inp["ntype_offsets"])

    def forward(p, gr):
        out = ref_mod.forward(p, gr, cfg)
        if variant == "fault_altered_answer":
            out = out + torch.nn.functional.pad(
                out.new_full((1, 1), ALTER), (0, out.shape[1] - 1))
        return out

    rows = ((lambda idx: idx[: idx.numel() // 2])
            if variant == "fault_half_batch" else (lambda idx: idx))
    return refc.train_readings(
        forward, start, rg, inp["labels"], inp["train_idx"],
        lr=float(cfg["lr"]), steps=SETUP_STEPS,
        tf32=variant == "control_tf32", loss_rows=rows, frozen=frozen)


def control_gaps(spec, seed: int, device, variants=VARIANTS
                 ) -> Dict[str, Dict[str, float]]:
    """Each variant's gaps against the reference on seed ``seed``'s
    inputs at the cell's size (``fault_frozen_leaf``'s a leaf)."""
    cfg, traffic = spec.config, spec.traffic
    ref_mod = load("reference", cfg["family"])
    inp = load("graphs", traffic["generator"]).generate(
        traffic["graph"], cfg["num_classes"], seed, device)
    shapes = ref_mod.param_shapes(cfg, inp["num_nodes"], inp["num_rels"],
                                  len(inp["ntype_offsets"]) - 1)
    base = _readings(spec, inp, shapes, ref_mod, seed, device)
    out = {"reference": base}
    for v in variants:
        if v == "fault_frozen_leaf":
            out[v] = {}
            for leaf in sorted(shapes):
                got = _readings(spec, inp, shapes, ref_mod, seed, device,
                                frozen=(leaf,))
                out[v][leaf] = {"gaps": compare.gaps(got, base)}
                gc.collect()
            continue
        got = _readings(spec, inp, shapes, ref_mod, seed, device, v)
        out[v] = {"gaps": compare.gaps(got, base), "readings": got}
        gc.collect()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", type=float, default=None)
    p.add_argument("--variants", nargs="*", choices=VARIANTS,
                   default=VARIANTS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    spec = cell_spec(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        if args.program is not None:
            result, notes = run_cell(spec, seed, args.program, False, dev,
                                     t0=time.time())
            print(json.dumps({
                "workload": spec.name, "seed": seed, "program": {
                    "correct": result["correct"],
                    "numbers": notes["numbers"],
                    "metrics": result["metrics"],
                    "reference_s": notes["reference_s"],
                    "uncompared": notes["uncompared"]}}), flush=True)
            del result, notes
            gc.collect()
            torch.cuda.empty_cache()
        if args.variants:
            print(json.dumps({"workload": spec.name, "seed": seed,
                              "gaps": control_gaps(spec, seed, dev,
                                                   args.variants)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
