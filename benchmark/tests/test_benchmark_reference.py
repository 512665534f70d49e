"""Each plain reference against the port at a tiny size on the CPU: the
logits and every parameter's gradient, from the same COO and the same
seeded parameters, under every trainer flag the cells use and more."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import params, run
from benchmark.reference import common as refc
from benchmark.tests.tiny import CPU, tiny_spec
from het_tpu_torch.graph.build import build_heterograph
from het_tpu_torch.train.driver import build_model

CASES = [
    ("rgat.mag.compact_mf", ["--compact_as_of_node_flag",
                             "--multiply_among_weights_first_flag"]),
    ("rgat.mag.compact_mf", []),
    ("rgat.mag.compact_mf", ["--multiply_among_weights_first_flag"]),
    ("rgat.mag.compact_mf", ["--compact_as_of_node_flag"]),
    ("hgt.mag.plain", []),
    ("hgt.mag.plain", ["--compact_as_of_node_flag"]),
]


def _grads(loss, named):
    names = list(named)
    return dict(zip(names, torch.autograd.grad(loss, [named[n]
                                                      for n in names])))


@pytest.mark.parametrize("cell,flags", CASES,
                         ids=[f"{c.split('.')[0]}[{' '.join(f)}]"
                              for c, f in CASES])
def test_reference_matches_the_port(cell, flags):
    spec = tiny_spec(cell)
    cfg = spec.config
    tcfg = run.trainer_config(cfg, flags)
    inp = run.load("graphs", "ogbn_mag").generate(
        spec.traffic["graph"], cfg["num_classes"], 5, CPU)
    N, R = inp["num_nodes"], inp["num_rels"]
    T = len(inp["ntype_offsets"]) - 1
    ref_mod = run.load("reference", cfg["family"])
    shapes = ref_mod.param_shapes(cfg, N, R, T)
    g = build_heterograph(*(inp[k].numpy() for k in ("src", "dst", "rel")),
                          N, R, ntype_offsets=inp["ntype_offsets"],
                          tile=tcfg.tile, build_compact=tcfg.compact)
    net = build_model(tcfg, SimpleNamespace(graph=g,
                                            num_classes=cfg["num_classes"]),
                      generator=torch.Generator())
    net.load_state_dict(params.seeded_params(shapes, 5, CPU))
    idx, lab = inp["train_idx"], inp["labels"][inp["train_idx"]]
    logits = net(g)
    got = _grads(refc.nll(logits[idx], lab), dict(net.named_parameters()))

    p = {n: t.clone().requires_grad_(True)
         for n, t in params.seeded_params(shapes, 5, CPU).items()}
    rg = refc.ref_graph(inp["src"], inp["dst"], inp["rel"], N, R,
                        inp["ntype_offsets"], block_edges=97)
    want_logits = ref_mod.forward(p, rg, cfg)
    want = _grads(refc.nll(want_logits[idx], lab), p)
    torch.testing.assert_close(logits, want_logits, rtol=1e-4, atol=1e-6)
    assert set(got) == set(want)
    for n in want:
        scale = float(want[n].abs().max())
        torch.testing.assert_close(got[n], want[n], rtol=1e-3,
                                   atol=1e-5 * scale + 1e-12, msg=n)
