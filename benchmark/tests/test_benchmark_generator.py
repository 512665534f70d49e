"""The ogbn-mag generator: published counts, one graph a seed; the law
of the seeded parameters."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import params, run
from benchmark.tests.tiny import CPU, scaled
from het_tpu_torch.data.loaders import SYNTH_SCALES

GEN = run.load("graphs", "ogbn_mag")
TRAFFIC = sorted((Path(run.BENCH) / "traffic").glob("mag_*.json"))


@pytest.mark.parametrize("path", TRAFFIC, ids=lambda p: p.stem)
def test_traffic_holds_the_published_counts(path):
    g = json.loads(path.read_text())["graph"]
    nodes = sum(c for _, c in g["node_types"])
    edges = sum(r[3] for r in g["relations"])
    assert (nodes, edges, len(g["relations"])) == SYNTH_SCALES["mag"]
    assert g["train_nodes"] == {"type": "paper", "count": 629571}
    assert dict(g["node_types"])["paper"] == 736389


def _small():
    return scaled(json.loads(TRAFFIC[0].read_text())["graph"], 1 / 1000)


def test_counts_ranges_and_labels():
    p = _small()
    out = GEN.generate(p, 8, 2**31 + 11, CPU)
    offs = out["ntype_offsets"]
    where = {n: (offs[i], offs[i + 1])
             for i, (n, _) in enumerate(p["node_types"])}
    assert out["num_nodes"] == sum(c for _, c in p["node_types"])
    counts = torch.bincount(out["rel"], minlength=len(p["relations"]))
    assert counts.tolist() == [r[3] for r in p["relations"]]
    for r, (_, s_type, d_type, _) in enumerate(p["relations"]):
        m = out["rel"] == r
        for ids, t in ((out["src"][m], s_type), (out["dst"][m], d_type)):
            lo, hi = where[t]
            assert int(ids.min()) >= lo and int(ids.max()) < hi
    assert out["labels"].shape == (out["num_nodes"],)
    assert 0 <= int(out["labels"].min()) and int(out["labels"].max()) < 8
    tr = out["train_idx"]
    lo, hi = where["paper"]
    assert tr.numel() == p["train_nodes"]["count"]
    assert tr.unique().numel() == tr.numel()
    assert int(tr.min()) >= lo and int(tr.max()) < hi


def test_same_seed_same_graph_other_seed_other_graph():
    p = _small()
    a, b = (GEN.generate(p, 8, 7, CPU) for _ in range(2))
    c = GEN.generate(p, 8, 8, CPU)
    for k in ("src", "dst", "rel", "labels", "train_idx"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["dst"], c["dst"])
    assert torch.equal(a["rel"], c["rel"])  # the counts do not move


def test_destination_degrees_are_skewed():
    p = _small()
    out = GEN.generate(p, 8, 3, CPU)
    deg = torch.bincount(out["dst"], minlength=out["num_nodes"])
    lo, hi = out["ntype_offsets"][0], out["ntype_offsets"][1]  # papers
    d = deg[lo:hi].double()
    # weights 1/sqrt(1 + rank): the top tenth of papers take far more
    # than a tenth of their in-edges
    top = d.sort(descending=True).values[: (hi - lo) // 10].sum()
    assert top / d.sum() > 0.2


def test_weights_are_drawn_a_matrix_at_a_time():
    """Each weight is Glorot-uniform over its last two axes, whatever
    leading (type, head, relation) axes stack it; embeddings lie in
    [0, 1); the same seed gives the same parameters."""
    shapes = {"embed.embed": (50, 4), "model.layers.0.k_linears":
              (4, 8, 64, 8), "model.layers.0.relation_pri": (4, 8),
              "model.layers.0.h_bias": (8,)}
    got = params.seeded_params(shapes, 2**31 + 5, torch.device("cpu"))
    w = got["model.layers.0.k_linears"]
    lim = math.sqrt(6.0 / (64 + 8))
    assert float(w.abs().max()) <= lim
    assert float(w.abs().max()) > 0.9 * lim
    assert 0.0 <= float(got["embed.embed"].min())
    assert float(got["embed.embed"].max()) < 1.0
    assert bool((got["model.layers.0.relation_pri"] == 1).all())
    assert bool((got["model.layers.0.h_bias"] == 0).all())
    again = params.seeded_params(shapes, 2**31 + 5, torch.device("cpu"))
    assert all(torch.equal(got[n], again[n]) for n in shapes)
