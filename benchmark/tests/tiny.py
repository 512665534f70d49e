"""Tiny cells for the tests: a real cell of ``BENCHMARK.json`` with its
traffic's counts cut by a common factor, run on the CPU."""

from __future__ import annotations

import copy

import torch

from benchmark import run

CELLS = ("rgat.mag.compact_mf", "hgt.mag.plain")
CPU = torch.device("cpu")


def scaled(graph, factor: float, least: int = 8):
    """The traffic's graph parameters with every count times ``factor``
    (at least ``least``)."""
    g = copy.deepcopy(graph)
    g["node_types"] = [[n, max(least, int(c * factor))]
                       for n, c in g["node_types"]]
    g["relations"] = [[n, s, d, max(least, int(c * factor))]
                      for n, s, d, c in g["relations"]]
    g["train_nodes"]["count"] = max(least, int(g["train_nodes"]["count"]
                                               * factor))
    return g


def tiny_spec(cell: str, factor: float = 1 / 4000):
    """The cell's spec (its configuration, traffic flags and limits) on a
    graph of its traffic's shape cut by ``factor``."""
    spec = run.cell_spec(cell)
    spec.traffic = dict(spec.traffic,
                        graph=scaled(spec.traffic["graph"], factor))
    return spec
