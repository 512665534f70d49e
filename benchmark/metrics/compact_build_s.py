"""Host seconds of the graph build's compact rows (the port's set-up
spans ``graph.compact.*`` under ``graph.build``: the unique (relation,
node) rows of each side and their sorted segmentations)."""

from benchmark.program_spans import setup_s


def read(ctx):
    return setup_s("graph.build/", "graph.compact.")
