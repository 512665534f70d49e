"""Seconds of the port's host graph build (``build_heterograph``: the
canonical sort, relation segments and, with compact materialization,
the unique (relation, node) rows), on the host clock."""


def read(ctx):
    return ctx["graph_build_s"]
