"""The port's benchmark: full-graph training of ``het_tpu_torch``'s models
on one card, measured end to end and by layer, and checked against plain
PyTorch references.  ``run.py`` runs one cell; ``BENCHMARK.json`` at the
checkout's root lists the cells."""
