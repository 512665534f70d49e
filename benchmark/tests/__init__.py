"""CPU tests of the benchmark (cards: the ``gpu``-marked ones)."""
