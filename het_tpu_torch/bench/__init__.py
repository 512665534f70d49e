"""The port's benchmark entry points, each ``python -m
het_tpu_torch.bench.<module>``: ``step`` (counterpart of ``bench.py``),
``models``, ``infer``, ``compiled``, ``sweep``, ``fullscale``,
``segmm_strategies`` and ``skew`` (counterparts of het_tpu's
``scripts/bench_*.py`` and ``scripts/benchmark_all.py``).  Each runs on
the card unless given ``--device cpu``, prints JSON lines, writes a file
only when given ``--out``, and exits non-zero when a variant fails, a
kernel disagrees with its plain version or a share of a bound passes
100%.  ``common`` holds what they share."""
