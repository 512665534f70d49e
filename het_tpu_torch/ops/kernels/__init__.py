"""Hand-written CUDA kernels with their plain PyTorch versions."""

from .seg_reduce import seg_sum_sorted, seg_sum_sorted_plain  # noqa: F401
