"""Hand-written CUDA kernels with their plain PyTorch versions."""

from .seg_reduce import seg_sum_sorted, seg_sum_sorted_plain  # noqa: F401
from .segment_mm import (segment_matmul_dw,  # noqa: F401
                         segment_matmul_dw_plain)
