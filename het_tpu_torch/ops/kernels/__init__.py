"""Hand-written CUDA kernels with their plain PyTorch versions."""

from typing import Dict

from .seg_reduce import (force_rowmajor,  # noqa: F401
                         force_rowmajor_plain, seg_max_sorted,
                         seg_max_sorted_plain, seg_sum_sorted,
                         seg_sum_sorted_plain)
from .segment_mm import (segment_matmul_dw,  # noqa: F401
                         segment_matmul_dw_plain, segment_matmul_dx,
                         segment_matmul_dx_plain, segment_matmul_fwd,
                         segment_matmul_fwd_plain)

# every kernel wrapper, each with a ``launches`` count of its CUDA launches
KERNELS = ("seg_sum_sorted", "seg_max_sorted", "segment_matmul_fwd",
           "segment_matmul_dx", "segment_matmul_dw", "force_rowmajor")


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNELS:
        globals()[name].launches = 0


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since its count was last set to 0."""
    return {name: globals()[name].launches for name in KERNELS}
