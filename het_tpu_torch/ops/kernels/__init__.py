"""Hand-written CUDA kernels with their plain PyTorch versions."""

from typing import Dict

from .compact_gat import (compact_gat_packed_bwd_dst,  # noqa: F401
                          compact_gat_packed_bwd_dst_plain,
                          compact_gat_packed_bwd_src,
                          compact_gat_packed_bwd_src_plain,
                          compact_gat_packed_fwd, compact_gat_packed_fwd_plain)
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
           "segment_matmul_dx", "segment_matmul_dw", "force_rowmajor",
           "compact_gat_packed_fwd", "compact_gat_packed_bwd_dst",
           "compact_gat_packed_bwd_src")
# the wrappers that also count their launches by element types (bf16
# instantiations beside the f32 ones) in ``launches_by_dtype``
TYPED = ("seg_sum_sorted", "segment_matmul_dw")


def reset_launches() -> None:
    """Set every kernel's launch counts to 0."""
    for name in KERNELS:
        globals()[name].launches = 0
    for name in TYPED:
        globals()[name].launches_by_dtype = {}


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since its count was last set to 0."""
    return {name: globals()[name].launches for name in KERNELS}


def launch_counts_by_dtype() -> Dict[str, Dict[str, int]]:
    """The typed kernels' launches by element types ("bf16->f32" for the
    segment sum's rows and sums, "bf16" for the dW's operands) since the
    counts were last set to 0."""
    return {name: dict(globals()[name].launches_by_dtype) for name in TYPED}
