"""Graph ops of the port.  Each picks its implementation from the device
of its tensors: hand-written CUDA kernels on the card, their plain
PyTorch versions on the CPU."""

from .common import (gather_dst, gather_nodes, safe_div,  # noqa: F401
                     take_rows, take_rows_injective)
from .linear import (compact_typed_linear, edge_rel_inner,  # noqa: F401
                     edge_typed_linear, segment_matmul, segment_rel_inner)
from .spmm import (CLIP_LOGIT, relational_fused_gat,  # noqa: F401
                   relational_fused_gat_compact,
                   relational_fused_gat_compact_packed)
