"""Graph ops of the port.  Each picks its implementation from the device
of its tensors: hand-written CUDA kernels on the card, their plain
PyTorch versions on the CPU."""

from .common import (gather_dst, gather_nodes, gather_src,  # noqa: F401
                     safe_div, scatter_sum_dst, take_rows,
                     take_rows_injective)
from .fused_agg import compact_weighted_agg  # noqa: F401
from .linear import (compact_typed_linear, edge_rel_inner,  # noqa: F401
                     edge_typed_linear, segment_matmul, segment_rel_inner)
from .spmm import (CLIP_LOGIT, rel_src_runs,  # noqa: F401
                   relational_fused_gat, relational_fused_gat_compact,
                   relational_fused_gat_compact_packed, rgcn_aggregate,
                   rgcn_aggregate_compact, rgcn_layer0, rgcn_layer1,
                   rgcn_norm)
