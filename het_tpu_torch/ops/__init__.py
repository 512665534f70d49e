"""Graph ops of the port.  Each picks its implementation from the device
of its tensors: hand-written CUDA kernels on the card, their plain
PyTorch versions on the CPU."""

from .common import (edge_rel_gather, edge_rel_sum,  # noqa: F401
                     gather_dst, gather_nodes, gather_src, ntype_sum,
                     safe_div, scatter_sum_dst, scatter_sum_src, take_rows,
                     take_rows_injective)
from .fused_agg import (compact_weighted_agg,  # noqa: F401
                        fused_softmax_agg)
from .linear import (compact_dst_inner, compact_rows,  # noqa: F401
                     compact_typed_linear, edge_rel_inner,
                     edge_rel_scale_grad, edge_rows_typed_linear,
                     edge_typed_linear, expand_compact, ntype_linear,
                     segment_matmul, segment_rel_inner)
from .spmm import (CLIP_LOGIT, edge_softmax,  # noqa: F401
                   edge_softmax_weighted_sum,
                   edge_softmax_weighted_sum_compact,
                   gat_layer_core, gat_node_fused, gat_node_fused2d,
                   hgt_compact_attention, hgt_edge_softmax,
                   hgt_plain_attention, hgt_plain_layer_core,
                   hgt_softmax_weighted_agg,
                   hgt_softmax_weighted_agg_compact,
                   inner_product_edge_node, rel_src_runs,
                   relational_fused_gat, relational_fused_gat_compact,
                   relational_fused_gat_compact_packed, rgcn_aggregate,
                   rgcn_aggregate_compact, rgcn_layer0, rgcn_layer1,
                   rgcn_norm)
