"""What the step counts share: the graph's bytes, the loss and Adam.

A count is the least work the equations need, whatever implements them:
each input byte read once and each output byte written once a pass, f32
values and int32 indices of 4 bytes.  The graph is read as its
destination-sorted form, a source and a relation id an edge and a row
pointer a node.  The backward of every term counts twice its forward's
operations (a matmul's dX and dW).
"""

from __future__ import annotations

from typing import Mapping

F32 = IDX = 4
BACKWARD = 2.0  # the backward's operations, as a multiple of the forward's


def graph_bytes(sizes: Mapping[str, int]) -> float:
    return IDX * (2.0 * sizes["num_edges"] + sizes["num_nodes"] + 1)


def layer_bytes(sizes: Mapping[str, int], k: int, o: int,
                params: int) -> float:
    """A layer's forward (read x, the graph, the parameters; write the
    output) and backward (read the output's cotangent, x, the graph, the
    parameters; write x's cotangent and the parameters' gradients)."""
    n, g = sizes["num_nodes"], graph_bytes(sizes)
    fwd = F32 * (n * k + params + n * o) + g
    bwd = F32 * (n * o + n * k + params + n * k + params) + g
    return fwd + bwd


def loss_cost(sizes: Mapping[str, int], classes: int):
    """(operations, bytes) of the NLL of ``log_softmax`` over the training
    rows, forward and backward: the rows' logits, labels and ids read, the
    logits' cotangent written."""
    t = sizes["train_nodes"]
    flops = 4.0 * t * classes * (1 + BACKWARD)
    return flops, F32 * (t * classes + 2 * t) + F32 * t * classes


def adam_cost(num_params: int):
    """(operations, bytes) of one Adam update: the parameter, its gradient
    and the two moments read, the parameter and the moments written;
    twelve operations an element."""
    return 12.0 * num_params, 7.0 * F32 * num_params
