"""Train THROUGH the compiler (``--use_compiler``): RGAT, HGT and RGCN
models whose per-layer cores execute as compiled Inter-Op DSL programs
(counterpart of ``het_tpu/train/compiled.py``).  The programs lower onto
the port's ops (``compiler/lower.py``), so onto its hand-written CUDA
kernels, and ``torch.autograd`` differentiates the compiled closure.

Pipeline per layer (all levels real):

    DSL text -> parse_dsl -> run_default passes (value numbering, shape
    inference, binop realize) -> flag rewrites (multiply_first ->
    reorder_linear_operators; compact -> compact_materialization) ->
    fuse_edge_softmax -> (compact) fuse_compact_gat, fuse_compact_agg,
    (compact and multiply_first) fuse_packed_projection ->
    schedule_program (Op-Spec SSA with GPU schedules) -> compile_program
    (the schedules steer the lowering)

The layers are single-head (the DSL has no head axis, as the reference's
rgat.inter-op program).  Bias, activation and dropout stay outside the
compiled core, as the reference keeps them around its generated kernels.
The parameters carry het_tpu's names, ``layer_{i}.W`` etc., glorot-
uniform from the caller's ``torch.Generator`` (flax's fan convention);
the softmax is the reference's raw ``exp``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import ops
from ..compiler import compile_program, parse_dsl, schedule_program
from ..compiler.fuse import (fuse_compact_agg, fuse_compact_gat,
                             fuse_edge_softmax, fuse_packed_projection)
from ..compiler.passes import run_default
from ..compiler.rewrites import (compact_materialization,
                                 reorder_linear_operators)
from ..models.rgat import dropout as _dropout, xavier_uniform_

# The RGAT layer program: the full el+er attention form of the reference's
# own DSL golden (hrt/pyctor/examples/inter-op-dsl/rgat.inter-op carries
# the src-side-only form; the dst term mirrors models.py:300-362's er).
RGAT_LAYER_DSL = """
for e in g.edges():
    e["zi"] = e.src.feature * W[e.etype]
    e["el"] = inner_product(attn_l[e.etype], e.zi)
    e["zr"] = e.dst.feature * W[e.etype]
    e["er"] = inner_product(attn_r[e.etype], e.zr)
    e["raw_sum"] = e.el + e.er
    e["raw_lrelu"] = leakyrelu(e.raw_sum)
    e["raw_attn"] = exp(e.raw_lrelu)

for n in g.dst_nodes():
    n["attn_sum"] = 0.0
    for e in n.incoming_edges():
        n["attn_sum"] += e.raw_attn
for e in g.edges():
    e["attn"] = e.raw_attn / e.dst.attn_sum

for n in g.dst_nodes():
    n["output"] = 0.0
    for e in n.incoming_edges():
        n["output"] += e.attn * e.zi
"""

# The HGT layer program: the reference's own DSL golden
# (hrt/pyctor/examples/inter-op-dsl/hgt.inter-op) with the attention inner
# product written explicitly (``inner_product``; the golden's
# ``tmp1 * e.dst.ht_attn`` realizes to the same EdgeInnerProduct through
# the binop realizer) and the ``relation_pri / sqrt(d_k)`` scaling folded
# into W_att by the caller (scaling the bilinear form scales the score).
HGT_LAYER_DSL = """
for n in g.nodes():
    n["hs"] = linear(V[n.ntype], n.feature)
    n["hs_attn"] = linear(K[n.ntype], n.feature)
    n["ht_attn"] = linear(Q[n.ntype], n.feature)

for e in g.edges():
    e["msg"] = e.src.hs * W_msg[e.etype]
    e["raw_attn_tmp1"] = e.src.hs_attn * W_att[e.etype]
    e["score"] = inner_product(e.raw_attn_tmp1, e.dst.ht_attn)
    e["raw_attn"] = exp(e.score)

for n in g.dst_nodes():
    n["attn_sum"] = 0.0
    for e in n.incoming_edges():
        n["attn_sum"] += e.raw_attn
for e in g.edges():
    e["attn"] = e.raw_attn / e.dst.attn_sum

for n in g.dst_nodes():
    n["output"] = 0.0
    for e in n.incoming_edges():
        n["output"] += e.attn * e.msg
"""

# The RGCN layer program: the edge-conv core of the reference golden
# (hrt/pyctor/examples/inter-op-dsl/rgcn.inter-op); the golden's W0
# self-loop term and tanh stay outside the compiled core, exactly where
# the hand-written RGCNLayer keeps self_loop/activation (models/rgcn.py).
RGCN_LAYER_DSL = """
for e in g.edges():
    e["m"] = e.src.feature * Wr[e.etype]
    e["msg"] = e.norm_factor * e.m

for n in g.dst_nodes():
    n["output"] = 0.0
    for e in n.incoming_edges():
        n["output"] += e.msg
"""
RGCN_SHAPE_HINTS = {"norm_factor": "scalar"}


def build_layer_program(dsl: str, *, compact: bool = False,
                        multiply_first: bool = False, shape_hints=None):
    """DSL text -> the analyzed, rewritten and fused Inter-Op SSA program
    (het_tpu's ``compile_rgat_layer`` / ``_compile_layer_dsl`` steps
    before ``schedule_program``)."""
    prog = run_default(parse_dsl(dsl), shape_hints=shape_hints)
    if multiply_first:
        reorder_linear_operators(prog)
        run_default(prog, shape_hints=shape_hints)
    if compact:
        compact_materialization(prog)
        run_default(prog, shape_hints=shape_hints)
    fuse_edge_softmax(prog)
    run_default(prog, shape_hints=shape_hints)
    if compact:
        # the full compact-GAT motif first (logits AND messages on compact
        # rows, the hand-written models' form), then the message-only sink
        fuse_compact_gat(prog)
        fuse_compact_agg(prog)
        if multiply_first:
            # fold the el inner product into the projection's columns
            fuse_packed_projection(prog)
        run_default(prog, shape_hints=shape_hints)
    return prog


def compile_layer(dsl: str, **kw):
    """DSL text -> (executable layer closure, its Op-Spec program): the
    whole pipeline, the schedules steering the lowering."""
    opspec = schedule_program(build_layer_program(dsl, **kw))
    return compile_program(opspec), opspec


class _CompiledModel(nn.Module):
    """The layers' parameters (``layer_{i}``, one ``ParameterDict``
    each) and the compiled layer closure, shared by every layer."""

    def __init__(self, layer_fn, opspec, impl: str, dropout: float):
        super().__init__()
        self.layer_fn, self.opspec = layer_fn, opspec
        self.impl = impl
        self.dropout = dropout

    def reschedule(self, strategy: Optional[str] = None,
                   packing: Optional[str] = None) -> None:
        """Flip every GEMM spec's ``strategy`` ("host_offsets",
        "device_offsets" or het_tpu's names) and every fused softmax
        aggregation's ``packing`` ("packed" or "split") where given, and
        compile the layer again from the edited Op-Spec program."""
        for spec in self.opspec.specs:
            if strategy is not None and spec.gpu.get("kernel") == \
                    "segment_matmul":
                spec.gpu["strategy"] = strategy
            if packing is not None and "packing" in spec.gpu:
                spec.gpu["packing"] = packing
        self.layer_fn = compile_program(self.opspec)

    def _layer(self, i: int) -> nn.ParameterDict:
        return getattr(self, f"layer_{i}")

    def _add_layer(self, i: int, shapes, generator, ones=()) -> None:
        """``layer_{i}`` with a parameter of each of ``shapes`` (name ->
        shape, in het_tpu's init order): glorot-uniform, ``bias`` zero,
        the names in ``ones`` one."""
        params = nn.ParameterDict()
        for name, shape in shapes.items():
            p = nn.Parameter(torch.empty(shape))
            if name == "bias":
                nn.init.zeros_(p)
            elif name in ones:
                nn.init.ones_(p)
            else:
                xavier_uniform_(p, generator)
            params[name] = p
        setattr(self, f"layer_{i}", params)

    def _drop(self, h: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            h = _dropout(h, self.dropout, generator)
        return h


class CompiledRGATModel(_CompiledModel):
    """Multi-layer RGAT, each layer's core the compiled
    ``RGAT_LAYER_DSL``: ``RGATModel``'s layer structure (dims, bias, ReLU
    between layers, dropout after it) at H = 1."""

    def __init__(self, in_feat: int, hidden: int, num_classes: int,
                 num_rels: int, num_layers: int = 2, *,
                 compact: bool = False, multiply_first: bool = False,
                 dropout: float = 0.5, impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__(*compile_layer(RGAT_LAYER_DSL, compact=compact,
                                        multiply_first=multiply_first),
                         impl, dropout)
        self.dims = [in_feat] + [hidden] * (num_layers - 1) + [num_classes]
        self.num_layers = num_layers
        for i in range(num_layers):
            fi, fo = self.dims[i], self.dims[i + 1]
            self._add_layer(i, {"W": (num_rels, fi, fo),
                                "attn_l": (num_rels, fo),
                                "attn_r": (num_rels, fo), "bias": (fo,)},
                            generator)

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            p = self._layer(i)
            out = self.layer_fn(
                g, {"feature": h},
                {"W": p["W"], "attn_l": p["attn_l"], "attn_r": p["attn_r"]},
                impl=self.impl)["output"]
            h = out + p["bias"]
            if i < self.num_layers - 1:
                h = self._drop(torch.relu(h), generator)
        return h


class CompiledHGTModel(_CompiledModel):
    """Multi-layer HGT, each layer's attention core the compiled
    ``HGT_LAYER_DSL``: ``HGTModel`` at H = 1 — per-ntype k/q/v
    projections, typed bilinear attention scaled by relation_pri /
    sqrt(d_k) (folded into W_att), typed softmax, message aggregation,
    then the skip-gated per-ntype output projection and dropout (after
    every layer) outside the compiled core."""

    def __init__(self, in_dim: int, hidden: int, num_classes: int,
                 num_ntypes: int, num_rels: int, num_layers: int = 1, *,
                 compact: bool = False, dropout: float = 0.2,
                 impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__(*compile_layer(HGT_LAYER_DSL, compact=compact),
                         impl, dropout)
        self.dims = [in_dim] + [hidden] * (num_layers - 1) + [num_classes]
        self.num_layers = num_layers
        T, R = num_ntypes, num_rels
        for i in range(num_layers):
            fi, fo = self.dims[i], self.dims[i + 1]
            self._add_layer(i, {
                "k_w": (T, fi, fo), "q_w": (T, fi, fo), "v_w": (T, fi, fo),
                "a_w": (T, fo, fo), "rel_att": (R, fo, fo),
                "rel_msg": (R, fo, fo), "rel_pri": (R,), "skip": (T,)},
                generator, ones=("rel_pri", "skip"))

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            p = self._layer(i)
            mu = p["rel_pri"] / math.sqrt(self.dims[i + 1])  # (R,)
            out = self.layer_fn(g, {"feature": h}, {
                "V": p["v_w"], "K": p["k_w"], "Q": p["q_w"],
                "W_msg": p["rel_msg"],
                # mu folded into the bilinear attention form; the
                # hand-written layer computes score = (q W_att) . k, the
                # DSL program (k W_att') . q with W_att' = W_att^T
                "W_att": p["rel_att"].transpose(1, 2) * mu[:, None, None],
            }, impl=self.impl)["output"]
            gated_a = torch.sigmoid(p["skip"])[:, None, None] * p["a_w"]
            h = ops.ntype_linear(g, out, gated_a[:, None],
                                 impl=self.impl)[:, 0, :]
            h = self._drop(h, generator)
        return h


class CompiledRGCNModel(_CompiledModel):
    """Entity-classification RGCN, each layer's core the compiled
    ``RGCN_LAYER_DSL`` (the reference's rgcn.inter-op edge-conv):
    ``RGCNModel(featureless=False)``'s bias on every layer, ReLU and
    dropout between layers, ``ops.rgcn_norm`` the program's
    ``norm_factor`` edge input."""

    def __init__(self, in_feat: int, hidden: int, num_classes: int,
                 num_rels: int, num_layers: int = 2, *,
                 compact: bool = False, dropout: float = 0.0,
                 impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__(*compile_layer(RGCN_LAYER_DSL, compact=compact,
                                        shape_hints=RGCN_SHAPE_HINTS),
                         impl, dropout)
        self.dims = [in_feat] + [hidden] * (num_layers - 1) + [num_classes]
        self.num_layers = num_layers
        for i in range(num_layers):
            fi, fo = self.dims[i], self.dims[i + 1]
            self._add_layer(i, {"W": (num_rels, fi, fo), "bias": (fo,)},
                            generator)

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        norm = ops.rgcn_norm(g)
        h = x
        for i in range(self.num_layers):
            p = self._layer(i)
            out = self.layer_fn(g, {"feature": h, "norm_factor": norm},
                                {"Wr": p["W"]}, impl=self.impl)["output"]
            h = out + p["bias"]
            if i < self.num_layers - 1:
                h = self._drop(torch.relu(h), generator)
        return h


FAMILIES = {"RGAT": CompiledRGATModel, "HGT": CompiledHGTModel,
            "RGCN": CompiledRGCNModel}


def build_compiled_model(cfg, g, num_classes: int, *, impl: str = "kernel",
                         generator: Optional[torch.Generator] = None
                         ) -> nn.Module:
    """The compiled model of ``cfg.model`` with het_tpu's trainer's
    arguments (``het_tpu/train/driver.py:51-99``): RGAT with the compact
    and multiply-first flags, HGT with the compact flag, RGCN with at
    least two layers; no heads (H = 1) and no ``--stable_softmax`` (the
    raw ``exp``).  Any other family raises ``ValueError``."""
    name = cfg.model.upper()
    if name not in FAMILIES:
        raise ValueError(f"--use_compiler supports RGAT/HGT/RGCN, got "
                         f"{cfg.model}")
    kw = dict(compact=cfg.compact, dropout=cfg.dropout, impl=impl,
              generator=generator)
    if name == "RGAT":
        return CompiledRGATModel(cfg.n_infeat, cfg.hidden, num_classes,
                                 g.num_rels, max(cfg.num_layers, 1),
                                 multiply_first=cfg.multiply_first, **kw)
    if name == "HGT":
        return CompiledHGTModel(cfg.n_infeat, cfg.hidden, num_classes,
                                g.num_ntypes, g.num_rels,
                                max(cfg.num_layers, 1), **kw)
    return CompiledRGCNModel(cfg.n_infeat, cfg.hidden, num_classes,
                             g.num_rels, max(cfg.num_layers, 2), **kw)
