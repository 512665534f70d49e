#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``het_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. build the host library (``csrc/graphops.cpp``, ``g++``: the graph
   builder's sorts and the neighbour sampler), then every CUDA kernel from
   ``het_tpu_torch/csrc`` (one ``nvcc`` per source, all at once), each
   with its build time; then host graph I/O on the synthetic ogbn-mag
   stand-in at scale 0.1: the graph built through the host library and
   through its plain (numpy) sorts, equal field for field, both timed;
   each sort against its plain version at the sizes that build gives it,
   equal bit for bit, both timed; ``save_heterograph`` /
   ``load_heterograph`` in a temporary directory (bytes, seconds, the
   loaded graph equal to the built one); and the sampler's draw against
   its plain version on the minibatch runs' batches (the contract, the
   caps, the times); at scale 1.0 the build both ways and the draws
   again;
3. each kernel against its plain PyTorch version, timed with CUDA events
   beside its bound and a PyTorch yardstick, on the synthetic ogbn-mag
   stand-in at scale 0.1 (dual- and union-list compact) and 0.2 (the
   packed run):
   * ``seg_sum_sorted`` at every shape the compact multiply-first, the
     packed, the union and the plain RGAT steps, the plain and compact
     RGCN steps, the plain, compact and compact stable="max" HGT steps
     and the GAT steps (mag at 0.1 and the arxiv stand-in; C = 256 and
     4, then the classes, 8 or 40, and 1) give it, on one card and on
     rank 0's shard of each data-parallel run (the boundary halo's
     exchange backward included), at every shape of a minibatch step on
     the first sampled batch of each minibatch run (1024 seeds, fanout 10,
     2 hops: the model's sums on the padded subgraph, whose compact
     tables are forced to their worst case, and the trainable table's
     gradient, 113,664 gathered rows into every node's row, mostly empty
     segments; at 0.1 and at 1.0) and of a link epoch on the fb15k
     stand-in (the encoder's sums on the message graph, DistMult's entity
     gradient, 620,230 rows into 14,541 nodes, and its relation gradient,
     310,115 rows into 474 relations), and at every shape a step of each
     compiled run (``--use_compiler``, H = 1) gives it,
     plus edge cases, among them a hub row
     of 100,000 edges among rows of 1-3 at C = 4, 12 and 68 with and
     without perm; every shape launched twice and compared bit for bit;
   * ``seg_max_sorted`` bit for bit at every shape the stable="max" steps
     give it (packed at 0.2, plain RGAT and compact HGT at 0.1, plain
     RGAT on rank 0's shard), plus
     edge cases, among them a
     hub row with a NaN and a +inf in different workers' chunks;
   * ``segment_matmul_dw`` at every shape the plain RGAT, the compact and
     the union steps give it, the plain minibatch step's and the plain
     link epoch's (S = 474 relations), the compiled runs' (the
     relation-typed inner products' dW at H = 1, O = 1, and under
     gather_einsum the typed linears' W over the edge rows), and the
     data-parallel runs (RGAT,
     compact and plain
     RGCN, and HGT's per-head typed linears, x a row a head at K = O =
     16 and 2, and over two node types its per-node typed linears) give
     rank 0's shard, at the general segment-matmul
     shapes (Hx = 1, K = O = 64, S =
     4 and S = 535, about 1e6 rows), plus edge cases (among them S = 535
     segments mostly shorter than a chunk, NaN rows before and past the
     segments, x one float off 16 bytes, a segment one row past a chunk),
     each launched twice and compared bit for bit, with a control that a
     dW from inputs rounded to TF32 fails the tolerance, and each time as
     a share of its bound;
   * ``segment_matmul_fwd`` and ``segment_matmul_dx`` at every shape the
     data-parallel runs give rank 0's shard (HGT's per head at K = O = 16
     and 2 among them) and the compiled gather_einsum run gives the edge
     rows (K = 64, O = 64 then 8, H = 1), at the general shapes (S =
     535: W is 8.8 MB) and edge cases (among them 300 short segments, three
     column passes, K = 63, the dX's reductions of 3, 16 and 17 columns
     and a per-head dX of 17 columns, one tile, NaN rows before and past
     the segments, an operand one float off 16 bytes), each launched
     twice and compared
     bit for bit, with the same TF32 control, timed beside bare
     per-relation cuBLAS (one ``torch.mm`` a segment on host offsets);
   * ``force_rowmajor`` bit for bit on the packed run's ``fe[..., 1:]``
     view, a transposed view and R = 0 (no path calls it);
   * compact multiply-first's fused op in its split and its packed
     operand form on the same inputs, forward and backward, at each
     layer's shapes of the compact multiply-first (0.1) and the packed
     (0.2) runs: the two agree, and their times and memory are printed;
   * the featureless RGCN layer's weight gradient (one segment sum over
     the (relation, source) runs) bit for bit on a second call and
     against its plain version;
   * (in phase 4, on the full-scale graph) the packed compact GAT op's
     three walks (``compact_gat_packed_fwd``, ``_bwd_dst``, ``_bwd_src``)
     at the benchmark's first cell's widths (8 heads of 8, clip), each
     against its plain version, a second launch bit for bit, timed beside
     its bound, its plain version and the chain of ops it replaces;
4. training runs of the 2-layer RGAT (heads 4, in 64, hidden 64, 8
   classes, f32, TF32 off, dropout 0), each once through the kernels and
   once through their plain versions from the same seeded parameters,
   with finite losses, per-step agreement and every kernel's launch
   count (the trainer's ``WARMUP`` untimed steps counted with the timed
   ones): five timed steps of the compact multiply-first and the plain
   (per-edge) branch (clip softmax), and of this slice's path, compact
   multiply-first with stable="max" at scale 0.2 (losses that fall;
   every dual-list compact multiply-first run takes the packed form,
   asserted); two steps each of the
   plain multiply-first, the compact, both union-list compact branches
   and plain stable="max"; five of the 2-layer RGCN (``--model RGCN``,
   in 64, hidden 64, 8 classes), plain and compact; five of the 2-layer
   HGT (``--model HGT``, heads 4, in 64, hidden 64, 8 classes: d_k 16
   and 2), plain and compact, and two of compact HGT with stable="max";
   five of the 2-layer GAT (``--model GAT``, heads 4 of 64 from in 64,
   then one head of 8 classes, raw softmax: layer 0 the fused core,
   layer 1 the node-sided op) at 0.1 and two on the arxiv stand-in at
   its published size (169,343 nodes, 1,166,243 edges, R = 1); every
   run's launches include the trainer's accuracy pass, and it prints
   the trainer's report (accuracy, forward/backward means, memory);
   then neighbour-sampled minibatch training (``train_minibatch``, het_tpu's
   defaults: 1024 seeds a batch, fanout 10, 2 hops, the trainable table)
   of compact multiply-first RGAT at 0.1 for five batches through the
   kernels and the plain versions (same parameters and batches, per-batch
   agreement), plain RGAT and compact RGCN for two batches, kernels only,
   each with its accuracy passes (at most 32 training batches, the whole
   test split) and its launches, each batch's draw, build, copy and step
   ms, seeds/s and peak memory; link prediction (``train_link``: the RGAT
   encoder and DistMult) on the fb15k stand-in at its published size,
   compact multiply-first for five epochs through the kernels and the
   plain versions and plain RGAT for two, kernels only, with losses, MRR,
   Hits@10, step ms, peak memory and launches;
   then the compiled runs (``--use_compiler``: each layer core a compiled
   Inter-Op DSL program, H = 1, raw softmax, in 64, hidden 64, 8 classes
   at 0.1): compact multiply-first RGAT five steps through the kernels and
   the plain versions, per-step agreement; the three other RGAT branches,
   HGT plain and compact and RGCN plain and compact two steps each, both
   ways; plain RGAT with every GEMM spec flipped to gather_einsum (the
   segment-matmul forward, dX and dW kernels) two steps, held per step to
   the default schedule's run; each with its launches a step asserted, its
   step ms and, beside it, the hand-written model's at H = 1 on the same
   graph and flags (its launches asserted too) and their ratio;
   then the packed max path at the published size (scale 1.0, 21.1M
   edges), three steps through the kernels, and compact RGCN and
   compact HGT on the same graph, two steps each, compiled compact
   multiply-first (two steps, beside the hand-written H = 1 model), and
   three minibatch batches of compact multiply-first on it,
   each with its step time, edges/s and peak device memory, after the
   segment sum and max at every shape of a packed max step, against their
   plain versions and timed beside their bounds;
   then bf16 mixed precision (``--dtype bfloat16 --loss_scale dynamic``):
   in phase 3 the segment sum's bf16 instantiations (bf16 rows into f32
   and into bf16 sums) at every shape of the bf16 runs' steps and the
   edge cases (unaligned rows too), and the bf16 dW (bf16 x and ct) at
   plain RGAT's shapes, each launched twice bit for bit; in phase 4
   compact multiply-first (packed) at 0.1 for five steps through the
   kernels and the plain versions, plain RGAT (the bf16 dW), compact
   RGCN, compact HGT and GAT at 0.1 for two steps, kernels only, and the
   packed max path at 1.0 for three steps: each with its f32 run's
   launches (in all, and by element types as ``_bf16_sum_pair`` says),
   losses within BF16_F32_RTOL of the f32 run's, step ms, edges/s and
   peak memory beside the f32 run's; then checkpoint and resume (three
   steps, a checkpoint, three more resumed, against six straight: bit for
   bit, in f32 and in bf16) and a ``--patience 1`` run that stops where
   its losses say, its checkpoints in a temporary directory;
5. data-parallel training: the graph split into P = 2 destination-range
   shards (balanced on edges), two ranks spawned as processes on cuda:0
   over gloo, five steps of compact multiply-first, of compact RGCN and
   of compact HGT (halo "auto", one partition) and two of plain RGAT, of
   plain RGAT with stable="max" (the segment max on a shard), of plain
   RGCN and of plain HGT (halo "boundary", one partition), and two of
   compact HGT over two node types whose boundary falls inside shard 0
   (its own partition; ``ntype_linear`` on the segment-matmul kernels),
   through the kernels and the plain versions, each held per step to the
   other and to a single-process run on the unpartitioned graph, with
   each kernel's launches a step a rank; in the same spawn, compact
   multiply-first through the kernels with rank 0 profiled
   (``utils/profile_step.py::profile_dp``): its warm step split into the
   collectives (timed on the host after a synchronize and a barrier, the
   wait for the peer apart), the card's work by category and the rest,
   printed; ``entry.dryrun_multichip``'s jobs on 2 ranks; and
   ``bench.scaling`` at its smallest form (mag at 0.01, worlds of 1 and 2
   ranks, 3 timed steps, each world's kernel loss held to its plain
   run's); then ``entry.dryrun_multichip`` on 4 ranks (the 2 x 2 mesh of
   ``make_mesh2``), all on cuda:0 over gloo: the dry runs take two steps
   of the RGCN -> HGT -> compact RGAT stack through the kernels and the
   plain versions, every loss finite and the two within TRAIN_RTOL at
   each step (the second's loss is the one after the first Adam step, so
   the backward's kernels are held too), each rank's launches and
   coordinates asserted; the phase's seconds;
6. the benchmark entry points (``het_tpu_torch.bench``): ``bench.step``
   (``bench.py``'s 1-layer RGAT forward + backward on synthetic
   ogbn-mag at 0.018, six variants: plain and kernels, with neither
   flag, compact multiply-first, and compact multiply-first in bf16),
   its JSON line, each kernel variant held to its plain variant at its
   first step, each share of the step's bounds in (0, 100] and each
   variant's launches a step (kernels 1 and 7); then ``bench.models``,
   ``bench.infer``, ``bench.compiled``, ``bench.sweep``,
   ``bench.fullscale`` (at 0.1), ``bench.segmm_strategies`` and
   ``bench.skew`` once each at their smallest form, each row's kernel
   held to its plain version; ``bench.halo_bytes`` at 0.01 (host only:
   the CPU tests hold its numbers); and the phase's seconds;
7. the breakdown phase: ``bench.breakdown --quick`` (``scripts/
   breakdown.py``'s 16 op rows of bench.py's step and HGT's plain
   attention at 4 heads, D = 16, on mag at 0.018, each kernel row held to
   its plain row and timed beside its bound, and the two end-to-end
   rows), each row's launches a call and the run's counts asserted; then
   the fused plain HGT attention (``HGTPlainAttention``) under "raw" and
   "clip" at the breakdown's widths on its graph (host offsets: kernels 1
   and 7) and on rank 0's shard of the plain data-parallel runs'
   partition (device offsets: kernels 1, 4, 6 and 7), its output and all five
   gradients held to the plain versions', its launches asserted, and its
   ms against the unfused chain's, forward and with every gradient.

The last two lines are a JSON object of per-kernel numbers (the bf16
instantiations as ``seg_sum_sorted[bf16->f32]``, ``seg_sum_sorted[bf16->
bf16]`` and ``segment_matmul_dw[bf16]`` beside the f32 ones) and
``{"ok": true, "device": {...}}``, after a line with the run's total
seconds.  Without a CUDA device, or without the package beside it, the
script exits non-zero and prints no result.
"""

import dataclasses
import json
import math
import statistics
import sys
import time

# the package beside the script: without it the run fails here
from het_tpu_torch.bench.common import card_line as _card_line
from het_tpu_torch.bench.common import seeded_state as _initial_state
from het_tpu_torch.bench.common import time_call_ms
from het_tpu_torch.utils.misc import exact_matmuls
from het_tpu_torch.utils.profiling import H100_SXM, device_peaks

# the training configuration (het_tpu's widths, 2 layers)
HEADS, IN_FEAT, HIDDEN, CLASSES, LAYERS = 4, 64, 64, 8, 2
STEPS, SHORT_STEPS = 5, 2
# the trainer's untimed Adam steps before the timed ones (het_tpu's
# warm-up; its default is 5): a training run launches every kernel
# (WARMUP + steps) times its launches a step
WARMUP = 2
# the H100 SXM's data-sheet peaks, the port's one row of them
HBM_BYTES_PER_S = H100_SXM["hbm_gbps"] * 1e9
F32_FLOP_PER_S = H100_SXM["f32_tflops"] * 1e12  # outside the tensor cores
BF16_FLOP_PER_S = H100_SXM["bf16_tflops"] * 1e12  # tensor cores, dense
TOL_RTOL = 1e-5  # f32 sums in another order
# segment_matmul_dw: |kernel - plain| <= DW_TOL * sum |x| |ct| per output.
# f32 sums in another order stay far inside it; products of inputs rounded
# to TF32 (10-bit mantissa) do not
DW_TOL = 1e-6
TRAIN_RTOL = 1e-4
# the trainer's report (het_tpu's schema) printed beside each run's times
REPORT_KEYS = ("train_acc", "test_acc", "mean_forward_time",
               "mean_backward_time", "mean_training_time",
               "max_memory_usage (mb)")
SCALE = 0.1  # synthetic ogbn-mag at the reference's ogbn_mag_0.1 size
# the slice's packed run: the smallest tenth whose source compact rows
# (1,348,864) pass het_tpu's packed gate of 1M rows (the port takes the
# packed form at every size)
PACKED_SCALE = 0.2
FULL_SCALE = 1.0  # the published size: 21,111,007 edges
FULL_STEPS = 3


def _run(compact, multiply_first, steps, launches, *, union=False,
         stable="clip", scale=SCALE, model="RGAT", dataset="mag",
         classes=CLASSES, in_feat=IN_FEAT, chain=None):
    return dict(compact=compact, multiply_first=multiply_first, steps=steps,
                launches=launches, union=union, stable=stable, scale=scale,
                model=model, dataset=dataset, classes=classes,
                in_feat=in_feat, chain=chain)


# the launches a step of the packed op's three walks, two layers
WALK_LAUNCHES = dict(compact_gat_packed_fwd=2, compact_gat_packed_bwd_dst=2,
                     compact_gat_packed_bwd_src=2)


def _walks(r):
    """Whether run ``r`` (a spec of any table) takes the packed compact
    op's walks: f32 dual-list compact multiply-first RGAT under "raw" or
    "clip" (``CompactFusedGATPacked._walks``); not its chain (``r`` from
    :func:`_chain`)."""
    return (r["model"] == "RGAT" and r["compact"] and r["multiply_first"]
            and not r.get("union") and r["stable"] != "max"
            and not r.get("compiled") and not r.get("on_chain"))


def _chain(r):
    """Run ``r`` with its packed op on the chain (its bf16 run): the
    launches a step the chain makes."""
    return dict(r, launches=r.get("chain") or r["launches"], on_chain=True)


# training runs: name -> the branch, its softmax, its graph's scale, its
# steps and the launches a step of each kernel (the ones not named launch
# none).  Every fused attention op sums its narrow and wide per-edge terms
# apart (z and z*feat forward, draw and dfeat at the source side: two
# segment sums and no [narrow | wide] buffer, PERF.md's GAT findings).
# Per layer: the dual-list compact branches reduce 7 times (z and z*feat,
# the (dst, rel) draw, the src-compact draw and dfeat, two compact-gather
# backwards; the packed form the same on its chain: bf16 or stable="max");
# the packed form in f32 under "raw" or "clip" (_walks) runs its three
# walks and reduces 3 times (the (dst, rel) draw and the two
# compact-gather backwards; ``chain`` keeps its chain's launches, for its
# bf16 run); the union ones 6 times (one
# compact gather: one projection serves both sides), the plain ones 4
# times (z and z*feat, two edge-gather backwards; the per-edge fused
# backward is gathers only); every branch
# without multiply-first takes two attention-vector dW a layer, and
# stable="max" one destination max a layer in the forward (the backward
# reuses it).  RGCN (2 layers from the learned embeddings, no heads)
# reduces twice a layer plain (the destination aggregation, the source
# edge-gather backward; the aggregation's backward is a gather) and 3
# times compact (compact_weighted_agg forward and backward through
# edge_sort_perm, the compact-gather backward).  HGT (2 layers from the
# learned embeddings, heads 4: d_k 16 in layer 0, 2 in layer 1) reduces 4
# times a layer plain (the fused core's z and z*msg, d_q, d_k with d_v in
# one) and 7 times compact (the fused attention's z and z*msg, its
# source-compact, source-node and (dst, rel)-run reduces, and the two
# compact-gather backwards); compact with stable="max" takes the unfused
# chain, 6 (one [z | z*msg] sum: its backward is autograd's gather of that
# buffer, the message expansion's backward, the score's two and the two
# gathers), and one destination max
# a layer.  relation_pri's gradient (score * mu[rel] is a per-relation
# scaling) is one grouped dW a layer over the relation-sorted edge rows
# (K = O = 1 a head).  GAT (heads 4 of 64, then one head of 8 classes,
# raw softmax, the graph read as one relation; on the arxiv stand-in from
# its 128 features to its 40 classes) reduces 5 times a layer: z and
# z*feat over in_row_ptr, d_er over in_row_ptr, and draw and dfeat over
# out_row_ptr through out_perm (layer 0 the fused
# core, layer 1 the projection then the node-sided op); its projections
# are torch.matmul.  Host-known offsets: the typed linears take per-relation
# matmuls.  Each run's trainer adds its accuracy pass, a forward without
# the backward (_eval_launches).
RUNS = {
    "compact_multiply_first": _run(True, True, STEPS,
                                   dict(seg_sum_sorted=6, **WALK_LAUNCHES),
                                   chain=dict(seg_sum_sorted=14)),
    "plain": _run(False, False, STEPS, dict(seg_sum_sorted=8,
                                            segment_matmul_dw=4)),
    "plain_multiply_first": _run(False, True, SHORT_STEPS,
                                 dict(seg_sum_sorted=8)),
    "compact": _run(True, False, SHORT_STEPS, dict(seg_sum_sorted=14,
                                                   segment_matmul_dw=4)),
    "compact_multiply_first_packed_max": _run(
        True, True, STEPS, dict(seg_sum_sorted=14, seg_max_sorted=2),
        stable="max", scale=PACKED_SCALE),
    "union_compact_multiply_first": _run(True, True, SHORT_STEPS,
                                         dict(seg_sum_sorted=12), union=True),
    "union_compact": _run(True, False, SHORT_STEPS, dict(
        seg_sum_sorted=12, segment_matmul_dw=4), union=True),
    "plain_max": _run(False, False, SHORT_STEPS, dict(
        seg_sum_sorted=8, segment_matmul_dw=4, seg_max_sorted=2),
        stable="max"),
    "rgcn_plain": _run(False, False, STEPS, dict(seg_sum_sorted=4),
                       model="RGCN"),
    "rgcn_compact": _run(True, False, STEPS, dict(seg_sum_sorted=6),
                         model="RGCN"),
    "hgt_plain": _run(False, False, STEPS, dict(seg_sum_sorted=8,
                                                segment_matmul_dw=2),
                      model="HGT"),
    "hgt_compact": _run(True, False, STEPS, dict(seg_sum_sorted=14,
                                                 segment_matmul_dw=2),
                        model="HGT"),
    "hgt_compact_max": _run(True, False, SHORT_STEPS, dict(
        seg_sum_sorted=12, seg_max_sorted=2, segment_matmul_dw=2),
        stable="max", model="HGT"),
    "gat": _run(False, False, STEPS, dict(seg_sum_sorted=10), stable="raw",
                model="GAT"),
    # the family's own homogeneous graph at its published size (R = 1)
    # and widths (128 features, 40 classes)
    "gat_arxiv": _run(False, False, SHORT_STEPS, dict(seg_sum_sorted=10),
                      stable="raw", scale=1.0, model="GAT",
                      dataset="arxiv", classes=40, in_feat=128),
}
# the single-card plain RGAT path, whose launches the dW reports
MAIN = "plain"
# this slice's path (compact multiply-first, packed, stable="max"), whose
# launches the segment sum and the segment max report
SLICE_MAIN = "compact_multiply_first_packed_max"
FULL = "full_scale"  # the slice's path at FULL_SCALE, kernels only
# compact RGCN and compact HGT at FULL_SCALE on the same graph, kernels
# only: (name, run, steps)
FULL_OTHERS = (("full_scale_rgcn_compact", "rgcn_compact", 2),
               ("full_scale_hgt_compact", "hgt_compact", 2))
# segment_matmul_fwd / _dx: |kernel - plain| <= MM_TOL * sum |x| |W| per
# output (the plain version on absolute values); TF32 inputs fail it
MM_TOL = 1e-5
# data-parallel runs, P ranks as processes on cuda:0 (gloo): name ->
# the branch, its steps, its halo and the launches a step a rank.  Per
# layer every RGAT branch makes two typed linears, whose offsets live only on
# the device on a shard (one forward each, one dX each where the layer's
# input needs a gradient: layer 1, not layer 0, whose input is the fixed
# features) and whose weight gradients are grouped dWs; the plain branch
# adds two attention-vector dWs.  Segment sums: the compact branches 5 in
# layer 0 (no compact-gather backward: its input needs no gradient) and 7
# in layer 1; the plain branch 2 in layer 0 (no edge-gather backward
# either) and 4 in layer 1, plus, with the boundary halo, one for
# layer 1's exchange backward (layer 0 exchanges the fixed features).
# Compact RGCN makes one typed linear a layer (H = 1) and reduces twice in
# layer 0 (compact_weighted_agg forward and backward) and 3 times in
# layer 1 (and its compact-gather backward).  HGT projects k, q and v on
# the shard's own rows (one node type, whose offsets stay on the host:
# per-relation matmuls) and exchanges k and v, so every layer's typed
# linears need an input gradient: compact, two per-head typed linears a
# layer on compact rows (a forward, a dX and a dW each) and the single
# card's 6 segment sums; plain, the fused core's two per-head typed
# linears on the edge rows, each run in the forward and again in the
# backward (a dX and a dW each), its 3 segment sums and, with the
# boundary halo, the exchange backwards of k and v; both the dW of
# relation_pri a layer.  Plain RGAT under stable="max" adds one
# destination max a layer.  Plain RGCN makes one typed linear a layer
# over the edge rows (H = 1; a dX in layer 1) and reduces once in layer 0
# (the destination aggregation) and 3 times in layer 1 (and its
# edge-gather backward and the boundary exchange's backward).  HGT over
# two node types whose boundary falls inside shard 0 (``ntypes``: the
# graph and the single-process reference take ``_ntype_offsets``) drops
# ``ntype_seg``'s host offsets on the shards, so its four per-node typed
# linears a layer (k, q and v per head, the output's a) reach the
# segment-matmul kernels: a forward and a dW each, a dX for a and, in
# layer 1, for k, q and v (layer 0's input is the fixed features), on
# top of compact HGT's launches.
P = 2


def _dp_run(compact, multiply_first, steps, halo, launches, model="RGAT",
            stable="clip", ntypes=False):
    return dict(compact=compact, multiply_first=multiply_first, steps=steps,
                halo=halo, launches=launches, model=model, stable=stable,
                ntypes=ntypes)


DP_RUNS = {
    "dp_compact_multiply_first": _dp_run(True, True, STEPS, "auto", dict(
        seg_sum_sorted=4, segment_matmul_fwd=4, segment_matmul_dx=2,
        segment_matmul_dw=4, **WALK_LAUNCHES)),
    "dp_plain": _dp_run(False, False, SHORT_STEPS, "boundary", dict(
        seg_sum_sorted=7, segment_matmul_fwd=4, segment_matmul_dx=2,
        segment_matmul_dw=8)),
    "dp_rgcn_compact": _dp_run(True, False, STEPS, "auto", dict(
        seg_sum_sorted=5, segment_matmul_fwd=2, segment_matmul_dx=1,
        segment_matmul_dw=2), model="RGCN"),
    "dp_hgt_compact": _dp_run(True, False, STEPS, "auto", dict(
        seg_sum_sorted=14, segment_matmul_fwd=4, segment_matmul_dx=4,
        segment_matmul_dw=6), model="HGT"),
    "dp_hgt_plain": _dp_run(False, False, SHORT_STEPS, "boundary", dict(
        seg_sum_sorted=12, segment_matmul_fwd=8, segment_matmul_dx=4,
        segment_matmul_dw=6), model="HGT"),
    "dp_plain_max": _dp_run(False, False, SHORT_STEPS, "boundary", dict(
        seg_sum_sorted=7, seg_max_sorted=2, segment_matmul_fwd=4,
        segment_matmul_dx=2, segment_matmul_dw=8), stable="max"),
    "dp_rgcn_plain": _dp_run(False, False, SHORT_STEPS, "boundary", dict(
        seg_sum_sorted=4, segment_matmul_fwd=2, segment_matmul_dx=1,
        segment_matmul_dw=2), model="RGCN"),
    "dp_hgt_ntypes": _dp_run(True, False, SHORT_STEPS, "auto", dict(
        seg_sum_sorted=14, segment_matmul_fwd=12, segment_matmul_dx=9,
        segment_matmul_dw=14), model="HGT", ntypes=True),
}
DP_MAIN = "dp_compact_multiply_first"  # this slice's main path
# ntype_linear's launches a step on dp_hgt_ntypes beyond dp_hgt_compact's
NTYPE_LINEAR = dict(segment_matmul_fwd=8, segment_matmul_dx=5,
                    segment_matmul_dw=8)
# dryrun_multichip's launches a step, a rank (the RGCN -> HGT -> compact
# RGAT stack at its shapes, halo "auto" -> boundary at 2 and 4 ranks;
# each rank's launches, from a CPU count of what CUDA tensors launch);
# the 2-rank jobs join the data-parallel spawn, the 4-rank run spawns
# its own ranks
DRYRUN_RANKS = (2, 4)
DRYRUN_LAUNCHES = dict(seg_sum_sorted=15, segment_matmul_fwd=7,
                       segment_matmul_dx=4, segment_matmul_dw=8)
# bench.scaling at its smallest form, in the data-parallel spawn: mag at
# 0.01, worlds of 1 and 2 ranks (both on cuda:0 over gloo), 3 timed steps
SCALING_RANKS, SCALING_SCALE, SCALING_STEPS = (1, 2), 0.01, 3

# neighbour-sampled minibatch runs (--minibatch at het_tpu's defaults:
# BATCH seeds a batch, FANOUT in-edges a node a hop, HOPS hops) on mag at
# SCALE, each training the model of a full-graph run (``base``) on the
# batches' subgraphs from the trainable table: a batch launches that
# run's step plus one segment sum, the table's gradient (its gathered
# rows summed into the table's rows); each evaluation batch launches the
# run's forward (_eval_launches).  ``plain``: the run is repeated through
# the plain versions from the same parameters and batches
BATCH, FANOUT, HOPS = 1024, 10, 2


def _mb_run(base, batches, plain):
    launches = dict(RUNS[base]["launches"])
    launches["seg_sum_sorted"] += 1
    return dict(RUNS[base], steps=batches, launches=launches, base=base,
                plain=plain)


MB_RUNS = {
    "minibatch_compact_multiply_first": _mb_run("compact_multiply_first",
                                                STEPS, True),
    "minibatch_plain": _mb_run("plain", SHORT_STEPS, False),
    "minibatch_rgcn_compact": _mb_run("rgcn_compact", SHORT_STEPS, False),
}
MB_MAIN = "minibatch_compact_multiply_first"  # this slice's main path
# MB_MAIN at FULL_SCALE, on check_full_scale's graph, kernels only
MB_FULL, MB_FULL_BATCHES = "minibatch_full_scale", 3
# link prediction (--task link) on the fb15k stand-in at LINK_SCALE (its
# published size: 14,541 nodes, 620,232 edges, R = 474): the RGAT encoder
# (its output HIDDEN wide) takes a full-graph step an epoch on the message
# graph (9/10 of the edges) and the DistMult decoder adds two segment
# sums, the entity rows' and the relation rows' gradients; the ranking
# after the epochs launches one forward
LINK_SCALE = 1.0


def _link_run(compact, multiply_first, epochs, launches, plain):
    return dict(_run(compact, multiply_first, epochs, launches,
                     dataset="fb15k", scale=LINK_SCALE, classes=HIDDEN),
                plain=plain)


LINK_RUNS = {
    "link_compact_multiply_first": _link_run(
        True, True, STEPS, dict(seg_sum_sorted=8, **WALK_LAUNCHES), True),
    # kernel 7 at S = 474 relations
    "link_plain": _link_run(False, False, SHORT_STEPS, dict(
        seg_sum_sorted=10, segment_matmul_dw=4), False),
}


# compiled runs (--use_compiler: each layer core a compiled Inter-Op DSL
# program lowered onto the port's ops, train/compiled.py) on mag at SCALE,
# 2 layers from in 64 through hidden 64 to 8 classes, H = 1 (the DSL has
# no head axis), the raw softmax: name -> the family and flags, its steps,
# the launches a step, whether the plain versions run too, the GEMM specs'
# strategy, and the RUNS entry whose branch the hand-written model at
# H = 1 (the step-time ratio's other side) takes.  Per layer: compiled
# RGAT sums as its hand-written branch does (compact: the fused op's z and
# z*feat forward, its (dst, rel)-run and two source-side backward sums,
# and the two compact gathers' backwards, the dst one under the er inner
# product's rows with multiply-first; plain: z and z*feat, and the two
# node gathers' backwards, the edge row gather's or, with multiply-first,
# the destination gather of er's inner product), and every branch takes
# the grouped dW for the relation-typed inner products (attn_l and attn_r,
# or W.a_r and, plain, attn_l with multiply-first; compact multiply-first
# folds el into the projection: one).  Compiled HGT: plain, the fused
# per-edge op's z and z*msg, the two typed linears' edge row gathers and
# the destination gather of ht_attn (5); compact, the source-compact fused
# op's z, z*msg and d_feat_c, the two compact gathers, the expansion of
# k.W_att and the destination gather (7).  Compiled RGCN: as hand-written
# (2 / 3).  "gather_einsum" (het_tpu's name for one launch over all
# relations) flips every GEMM spec to device offsets: the typed linears
# take the segment-matmul forward, dX (layer 0's input, the embeddings,
# needs a gradient too) and dW kernels.  The accuracy pass launches a
# step's forward (_eval_launches).
def _compiled_run(model, compact, multiply_first, steps, launches, base, *,
                  plain=True, strategy="host_offsets", same_as=None):
    return dict(_run(compact, multiply_first, steps, launches, stable="raw",
                     model=model), compiled=True, base=base, plain=plain,
                strategy=strategy, same_as=same_as)


COMPILED_RUNS = {
    "compiled_compact_multiply_first": _compiled_run(
        "RGAT", True, True, STEPS, dict(seg_sum_sorted=14,
                                        segment_matmul_dw=2),
        "compact_multiply_first"),
    "compiled_plain": _compiled_run("RGAT", False, False, SHORT_STEPS, dict(
        seg_sum_sorted=8, segment_matmul_dw=4), "plain"),
    "compiled_plain_multiply_first": _compiled_run(
        "RGAT", False, True, SHORT_STEPS, dict(seg_sum_sorted=8,
                                               segment_matmul_dw=4),
        "plain_multiply_first"),
    "compiled_compact": _compiled_run("RGAT", True, False, SHORT_STEPS, dict(
        seg_sum_sorted=14, segment_matmul_dw=4), "compact"),
    "compiled_hgt_plain": _compiled_run("HGT", False, False, SHORT_STEPS,
                                        dict(seg_sum_sorted=10), "hgt_plain"),
    "compiled_hgt_compact": _compiled_run("HGT", True, False, SHORT_STEPS,
                                          dict(seg_sum_sorted=14),
                                          "hgt_compact"),
    "compiled_rgcn_plain": _compiled_run("RGCN", False, False, SHORT_STEPS,
                                         dict(seg_sum_sorted=4),
                                         "rgcn_plain"),
    "compiled_rgcn_compact": _compiled_run("RGCN", True, False, SHORT_STEPS,
                                           dict(seg_sum_sorted=6),
                                           "rgcn_compact"),
    # the same function as compiled_plain through kernels 4, 6 and 7,
    # held per step to compiled_plain's kernel run
    "compiled_plain_gather_einsum": _compiled_run(
        "RGAT", False, False, SHORT_STEPS, dict(
            seg_sum_sorted=8, segment_matmul_fwd=4, segment_matmul_dx=4,
            segment_matmul_dw=8), "plain", plain=False,
        strategy="gather_einsum", same_as="compiled_plain"),
}
COMPILED_MAIN = "compiled_compact_multiply_first"  # this slice's main path
# COMPILED_MAIN at FULL_SCALE, on check_full_scale's graph, kernels only
COMPILED_FULL, COMPILED_FULL_STEPS = "compiled_full_scale", 2


def _spec(run):
    """The ``RUNS``, ``DP_RUNS``, ``MB_RUNS``, ``LINK_RUNS`` or
    ``COMPILED_RUNS`` entry of a run (``MB_FULL``: ``MB_MAIN``'s,
    ``COMPILED_FULL``: ``COMPILED_MAIN``'s)."""
    for runs in (RUNS, DP_RUNS, MB_RUNS, LINK_RUNS, COMPILED_RUNS):
        if run in runs:
            return runs[run]
    if run == MB_FULL:
        return MB_RUNS[MB_MAIN]
    if run == COMPILED_FULL:
        return COMPILED_RUNS[COMPILED_MAIN]
    raise KeyError(run)


def _per_step(run):
    """Each kernel's launches a step (a rank) of a training run."""
    return _spec(run)["launches"]


def _eval_launches(r):
    """The launches of the trainer's accuracy pass after its steps (``r`` a
    ``RUNS`` value): a step's forward without its backward, two segment
    sums a layer (the fused attention ops' z and z*feat; one for RGCN's
    aggregation and HGT's unfused stable="max" chain; none and the forward
    walk where the packed op takes its walks) and, under stable="max", one
    segment max a layer; a compiled run on device offsets also its step's
    segment-matmul forwards."""
    one = r["model"] == "RGCN" or (r["model"] == "HGT"
                                   and r["stable"] == "max")
    walks = _walks(r)
    return dict(seg_sum_sorted=LAYERS * (0 if walks else 1 if one else 2),
                compact_gat_packed_fwd=LAYERS if walks else 0,
                seg_max_sorted=LAYERS if r["stable"] == "max" else 0,
                segment_matmul_fwd=(r["launches"].get("segment_matmul_fwd", 0)
                                    if r.get("compiled") else 0))


def _train_launches(r, steps):
    """Each kernel's launches in one ``train`` call of ``r`` (a ``RUNS``
    value) with ``steps`` timed steps: the warm-up and timed steps and the
    accuracy pass."""
    from het_tpu_torch.ops.kernels import KERNELS

    ev = _eval_launches(r)
    return {k: r["launches"].get(k, 0) * (WARMUP + steps) + ev.get(k, 0)
            for k in KERNELS}


def _data_key(r):
    """The synthetic stand-in a ``RUNS`` value trains on."""
    return (r["dataset"], r["scale"], r["union"], r["classes"])


def _check_shape_count(kernel, shapes_per_run):
    """The shapes a check lists for each run cover exactly the launches
    the run is asserted to make: {run: launches a step of the shapes}."""
    for run, n in shapes_per_run.items():
        want = _per_step(run).get(kernel, 0)
        if n != want:
            raise AssertionError(f"{kernel}: {n} shapes a step listed for "
                                 f"{run}, {want} launches asserted")


def _time_ms(fn, reps, flush):
    """Median ms of ``fn`` over ``reps`` single launches, each after
    ``flush`` is overwritten and a spin on the card
    (``bench.common.time_call_ms``)."""
    return time_call_ms(fn, flush.device, reps, flush)


def _dims(classes=CLASSES):
    return [IN_FEAT] + [HIDDEN] * (LAYERS - 1) + [classes]


# ------------------------------------------------------------ seg_sum_sorted


def _seg_sum_shapes(g, compact, first_input_grad, classes=CLASSES,
                    walks=False):
    """[(label, rows of vals, C, row_ptr, perm)] of every seg_sum_sorted
    launch of one training step of the compact branches (the reductions
    of both, and of the packed form on its chain, the same; the packed
    form's ``walks`` sum only draw over the (dst, rel) runs) or the plain
    ones on ``g``.  Layer 0's gather backwards run only where
    its input needs a gradient: the learned embeddings of a single-card
    run, not the fixed features of a data-parallel one.  A union-list
    graph has one compact gather a layer (one projection).  A shard with
    the boundary halo adds the exchange's backward where the layer's input
    needs a gradient."""
    S, D = g.compact_src, g.compact_dst
    E = g.edge_rel_seg
    EP = g.num_padded_edges
    dims = _dims(classes)
    shapes = []
    for layer in range(LAYERS):
        width = dims[layer + 1]  # z*feat, dfeat
        gathers = layer > 0 or first_input_grad
        if not walks:
            shapes += [
                (f"l{layer} fwd dst z", EP, HEADS, g.in_row_ptr, None),
                (f"l{layer} fwd dst z*feat", EP, width, g.in_row_ptr, None),
            ]
        if compact:
            shapes.append((f"l{layer} bwd (dst,rel) runs draw", EP, HEADS,
                           D.canon_ptr, None))
            if not walks:
                shapes += [
                    (f"l{layer} bwd src-compact draw", EP, HEADS,
                     S.edge_row_ptr, S.edge_sort_perm),
                    (f"l{layer} bwd src-compact dfeat", EP, width,
                     S.edge_row_ptr, S.edge_sort_perm),
                ]
            if gathers:
                shapes.append((f"l{layer} bwd src gather", S.seg.n_rows,
                               dims[layer], S.node_row_ptr,
                               S.node_sort_perm))
            if gathers and not g.compact_shared:
                shapes.append((f"l{layer} bwd dst gather", D.seg.n_rows,
                               dims[layer], D.node_row_ptr,
                               D.node_sort_perm))
        elif gathers:
            src_perm = E.inv.index_select(0, g.out_perm)  # rows -> src order
            shapes += [
                (f"l{layer} bwd src edge gather", E.n_rows, dims[layer],
                 g.out_row_ptr, src_perm),
                (f"l{layer} bwd dst edge gather", E.n_rows, dims[layer],
                 g.in_row_ptr, E.inv),
            ]
        if gathers and g.halo_back_ptr is not None:
            shapes.append((f"l{layer} bwd halo exchange",
                           g.halo_back_perm.numel(), dims[layer],
                           g.halo_back_ptr, g.halo_back_perm))
    return shapes


def _rgcn_seg_sum_shapes(g, compact, first_input_grad):
    """The same list for a step of the RGCN runs: per layer the
    destination aggregation (plain: the normalized per-edge rows;
    compact: ``compact_weighted_agg``'s forward) and, compact, its
    backward into the source compact rows through ``edge_sort_perm``, at
    the layer's output width; the source gather's backward at its input
    width where the layer's input needs a gradient (the plain one over the
    edge rows in source order, the compact one over the compact rows)."""
    S, E = g.compact_src, g.edge_rel_seg
    EP = g.num_padded_edges
    dims = _dims()
    shapes = []
    for layer in range(LAYERS):
        out = dims[layer + 1]
        gathers = layer > 0 or first_input_grad
        shapes.append((f"l{layer} fwd dst aggregate", EP, out, g.in_row_ptr,
                       None))
        if compact:
            shapes.append((f"l{layer} bwd src-compact ct*norm", EP, out,
                           S.edge_row_ptr, S.edge_sort_perm))
            if gathers:
                shapes.append((f"l{layer} bwd src gather", S.seg.n_rows,
                               dims[layer], S.node_row_ptr,
                               S.node_sort_perm))
        elif gathers:
            shapes.append((f"l{layer} bwd src edge gather", E.n_rows,
                           dims[layer], g.out_row_ptr,
                           E.inv.index_select(0, g.out_perm)))
        if gathers and g.halo_back_ptr is not None:
            shapes.append((f"l{layer} bwd halo exchange",
                           g.halo_back_perm.numel(), dims[layer],
                           g.halo_back_ptr, g.halo_back_perm))
    return shapes


def _hgt_seg_sum_shapes(g, compact, stable):
    """The same list for a step of the HGT runs.  Every layer's typed
    linears need an input gradient (their inputs are projections), and
    the gathered rows are the projections, as wide as the layer's output
    (``out`` = heads x d_k)."""
    S, D, E = g.compact_src, g.compact_dst, g.edge_rel_seg
    EP = g.num_padded_edges
    dims = _dims()
    shapes = []
    for layer in range(LAYERS):
        out = dims[layer + 1]
        if compact and stable == "max":
            shapes += [
                (f"l{layer} fwd dst [z|z*msg]", EP, HEADS + out,
                 g.in_row_ptr, None),
                (f"l{layer} bwd msg expansion into src compact", EP, out,
                 S.edge_row_ptr, S.edge_sort_perm),
                (f"l{layer} bwd score (dst,rel) runs", EP, out, D.canon_ptr,
                 None),
                (f"l{layer} bwd score src k", EP, out, g.out_row_ptr,
                 g.out_perm),
            ]
        elif compact:
            shapes += [
                (f"l{layer} fwd dst z", EP, HEADS, g.in_row_ptr, None),
                (f"l{layer} fwd dst z*msg", EP, out, g.in_row_ptr, None),
                (f"l{layer} bwd src-compact [dmsg|dscore*attq]", EP, 2 * out,
                 S.edge_row_ptr, S.edge_sort_perm),
                (f"l{layer} bwd src-compact rows -> k", S.seg.n_rows, out,
                 S.node_row_ptr, S.node_sort_perm),
                (f"l{layer} bwd (dst,rel) runs dscore*k", EP, out,
                 D.canon_ptr, None),
            ]
        else:
            shapes += [
                (f"l{layer} fwd dst z", EP, HEADS, g.in_row_ptr, None),
                (f"l{layer} fwd dst z*msg", EP, out, g.in_row_ptr, None),
                (f"l{layer} bwd q edge rows", E.n_rows, out, g.in_row_ptr,
                 E.inv),
                (f"l{layer} bwd [k|v] edge rows", E.n_rows, 2 * out,
                 g.out_row_ptr, E.inv.index_select(0, g.out_perm)),
            ]
        if compact:
            shapes += [
                (f"l{layer} bwd q dst compact gather", D.seg.n_rows, out,
                 D.node_row_ptr, D.node_sort_perm),
                (f"l{layer} bwd v src compact gather", S.seg.n_rows, out,
                 S.node_row_ptr, S.node_sort_perm),
            ]
        if g.halo_back_ptr is not None:
            shapes += [(f"l{layer} bwd halo exchange {t}",
                        g.halo_back_perm.numel(), out, g.halo_back_ptr,
                        g.halo_back_perm) for t in "kv"]
    return shapes


def _gat_seg_sum_shapes(g, classes):
    """The same list for a step of the GAT runs: per layer ``z`` and
    ``z*feat`` over ``in_row_ptr``, ``d_er`` (``draw``) over it, and
    ``draw`` and ``dfeat`` over ``out_row_ptr`` through ``out_perm``, at H
    lanes (4, then 1) or H*D (256, then the ``classes``)."""
    EP = g.num_padded_edges
    shapes = []
    for layer, (heads, width) in enumerate(((HEADS, HEADS * HIDDEN),
                                            (1, classes))):
        shapes += [
            (f"l{layer} fwd dst z", EP, heads, g.in_row_ptr, None),
            (f"l{layer} fwd dst z*feat", EP, width, g.in_row_ptr, None),
            (f"l{layer} bwd d_er draw", EP, heads, g.in_row_ptr, None),
            (f"l{layer} bwd src draw", EP, heads, g.out_row_ptr,
             g.out_perm),
            (f"l{layer} bwd src dfeat", EP, width, g.out_row_ptr,
             g.out_perm),
        ]
    return shapes


def _compiled_seg_sum_shapes(g, spec):
    """The same list for a step of a compiled run (``COMPILED_RUNS``: H =
    1, every layer's input needing a gradient, the learned embeddings
    layer 0's).  The fused ops' narrow sums are one lane wide; the
    gathers' backwards sum rows as wide as what they gather: the layer's
    input for RGAT's and RGCN's node features, its output for HGT's
    projections (hs, hs_attn, ht_attn)."""
    S, D, E = g.compact_src, g.compact_dst, g.edge_rel_seg
    EP = g.num_padded_edges
    src_perm = E.inv.index_select(0, g.out_perm)  # edge rows -> src order
    dims = _dims()
    compact, mf = spec["compact"], spec["multiply_first"]
    shapes = []
    for layer in range(LAYERS):
        fi, fo = dims[layer], dims[layer + 1]
        fwd = [(f"l{layer} fwd dst z", EP, 1, g.in_row_ptr, None),
               (f"l{layer} fwd dst z*feat", EP, fo, g.in_row_ptr, None)]
        if spec["model"] == "RGCN":
            shapes.append((f"l{layer} fwd dst aggregate", EP, fo,
                           g.in_row_ptr, None))
            if compact:
                shapes += [
                    (f"l{layer} bwd m expansion into src compact", EP, fo,
                     S.edge_row_ptr, S.edge_sort_perm),
                    (f"l{layer} bwd src compact gather", S.seg.n_rows, fi,
                     S.node_row_ptr, S.node_sort_perm)]
            else:
                shapes.append((f"l{layer} bwd src edge gather", E.n_rows, fi,
                               g.out_row_ptr, src_perm))
        elif spec["model"] == "HGT":
            shapes += fwd + [(f"l{layer} bwd ht_attn dst gather", EP, fo,
                              g.in_row_ptr, None)]
            if compact:
                shapes += [
                    (f"l{layer} bwd src-compact d_msg", EP, fo,
                     S.edge_row_ptr, S.edge_sort_perm),
                    (f"l{layer} bwd hs_attn.W_att expansion", EP, fo,
                     S.edge_row_ptr, S.edge_sort_perm)] + [
                    (f"l{layer} bwd {t} src compact gather", S.seg.n_rows,
                     fo, S.node_row_ptr, S.node_sort_perm)
                    for t in ("hs", "hs_attn")]
            else:
                shapes += [(f"l{layer} bwd {t} src edge gather", E.n_rows,
                            fo, g.out_row_ptr, src_perm)
                           for t in ("hs", "hs_attn")]
        elif compact:
            shapes += fwd + [
                (f"l{layer} bwd (dst,rel) runs draw", EP, 1, D.canon_ptr,
                 None),
                (f"l{layer} bwd src-compact draw", EP, 1, S.edge_row_ptr,
                 S.edge_sort_perm),
                (f"l{layer} bwd src-compact dfeat", EP, fo, S.edge_row_ptr,
                 S.edge_sort_perm),
                (f"l{layer} bwd src compact gather", S.seg.n_rows, fi,
                 S.node_row_ptr, S.node_sort_perm),
                (f"l{layer} bwd dst compact gather", D.seg.n_rows, fi,
                 D.node_row_ptr, D.node_sort_perm)]
        else:
            shapes += fwd + [
                (f"l{layer} bwd src edge gather", E.n_rows, fi,
                 g.out_row_ptr, src_perm),
                (f"l{layer} bwd dst gather of er's input", EP, fi,
                 g.in_row_ptr, None) if mf else
                (f"l{layer} bwd dst edge gather", E.n_rows, fi, g.in_row_ptr,
                 E.inv)]
    return shapes


def _run_seg_sum_shapes(run, g, chain=False):
    """Every seg_sum_sorted launch of a step of ``run``'s model on ``g``
    (rank 0's shard for a data-parallel run, whose layer 0 reads fixed
    features; a sampled subgraph for a minibatch run; the message graph
    for a link run, whose last layer is HIDDEN wide), with its packed op
    on the chain where ``chain`` (the run's bf16 form)."""
    spec = _spec(run)
    if chain:
        spec = _chain(spec)
    if spec.get("compiled"):
        return _compiled_seg_sum_shapes(g, spec)
    if spec["model"] == "GAT":
        return _gat_seg_sum_shapes(g, spec["classes"])
    if spec["model"] == "HGT":
        return _hgt_seg_sum_shapes(g, spec["compact"],
                                   spec.get("stable", "clip"))
    if spec["model"] == "RGCN":
        return _rgcn_seg_sum_shapes(g, spec["compact"], run not in DP_RUNS)
    return _seg_sum_shapes(g, spec["compact"], run not in DP_RUNS,
                           spec.get("classes", CLASSES), _walks(spec))


def _hub_ptr(dev, hub=100_000, short=20_000, at=1, seed=0):
    """A row pointer with one hub row (row ``at``, ``hub`` edges) among
    ``short`` rows of 1-3 edges, starting at 7 (nonzero ptr[0])."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, 4, (short,), generator=gen)
    lengths[at] = hub
    ptr = torch.cat([torch.zeros(1, dtype=torch.long), lengths.cumsum(0)])
    return (ptr + 7).to(torch.int32).to(dev)


def _seg_sum_edge_cases(dev):
    import torch

    i32 = dict(dtype=torch.int32, device=dev)
    perm = torch.randperm(40, device=dev).to(torch.int32)
    hub = _hub_ptr(dev)
    rows = int(hub[-1]) + 11
    hub_perm = torch.randperm(rows, device=dev).to(torch.int32)
    return [
        ("empty segments", 40, 12, torch.tensor([0, 0, 5, 5, 12, 30, 30],
                                                **i32), None),
        ("all empty", 40, 4, torch.zeros(5, **i32), None),
        ("one segment", 40, 68, torch.tensor([0, 40], **i32), None),
        ("C=1", 40, 1, torch.tensor([0, 7, 7, 40], **i32), None),
        ("C=3 scalar loads", 40, 3, torch.tensor([0, 9, 40], **i32), None),
        ("perm, padding past ptr[n]", 40, 4,
         torch.tensor([0, 4, 9, 20], **i32), perm),
    ] + [(f"hub row of 100000 among 1-3 edge rows, C={C}"
          + (", perm" if p is not None else ""), rows, C, hub, p)
         for C in (4, 12, 68) for p in (None, hub_perm)]


def _bf16_ulp(t):
    """One bf16 unit in the last place of each entry of ``t`` (8
    significant bits; the smallest normal's for zeros)."""
    import torch

    _, e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _compare_seg_sum(vals, ptr, perm, label, out_dtype=None):
    """One call against the plain version (f64 sums of the same rows,
    rounded once).  f32 sums: rtol TOL_RTOL, atol TOL_RTOL * max|plain|;
    bf16 sums: one bf16 ulp of the plain version's rounded sum beyond
    that f32 limit (each is an f32 sum rounded once).  Returns the
    kernel's result and the largest |kernel - plain|."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted, seg_sum_sorted_plain

    got = seg_sum_sorted(vals, ptr, perm, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = seg_sum_sorted_plain(vals, ptr, perm, out_dtype)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not want.numel():
        return got, 0.0
    g, w = got.float(), want.float()
    scale = w.abs().max().item()
    if got.dtype == torch.bfloat16:
        limit = (TOL_RTOL * w.abs() + TOL_RTOL * scale
                 + torch.maximum(_bf16_ulp(g), _bf16_ulp(w)))
        if not ((g - w).abs() <= limit).all():
            raise AssertionError(f"{label}: bf16 sums differ from plain by "
                                 f"{(g - w).abs().max().item()}, past one "
                                 "ulp of the rounded sum")
    else:
        torch.testing.assert_close(got, want, rtol=TOL_RTOL,
                                   atol=TOL_RTOL * max(scale, 1e-30),
                                   msg=lambda m: f"{label}: {m}")
    return got, (g - w).abs().max().item()


def _entry_totals(totals, run):
    t = totals[run]
    return dict(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by="bytes" if t["bytes_ms"] >= t["ops_ms"]
                else "operations", library_ms=t["library_ms"])


def seg_sum_run_table(run, shapes, dev, flush, gen, pair_of=None):
    """Kernel against plain, timed beside its bound, the plain version and
    ``torch.segment_reduce``, at each of ``shapes`` (``_seg_sum_shapes``)
    of one run, each call also repeated bit for bit.  ``pair_of(label)``,
    where given, names each shape's (rows, sums) element types (a bf16
    step's, ``_bf16_sum_pair``): the rows are drawn in f32 and rounded to
    them, the bound counts 2 bytes a bf16 element and the adds at the bf16
    rate, and the yardstick reduces the bf16 rows.  Returns the
    per-step totals (under ``by_dtype`` too, a bf16 run's) and the
    largest |error|."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted, seg_sum_sorted_plain
    from het_tpu_torch.ops.kernels.seg_reduce import dtype_key

    def zero():
        return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                    bytes_ms=0.0, ops_ms=0.0)

    total, by_dtype = zero(), {}
    max_err = 0.0
    print(f"[{run}] shape | n | rows read | C | perm | dtypes | kernel ms | "
          "bound ms | plain ms | segment_reduce ms")
    for label, rows, C, ptr, perm in shapes:
        in_dt, out_dt = (pair_of(label) if pair_of is not None
                         else (torch.float32, torch.float32))
        vals = torch.randn(rows, C, device=dev, generator=gen).to(in_dt)
        got, err = _compare_seg_sum(vals, ptr, perm, label, out_dt)
        max_err = max(max_err, err)
        _compare_exact(got, seg_sum_sorted(vals, ptr, perm, out_dtype=out_dt),
                       f"{label} (repeat)")
        del got
        n = ptr.numel() - 1
        lo, hi = int(ptr[0]), int(ptr[-1])
        read = hi - lo
        nbytes = (read * C * vals.element_size()
                  + (4 * read if perm is not None else 0)
                  + (n + 1) * 4 + n * C * out_dt.itemsize)
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = read * C / (F32_FLOP_PER_S if in_dt == torch.float32
                            else BF16_FLOP_PER_S)
        bound = max(bytes_s, ops_s)
        ms = _time_ms(lambda: seg_sum_sorted(vals, ptr, perm,
                                             out_dtype=out_dt), 20, flush)
        plain = _time_ms(lambda: seg_sum_sorted_plain(vals, ptr, perm,
                                                      out_dt), 5, flush)
        off64 = ptr.long()
        idx = (perm[lo:hi].long() if perm is not None
               else torch.arange(lo, hi, device=dev))

        def library():
            # the yardstick: one PyTorch segment reduction over the rows
            # the kernel reads, in their element type (the port never
            # calls it)
            return torch.segment_reduce(vals[idx], "sum", offsets=off64 - lo)

        # the yardstick computes the same sums (f32 in its own order; a
        # row such as a halo's padding row gathers thousands of terms).
        # On bf16 rows it returns bf16 sums of its own rounding: their
        # distance from the f32 sums is printed, not held to a limit
        want = seg_sum_sorted_plain(vals, ptr, perm)
        lib_out = library().float()
        if in_dt == torch.float32:
            torch.testing.assert_close(
                lib_out, want, rtol=1e-4,
                atol=1e-4 * max(want.abs().max().item(), 1e-30))
        elif lib_out.shape != want.shape:
            raise AssertionError(f"{label}: segment_reduce gave "
                                 f"{tuple(lib_out.shape)}")
        else:
            print(f"{label}: segment_reduce on bf16 rows, largest |diff| "
                  f"from the f32 sums {(lib_out - want).abs().max().item()}"
                  f" (largest |sum| {want.abs().max().item()})")
        del want, lib_out
        lib = _time_ms(library, 5, flush)
        print(f"{label} | {n} | {read} | {C} | {perm is not None} | "
              f"{dtype_key(in_dt, out_dt)} | {ms:.4f} | {bound * 1e3:.4f} | "
              f"{plain:.4f} | {lib:.4f}")
        parts = [total]
        if pair_of is not None:
            parts.append(by_dtype.setdefault(dtype_key(in_dt, out_dt),
                                             zero()))
        for part in parts:
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("bound_ms", bound * 1e3), ("library_ms", lib),
                           ("bytes_ms", bytes_s * 1e3),
                           ("ops_ms", ops_s * 1e3)):
                part[key] += v
        del vals, idx
    if by_dtype:
        total["by_dtype"] = by_dtype
    print(f"[{run}] per-step totals (ms):", json.dumps(total))
    return total, max_err


def check_seg_sum(graphs, dev, flush, extra=None):
    """Kernel against plain at every shape of a step of each run in
    ``graphs`` (run -> graph on the card; rank 0's shard for a
    data-parallel run), plus ``extra`` (run -> more shapes of its step:
    the minibatch table's gradient, the DistMult gradients), and at the
    edge cases (each also launched twice, bit for bit); per-shape times.
    Returns the kernel's JSON entry: per-step totals of the slice's main
    path (MB_MAIN), and of every run under ``per_run``."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted

    print(f"seg_sum_sorted vs plain tolerance: rtol {TOL_RTOL}, "
          f"atol {TOL_RTOL} * max|plain|; edge cases twice, bit for bit")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for label, rows, C, ptr, perm in _seg_sum_edge_cases(dev):
        vals = torch.randn(rows, C, device=dev, generator=gen)
        # rows outside [ptr[0], ptr[n]) must never be read
        order = (perm.long() if perm is not None
                 else torch.arange(rows, device=dev))
        vals[order[:int(ptr[0])]] = float("nan")
        vals[order[int(ptr[-1]):]] = float("nan")
        max_err = max(max_err, _compare_seg_sum(vals, ptr, perm, label)[1])
        _compare_exact(seg_sum_sorted(vals, ptr, perm),
                       seg_sum_sorted(vals, ptr, perm), f"{label} (repeat)")
        print(f"seg_sum edge case ok: {label}")

    runs = {run: _run_seg_sum_shapes(run, g) + (extra or {}).get(run, [])
            for run, g in graphs.items()}
    _check_shape_count("seg_sum_sorted",
                       {run: len(shapes) for run, shapes in runs.items()})
    totals = {}
    for run, shapes in runs.items():
        totals[run], err = seg_sum_run_table(run, shapes, dev, flush, gen)
        max_err = max(max_err, err)
    return {
        "name": "seg_sum_sorted",
        "route": "cuda",
        "source": "het_tpu_torch/csrc/seg_reduce.cu",
        "replaces": "het_tpu/ops/pallas/seg_reduce.py:360",
        "launches": None,  # filled from the training run
        "max_abs_err": max_err,
        **_entry_totals(totals, MB_MAIN),
        "per_run": totals,
    }


# ------------------------------------------------------------ seg_max_sorted


def _seg_max_shapes(g):
    """[(label, rows of vals, C, row_ptr)] of every seg_max_sorted launch
    of a step under stable="max": the destination max of act(raw) over
    in_row_ptr, once a layer in the forward, C = heads."""
    return [(f"l{layer} fwd dst max act(raw)", g.num_padded_edges, HEADS,
             g.in_row_ptr) for layer in range(LAYERS)]


def _seg_max_edge_cases(dev):
    import torch

    i32 = dict(dtype=torch.int32, device=dev)
    hub = _hub_ptr(dev, seed=1)
    return [
        ("empty segments", 40, 4, torch.tensor([0, 0, 5, 5, 12, 30, 30],
                                                **i32), "normal"),
        ("single-edge segments", 40, 4, torch.tensor([3, 4, 4, 5, 40],
                                                      **i32), "normal"),
        ("all negative", 40, 4, torch.tensor([0, 7, 7, 40], **i32),
         "negative"),
        ("+-inf and NaN", 400, 4, torch.arange(0, 401, 20, **i32), "inf"),
        ("C=1", 40, 1, torch.tensor([0, 9, 9, 40], **i32), "normal"),
        ("C=8", 40, 8, torch.tensor([0, 9, 9, 40], **i32), "normal"),
        ("n=0", 40, 4, torch.tensor([7], **i32), "normal"),
        ("hub row of 100000, NaN and +inf in other workers' chunks",
         int(hub[-1]) + 11, 4, hub, "hub"),
    ]


def _max_values(rows, C, kind, dev, gen, ptr):
    import torch

    vals = torch.randn(rows, C, device=dev, generator=gen)
    if kind == "negative":
        vals = -vals.abs() - 1.0
    elif kind == "inf":
        hit = torch.rand(rows, C, device=dev, generator=gen)
        vals[hit < 0.05] = float("inf")
        vals[hit > 0.9] = float("-inf")
        vals[(hit > 0.5) & (hit < 0.51)] = float("nan")
    elif kind == "hub":  # row 1 of ``_hub_ptr`` is the hub
        h = int(ptr[1])
        vals[h + 1000, 0] = float("nan")
        vals[h + 90_000, C - 1] = float("inf")
        vals[h + 50_000, 1] = float("-inf")
        vals[:int(ptr[0])] = float("nan")  # never read
        vals[int(ptr[-1]):] = float("nan")
    return vals


def _compare_exact(got, want, label):
    """Raise unless ``got`` equals ``want`` bit for bit (torch.equal);
    returns the largest |got - want| (0 where the two are equal, inf
    included)."""
    import torch

    torch.cuda.synchronize()
    diff = None
    if got.shape == want.shape:
        diff = torch.where(got == want, 0.0, (got - want).abs())
        diff = diff.max().item() if diff.numel() else 0.0
    if diff is None or not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel differs from plain (shape "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max |diff| {diff})")
    return diff


def seg_max_run_table(run, shapes, dev, flush, gen):
    """Kernel against plain, bit for bit, timed beside its bound, the
    plain version and ``torch.segment_reduce(..., "max")``, at each of
    ``shapes`` (``_seg_max_shapes``) of one run.  Returns the per-step
    totals and the largest |error| (0)."""
    import torch
    from het_tpu_torch.ops.kernels import seg_max_sorted, seg_max_sorted_plain

    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                 bytes_ms=0.0, ops_ms=0.0)
    max_err = 0.0
    print(f"[{run}] shape | n | rows read | C | kernel ms | bound ms | "
          "plain ms | segment_reduce ms")
    for label, rows, C, ptr in shapes:
        vals = torch.randn(rows, C, device=dev, generator=gen)
        max_err = max(max_err, _compare_exact(
            seg_max_sorted(vals, ptr), seg_max_sorted_plain(vals, ptr),
            label))
        n = ptr.numel() - 1
        lo, hi = int(ptr[0]), int(ptr[-1])
        read = hi - lo
        nbytes = read * C * 4 + (n + 1) * 4 + n * C * 4
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = read * C / F32_FLOP_PER_S
        bound = max(bytes_s, ops_s)
        ms = _time_ms(lambda: seg_max_sorted(vals, ptr), 20, flush)
        plain = _time_ms(lambda: seg_max_sorted_plain(vals, ptr), 5, flush)
        lengths = (ptr[1:] - ptr[:-1]).long()
        window = vals[lo:hi]

        def library():
            # the yardstick: one PyTorch segment max over the rows the
            # kernel reads (the port never calls it); empty segments
            # come out as -inf there, mapped to 0 only for the check
            return torch.segment_reduce(window, "max", lengths=lengths)

        lib_out = library()
        torch.testing.assert_close(
            torch.where(torch.isfinite(lib_out), lib_out, 0.0),
            seg_max_sorted_plain(vals, ptr), rtol=0, atol=0)
        lib = _time_ms(library, 5, flush)
        print(f"{label} | {n} | {read} | {C} | {ms:.4f} | "
              f"{bound * 1e3:.4f} | {plain:.4f} | {lib:.4f}")
        for key, v in (("ms", ms), ("plain_ms", plain),
                       ("bound_ms", bound * 1e3), ("library_ms", lib),
                       ("bytes_ms", bytes_s * 1e3), ("ops_ms", ops_s * 1e3)):
            total[key] += v
        del vals, window, lib_out
    print(f"[{run}] seg_max_sorted per-step totals (ms):", json.dumps(total))
    return total, max_err


def check_seg_max(graphs, dev, flush):
    """Kernel against plain, bit for bit, at every shape of a step of the
    stable="max" runs (``graphs``: run -> graph on the card) and at the
    edge cases; per-shape times.  Returns the kernel's JSON entry:
    per-step totals of the slice's path, and of every run under
    ``per_run``."""
    import torch
    from het_tpu_torch.ops.kernels import seg_max_sorted, seg_max_sorted_plain

    print("seg_max_sorted vs plain: bit for bit (torch.equal)")
    gen = torch.Generator(device=dev).manual_seed(4)
    max_err = 0.0
    for label, rows, C, ptr, kind in _seg_max_edge_cases(dev):
        vals = _max_values(rows, C, kind, dev, gen, ptr)
        max_err = max(max_err, _compare_exact(
            seg_max_sorted(vals, ptr), seg_max_sorted_plain(vals, ptr),
            label))
        print(f"seg_max edge case ok: {label}")
    runs = {run: _seg_max_shapes(g) for run, g in graphs.items()}
    _check_shape_count("seg_max_sorted",
                       {run: len(shapes) for run, shapes in runs.items()})
    totals = {}
    for run, shapes in runs.items():
        totals[run], err = seg_max_run_table(run, shapes, dev, flush, gen)
        max_err = max(max_err, err)
    return {
        "name": "seg_max_sorted",
        "route": "cuda",
        "source": "het_tpu_torch/csrc/seg_reduce.cu",
        "replaces": "het_tpu/ops/pallas/seg_reduce.py:284",
        "launches": None,  # filled from the training run
        "max_abs_err": max_err,
        **_entry_totals(totals, SLICE_MAIN),
        "per_run": totals,
    }


# ------------------------------------------------------------ force_rowmajor


def check_force_rowmajor(g, dev, flush):
    """The row copy against plain, bit for bit, on the feature lanes
    ``fe[..., 1:]`` of the packed run's multiply-first projection (``g``
    that run's graph on the card: (UCs, heads, 1 + D) at layer 0), a
    transposed view and R = 0; times beside the bytes bound, the plain
    version and ``.contiguous()``.  No path calls it (as in het_tpu), so
    its entry reports one call at the fe shape."""
    import torch
    from het_tpu_torch.ops.kernels import force_rowmajor, force_rowmajor_plain

    gen = torch.Generator(device=dev).manual_seed(5)
    D = HIDDEN // HEADS
    UC = g.compact_src.seg.n_rows
    fe = torch.randn(UC, HEADS, 1 + D, device=dev, generator=gen)
    cases = [
        (f"fe[..., 1:] ({UC}, {HEADS}, {D}) of ({UC}, {HEADS}, {1 + D})",
         fe[..., 1:]),
        ("transposed (4096, 68)",
         torch.randn(68, 4096, device=dev, generator=gen).t()),
        ("R=0", torch.randn(0, 64, device=dev)),
    ]
    print("force_rowmajor vs plain: bit for bit (torch.equal)")
    print("view | elements | kernel ms | bound ms | plain ms | "
          ".contiguous() ms")
    entry = None
    max_err = 0.0
    for label, x in cases:
        max_err = max(max_err, _compare_exact(
            force_rowmajor(x), force_rowmajor_plain(x), label))
        if x.numel() == 0:
            print(f"{label} | 0 | ok")
            continue
        nbytes = 2 * x.numel() * 4  # each element read once, written once
        bound = nbytes / HBM_BYTES_PER_S
        ms = _time_ms(lambda: force_rowmajor(x), 20, flush)
        plain = _time_ms(lambda: force_rowmajor_plain(x), 5, flush)
        lib = _time_ms(lambda: x.contiguous(), 5, flush)
        print(f"{label} | {x.numel()} | {ms:.4f} | {bound * 1e3:.4f} | "
              f"{plain:.4f} | {lib:.4f}")
        if entry is None:
            entry = {
                "name": "force_rowmajor",
                "route": "cuda",
                "source": "het_tpu_torch/csrc/seg_reduce.cu",
                "replaces": "het_tpu/ops/pallas/seg_reduce.py:825",
                "launches": None,  # filled: no path calls it
                "max_abs_err": None,  # over every case, below
                "ms": ms,
                "plain_ms": plain,
                "bound_ms": bound * 1e3,
                "bound_by": "bytes",
                "library_ms": lib,
                "shape": label,
            }
    del fe
    entry["max_abs_err"] = max_err
    return entry


# ------------------------------------------------- packed compact GAT walks

# the benchmark's first cell: 8 heads of 8 in both layers (hidden 64, 64
# classes), the clip softmax
CELL_HEADS, CELL_D = 8, 8
WALKS = ("compact_gat_packed_fwd", "compact_gat_packed_bwd_dst",
         "compact_gat_packed_bwd_src")


def _walk_bytes(g, H, D):
    """Each walk's least bytes (every walked edge's index and row reads
    once, as the segment sum's bound counts rows read through perm; each
    row pointer and output once): {walk: bytes}."""
    E = int(g.in_row_ptr[-1] - g.in_row_ptr[0])
    N, UCs = g.num_nodes, g.compact_src.seg.n_rows
    W, HD = H * (1 + D), H * D
    row = 4 * (2 + W + H)  # two edge-map entries, a source row, er's row
    return {
        "compact_gat_packed_fwd": E * row + 4 * (N + 1 + N * (H + HD)),
        "compact_gat_packed_bwd_dst": (E * (row + 8 * H)
                                       + 4 * (N + 1 + N * (H + 2 * HD))),
        "compact_gat_packed_bwd_src": (E * 4 * (2 + 2 * H + HD)
                                       + 4 * (UCs + 1 + UCs * W)),
    }


def check_compact_gat(g, dev, flush, label):
    """The packed compact GAT op's three walks (``ops/kernels/
    compact_gat.py``) at the benchmark's first cell's shapes on ``g`` (the
    full-scale graph: H = 8, D = 8, the clip softmax): each against its
    plain version (TOL_RTOL; the backward walks on the plain forward's s
    and out, the source walk on the plain draw and alpha), a second launch
    bit for bit, each timed beside its bound (bytes), its plain version
    and, as the yardstick, the chain of PyTorch ops and segment sums it
    replaces in ``CompactFusedGATPacked`` (the forward's gathers and two
    sums; the backward's gathers, destination gather and elementwise
    terms; its two source-side sums and the concatenation).  Returns the
    three JSON entries."""
    import torch
    from het_tpu_torch.ops import fused_agg as fa
    from het_tpu_torch.ops.kernels import (
        compact_gat_packed_bwd_dst, compact_gat_packed_bwd_dst_plain,
        compact_gat_packed_bwd_src, compact_gat_packed_bwd_src_plain,
        compact_gat_packed_fwd, compact_gat_packed_fwd_plain)
    from het_tpu_torch.models.rgat import LEAKY_RELU_SLOPE as slope

    H, D = CELL_HEADS, CELL_D
    clip = fa.CLIP_LOGIT
    gen = torch.Generator(device=dev).manual_seed(9)
    S, Dc = g.compact_src, g.compact_dst
    fe2d = torch.randn(S.seg.n_rows, H * (1 + D), device=dev, generator=gen)
    er = torch.randn(Dc.seg.n_rows, H, device=dev, generator=gen)
    ct = torch.randn(g.num_nodes, H, D, device=dev, generator=gen)
    rows = (S.edge_map, Dc.edge_map, g.in_row_ptr)
    walk3 = (ct, g.dst, S.edge_row_ptr, S.edge_sort_perm)
    E = g.num_edges
    s, out = compact_gat_packed_fwd_plain(fe2d, er, *rows, slope, clip)
    draw, alpha = compact_gat_packed_bwd_dst_plain(fe2d, er, *rows, s, out,
                                                   ct, slope, clip)
    calls = {
        "compact_gat_packed_fwd": (
            lambda: compact_gat_packed_fwd(fe2d, er, *rows, slope, clip),
            lambda: compact_gat_packed_fwd_plain(fe2d, er, *rows, slope,
                                                 clip),
            lambda t: t),
        "compact_gat_packed_bwd_dst": (
            lambda: compact_gat_packed_bwd_dst(fe2d, er, *rows, s, out, ct,
                                               slope, clip),
            lambda: compact_gat_packed_bwd_dst_plain(fe2d, er, *rows, s, out,
                                                     ct, slope, clip),
            lambda t: tuple(x[:E] for x in t)),
        "compact_gat_packed_bwd_src": (
            lambda: compact_gat_packed_bwd_src(draw, alpha, *walk3),
            lambda: compact_gat_packed_bwd_src_plain(draw, alpha, *walk3),
            lambda t: t),
    }

    def edge_rows():
        return fa.CompactFusedGATPacked._edge_rows(fe2d, er, g, H)

    def chain_fwd():
        raw, ge = edge_rows()
        z, _ = fa._softmax_num(g, raw, slope, "clip", "kernel")
        return fa._aggregate(g, z, ge[..., 1:], "kernel")

    def chain_dst():
        raw, ge = edge_rows()
        return fa._softmax_backward(g, ct, s, out, raw, ge[..., 1:], slope,
                                    clip)

    ctd = chain_dst()[0]

    def chain_src():
        d_el, d_feat = fa._sum_heads(draw, alpha, ctd, S.edge_row_ptr,
                                     S.edge_sort_perm, "kernel",
                                     torch.float32, torch.float32)
        return torch.cat([d_el[..., None], d_feat.view(-1, H, D)], dim=2)

    chains = dict(zip(WALKS, (chain_fwd, chain_dst, chain_src)))
    nbytes = _walk_bytes(g, H, D)
    print(f"[{label}] packed compact GAT walks vs plain (H = {H}, D = {D}, "
          f"clip; rtol {TOL_RTOL}, atol {TOL_RTOL} * max|plain|), a second "
          "launch bit for bit")
    print("walk | kernel ms | bound ms (bytes) | share of bound | plain ms | "
          "replaced chain ms | max |kernel - plain|")
    entries = []
    for name in WALKS:
        kern, plain, cut = calls[name]
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for a, b in zip(cut(got), cut(want)):
            torch.testing.assert_close(
                a, b, rtol=TOL_RTOL,
                atol=TOL_RTOL * max(b.abs().max().item(), 1e-30),
                msg=lambda m, n=name: f"{label} {n}: {m}")
            err = max(err, (a - b).abs().max().item())
        again = kern()
        again = again if isinstance(again, tuple) else (again,)
        for a, b in zip(cut(again), cut(got)):
            _compare_exact(a, b, f"{label} {name} (repeat)")
        del got, want, again
        ms = _time_ms(kern, 10, flush)
        plain_ms = _time_ms(plain, 3, flush)
        chain_ms = _time_ms(chains[name], 3, flush)
        bound = nbytes[name] / HBM_BYTES_PER_S * 1e3
        print(f"{name} | {ms:.3f} | {bound:.3f} | {100 * bound / ms:.1f}% | "
              f"{plain_ms:.3f} | {chain_ms:.3f} | {err:.3e}")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "het_tpu_torch/csrc/compact_gat.cu",
            "replaces": ("het_tpu/ops/pallas/fused_agg.py:476 "
                         "_make_compact_fused_packed_op"),
            "launches": None,  # filled from the training run
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": None,  # no one PyTorch call computes it
            "chain_ms": chain_ms,
            "shape": f"{label}: H = {H}, D = {D}, {E} edges",
        })
    return entries


# ------------------------------------------------------------ fused op forms


def compare_fused_forms(graphs, dev, flush):
    """Compact multiply-first's fused softmax aggregation in both operand
    forms on the same inputs: the split op on the views ``fe[..., 1:]`` and
    ``fe[..., 0]`` of the projection (het_tpu's form below 1M source
    compact rows) and the packed op on ``fe`` itself (the port's form),
    forward and backward to the gradients of ``fe`` and ``er`` through the
    kernels, at each layer's shapes of the runs in ``graphs`` (run ->
    graph on the card) with the run's softmax.  The two must agree within
    TOL_RTOL; each form's ms (mean of two medians, timed split, packed,
    packed, split) and its peak device memory above the inputs are
    printed and returned."""
    import torch
    from het_tpu_torch import ops
    from het_tpu_torch.models.rgat import LEAKY_RELU_SLOPE as slope

    forms = {
        "split": lambda g, fe, er, st: ops.relational_fused_gat_compact(
            g, fe[..., 1:], fe[..., 0], er, slope, stable=st),
        "packed": lambda g, fe, er, st:
            ops.relational_fused_gat_compact_packed(g, fe, er, slope,
                                                    stable=st),
    }
    gen = torch.Generator(device=dev).manual_seed(6)
    dims = _dims()
    print("compact multiply-first fused op, split vs packed form (forward "
          f"+ backward to fe and er; agreement rtol {TOL_RTOL}, atol "
          f"{TOL_RTOL} * max|packed|)")
    print("run | layer | fe shape | split ms | packed ms | split peak MB | "
          "packed peak MB")
    result = {}
    for run, g in graphs.items():
        stable = RUNS[run]["stable"]
        total = dict(split_ms=0.0, packed_ms=0.0, split_peak_mb=0.0,
                     packed_peak_mb=0.0)
        for layer in range(LAYERS):
            D = dims[layer + 1] // HEADS
            shape = (g.compact_src.seg.n_rows, HEADS, 1 + D)
            fe = torch.randn(shape, device=dev, generator=gen)
            er = torch.randn(g.compact_dst.seg.n_rows, HEADS, device=dev,
                             generator=gen)
            ct = torch.randn(g.num_nodes, HEADS, D, device=dev,
                             generator=gen)
            fe.requires_grad_()
            er.requires_grad_()
            got, row = {}, {}
            for name in ("split", "packed", "packed", "split"):
                def step(form=forms[name]):
                    out = form(g, fe, er, stable)
                    return (out, *torch.autograd.grad(out, (fe, er), ct))

                if name not in got:
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    got[name] = step()
                    row[f"{name}_peak_mb"] = (
                        torch.cuda.max_memory_allocated(dev) - base) / 2**20
                row[f"{name}_ms"] = (row.get(f"{name}_ms", 0.0)
                                     + _time_ms(step, 10, flush) / 2)
            for what, a, b in zip(("out", "d_fe", "d_er"), got["split"],
                                  got["packed"]):
                scale = b.abs().max().item()
                torch.testing.assert_close(
                    a, b, rtol=TOL_RTOL, atol=TOL_RTOL * max(scale, 1e-30),
                    msg=lambda m, w=what: f"{run} l{layer} {w}: {m}")
            print(f"{run} | {layer} | {shape} | {row['split_ms']:.4f} | "
                  f"{row['packed_ms']:.4f} | {row['split_peak_mb']:.1f} | "
                  f"{row['packed_peak_mb']:.1f}")
            for key in total:
                total[key] += row[key]
            del got, fe, er, ct
        result[run] = total
    print("fused op forms, per-step totals:", json.dumps(result))
    return result


def check_rgcn_layer0(g, dev):
    """The featureless RGCN layer (``rgcn_layer0``, weight (R, N, HIDDEN))
    on the card, ``g`` the scale-0.1 graph: two segment-sum launches a
    forward and backward (the aggregation, then the weight gradient as one
    sum over the (relation, source) runs, no scatter), the weight gradient
    the same bit for bit on a second call and within the segment sum's
    tolerance of the plain versions' (which launch nothing).  No training
    run takes this layer (het_tpu's trainer feeds RGCN embeddings)."""
    import torch
    from het_tpu_torch import ops
    from het_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(8)
    w = torch.randn(g.num_rels, g.num_nodes, HIDDEN, device=dev,
                    generator=gen).requires_grad_()
    ct = torch.randn(g.num_nodes, HIDDEN, device=dev, generator=gen)
    norm, runs = ops.rgcn_norm(g), ops.rel_src_runs(g)

    def grad(impl):
        kernels.reset_launches()
        out = ops.rgcn_layer0(g, w, norm, impl=impl, runs=runs)
        dw = torch.autograd.grad(out, w, ct)[0]
        n = kernels.launch_counts()["seg_sum_sorted"]
        if n != (2 if impl == "kernel" else 0):
            raise AssertionError(f"rgcn_layer0 {impl}: {n} segment sums")
        return dw

    got = grad("kernel")
    _compare_exact(got, grad("kernel"), "rgcn_layer0 weight gradient, "
                   "second call")
    want = grad("plain")
    torch.testing.assert_close(
        got, want, rtol=TOL_RTOL,
        atol=TOL_RTOL * max(want.abs().max().item(), 1e-30),
        msg=lambda m: f"rgcn_layer0 weight gradient: {m}")
    print(f"rgcn_layer0 weight gradient ({tuple(w.shape)}, {g.num_edges} "
          f"edges): 2 segment sums, bit for bit on a second call, max "
          f"|kernel - plain| {(got - want).abs().max().item():.3g}")
    del w, got, want


# --------------------------------------------------------- segment_matmul_dw


def _segments(sizes, tile, dev):
    import numpy as np
    from het_tpu_torch.graph.build import build_segments

    seg_of_row = np.repeat(np.arange(len(sizes)), sizes)
    return build_segments(seg_of_row, len(sizes), tile).to(dev)


def _shifted(seg, lead):
    """``seg`` moved ``lead`` rows into its row space: rows before its
    first segment and past its last belong to none."""
    import dataclasses
    import torch

    ptrs = tuple(p + lead for p in seg.seg_ptrs_static)
    return dataclasses.replace(
        seg, n_rows=ptrs[-1], seg_ptrs_static=ptrs,
        seg_ptrs=torch.tensor(ptrs, dtype=torch.int32,
                              device=seg.seg_ptrs.device))


def _dw_chunk_rows(n_rows, S, H, Hx, K, O, dev):
    """Rows a chunk of the dW kernel's plan for such operands."""
    import torch
    from het_tpu_torch.ops.kernels.segment_mm import card_dw_plan

    return card_dw_plan(torch.zeros(n_rows, Hx * K, device=dev),
                        torch.zeros(n_rows, H * O, device=dev),
                        (S, H, K, O)).chunk_rows


def _runs_of(run):
    """The runs a shape is listed for: None, one name or a tuple."""
    if run is None:
        return ()
    return run if isinstance(run, tuple) else (run,)


def _dw_shapes(g, gu, shards, dev, edge_graphs):
    """(label, run(s) or None, launches per step, seg, H, Hx, K, O, zero
    ct on invalid rows[, operand form: "nan_outside" for NaN rows before
    and past the segments, "unaligned" for x one float off 16 bytes]):
    the attention-vector dW of the plain RGAT steps
    (two a layer over the relation-sorted edge rows), of the compact step
    (per layer, attn_l over the source and attn_r over the destination
    compact rows) and of the union-compact step (both over the shared
    union rows of ``gu``); on rank 0's shard, whose offsets live only on
    the device, the
    typed-linear dWs of both data-parallel runs and the plain one's
    attention-vector dWs; the attention-vector dWs of the plain RGAT steps
    on ``edge_graphs`` (run -> graph on the card: the minibatch run's
    sampled subgraph, the link run's message graph at S = 474); the
    general segment-matmul dW and edge cases."""
    import numpy as np

    E = g.edge_rel_seg
    dims = _dims()
    rng = np.random.default_rng(0)
    big = 1_000_000
    skew = 1.0 / (1.0 + np.arange(535))  # a few large relations, a long tail
    cs = shards["dp_compact_multiply_first"]
    ps = shards["dp_plain"]
    rs = shards["dp_rgcn_compact"]
    hc, hp = shards["dp_hgt_compact"], shards["dp_hgt_plain"]
    hn = shards["dp_hgt_ntypes"]
    hgt = ("hgt_plain", "hgt_compact", "hgt_compact_max")
    shapes = []
    for layer in range(LAYERS):
        K = dims[layer + 1] // HEADS
        shapes += [
            # two node types: compact HGT's dWs on its own shard, and
            # ntype_linear's k, q, v (x shared by the heads) and a over
            # the node rows arranged by type
            (f"l{layer} shard HGT relation_pri dW, edge rows, two node "
             "types", "dp_hgt_ntypes", 1, hn.edge_rel_seg, HEADS, HEADS, 1,
             1, True),
            (f"l{layer} shard dst compact HGT q.W_att dW, per head, two node"
             " types", "dp_hgt_ntypes", 1, hn.compact_dst.seg, HEADS, HEADS,
             K, K, True),
            (f"l{layer} shard src compact HGT v.W_msg dW, per head, two node"
             " types", "dp_hgt_ntypes", 1, hn.compact_src.seg, HEADS, HEADS,
             K, K, True),
            (f"l{layer} shard node rows HGT k, q, v dW by node type",
             "dp_hgt_ntypes", 3, hn.ntype_seg, HEADS, 1, dims[layer], K,
             True),
            (f"l{layer} shard node rows HGT a dW by node type",
             "dp_hgt_ntypes", 1, hn.ntype_seg, 1, 1, dims[layer + 1],
             dims[layer + 1], True),
            (f"l{layer} shard edge rows RGCN W dW", "dp_rgcn_plain", 1,
             ps.edge_rel_seg, 1, 1, dims[layer], dims[layer + 1], False),
        ]
        shapes += [
            # HGT's relation_pri: score * mu[rel], K = O = 1 a head
            (f"l{layer} HGT relation_pri dW, edge rows", hgt, 1, E, HEADS,
             HEADS, 1, 1, True),
            (f"l{layer} shard HGT relation_pri dW, edge rows",
             "dp_hgt_compact", 1, hc.edge_rel_seg, HEADS, HEADS, 1, 1, True),
            (f"l{layer} shard HGT relation_pri dW, edge rows, boundary",
             "dp_hgt_plain", 1, hp.edge_rel_seg, HEADS, HEADS, 1, 1, True),
            # HGT's per-head typed linears (x a row a head, K = O = d_k)
            (f"l{layer} shard dst compact HGT q.W_att dW, per head",
             "dp_hgt_compact", 1, hc.compact_dst.seg, HEADS, HEADS, K, K,
             True),
            (f"l{layer} shard src compact HGT v.W_msg dW, per head",
             "dp_hgt_compact", 1, hc.compact_src.seg, HEADS, HEADS, K, K,
             True),
            (f"l{layer} shard edge rows HGT q.W_att, v.W_msg dW, per head",
             "dp_hgt_plain", 2, hp.edge_rel_seg, HEADS, HEADS, K, K, True),
        ]
        shapes += [
            (f"l{layer} attn_l/attn_r dW, edge rows", (MAIN, "plain_max"),
             2, E, HEADS, HEADS, K, 1, True),
            (f"l{layer} attn_l dW, src compact rows", "compact", 1,
             g.compact_src.seg, HEADS, HEADS, K, 1, True),
            (f"l{layer} attn_r dW, dst compact rows", "compact", 1,
             g.compact_dst.seg, HEADS, HEADS, K, 1, True),
            (f"l{layer} attn_l/attn_r dW, union compact rows",
             "union_compact", 2, gu.compact_src.seg, HEADS, HEADS, K, 1,
             True),
        ]
    for run, ge in edge_graphs.items():
        for layer in range(LAYERS):
            K = _dims(_spec(run)["classes"])[layer + 1] // HEADS
            shapes.append((f"l{layer} attn_l/attn_r dW, edge rows, {run}",
                           run, 2, ge.edge_rel_seg, HEADS, HEADS, K, 1,
                           True))
    # the compiled runs (H = 1): the relation-typed inner products' dW
    # (attn_l and attn_r per edge or per compact row at the layer's output
    # width, or W.a_r at its input width), and under gather_einsum the
    # typed linears' W dW over the edge rows, read on device offsets
    cr = dict(plain="compiled_plain", mf="compiled_plain_multiply_first",
              compact="compiled_compact", cmf=COMPILED_MAIN,
              einsum="compiled_plain_gather_einsum")
    for layer in range(LAYERS):
        fi, fo = dims[layer], dims[layer + 1]
        shapes += [
            (f"l{layer} compiled attn_l/attn_r dW, edge rows",
             (cr["plain"], cr["einsum"]), 2, E, 1, 1, fo, 1, True),
            (f"l{layer} compiled attn_l dW, edge rows", cr["mf"], 1, E, 1, 1,
             fo, 1, True),
            (f"l{layer} compiled W.a_r dW, edge rows", cr["mf"], 1, E, 1, 1,
             fi, 1, True),
            (f"l{layer} compiled attn_l dW, src compact rows",
             cr["compact"], 1, g.compact_src.seg, 1, 1, fo, 1, True),
            (f"l{layer} compiled attn_r dW, dst compact rows",
             cr["compact"], 1, g.compact_dst.seg, 1, 1, fo, 1, True),
            (f"l{layer} compiled W.a_r dW, dst compact rows", cr["cmf"], 1,
             g.compact_dst.seg, 1, 1, fi, 1, True),
            (f"l{layer} compiled W dW (src, dst), edge rows, device offsets",
             cr["einsum"], 2, E, 1, 1, fi, fo, False),
        ]
    for layer in range(LAYERS):
        K, D = dims[layer], dims[layer + 1] // HEADS
        shapes += [
            (f"l{layer} shard src compact [W.a_l | W] dW",
             "dp_compact_multiply_first", 1, cs.compact_src.seg, HEADS, 1,
             K, 1 + D, False),
            (f"l{layer} shard dst compact W.a_r dW",
             "dp_compact_multiply_first", 1, cs.compact_dst.seg, HEADS, 1,
             K, 1, False),
            (f"l{layer} shard edge rows W dW (src, dst)",
             ("dp_plain", "dp_plain_max"), 2, ps.edge_rel_seg, HEADS, 1, K,
             D, False),
            (f"l{layer} shard attn_l/attn_r dW, edge rows",
             ("dp_plain", "dp_plain_max"), 2, ps.edge_rel_seg, HEADS, HEADS,
             D, 1, True),
            (f"l{layer} shard src compact RGCN W dW", "dp_rgcn_compact", 1,
             rs.compact_src.seg, 1, 1, K, dims[layer + 1], False),
        ]
    shapes += [
        ("general S=4", None, 0, _segments(rng.multinomial(
            big, [0.4, 0.3, 0.2, 0.1]), 128, dev), 1, 1, 64, 64, False),
        ("general S=535", None, 0, _segments(rng.multinomial(
            big, skew / skew.sum()), 128, dev), 1, 1, 64, 64, False),
        ("edge: empty segments", None, 0, _segments((40, 0, 17, 0), 8, dev),
         2, 2, 8, 1, False),
        ("edge: all empty", None, 0, _segments((0, 0, 0), 8, dev), 2, 2, 4,
         3, False),
        ("edge: one segment", None, 0, _segments((300,), 8, dev), 1, 1, 64,
         64, False),
        ("edge: K=1", None, 0, _segments((50, 0, 900), 8, dev), 1, 1, 1, 64,
         False),
        ("edge: O=1", None, 0, _segments((50, 0, 900), 8, dev), 2, 1, 8, 1,
         False),
        ("edge: per-head x, O>1", None, 0, _segments((50, 0, 900), 8, dev),
         2, 2, 70, 5, False),
        ("edge: shared x, heads across tiles", None, 0,
         _segments((50, 0, 900), 8, dev), 3, 1, 70, 30, False),
        # most of the 535 segments shorter than a chunk, NC = 68
        ("edge: S=535 short segments, NC=68", None, 0, _segments(
            rng.multinomial(200_000, skew / skew.sum()), 1, dev), 4, 1, 64,
         17, False),
        ("edge: NaN rows outside the segments, NC=68", None, 0,
         _shifted(_segments((3000, 0, 1500, 9), 1, dev), 37), 4, 1, 64, 17,
         False, "nan_outside"),
        ("edge: NaN rows outside the segments, NC=4", None, 0,
         _shifted(_segments((3000, 0, 1500, 9), 1, dev), 37), 4, 1, 64, 1,
         False, "nan_outside"),
        ("edge: x not 16-byte aligned, NC=68", None, 0,
         _segments((2000, 33, 0, 900), 8, dev), 4, 1, 64, 17, False,
         "unaligned"),
        ("edge: x not 16-byte aligned, NC=4", None, 0,
         _segments((2000, 33, 0, 900), 8, dev), 4, 1, 64, 1, False,
         "unaligned"),
    ]
    for H, Hx, K, O in ((4, 1, 64, 17), (4, 1, 64, 1)):
        rows = _dw_chunk_rows(3000, 2, H, Hx, K, O, dev)
        shapes.append((f"edge: a segment one row past a chunk, NC={H * O}",
                       None, 0, _segments((rows + 1, 3000 - rows - 1), 1,
                                          dev), H, Hx, K, O, False))
    assert g.num_rels == E.n_segments
    for shape in shapes:
        if any(run in DP_RUNS for run in _runs_of(shape[1])):
            assert shape[3].seg_ptrs_static is None, shape[0]
    return shapes


def _tf32(t):
    """``t`` rounded to TF32 (10-bit mantissa, to nearest, ties away from
    zero), as a tensor-core load would round it."""
    import torch

    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _worst_share(diff, limit):
    """max of diff / limit (0 where both are 0; inf where only the limit
    is)."""
    import torch

    share = torch.where(limit > 0, diff / limit,
                        torch.where(diff > 0, float("inf"), 0.0))
    return share.max().item() if share.numel() else 0.0


def check_dw(g, gu, shards, dev, flush, edge_graphs):
    """segment_matmul_dw against its plain version at every shape (``g``
    the single-card graph, ``gu`` its union-list form, ``shards`` rank 0's
    shard of each data-parallel run, ``edge_graphs`` the minibatch and
    link plain runs' graphs, all on the card), within
    |kernel - plain| <= DW_TOL * sum |x| |ct| (the plain version on
    absolute values), and a control: the plain version on inputs rounded to
    TF32 must fail that limit at every shape that has rows, so the check
    tells an f32 kernel from a TF32 one.  Per-shape times.  Returns the
    kernel's JSON entry: per-step totals of the single-card main path,
    and of every run under ``per_run``."""
    import torch
    from het_tpu_torch.ops.kernels import (segment_matmul_dw,
                                           segment_matmul_dw_plain)
    from het_tpu_torch.ops.kernels.segment_mm import host_seg_ptrs

    print(f"segment_matmul_dw vs plain tolerance: |kernel - plain| <= "
          f"{DW_TOL} * sum|x|*|ct|; 'share' is the largest |diff| / limit")
    gen = torch.Generator(device=dev).manual_seed(1)
    totals = {}
    max_err = 0.0
    print("shape | run | S | rows | H | Hx | K | O | kernel share | TF32 "
          "control share | kernel ms | bound ms | bound / kernel | plain ms "
          "| per-relation torch.matmul ms")
    shapes = _dw_shapes(g, gu, shards, dev, edge_graphs)
    counts = dict.fromkeys(
        list(RUNS) + list(DP_RUNS) + list(MB_RUNS) + list(LINK_RUNS)
        + list(COMPILED_RUNS), 0)
    for shape in shapes:
        for run in _runs_of(shape[1]):
            counts[run] += shape[2]
    _check_shape_count("segment_matmul_dw", counts)
    for label, run, per_step, seg, H, Hx, K, O, mask, *form in shapes:
        S, n = seg.n_segments, seg.n_rows
        w_shape = (S, H, K, O)
        if form == ["unaligned"]:  # a contiguous view one float in
            x = torch.randn(n * Hx * K + 1, device=dev,
                            generator=gen)[1:].view(n, Hx * K)
            assert x.data_ptr() % 16 != 0, label
        else:
            x = torch.randn(n, Hx * K, device=dev, generator=gen)
        ct = torch.randn(n, H * O, device=dev, generator=gen)
        if mask:  # as _RelInner's backward: no cotangent on padding rows
            ct = torch.where(seg.row_valid[:, None], ct, 0.0)
        if form == ["nan_outside"]:  # rows no segment holds, and more past
            first = int(seg.seg_ptrs_static[0])
            x = torch.cat([x, torch.randn(45, Hx * K, device=dev)])
            ct = torch.cat([ct, torch.randn(45, H * O, device=dev)])
            for t in (x, ct):
                t[:first] = float("nan")
                t[n:] = float("nan")
        got = segment_matmul_dw(x, ct, w_shape, seg)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: the dW is not finite")
        if not torch.equal(got, segment_matmul_dw(x, ct, w_shape, seg)):
            raise AssertionError(f"{label}: two calls differ")
        want = segment_matmul_dw_plain(x, ct, w_shape, seg)
        limit = DW_TOL * segment_matmul_dw_plain(x.abs(), ct.abs(), w_shape,
                                                 seg)
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        err = (got - want).abs()
        share = _worst_share(err, limit)
        if share > 1.0:
            raise AssertionError(
                f"{label}: kernel differs from plain by {err.max().item()}"
                f", {share} times the limit {DW_TOL} * sum|x||ct|")
        control = _worst_share((segment_matmul_dw_plain(
            _tf32(x), _tf32(ct), w_shape, seg) - want).abs(), limit)
        if limit.max().item() > 0 and not control > 1.0:
            raise AssertionError(
                f"{label}: a TF32-input dW stays within the limit ({control}"
                f" of it), so the check cannot tell it from f32")
        max_err = max(max_err, err.max().item() if err.numel() else 0.0)
        ptrs = host_seg_ptrs(seg)  # read once, outside the timed calls

        def yardstick():
            # the per-relation torch.matmul loop of the host-offset
            # segment matmul's backward (ops/linear.py::_static_bwd: where
            # x is per head, one (H*K, H*O) product and its diagonal
            # blocks); the port's dW never calls it
            out = torch.zeros(w_shape, device=dev)
            for s in range(S):
                lo, hi = ptrs[s], ptrs[s + 1]
                if hi == lo:
                    continue
                full = x[lo:hi].t() @ ct[lo:hi]  # (Hx*K, H*O)
                if Hx == 1:
                    out[s] = full.view(K, H, O).permute(1, 0, 2)
                else:
                    out[s] = full.view(H, K, H, O).diagonal(
                        dim1=0, dim2=2).permute(2, 0, 1)
            return out

        if (yardstick() - want).abs().max().item() > 1e-4 * max(
                limit.max().item() / DW_TOL, 1.0):
            raise AssertionError(f"{label}: yardstick disagrees")
        rows = ptrs[-1] - ptrs[0]
        nbytes = rows * (Hx * K + H * O) * 4 + S * H * K * O * 4 + (S + 1) * 4
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = 2 * rows * H * K * O / F32_FLOP_PER_S
        bound = max(bytes_s, ops_s)
        ms = _time_ms(lambda: segment_matmul_dw(x, ct, w_shape, seg), 20,
                      flush)
        plain = _time_ms(
            lambda: segment_matmul_dw_plain(x, ct, w_shape, seg), 5, flush)
        yard = _time_ms(yardstick, 5, flush)
        print(f"{label} | {run} | {S} | {rows} | {H} | {Hx} | {K} | {O} | "
              f"{share:.4g} | {control:.4g} | {ms:.4f} | {bound * 1e3:.4f} "
              f"({'bytes' if bytes_s >= ops_s else 'operations'}) | "
              f"{bound * 1e3 / ms:.1%} | {plain:.4f} | {yard:.4f}")
        for r in _runs_of(run):
            total = totals.setdefault(r, dict(
                ms=0.0, plain_ms=0.0, bound_ms=0.0, yardstick_ms=0.0,
                bytes_ms=0.0, ops_ms=0.0))
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("bound_ms", bound * 1e3), ("yardstick_ms", yard),
                           ("bytes_ms", bytes_s * 1e3),
                           ("ops_ms", ops_s * 1e3)):
                total[key] += per_step * v
    for run, total in totals.items():
        print(f"[{run}] segment_matmul_dw per-step totals (ms):",
              json.dumps(total))
    total = totals[MAIN]
    return {
        "name": "segment_matmul_dw",
        "route": "cuda",
        "source": "het_tpu_torch/csrc/segment_mm.cu",
        "replaces": "het_tpu/ops/pallas/segment_mm.py:400,568",
        "launches": None,  # filled from the training run
        "max_abs_err": max_err,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                     else "operations"),
        "library_ms": None,  # no single PyTorch call computes a grouped dW
        "yardstick_ms": total["yardstick_ms"],
        "yardstick": "per-relation torch.matmul loop",
        "per_run": totals,
    }


# ------------------------------------------- segment_matmul_fwd / _dx


def _mm_shapes(shards, dev, g):
    """(label, run or None, forward launches a step, dX launches a step,
    seg, S, H, Hx, K, O[, operand form: "nan_outside" for NaN rows before
    and past the segments, "unaligned" for an operand one float off 16
    bytes]) of every forward and dX the data-parallel runs give rank 0's
    shard (on the card), the compiled gather_einsum run gives ``g``'s
    relation-sorted edge rows, the general shapes and edge cases.  Offsets
    live only on the device, as on a shard."""
    import dataclasses

    import numpy as np

    dims = _dims()
    rng = np.random.default_rng(2)
    big = 1_000_000
    skew = 1.0 / (1.0 + np.arange(535))
    cs = shards["dp_compact_multiply_first"]
    ps = shards["dp_plain"]
    rs = shards["dp_rgcn_compact"]
    hc, hp = shards["dp_hgt_compact"], shards["dp_hgt_plain"]
    hn = shards["dp_hgt_ntypes"]
    R, T = ps.num_rels, hn.num_ntypes
    shapes = []
    for layer in range(LAYERS):
        K, D = dims[layer], dims[layer + 1] // HEADS
        out = dims[layer + 1]
        dx = 1 if layer > 0 else 0
        # two node types: compact HGT's per-head typed linears on its own
        # shard, and ntype_linear's k, q, v (x shared by the heads; a dX
        # where the layer's input needs one) and a (always a dX) over the
        # node rows arranged by type, on device offsets
        shapes += [
            (f"l{layer} dst compact HGT q.W_att, per head, two node types",
             "dp_hgt_ntypes", 1, 1, hn.compact_dst.seg, R, HEADS, HEADS, D,
             D),
            (f"l{layer} src compact HGT v.W_msg, per head, two node types",
             "dp_hgt_ntypes", 1, 1, hn.compact_src.seg, R, HEADS, HEADS, D,
             D),
            (f"l{layer} node rows HGT k, q, v by node type", "dp_hgt_ntypes",
             3, 3 * dx, hn.ntype_seg, T, HEADS, 1, K, D),
            (f"l{layer} node rows HGT a by node type", "dp_hgt_ntypes", 1, 1,
             hn.ntype_seg, T, 1, 1, out, out),
            (f"l{layer} edge rows RGCN W", "dp_rgcn_plain", 1, dx,
             ps.edge_rel_seg, R, 1, 1, K, out),
        ]
        # HGT's per-head typed linears: an input gradient in every layer;
        # the plain core runs its two in the forward and again in the
        # backward
        shapes += [
            (f"l{layer} dst compact HGT q.W_att, per head", "dp_hgt_compact",
             1, 1, hc.compact_dst.seg, R, HEADS, HEADS, D, D),
            (f"l{layer} src compact HGT v.W_msg, per head", "dp_hgt_compact",
             1, 1, hc.compact_src.seg, R, HEADS, HEADS, D, D),
            (f"l{layer} edge rows HGT q.W_att, v.W_msg, per head",
             "dp_hgt_plain", 4, 2, hp.edge_rel_seg, R, HEADS, HEADS, D, D),
        ]
        shapes += [
            (f"l{layer} src compact RGCN W", "dp_rgcn_compact", 1, dx,
             rs.compact_src.seg, R, 1, 1, K, dims[layer + 1]),
            (f"l{layer} src compact [W.a_l | W]", "dp_compact_multiply_first",
             1, dx, cs.compact_src.seg, R, HEADS, 1, K, 1 + D),
            (f"l{layer} dst compact W.a_r", "dp_compact_multiply_first", 1,
             dx, cs.compact_dst.seg, R, HEADS, 1, K, 1),
            (f"l{layer} edge rows W (src, dst)", ("dp_plain", "dp_plain_max"),
             2, 2 * dx, ps.edge_rel_seg, R, HEADS, 1, K, D),
        ]

    # compiled plain RGAT with every GEMM spec on device offsets (H = 1):
    # both typed linears of a layer (the edges' source and destination
    # rows), a dX each in both layers (the embeddings need a gradient)
    E = dataclasses.replace(g.edge_rel_seg, seg_ptrs_static=None)
    for layer in range(LAYERS):
        shapes.append((f"l{layer} compiled edge rows W (src, dst)",
                       "compiled_plain_gather_einsum", 2, 2, E, g.num_rels,
                       1, 1, dims[layer], dims[layer + 1]))

    def general(sizes, tile):
        return dataclasses.replace(_segments(sizes, tile, dev),
                                   seg_ptrs_static=None)

    shapes += [
        ("general S=4", None, 0, 0, general(rng.multinomial(
            big, [0.4, 0.3, 0.2, 0.1]), 128), 4, 1, 1, 64, 64),
        ("general S=535 (W 8.8 MB)", None, 0, 0, general(rng.multinomial(
            big, skew / skew.sum()), 128), 535, 1, 1, 64, 64),
        ("edge: empty segment", None, 0, 0, general((40, 0, 17, 0), 8), 4,
         2, 1, 8, 3),
        ("edge: one segment", None, 0, 0, general((300,), 8), 1, 1, 1, 64,
         64),
        ("edge: K=1", None, 0, 0, general((50, 0, 900), 8), 3, 1, 1, 1, 64),
        ("edge: O=1", None, 0, 0, general((50, 0, 900), 8), 3, 2, 1, 8, 1),
        ("edge: per-head x", None, 0, 0, general((500, 0, 700), 8), 3, 4, 4,
         16, 5),
        # 300 segments of 0-19 rows: tiles and warps across many segments
        ("edge: short segments, C=68", None, 0, 0, general(
            [i * 7 % 20 for i in range(300)], 1), 300, 4, 1, 64, 17),
        ("edge: short segments, C=12", None, 0, 0, general(
            [i * 7 % 20 for i in range(300)], 1), 300, 4, 1, 64, 3),
        ("edge: C=200, three column passes", None, 0, 0,
         general((3000, 0, 900), 1), 3, 2, 1, 64, 100),
        ("edge: K=63, C=68", None, 0, 0, general((3000, 0, 900), 1), 3, 4,
         1, 63, 17),
        ("edge: K=63, C=4", None, 0, 0, general((3000, 0, 900), 1), 3, 4, 1,
         63, 1),
        ("edge: K=130, C=4, three k tiles", None, 0, 0,
         general((3000, 0, 900), 1), 3, 4, 1, 130, 1),
        ("edge: per-head x, K=100, two k tiles", None, 0, 0,
         general((3000, 0, 900), 1), 3, 2, 2, 100, 3),
        # the dX's reduction R (H*O, or O a head) and output (K) axes
        ("edge: dX R=16", None, 0, 0, general((3000, 0, 900), 1), 3, 4, 1,
         64, 4),
        ("edge: dX R=17, 4-byte ct loads", None, 0, 0,
         general((3000, 0, 900), 1), 3, 1, 1, 64, 17),
        ("edge: dX R=3, a ct row of 12 bytes", None, 0, 0,
         general((3000, 0, 900), 1), 3, 1, 1, 64, 3),
        ("edge: dX per-head K=17, wide output", None, 0, 0,
         general((3000, 0, 900), 1), 3, 4, 4, 17, 5),
        ("edge: one tile", None, 0, 0, general((16, 16, 16, 16), 1), 4, 4, 1,
         64, 1),
    ]
    for H, O in ((4, 17), (4, 1)):
        shapes += [
            (f"edge: NaN rows outside the segments, C={H * O}", None, 0, 0,
             dataclasses.replace(_shifted(_segments((3000, 0, 1500, 9), 1,
                                                    dev), 37),
                                 seg_ptrs_static=None), 4, H, 1, 64, O,
             "nan_outside"),
            (f"edge: operand not 16-byte aligned, C={H * O}", None, 0, 0,
             general((2000, 33, 0, 900), 8), 4, H, 1, 64, O, "unaligned"),
        ]
    for shape in shapes:
        assert shape[4].seg_ptrs_static is None, shape[0]
    return shapes


def _bare_cublas(direction, a, w, ptrs, Hx):
    """The yardstick of the forward (``direction`` "fwd") or the dX: one
    ``torch.mm`` into the output's rows a non-empty segment, on offsets
    ``ptrs`` read on the host and W laid out beforehand as (S, Hx*K, H*O)
    (forward) or (S, H*O, Hx*K) (dX), block-diagonal over the heads where
    x has one row a head; the rows outside the segments are zeroed.  The
    port never calls it.  Returns the function to time."""
    import torch

    S, H, K, O = w.shape
    if Hx == 1:  # (S, K, H*O): column h*O + o of row k is W[s, h, k, o]
        w_cat = w.permute(0, 2, 1, 3).reshape(S, K, H * O)
    else:
        w_cat = torch.stack([torch.block_diag(*w[s]) for s in range(S)])
    if direction == "dx":
        w_cat = w_cat.transpose(1, 2)
    w_cat = w_cat.contiguous()
    segs = [(s, ptrs[s], ptrs[s + 1]) for s in range(S)
            if ptrs[s + 1] > ptrs[s]]
    width = w_cat.shape[2]

    def run():
        out = torch.empty(a.shape[0], width, device=a.device)
        out[:ptrs[0]] = 0.0
        out[ptrs[-1]:] = 0.0
        for s, lo, hi in segs:
            torch.mm(a[lo:hi], w_cat[s], out=out[lo:hi])
        return out

    return run


def check_fwd_dx(shards, dev, flush, g):
    """segment_matmul_fwd and segment_matmul_dx against their plain
    versions at every shape, within |kernel - plain| <= MM_TOL * sum |x|
    |W| (the plain version on absolute values), with the control that the
    plain version on TF32-rounded inputs fails that limit wherever there
    are rows; per-shape times beside two yardsticks on host-known
    offsets: bare per-relation cuBLAS (:func:`_bare_cublas`) and the plain
    version (per-relation ``torch.matmul`` with its zero fill and copies,
    without the host read of ``seg_ptrs``).  Returns both kernels' JSON
    entries."""
    import dataclasses

    import torch
    from het_tpu_torch.ops.kernels import (segment_matmul_dx,
                                           segment_matmul_dx_plain,
                                           segment_matmul_fwd,
                                           segment_matmul_fwd_plain)
    from het_tpu_torch.ops.kernels.segment_mm import host_seg_ptrs

    print(f"segment_matmul_fwd/_dx vs plain tolerance: |kernel - plain| <= "
          f"{MM_TOL} * sum|x|*|W|; 'share' is the largest |diff| / limit")
    print("direction | shape | run | S | rows | H | Hx | K | O | kernel share"
          " | TF32 control share | kernel ms | bound ms | plain ms | "
          "plain on host offsets ms | bare per-relation cuBLAS ms")
    gen = torch.Generator(device=dev).manual_seed(3)
    kernels = {"fwd": (segment_matmul_fwd, segment_matmul_fwd_plain),
               "dx": (segment_matmul_dx, segment_matmul_dx_plain)}
    totals = {"fwd": {}, "dx": {}}
    max_err = {"fwd": 0.0, "dx": 0.0}
    shapes = _mm_shapes(shards, dev, g)
    for i, name in ((2, "segment_matmul_fwd"), (3, "segment_matmul_dx")):
        counts = dict.fromkeys(list(DP_RUNS) + list(COMPILED_RUNS), 0)
        for shape in shapes:
            for run in _runs_of(shape[1]):
                counts[run] += shape[i]
        _check_shape_count(name, counts)
    for (label, run, n_fwd, n_dx, seg, S, H, Hx, K, O, *form) in shapes:
        n = seg.n_rows
        w = torch.randn(S, H, K, O, device=dev, generator=gen) / math.sqrt(K)
        # the yardstick's offsets, read on the host once beforehand
        static = dataclasses.replace(seg, seg_ptrs_static=host_seg_ptrs(seg))
        for direction, per_step in (("fwd", n_fwd), ("dx", n_dx)):
            fn, plain_fn = kernels[direction]
            width = Hx * K if direction == "fwd" else H * O
            if form == ["unaligned"]:  # a contiguous view one float in
                a = torch.randn(n * width + 1, device=dev,
                                generator=gen)[1:].view(n, width)
                assert a.data_ptr() % 16 != 0, label
            else:
                a = torch.randn(n, width, device=dev, generator=gen)
            if form == ["nan_outside"]:  # rows no segment holds, and more
                first = static.seg_ptrs_static[0]
                a = torch.cat([a, torch.randn(45, width, device=dev)])
                a[:first] = float("nan")
                a[n:] = float("nan")
            extra = () if direction == "fwd" else (Hx,)
            got = fn(a, w, seg, *extra)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{direction} {label}: not finite")
            if not torch.equal(got, fn(a, w, seg, *extra)):
                raise AssertionError(f"{direction} {label}: two calls "
                                     f"differ")
            want = plain_fn(a, w, seg, *extra)
            limit = MM_TOL * plain_fn(a.abs(), w.abs(), seg, *extra)
            if got.shape != want.shape:
                raise AssertionError(f"{direction} {label}: shape "
                                     f"{tuple(got.shape)} vs "
                                     f"{tuple(want.shape)}")
            err = (got - want).abs()
            share = _worst_share(err, limit)
            if share > 1.0:
                raise AssertionError(
                    f"{direction} {label}: kernel differs from plain by "
                    f"{err.max().item()}, {share} times the limit")
            control = _worst_share((plain_fn(_tf32(a), _tf32(w), seg, *extra)
                                    - want).abs(), limit)
            if limit.max().item() > 0 and not control > 1.0:
                raise AssertionError(
                    f"{direction} {label}: a TF32-input product stays within"
                    f" the limit ({control} of it)")
            max_err[direction] = max(max_err[direction],
                                     err.max().item() if err.numel() else 0.0)
            nbytes = n * (Hx * K + H * O) * 4 + S * H * K * O * 4 + (S + 1) * 4
            bytes_s = nbytes / HBM_BYTES_PER_S
            ops_s = 2 * n * H * K * O / F32_FLOP_PER_S
            bound = max(bytes_s, ops_s)
            ms = _time_ms(lambda: fn(a, w, seg, *extra), 20, flush)
            plain = _time_ms(lambda: plain_fn(a, w, seg, *extra), 5, flush)
            host_ms = _time_ms(lambda: plain_fn(a, w, static, *extra), 5,
                               flush)
            bare = _bare_cublas(direction, a, w, static.seg_ptrs_static, Hx)
            if _worst_share((bare().view(want.shape) - want).abs(),
                            limit) > 1.0:
                raise AssertionError(f"{direction} {label}: bare cuBLAS "
                                     f"differs from plain")
            bare_ms = _time_ms(bare, 5, flush)
            print(f"{direction} | {label} | {run} | {S} | {n} | {H} | {Hx} |"
                  f" {K} | {O} | {share:.4g} | {control:.4g} | {ms:.4f} | "
                  f"{bound * 1e3:.4f} "
                  f"({'bytes' if bytes_s >= ops_s else 'operations'}) | "
                  f"{plain:.4f} | {host_ms:.4f} | {bare_ms:.4f}")
            for r in _runs_of(run):
                total = totals[direction].setdefault(r, dict(
                    ms=0.0, plain_ms=0.0, bound_ms=0.0, bare_cublas_ms=0.0,
                    plain_host_offsets_ms=0.0, bytes_ms=0.0, ops_ms=0.0))
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("bound_ms", bound * 1e3),
                               ("bare_cublas_ms", bare_ms),
                               ("plain_host_offsets_ms", host_ms),
                               ("bytes_ms", bytes_s * 1e3),
                               ("ops_ms", ops_s * 1e3)):
                    total[key] += per_step * v
    entries = []
    for direction, name, replaces in (
            ("fwd", "segment_matmul_fwd",
             "het_tpu/ops/pallas/segment_mm.py:131,220"),
            ("dx", "segment_matmul_dx",
             "het_tpu/ops/pallas/segment_mm.py:324,478")):
        for run, total in totals[direction].items():
            print(f"[{run}] {name} per-step totals, rank 0 (ms):",
                  json.dumps(total))
        total = totals[direction][DP_MAIN]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "het_tpu_torch/csrc/segment_mm.cu",
            "replaces": replaces,
            "launches": None,  # filled from the data-parallel run
            "max_abs_err": max_err[direction],
            "ms": total["ms"],
            "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                         else "operations"),
            "library_ms": None,  # no single PyTorch call: no f32 grouped GEMM
            "yardstick_ms": total["bare_cublas_ms"],
            "yardstick": "bare per-relation torch.mm (cuBLAS) on host-known "
                         "offsets",
            "plain_host_offsets_ms": total["plain_host_offsets_ms"],
            "per_run": totals[direction],
        })
    return entries


# ------------------------------------------------------- data parallel


def _dp_features(g, seed=0):
    """Fixed node features and labels, as the data-parallel dry run has
    them: features from a numpy seed, every real node labelled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.standard_normal((g.num_nodes, IN_FEAT)).astype(np.float32)


def _ntype_offsets(info):
    """Two node types whose boundary falls in the middle of shard 0's
    destination range (the edge-balanced bounds do not depend on the node
    types): the offsets of the ``ntypes`` runs' graphs."""
    lo, hi = info.bounds[0], info.bounds[1]
    return (0, lo + (hi - lo) // 2, info.num_global_nodes)


def _coo(g):
    E = g.num_edges
    return [t[:E].numpy() for t in (g.src, g.dst, g.rel)]


def partition_dp(data):
    """Each data-parallel run's partition of the graph: P shards by
    destination ranges balanced on edges, one partition for the runs that
    share its compact rows, halo and node types.  Returns {run: (shards,
    info)}."""
    from het_tpu_torch.parallel import halo_bytes, partition_by_dst

    g = data.graph
    coo = _coo(g)
    out, made = {}, {}
    for run, spec in DP_RUNS.items():
        compact, halo, ntypes = spec["compact"], spec["halo"], spec["ntypes"]
        key = compact, halo, ntypes
        if key in made:
            out[run] = made[key]
            print(f"[{run}] the partition of {out[run][2]}")
            continue
        offsets = None
        if ntypes:  # the bounds of the first partition made
            offsets = _ntype_offsets(next(iter(made.values()))[1])
        t0 = time.perf_counter()
        shards, info = partition_by_dst(
            *coo, g.num_nodes, g.num_rels, P, tile=g.edge_rel_seg.tile,
            build_compact=compact, balance="edges", halo=halo,
            ntype_offsets=offsets)
        hb = halo_bytes(shards[0], P, IN_FEAT)
        if ntypes:
            print(f"[{run}] node types at {offsets}: the boundary "
                  f"{offsets[1]} inside shard 0's destinations, bounds "
                  f"{info.bounds}")
            assert info.bounds[0] < offsets[1] < info.bounds[1]
            assert _ntype_offsets(info) == offsets
        print(f"[{run}] partitioned in {time.perf_counter() - t0:.1f} s: "
              f"halo={halo} -> {hb['mode']} ({hb['bytes']} B a rank receives "
              f"for a {IN_FEAT}-wide layer; all-gather {hb['gather_bytes']} "
              f"B), bounds {info.bounds}, nodes_per_part "
              f"{info.nodes_per_part}, per shard: real edges "
              f"{[int((s.dst < s.num_nodes).sum()) for s in shards]}, "
              f"padded {shards[0].num_padded_edges}, src_space "
              f"{shards[0].src_space}, edge rows "
              f"{shards[0].edge_rel_seg.n_rows}"
              + (f", compact rows src {shards[0].compact_src.seg.n_rows} dst"
                 f" {shards[0].compact_dst.seg.n_rows}" if compact else ""))
        out[run] = made[key] = (shards, info, run)
    return {run: part[:2] for run, part in out.items()}


def _dp_model(spec, g):
    """The family and keyword arguments of a ``DP_RUNS`` entry's model on
    ``g`` (the graph whose node types it reads)."""
    from het_tpu_torch.parallel.launch import MODELS

    if spec["model"] == "RGCN":
        kw = dict(num_nodes=g.num_nodes, hidden=HIDDEN, num_classes=CLASSES,
                  num_rels=g.num_rels, featureless=False, in_feat=IN_FEAT,
                  compact=spec["compact"], dropout=0.0)
    elif spec["model"] == "HGT":
        kw = dict(in_dim=IN_FEAT, hidden=HIDDEN, num_classes=CLASSES,
                  num_ntypes=g.num_ntypes, num_rels=g.num_rels,
                  num_heads=HEADS, num_layers=LAYERS,
                  compact=spec["compact"], dropout=0.0,
                  stable_softmax=spec["stable"])
    else:
        kw = dict(in_feat=IN_FEAT, hidden=HIDDEN, num_classes=CLASSES,
                  num_rels=g.num_rels, num_heads=HEADS, num_layers=LAYERS,
                  compact=spec["compact"],
                  multiply_first=spec["multiply_first"], dropout=0.0,
                  stable_softmax=spec["stable"])
    return MODELS[spec["model"]], kw


def _print_dp_profile(prof, card):
    """The profiled DP step's split (``utils/profile_step.py::
    profile_dp``): collectives, the card's work by category, the rest."""
    coll = sum(prof["collective_ms"].values())
    busy = prof["device_busy_ms"]
    copies = prof["device_ms_by_category"].get("copies", 0.0)
    step = prof["step_ms"]
    wait = prof["collective_wait_ms"]
    print(f"[{DP_MAIN}] profiled warm step, rank 0 of {P} sharing one card "
          f"over gloo ({card}): {step:.2f} ms (traced {prof['traced_step_ms']}"
          f", untraced warm {prof['untraced_warm_step_ms']}); collectives "
          f"{coll:.2f} ms ({100 * coll / step:.1f}%: "
          + ", ".join(f"{k} {v:.2f} ms in {prof['collective_calls'][k]} "
                      "calls" for k, v in prof["collective_ms"].items())
          + f"); waiting for the peer at them {wait:.2f} ms "
          f"({100 * wait / step:.1f}%); the card's work outside them "
          f"{busy - copies:.2f} ms "
          f"({100 * (busy - copies) / step:.1f}%); gloo's host <-> card "
          f"copies {copies:.2f} ms; the rest {prof['rest_ms']:.2f} ms "
          f"({100 * prof['rest_ms'] / step:.1f}%)")
    print("category | device ms a step")
    for cat, ms in sorted(prof["device_ms_by_category"].items(),
                          key=lambda kv: -kv[1]):
        print(f"{cat} | {ms:.4f}")
    print(f"[{DP_MAIN}] profile:", json.dumps(prof))
    if not busy > 0 or not coll > 0:
        raise AssertionError(f"{DP_MAIN} profile: busy {busy} ms, "
                             f"collectives {coll} ms")


def check_dp(data, parts, dev, card):
    """Every DP_RUNS entry on P spawned ranks sharing cuda:0 (gloo),
    through the kernels and through the plain versions from the same
    seeded parameters, each against a single-process run of the port's
    model on the unpartitioned graph (the ``ntypes`` runs' graph built
    with their node types); then, in the same spawn, ``DP_MAIN`` through
    the kernels with rank 0 profiled (``profile_dp``), whose split is
    printed; then ``entry.dryrun_multichip``'s jobs on P ranks
    (:func:`check_dryrun`) and ``bench.scaling``'s at its smallest form.
    Returns {run: rank 0's launches}."""
    import tempfile

    import torch
    from het_tpu_torch.bench import scaling
    from het_tpu_torch.entry import dryrun_jobs
    from het_tpu_torch.graph import build_heterograph
    from het_tpu_torch.ops.kernels import KERNELS
    from het_tpu_torch.parallel import train_full
    from het_tpu_torch.parallel.launch import spawn_ranks
    from het_tpu_torch.utils.profile_step import STEPS as PROFILE_STEPS

    g = data.graph
    x = _dp_features(g)
    labels = data.labels
    jobs, singles = [], {}
    for run, spec in DP_RUNS.items():
        shards, info = parts[run]
        steps = spec["steps"]
        gr = g
        if spec["ntypes"]:
            gr = build_heterograph(*_coo(g), g.num_nodes, g.num_rels,
                                   tile=g.edge_rel_seg.tile,
                                   ntype_offsets=_ntype_offsets(info),
                                   build_compact=True)
            print(f"[{run}] single-process graph at node types "
                  f"{_ntype_offsets(info)}: {gr.describe()}")
        family, kw = _dp_model(spec, gr)
        state = _initial_state(family(**kw))
        model = family(**kw)
        model.load_state_dict(state)
        single = train_full(model.to(dev).train(), gr.to(dev),
                            torch.from_numpy(x).to(dev),
                            torch.as_tensor(labels).to(dev), steps=steps)
        singles[run] = single["loss_list"]
        print(f"[{run}] single process, unpartitioned ({card}): "
              f"{json.dumps(single)}")
        del model, gr
        for impl in ("kernel", "plain"):
            jobs.append(dict(shards=shards, nodes_per_part=info.nodes_per_part,
                             x=info.pad_node_data(x),
                             labels=info.pad_node_data(labels, fill=-1),
                             family=spec["model"], model=kw, state=state,
                             steps=steps, lr=1e-2, impl=impl))
    # DP_MAIN (the first run, kernels first) again, rank 0 profiled
    assert next(iter(DP_RUNS)) == DP_MAIN and jobs[0]["impl"] == "kernel"
    jobs.append(dict(jobs[0], profile=True))
    n_dp = len(jobs)
    dry_jobs, dry_meta = dryrun_jobs(P)
    scale_jobs, scale_meta = scaling.scaling_jobs(
        SCALING_RANKS, SCALING_SCALE, steps=SCALING_STEPS)
    assert scale_meta["world"] <= P
    jobs += dry_jobs + scale_jobs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        results = spawn_ranks(P, jobs, workdir=workdir, device="cuda")
    print(f"data-parallel ranks ran in {time.perf_counter() - t0:.1f} s")
    launches = check_dryrun(P, dry_jobs, dry_meta, [
        r[n_dp:n_dp + len(dry_jobs)] for r in results], card)
    res = scaling.summarize(scale_jobs, results[0][n_dp + len(dry_jobs):],
                            scale_meta, torch.device("cuda"))
    if [r["world"] for r in res["results"]] != list(SCALING_RANKS) or \
            res["note"] != scaling.SHARED:
        raise AssertionError(f"bench.scaling: {json.dumps(res)}")
    print(f"bench.scaling ({card}): " + ", ".join(
        f"world {r['world']} {r['step_ms']:.2f} ms (median "
        f"{r['median_step_ms']:.2f}), {r['edges_per_s']:.4g} edges/s, "
        f"efficiency {r['scaling_efficiency']:.3f}, kernel vs plain "
        f"{r['kernel_vs_plain_max_rel']:.3g}" for r in res["results"])
          + f"; {res['note']}")
    i = 0
    for run, spec in DP_RUNS.items():
        compact, steps = spec["compact"], spec["steps"]
        want = {k: spec["launches"].get(k, 0) * steps for k in KERNELS}
        runs = {}
        for impl in ("kernel", "plain"):
            runs[impl] = [results[rank][i] for rank in range(P)]
            i += 1
        for impl, ranks in runs.items():
            for rank, m in enumerate(ranks):
                losses = m["loss_list"]
                if len(losses) != steps or not all(map(math.isfinite,
                                                       losses)):
                    raise AssertionError(f"{run} {impl} rank {rank}: losses "
                                         f"{losses}")
                if steps == STEPS and not losses[-1] < losses[0]:
                    raise AssertionError(f"{run} {impl} rank {rank}: loss "
                                         f"did not fall: {losses}")
                for step, (a, b) in enumerate(zip(losses, singles[run])):
                    if abs(a - b) > TRAIN_RTOL * abs(b):
                        raise AssertionError(
                            f"{run} {impl} rank {rank} step {step}: loss {a}"
                            f" vs single process {b} (rtol {TRAIN_RTOL})")
                expect = want if impl == "kernel" else dict.fromkeys(want, 0)
                if m["launches"] != expect:
                    raise AssertionError(f"{run} {impl} rank {rank}: "
                                         f"launched {m['launches']}, expected"
                                         f" {expect}")
                if m["backend"] != "gloo" or m["device"] != "cuda:0":
                    raise AssertionError(f"{run}: rank {rank} ran on "
                                         f"{m['device']} with {m['backend']}")
                if spec["ntypes"] and not m["device_only"]["ntype_seg"]:
                    raise AssertionError(f"{run} rank {rank}: ntype_seg kept "
                                         "its host offsets")
        for step, (a, b) in enumerate(zip(runs["kernel"][0]["loss_list"],
                                          runs["plain"][0]["loss_list"])):
            if abs(a - b) > TRAIN_RTOL * abs(b):
                raise AssertionError(f"{run} step {step}: kernel loss {a} vs"
                                     f" plain {b} (rtol {TRAIN_RTOL})")
        keys = ["compact_src", "compact_dst"] if compact else ["edge_rel_seg"]
        if not any(m["device_only"][k] for m in runs["kernel"] for k in keys):
            raise AssertionError(f"{run}: every shard kept host offsets; the "
                                 "segment-matmul kernels were not reached")
        summary = {impl: [{
            "rank": rank, "losses": m["loss_list"], "step_ms": m["step_ms_list"],
            "median_warm_step_ms": statistics.median(m["step_ms_list"][1:]),
            "launches": m["launches"], "peak_mem_gb": m["peak_mem_gb"],
            "device_only_offsets": m["device_only"]}
            for rank, m in enumerate(ranks)] for impl, ranks in runs.items()}
        summary["single_process_losses"] = singles[run]
        print(f"training {run}, {P} ranks sharing one card over gloo "
              f"(step times of ranks that share a card are not scaling "
              f"figures; {card}):", json.dumps(summary))
        launches[run] = runs["kernel"][0]["launches"]
    # ntype_linear past the node-type boundary: kernels 4, 6 and 7 beyond
    # compact HGT's, a step
    for k, n in NTYPE_LINEAR.items():
        per = DP_RUNS["dp_hgt_ntypes"]["steps"]
        extra = (launches["dp_hgt_ntypes"][k] / per
                 - launches["dp_hgt_compact"][k] / DP_RUNS["dp_hgt_compact"]
                 ["steps"])
        if extra != n:
            raise AssertionError(f"dp_hgt_ntypes: ntype_linear launched "
                                 f"{extra} {k} a step, expected {n}")
    print(f"dp_hgt_ntypes: ntype_linear a step on the kernels: "
          f"{json.dumps(NTYPE_LINEAR)}")
    prof = results[0][i]
    want = {k: DP_RUNS[DP_MAIN]["launches"].get(k, 0) * PROFILE_STEPS
            for k in KERNELS}
    if prof["launches"] != want:
        raise AssertionError(f"{DP_MAIN} profiled: launched "
                             f"{prof['launches']}, expected {want}")
    _print_dp_profile(prof["profile"], card)
    return launches


def check_dryrun(n, jobs, meta, results, card):
    """``entry.dryrun_multichip``'s results on ``n`` ranks, every rank on
    cuda:0 over gloo (``results[rank][i]`` for ``jobs[i]``): every loss
    finite and the kernels' within ``TRAIN_RTOL`` of the plain versions'
    at each step (``entry.dryrun_check`` raises otherwise), each rank's
    launches ``DRYRUN_LAUNCHES`` a step and, on the mesh, each rank's
    coordinates.  Returns {run: rank 0's launches}."""
    from het_tpu_torch.entry import dryrun_check, dryrun_mesh

    res = dryrun_check(n, jobs, meta, results)
    mesh = dryrun_mesh(n)
    coords = ([(p // mesh[1], p % mesh[1]) for p in range(n)] if mesh
              else [None] * n)
    if res["coords"] != coords or res["mesh"] != mesh:
        raise AssertionError(f"dryrun_multichip({n}): mesh {res['mesh']},"
                             f" coordinates {res['coords']}")
    if res["backend"] != "gloo" or res["device"] != "cuda:0":
        raise AssertionError(f"dryrun_multichip({n}): {res['device']} "
                             f"with {res['backend']}")
    steps = jobs[0]["steps"]
    for rank, counts in enumerate(res["launches"]):
        want = {k: DRYRUN_LAUNCHES.get(k, 0) * steps for k in counts}
        if counts != want:
            raise AssertionError(f"dryrun_multichip({n}) rank {rank}: "
                                 f"launched {counts}, expected {want}")
    print(f"dryrun_multichip({n}) ({card}): losses {res['losses']} (plain "
          f"{res['plain_losses']}), mesh {res['mesh']}, coordinates "
          f"{res['coords']}, launches a rank "
          f"{json.dumps(res['launches'][0])}, halo {json.dumps(res['halo'])}")
    return {f"dryrun_multichip_{n}": res["launches"][0]}


def check_dryruns(card):
    """``entry.dryrun_multichip`` on each of ``DRYRUN_RANKS`` past P (4:
    the 2 x 2 mesh), spawning its ranks, held by :func:`check_dryrun`
    (the P-rank run joins :func:`check_dp`'s spawn).  Returns {run: rank
    0's launches}."""
    import tempfile

    from het_tpu_torch.entry import dryrun_jobs
    from het_tpu_torch.parallel.launch import spawn_ranks

    out = {}
    for n in DRYRUN_RANKS:
        if n == P:
            continue
        t0 = time.perf_counter()
        jobs, meta = dryrun_jobs(n)
        with tempfile.TemporaryDirectory() as workdir:
            results = spawn_ranks(n, jobs, workdir=workdir, device="cuda")
        out.update(check_dryrun(n, jobs, meta, results, card))
        print(f"dryrun_multichip({n}): {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ training


class _PackedCalls:
    """Counts the model's calls of the packed-form fused op while in its
    ``with`` block, so that a run can show which form it took."""

    def __enter__(self):
        from het_tpu_torch import ops

        self.ops, self.orig, self.calls = ops, \
            ops.relational_fused_gat_compact_packed, 0

        def counted(*args, **kw):
            self.calls += 1
            return self.orig(*args, **kw)

        ops.relational_fused_gat_compact_packed = counted
        return self

    def __exit__(self, *exc):
        self.ops.relational_fused_gat_compact_packed = self.orig


def _config(r, dev, steps):
    """The trainer's configuration of run ``r`` (a ``RUNS`` value):
    ``WARMUP`` untimed steps, then ``steps`` timed ones."""
    from het_tpu_torch.train import TrainConfig

    return TrainConfig(
        model=r["model"], dataset=r["dataset"], dataset_scale=r["scale"],
        n_infeat=r["in_feat"], hidden=HIDDEN, num_classes=r["classes"],
        num_heads=HEADS, num_layers=LAYERS, compact=r["compact"],
        compact_union=r["union"], multiply_first=r["multiply_first"],
        dropout=0.0, stable_softmax=r["stable"], num_epochs=steps,
        warmup_epochs=WARMUP, device=str(dev),
    )


def _check_losses(run, impl, losses, steps, falling):
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{run} {impl}: losses {losses}")
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"{run} {impl}: loss did not fall: {losses}")


def _check_packed(run, r, calls, steps):
    """Dual-list compact multiply-first (``r`` a ``RUNS`` value) took the
    packed form on every layer of every forward (``steps`` counting the
    warm-up and the accuracy pass); any other branch never took it."""
    packed = r["compact"] and r["multiply_first"] and not r["union"]
    want = LAYERS * steps if packed else 0
    if calls != want:
        raise AssertionError(f"{run}: the packed form was taken {calls} "
                             f"times, expected {want}")


def _check_agreement(run, runs, what="step"):
    """The kernel run's losses (``runs["kernel"]``) within TRAIN_RTOL of
    the plain versions' at every ``what``, and the plain run launched no
    kernel."""
    k, p = runs["kernel"], runs["plain"]
    for step, (a, b) in enumerate(zip(k["loss_list"], p["loss_list"])):
        if abs(a - b) > TRAIN_RTOL * abs(b):
            raise AssertionError(
                f"{run} {what} {step}: kernel loss {a} vs plain {b} "
                f"(rtol {TRAIN_RTOL})")
    if any(p["launches"].values()):
        raise AssertionError(f"{run}: plain run launched {p['launches']}")


def check_training(data, dev, card, run):
    """One ``RUNS`` entry through the kernels and through the plain
    versions from the same parameters.  Returns the kernel run's launches
    of each kernel and the summary printed."""
    import torch
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train import build_model, train

    steps = RUNS[run]["steps"]
    cfg = _config(RUNS[run], dev, steps)
    state = _initial_state(build_model(cfg, data))
    runs = {}
    for impl in ("kernel", "plain"):
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        with _PackedCalls() as packed:
            m = train(cfg, data, state=state, impl=impl,
                      log=lambda s, i=impl: print(f"[{run} {i}] {s}"))
        m["launches"] = kernels.launch_counts()
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        _check_packed(run, RUNS[run], packed.calls, WARMUP + steps + 1)
        runs[impl] = m
    for impl, m in runs.items():
        _check_losses(run, impl, m["loss_list"], steps, steps == STEPS)
    _check_agreement(run, runs)
    want = _train_launches(RUNS[run], steps)
    if runs["kernel"]["launches"] != want:
        raise AssertionError(f"{run}: kernel run launched "
                             f"{runs['kernel']['launches']}, expected {want}")
    summary = {impl: _run_summary(m, data.graph.num_edges)
               for impl, m in runs.items()}
    print(f"training {run} ({card}):", json.dumps(summary))
    return runs["kernel"]["launches"], summary


# ------------------------------------------------------------- compiled


def _compiled_config(r, dev, steps, *, compiler=True):
    """The trainer's configuration of compiled run ``r`` (a
    ``COMPILED_RUNS`` value): H = 1 (the DSL has no head axis) and the
    raw softmax; with ``compiler=False`` the hand-written model on the
    same graph, flags, heads and softmax."""
    return dataclasses.replace(_config(r, dev, steps), num_heads=1,
                               stable_softmax="raw", use_compiler=compiler)


def _compiled_train(cfg, data, dev, r, impl, label):
    """One ``train`` call of compiled run ``r``'s model (its GEMM specs
    flipped to ``r["strategy"]``) from ``_initial_state``'s parameters,
    with its kernel launches and peak memory."""
    import torch
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train import build_model, train

    net = build_model(cfg, data, impl=impl)
    if r["strategy"] != "host_offsets":
        net.model.reschedule(strategy=r["strategy"])
    net.load_state_dict(_initial_state(net))
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    m = train(cfg, data, impl=impl, net=net,
              log=lambda s: print(f"[{label} {impl}] {s}"))
    m["launches"] = kernels.launch_counts()
    m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return m


def _run_summary(m, E):
    warm = statistics.median(m["step_ms_list"][1:])
    return {"losses": m["loss_list"], "step_ms": m["step_ms_list"],
            "median_warm_step_ms": warm, "edges_per_s": E / (warm / 1e3),
            "launches": m["launches"], "peak_mem_gb": m["peak_mem_gb"],
            **{key: m[key] for key in REPORT_KEYS}}


def check_compiled(data, dev, card, run, summaries, *, r=None, name=None):
    """Compiled run ``run`` (``r``, a ``COMPILED_RUNS`` value, as ``name``)
    through the kernels and, where ``r["plain"]``, the plain versions from
    the same seeded parameters: finite losses (falling over STEPS steps),
    per-step agreement within TRAIN_RTOL, every kernel's launches; a run
    with ``same_as`` held per step to that run's kernel losses
    (``summaries``).  Then the hand-written model at H = 1 on the same
    graph and flags (its branch's launches asserted) for the step-time
    ratio.  Returns the kernel run's launches and the summary printed."""
    r = r or COMPILED_RUNS[run]
    name = name or run
    steps = r["steps"]
    E = data.graph.num_edges
    cfg = _compiled_config(r, dev, steps)
    runs = {impl: _compiled_train(cfg, data, dev, r, impl, name)
            for impl in (("kernel", "plain") if r["plain"] else ("kernel",))}
    for impl, m in runs.items():
        _check_losses(name, impl, m["loss_list"], steps, steps == STEPS)
    if "plain" in runs:
        _check_agreement(name, runs)
    if r["same_as"] is not None:
        _check_agreement(name, {"kernel": runs["kernel"], "plain": {
            "loss_list": summaries[r["same_as"]]["kernel"]["losses"],
            "launches": {}}}, "step against " + r["same_as"])
    want = _train_launches(r, steps)
    if runs["kernel"]["launches"] != want:
        raise AssertionError(f"{name}: kernel run launched "
                             f"{runs['kernel']['launches']}, expected {want}")
    # the hand-written model at H = 1, its branch's launches a step
    import torch
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train import train

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    hm = train(_compiled_config(r, dev, steps, compiler=False), data,
               log=lambda s: print(f"[{name} hand-written H=1] {s}"))
    hm["launches"] = kernels.launch_counts()
    hm["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    _check_losses(name + " hand-written", "kernel", hm["loss_list"], steps,
                  False)
    hw_want = _train_launches(dict(RUNS[r["base"]], stable="raw"), steps)
    if hm["launches"] != hw_want:
        raise AssertionError(f"{name} hand-written H=1: launched "
                             f"{hm['launches']}, expected {hw_want}")
    summary = {impl: _run_summary(m, E) for impl, m in runs.items()}
    summary["launches_a_step"] = r["launches"]
    summary["strategy"] = r["strategy"]
    summary["handwritten_h1"] = _run_summary(hm, E)
    summary["compiled_over_handwritten"] = (
        summary["kernel"]["median_warm_step_ms"]
        / summary["handwritten_h1"]["median_warm_step_ms"])
    print(f"compiled {name} ({card}):", json.dumps(summary))
    print(f"compiled {name}: step {summary['kernel']['median_warm_step_ms']:.3f}"
          f" ms, hand-written H=1 "
          f"{summary['handwritten_h1']['median_warm_step_ms']:.3f} ms, "
          f"ratio {summary['compiled_over_handwritten']:.3f} ({card})")
    return runs["kernel"]["launches"], summary


# ------------------------------------------------- minibatch and link


def _mb_config(r, dev, batches, scale=SCALE):
    """The minibatch trainer's configuration of run ``r`` (an ``MB_RUNS``
    value): ``batches`` batches at het_tpu's sampling defaults."""
    from het_tpu_torch.train import TrainConfig

    return TrainConfig(
        model=r["model"], dataset="mag", dataset_scale=scale,
        n_infeat=IN_FEAT, hidden=HIDDEN, num_classes=CLASSES,
        num_heads=HEADS, num_layers=LAYERS, compact=r["compact"],
        multiply_first=r["multiply_first"], dropout=0.0,
        stable_softmax=r["stable"], num_epochs=10, max_batches=batches,
        batch_size=BATCH, fanout=FANOUT, num_hops=HOPS,
        full_graph_training=False, device=str(dev))


def _link_config(r, dev):
    """The link trainer's configuration of run ``r`` (a ``LINK_RUNS``
    value)."""
    from het_tpu_torch.train import TrainConfig

    return TrainConfig(
        model="RGAT", task="link", dataset="fb15k", dataset_scale=r["scale"],
        n_infeat=IN_FEAT, hidden=HIDDEN, num_heads=HEADS, num_layers=LAYERS,
        compact=r["compact"], multiply_first=r["multiply_first"],
        dropout=0.0, stable_softmax=r["stable"], num_epochs=r["steps"],
        device=str(dev))


def minibatch_inputs(data, run, dev, scale=SCALE):
    """The first batch ``run``'s trainer draws (the same seeds and sampler
    seed), on the card, and the shape of the table's gradient: its
    subgraph and [(label, rows, C, ptr, perm)]."""
    import numpy as np
    from het_tpu_torch.data.sampling import NeighborSampler
    from het_tpu_torch.train.minibatch import make_batch

    cfg = _mb_config(_spec(run), dev, 1, scale)
    g = data.graph
    E = g.num_edges
    sampler = NeighborSampler(g.src[:E].numpy(), g.dst[:E].numpy(),
                              g.rel[:E].numpy(), g.num_nodes, g.num_rels,
                              fanout=FANOUT, num_hops=HOPS, seed=cfg.seed)
    order = np.random.default_rng(cfg.seed).permutation(len(data.train_idx))
    batch = make_batch(sampler, data.train_idx[order[:BATCH]], cfg,
                       g.num_nodes, dev)
    sub = batch.graph
    print(f"[{run}] sampled batch: draw {batch.draw_ms:.1f} ms, build "
          f"{batch.build_ms:.1f} ms, copy {batch.copy_ms:.1f} ms; "
          f"{sub.describe()}")
    return sub, [("table gradient", batch.nodes.numel(), IN_FEAT, batch.ptr,
                  batch.perm)]


def link_inputs(data, dev):
    """The link runs' message graph on the card (with compact rows: the
    plain run reads none of them) and the shapes of DistMult's two
    gradients, the entity rows (positive and corrupted triples, one
    gather) and the relation rows."""
    import torch
    from het_tpu_torch.train.link import NEG_RATIO, message_graph, sort_ptr

    t0 = time.perf_counter()
    cfg = _link_config(LINK_RUNS["link_compact_multiply_first"], dev)
    g, triples = message_graph(data, cfg)
    print(f"[link] message graph built in {time.perf_counter() - t0:.1f} s: "
          f"{g.describe()}, relation-sorted edge rows "
          f"{g.edge_rel_seg.n_rows}")
    g = g.to(dev)
    s, r, o = (torch.from_numpy(a).long().to(dev) for a in triples)
    N, R = g.num_nodes, g.num_rels
    gen = torch.Generator(device=dev).manual_seed(0)
    neg_o = torch.randint(0, N, (s.numel() * NEG_RATIO,), device=dev,
                          generator=gen)
    ent = torch.cat([s, o, s.repeat_interleave(NEG_RATIO), neg_o])
    rel = torch.cat([r, r.repeat_interleave(NEG_RATIO)])
    return g, [("DistMult entity rows", ent.numel(), HIDDEN,
                *sort_ptr(ent, N)),
               ("DistMult relation rows", rel.numel(), HIDDEN,
                *sort_ptr(rel, R))]


def _mb_launches(r, batches, data):
    """Each kernel's launches in one minibatch run of ``r`` (an
    ``MB_RUNS`` value) with ``batches`` batches: their steps, then the
    accuracy passes (at most 32 batches of training seeds, every batch of
    the test split), a forward each."""
    from het_tpu_torch.ops.kernels import KERNELS
    from het_tpu_torch.train.minibatch import TRAIN_ACC_BATCHES

    evals = (min(TRAIN_ACC_BATCHES, -(-len(data.train_idx) // BATCH))
             + -(-len(data.test_idx) // BATCH))
    ev = _eval_launches(r)
    return {k: r["launches"].get(k, 0) * batches + ev.get(k, 0) * evals
            for k in KERNELS}


def _host_summary(m):
    """A minibatch run's host and device ms a batch (medians past the
    first batch), its seeds/s and host share."""
    tail = slice(1, None) if len(m["step_ms_list"]) > 1 else slice(None)
    host = [a + b + c for a, b, c in zip(
        m["sample_ms_list"], m["build_ms_list"], m["copy_ms_list"])]
    med = {key: statistics.median(m[key][tail]) for key in (
        "sample_ms_list", "build_ms_list", "copy_ms_list", "step_ms_list")}
    host_ms = statistics.median(host[tail])
    step = med["step_ms_list"]
    return {"median_draw_ms": med["sample_ms_list"],
            "median_build_ms": med["build_ms_list"],
            "median_copy_ms": med["copy_ms_list"],
            "median_step_ms": step, "median_host_ms": host_ms,
            "host_share": host_ms / (host_ms + step),
            "seeds_per_s_device": BATCH / (step / 1e3),
            "seeds_per_s_end_to_end": BATCH / ((host_ms + step) / 1e3)}


def check_minibatch(data, dev, card, run, *, scale=SCALE, name=None,
                    batches=None, plain=None):
    """One ``MB_RUNS`` entry through ``train_minibatch``: ``batches``
    batches through the kernels and, where the run says, through the
    plain versions (``plain``, the run's own choice by default) from the
    same seeded parameters and batches; finite
    losses, per-batch agreement within TRAIN_RTOL, every kernel's
    launches (steps and accuracy passes), accuracies in [0, 1].  Prints
    each batch's draw, build, copy and step ms and the run's summary
    (seeds/s, host share, peak memory).  Returns the kernel run's
    launches and the summary."""
    import torch
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train.minibatch import train_minibatch

    r = MB_RUNS[run]
    name = name or run
    batches = batches or r["steps"]
    cfg = _mb_config(r, dev, batches, scale)
    runs = {}
    plain = r["plain"] if plain is None else plain
    for impl in ("kernel", "plain") if plain else ("kernel",):
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        m = train_minibatch(cfg, data, impl=impl,
                            log=lambda s, i=impl: print(f"[{name} {i}] {s}"))
        m["launches"] = kernels.launch_counts()
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        runs[impl] = m
    for impl, m in runs.items():
        _check_losses(name, impl, m["loss_list"], batches, False)
        if not (0.0 <= m["train_acc"] <= 1.0 and 0.0 <= m["test_acc"] <= 1.0
                and m["embed_trained_delta"] > 0.0):
            raise AssertionError(f"{name} {impl}: report {m}")
    if "plain" in runs:
        _check_agreement(name, runs, "batch")
    want = _mb_launches(r, batches, data)
    if runs["kernel"]["launches"] != want:
        raise AssertionError(f"{name}: kernel run launched "
                             f"{runs['kernel']['launches']}, expected {want}")
    summary = {}
    for impl, m in runs.items():
        summary[impl] = {
            "losses": m["loss_list"], "step_ms": m["step_ms_list"],
            "draw_ms": m["sample_ms_list"], "build_ms": m["build_ms_list"],
            "copy_ms": m["copy_ms_list"],
            "seeds_per_s_end_to_end_list": [
                BATCH / ((a + b + c + t) / 1e3) for a, b, c, t in zip(
                    m["sample_ms_list"], m["build_ms_list"],
                    m["copy_ms_list"], m["step_ms_list"])],
            **_host_summary(m),
            "launches": m["launches"], "peak_mem_gb": m["peak_mem_gb"],
            **{key: m[key] for key in (
                "train_acc", "test_acc", "embed_trained_delta", "wall_s",
                "sample_wall_s", "mean_forward_time", "mean_backward_time",
                "mean_training_time", "max_memory_usage (mb)")}}
    print(f"training {name} ({card}):", json.dumps(summary))
    return runs["kernel"]["launches"], summary


def check_link(data, dev, card, run):
    """One ``LINK_RUNS`` entry through ``train_link``: its epochs through
    the kernels and, where the run says, through the plain versions from
    the same seeded parameters and negatives; finite losses (falling over
    STEPS epochs), per-epoch agreement within TRAIN_RTOL, every kernel's
    launches (the epochs and the ranking's forward).  Prints the losses,
    MRR, Hits@10, step ms and peak memory.  Returns the kernel run's
    launches and the summary."""
    import torch
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.ops.kernels import KERNELS
    from het_tpu_torch.train.link import train_link

    r = LINK_RUNS[run]
    cfg = _link_config(r, dev)
    runs = {}
    for impl in ("kernel", "plain") if r["plain"] else ("kernel",):
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        m = train_link(cfg, data, impl=impl,
                       log=lambda s, i=impl: print(f"[{run} {i}] {s}"))
        m["launches"] = kernels.launch_counts()
        m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        runs[impl] = m
    for impl, m in runs.items():
        _check_losses(run, impl, m["loss_list"], r["steps"],
                      r["steps"] == STEPS)
        if not (0.0 < m["mrr"] <= 1.0 and 0.0 <= m["hits@10"] <= 1.0):
            raise AssertionError(f"{run} {impl}: MRR {m['mrr']}, Hits@10 "
                                 f"{m['hits@10']}")
    if "plain" in runs:
        _check_agreement(run, runs, "epoch")
    ev = _eval_launches(r)
    want = {k: r["launches"].get(k, 0) * r["steps"] + ev.get(k, 0)
            for k in KERNELS}
    if runs["kernel"]["launches"] != want:
        raise AssertionError(f"{run}: kernel run launched "
                             f"{runs['kernel']['launches']}, expected {want}")
    E = data.graph.num_edges - runs["kernel"]["num_supervision_edges"]
    summary = {}
    for impl, m in runs.items():
        warm = statistics.median(m["step_ms_list"][1:])
        summary[impl] = {
            "losses": m["loss_list"], "step_ms": m["step_ms_list"],
            "median_warm_step_ms": warm,
            "message_edges_per_s": E / (warm / 1e3),
            "mrr": m["mrr"], "hits@10": m["hits@10"],
            "launches": m["launches"], "peak_mem_gb": m["peak_mem_gb"],
            "wall_s": m["wall_s"]}
    print(f"training {run} ({card}):", json.dumps(summary))
    return runs["kernel"]["launches"], summary


# ------------------------------------------------------------------ bf16

# bf16 mixed precision (--dtype bfloat16 --loss_scale dynamic): f32 master
# parameters and Adam state, the model run on bf16 copies of the
# parameters.  Each run mirrors an f32 run of RUNS (``f32``) and launches
# as it does: the dtype changes no launch.  The segment sums read bf16
# rows (het_tpu packs every payload in bf16, its ``pack_dt``) into f32
# sums, or into bf16 sums where het_tpu passes ``out_dt=pack_dt``
# (``_bf16_sum_pair``); plain RGAT's attention-vector dW reads bf16 x and
# ct, HGT's relation_pri dW stays f32 (its score and logit gradient are
# f32).  ``plain``: the run is repeated through the plain versions; the
# others run through the kernels only.
BF16_RUNS = {
    "bf16_compact_multiply_first": dict(f32="compact_multiply_first",
                                        steps=STEPS, plain=True, dw=None),
    "bf16_plain": dict(f32="plain", steps=SHORT_STEPS, plain=False,
                       dw="bf16"),
    "bf16_rgcn_compact": dict(f32="rgcn_compact", steps=SHORT_STEPS,
                              plain=False, dw=None),
    "bf16_hgt_compact": dict(f32="hgt_compact", steps=SHORT_STEPS,
                             plain=False, dw="f32"),
    "bf16_gat": dict(f32="gat", steps=SHORT_STEPS, plain=False, dw=None),
}
BF16_MAIN = "bf16_compact_multiply_first"  # this slice's main path
BF16_DW = "bf16_plain"  # the bf16 run that reaches the bf16 dW
BF16_FULL = "full_scale_bf16"  # the slice's packed max path at 1.0 in bf16
# a bf16 step through the kernels against the plain versions (f32 sums in
# another order, each rounded once to bf16 where the sum is bf16: a unit
# of bf16 is 0.4-0.8% of a value) and a bf16 run's losses against its f32
# run's (het_tpu's own bf16 loss is 1.7e-4 from its f32 loss at the first
# step; Adam's steps take the two apart further)
BF16_TRAIN_RTOL = 1e-2
BF16_F32_RTOL = 2e-2
RESUME_STEPS = 3  # saved after this many timed steps, then as many more


def _bf16_sum_pair(label):
    """The (rows, sums) element types of the segment sum ``label`` (a
    label of ``_run_seg_sum_shapes``) in a bf16 step: bf16 rows, summed
    into bf16 by the backward's source-side and (dst, rel)-run reduces of
    the fused attention ops and of compact_weighted_agg, into f32 by the
    rest (the forward's sums, the gather backwards, HGT's compact rows
    into k)."""
    import torch

    bf16_out = ("(dst,rel) runs" in label
                or ("src-compact" in label and "rows -> k" not in label)
                or label.endswith(("bwd src draw", "bwd src dfeat")))
    return torch.bfloat16, torch.bfloat16 if bf16_out else torch.float32


def _bf16_launches(run, steps, g):
    """The typed kernels' launches by element types in one ``train`` call
    of bf16 run ``run`` with ``steps`` timed steps on ``g``: the
    warm-up and timed steps' sums by ``_bf16_sum_pair``, the accuracy
    pass's forward sums (bf16 -> f32) and the dW's."""
    from collections import Counter

    from het_tpu_torch.ops.kernels.seg_reduce import dtype_key

    spec = BF16_RUNS[run]
    r = _chain(RUNS[spec["f32"]])
    shapes = _run_seg_sum_shapes(spec["f32"], g, chain=True)
    sums = Counter(dtype_key(*_bf16_sum_pair(s[0])) for s in shapes)
    sums = {k: v * (WARMUP + steps) for k, v in sums.items()}
    sums["bf16->f32"] = (sums.get("bf16->f32", 0)
                         + _eval_launches(r)["seg_sum_sorted"])
    dw = r["launches"].get("segment_matmul_dw", 0) * (WARMUP + steps)
    return {"seg_sum_sorted": sums,
            "segment_matmul_dw": {spec["dw"]: dw} if dw else {}}


def _bf16_seg_sum_edge_cases(dev, gen):
    """The segment sum's edge cases (``_seg_sum_edge_cases``) in bf16 rows
    into f32 and into bf16 sums, NaN rows outside the row pointer, each
    launched twice and compared bit for bit; and rows one element into
    their storage (2-byte aligned).  Returns the largest |error|."""
    import torch
    from het_tpu_torch.ops.kernels import seg_sum_sorted

    max_err = 0.0
    cases = _seg_sum_edge_cases(dev)
    for label, rows, C, ptr, perm in cases:
        for out_dt in (torch.float32, torch.bfloat16):
            vals = torch.randn(rows, C, device=dev, generator=gen)
            order = (perm.long() if perm is not None
                     else torch.arange(rows, device=dev))
            vals[order[:int(ptr[0])]] = float("nan")
            vals[order[int(ptr[-1]):]] = float("nan")
            vals = vals.bfloat16()
            what = f"bf16 {label} into {out_dt}"
            got, err = _compare_seg_sum(vals, ptr, perm, what, out_dt)
            _compare_exact(got, seg_sum_sorted(vals, ptr, perm,
                                               out_dtype=out_dt),
                           f"{what} (repeat)")
            max_err = max(max_err, err)
    for C in (1, 4, 12, 68):  # unaligned rows: 2-, 4- or 8-byte loads
        hub = _hub_ptr(dev)
        rows = int(hub[-1])
        vals = torch.randn(rows * C + 1, device=dev,
                           generator=gen).bfloat16()[1:].view(rows, C)
        for out_dt in (torch.float32, torch.bfloat16):
            max_err = max(max_err, _compare_seg_sum(
                vals, hub, None, f"bf16 unaligned C={C} into {out_dt}",
                out_dt)[1])
    print(f"seg_sum bf16 edge cases ok ({len(cases)} x 2 pairs, twice "
          "each; unaligned rows)")
    return max_err


def check_seg_sum_bf16(graphs, dev, flush):
    """The bf16 instantiations against their plain versions at every shape
    of a step of each bf16 run (``graphs``: run -> its graph on the card),
    each launched twice bit for bit, timed beside their bound, the plain
    version and ``torch.segment_reduce`` on the bf16 rows; and the edge
    cases.  Returns one JSON entry for each pair (bf16 -> f32 and bf16 ->
    bf16), the per-step totals of this slice's main path."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    max_err = _bf16_seg_sum_edge_cases(dev, gen)
    totals = {}
    for run, g in graphs.items():
        totals[run], err = seg_sum_run_table(
            run, _run_seg_sum_shapes(BF16_RUNS[run]["f32"], g, chain=True),
            dev, flush, gen, pair_of=_bf16_sum_pair)
        max_err = max(max_err, err)
    entries = []
    for key in ("bf16->f32", "bf16->bf16"):
        per_run = {run: t["by_dtype"][key] for run, t in totals.items()
                   if key in t["by_dtype"]}
        t = per_run[BF16_MAIN]
        entries.append({
            "name": f"seg_sum_sorted[{key}]",
            "route": "cuda",
            "source": "het_tpu_torch/csrc/seg_reduce.cu",
            "replaces": "het_tpu/ops/pallas/seg_reduce.py:360",
            "launches": None,  # filled from the bf16 training run
            "max_abs_err": max_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"],
            "library": "torch.segment_reduce on the bf16 rows",
            "per_run": per_run,
        })
    return entries


def check_dw_bf16(g, dev, flush):
    """The bf16 dW (bf16 x and ct, f32 dW) against its plain version (the
    operands widened to f32 exactly) at the bf16 plain RGAT step's shapes
    (the attention vectors' dW, two a layer over the relation-sorted edge
    rows), the general K = O = 64, S = 4 shape and x one element off 16
    bytes: within DW_TOL * sum |x| |ct| (each bf16 product is exact in
    f32), each launched twice bit for bit, timed beside its bound (2
    bytes a bf16 element, operations at the bf16 rate), the plain version
    and a per-relation bf16 torch.matmul.  Returns the JSON entry."""
    import numpy as np
    import torch
    from het_tpu_torch.ops.kernels import (segment_matmul_dw,
                                           segment_matmul_dw_plain)
    from het_tpu_torch.ops.kernels.segment_mm import host_seg_ptrs

    E = g.edge_rel_seg
    dims = _dims()
    rng = np.random.default_rng(2)
    shapes = [(f"l{layer} attn_l/attn_r dW, edge rows", 2, E, HEADS, HEADS,
               dims[layer + 1] // HEADS, 1, True, False)
              for layer in range(LAYERS)]
    shapes += [
        ("general S=4", 0, _segments(rng.multinomial(
            1_000_000, [0.4, 0.3, 0.2, 0.1]), 128, dev), 1, 1, 64, 64,
         False, False),
        ("edge: x not 16-byte aligned, per head", 0, _segments(
            (2000, 33, 0, 900), 8, dev), 4, 4, 16, 1, False, True),
    ]
    want_per_step = RUNS[BF16_RUNS[BF16_DW]["f32"]]["launches"][
        "segment_matmul_dw"]
    if sum(s[1] for s in shapes) != want_per_step:
        raise AssertionError("bf16 dW: the shapes do not cover the run")
    gen = torch.Generator(device=dev).manual_seed(5)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, yardstick_ms=0.0,
                 bytes_ms=0.0, ops_ms=0.0)
    max_err = 0.0
    print("bf16 dW shape | S | rows | H | Hx | K | O | kernel share | "
          "kernel ms | bound ms | plain ms | per-relation bf16 matmul ms")
    for label, per_step, seg, H, Hx, K, O, mask, unaligned in shapes:
        S, n = seg.n_segments, seg.n_rows
        w_shape = (S, H, K, O)
        x = torch.randn(n * Hx * K + 1, device=dev, generator=gen).bfloat16()
        x = x[1:] if unaligned else x[:-1]
        x = x.view(n, Hx * K)
        assert (x.data_ptr() % 16 != 0) == unaligned, label
        ct = torch.randn(n, H * O, device=dev, generator=gen).bfloat16()
        if mask:
            ct = torch.where(seg.row_valid[:, None], ct, 0.0)
        got = segment_matmul_dw(x, ct, w_shape, seg)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.isfinite(got).all():
            raise AssertionError(f"bf16 {label}: {got.dtype}, not finite")
        _compare_exact(got, segment_matmul_dw(x, ct, w_shape, seg),
                       f"bf16 {label} (repeat)")
        want = segment_matmul_dw_plain(x, ct, w_shape, seg)
        limit = DW_TOL * segment_matmul_dw_plain(x.abs(), ct.abs(), w_shape,
                                                 seg)
        err = (got - want).abs()
        share = _worst_share(err, limit)
        if share > 1.0:
            raise AssertionError(f"bf16 {label}: {share} times the limit")
        max_err = max(max_err, err.max().item())
        ptrs = host_seg_ptrs(seg)

        def yardstick():
            # one bf16 torch.matmul a relation (the port never calls it)
            out = torch.zeros(w_shape, device=dev, dtype=torch.bfloat16)
            for s in range(S):
                lo, hi = ptrs[s], ptrs[s + 1]
                if hi == lo:
                    continue
                full = x[lo:hi].t() @ ct[lo:hi]
                if Hx == 1:
                    out[s] = full.view(K, H, O).permute(1, 0, 2)
                else:
                    out[s] = full.view(H, K, H, O).diagonal(
                        dim1=0, dim2=2).permute(2, 0, 1)
            return out

        rows = ptrs[-1] - ptrs[0]
        nbytes = rows * (Hx * K + H * O) * 2 + S * H * K * O * 4 + (S + 1) * 4
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = 2 * rows * H * K * O / BF16_FLOP_PER_S
        bound = max(bytes_s, ops_s)
        ms = _time_ms(lambda: segment_matmul_dw(x, ct, w_shape, seg), 20,
                      flush)
        plain = _time_ms(
            lambda: segment_matmul_dw_plain(x, ct, w_shape, seg), 5, flush)
        yard = _time_ms(yardstick, 5, flush)
        print(f"{label} | {S} | {rows} | {H} | {Hx} | {K} | {O} | "
              f"{share:.4g} | {ms:.4f} | {bound * 1e3:.4f} | {plain:.4f} | "
              f"{yard:.4f}")
        for key, v in (("ms", ms), ("plain_ms", plain),
                       ("bound_ms", bound * 1e3), ("yardstick_ms", yard),
                       ("bytes_ms", bytes_s * 1e3), ("ops_ms", ops_s * 1e3)):
            total[key] += per_step * v
    print(f"[{BF16_DW}] bf16 segment_matmul_dw per-step totals (ms):",
          json.dumps(total))
    return {
        "name": "segment_matmul_dw[bf16]",
        "route": "cuda",
        "source": "het_tpu_torch/csrc/segment_mm.cu",
        "replaces": "het_tpu/ops/pallas/segment_mm.py:400,568",
        "launches": None,  # filled from the bf16 training run
        "max_abs_err": max_err,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                     else "operations"),
        "library_ms": None,  # no single PyTorch call computes a grouped dW
        "yardstick_ms": total["yardstick_ms"],
        "yardstick": "per-relation bf16 torch.matmul loop",
    }


def _bf16_config(r, dev, steps):
    return dataclasses.replace(_config(r, dev, steps), dtype="bfloat16",
                               loss_scale="dynamic")


def check_bf16_training(datasets, dev, card, summaries):
    """Every BF16_RUNS entry through the kernels (and, ``plain``, through
    their plain versions) from its f32 run's seeded parameters: finite
    losses (falling over STEPS), the kernels within BF16_TRAIN_RTOL of the
    plain versions a step and within BF16_F32_RTOL of the f32 run's losses
    (``summaries``), the f32 run's launches in all and the launches by
    element types of ``_bf16_launches``; step ms, edges/s and peak memory
    beside the f32 run's.  Returns {run: (launches, launches by dtype)}."""
    import torch
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train import build_model, train

    out = {}
    for run, spec in BF16_RUNS.items():
        r = RUNS[spec["f32"]]
        data = datasets[_data_key(r)]
        steps = spec["steps"]
        cfg = _bf16_config(r, dev, steps)
        state = _initial_state(build_model(cfg, data))
        runs = {}
        for impl in ("kernel", "plain") if spec["plain"] else ("kernel",):
            torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launches()
            with _PackedCalls() as packed:
                m = train(cfg, data, state=state, impl=impl,
                          log=lambda s, i=impl: print(f"[{run} {i}] {s}"))
            m["launches"] = kernels.launch_counts()
            m["launches_by_dtype"] = kernels.launch_counts_by_dtype()
            m["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            _check_packed(run, r, packed.calls, WARMUP + steps + 1)
            _check_losses(run, impl, m["loss_list"], steps, steps == STEPS)
            runs[impl] = m
        k = runs["kernel"]
        if "plain" in runs:
            for step, (a, b) in enumerate(zip(k["loss_list"],
                                              runs["plain"]["loss_list"])):
                if abs(a - b) > BF16_TRAIN_RTOL * abs(b):
                    raise AssertionError(
                        f"{run} step {step}: kernel loss {a} vs plain {b} "
                        f"(rtol {BF16_TRAIN_RTOL})")
            if any(runs["plain"]["launches"].values()):
                raise AssertionError(f"{run}: plain run launched")
        f32 = summaries[spec["f32"]]["kernel"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(k["loss_list"],
                                                      f32["losses"]))
        if gap > BF16_F32_RTOL:
            raise AssertionError(f"{run}: bf16 losses {k['loss_list']} vs "
                                 f"f32 {f32['losses']} (rtol {BF16_F32_RTOL})")
        want = _train_launches(_chain(r), steps)
        if k["launches"] != want:
            raise AssertionError(f"{run}: launched {k['launches']}, the f32 "
                                 f"run's on the chain {want}")
        want_by = _bf16_launches(run, steps, data.graph)
        if k["launches_by_dtype"] != want_by:
            raise AssertionError(f"{run}: launched by dtype "
                                 f"{k['launches_by_dtype']}, expected "
                                 f"{want_by}")
        E = data.graph.num_edges
        summary = {"losses_vs_f32_max_rel": gap,
                   "f32": {key: f32[key] for key in (
                       "losses", "median_warm_step_ms", "edges_per_s",
                       "peak_mem_gb")}}
        for impl, m in runs.items():
            warm = statistics.median(m["step_ms_list"][1:])
            summary[impl] = {
                "losses": m["loss_list"], "step_ms": m["step_ms_list"],
                "median_warm_step_ms": warm, "edges_per_s": E / (warm / 1e3),
                "launches": m["launches"],
                "launches_by_dtype": m["launches_by_dtype"],
                "peak_mem_gb": m["peak_mem_gb"],
                "loss_scale_state": m["loss_scale_state"],
                **{key: m[key] for key in REPORT_KEYS}}
        if "plain" in runs:
            summary["kernel_vs_plain_max_rel"] = max(
                abs(a - b) / abs(b) for a, b in zip(
                    k["loss_list"], runs["plain"]["loss_list"]))
        print(f"training {run} ({card}):", json.dumps(summary))
        out[run] = (k["launches"], k["launches_by_dtype"])
    return out


def check_resume(data, dev, card):
    """Checkpoint and resume through the trainer, in f32 and in bf16
    (dynamic loss scale): compact multiply-first (packed) at SCALE with
    dropout 0.3 (the dropout generator is a CUDA generator), RESUME_STEPS
    timed steps, a checkpoint, then as many more resumed, against
    2 * RESUME_STEPS straight steps: the resumed losses and the final
    parameters bit for bit.  Then a --patience 1 run (lr 0.05, 8 epochs)
    stops where EarlyStopping says on its own losses, and its last
    checkpoint carries the epoch it reached.  Checkpoints go to a
    temporary directory, removed after."""
    import tempfile

    import torch
    from het_tpu_torch.train import build_model, train
    from het_tpu_torch.train.checkpoint import latest_step, load_checkpoint
    from het_tpu_torch.utils.misc import EarlyStopping

    r = RUNS["compact_multiply_first"]
    quiet = lambda s: None  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            base = dataclasses.replace(
                _config(r, dev, 2 * RESUME_STEPS), dropout=0.3, dtype=dtype,
                loss_scale="dynamic" if dtype == "bfloat16" else "none",
                checkpoint_dir=f"{tmp}/{dtype}")

            def seeded():  # the trainer's own seeded parameters
                return build_model(base, data, generator=torch.Generator(
                    ).manual_seed(base.seed))

            net = seeded()
            ref = train(base, data, net=net, log=quiet)
            half = dataclasses.replace(base, num_epochs=RESUME_STEPS,
                                       save_every=RESUME_STEPS)
            train(half, data, log=quiet)
            if latest_step(base.checkpoint_dir) != RESUME_STEPS:
                raise AssertionError(f"resume {dtype}: no checkpoint")
            net2 = seeded()
            res = train(dataclasses.replace(base, resume=True), data,
                        net=net2, log=quiet)
            if res["loss_list"] != ref["loss_list"][RESUME_STEPS:]:
                raise AssertionError(
                    f"resume {dtype}: losses {res['loss_list']} vs the "
                    f"uninterrupted {ref['loss_list'][RESUME_STEPS:]}")
            want = net.state_dict()
            for key, v in net2.state_dict().items():
                if not torch.equal(v, want[key]):
                    raise AssertionError(f"resume {dtype}: {key} differs")
            print(f"resume {dtype} ({card}): {RESUME_STEPS} + "
                  f"{RESUME_STEPS} resumed steps equal {2 * RESUME_STEPS} "
                  "straight, losses and parameters bit for bit:",
                  json.dumps({"straight": ref["loss_list"],
                              "resumed": res["loss_list"]}))
        cfg = dataclasses.replace(_config(r, dev, 8), lr=0.05, patience=1,
                                  save_every=100,
                                  checkpoint_dir=f"{tmp}/patience")
        m = train(cfg, data, log=quiet)
        losses = m["loss_list"]
        stopper = EarlyStopping(patience=1)
        stops = [stopper.update(v, i) for i, v in enumerate(losses)]
        reached = stops.index(True) + 1 if True in stops else len(stops)
        if len(losses) != reached or m["epochs_done"] != reached:
            raise AssertionError(f"patience 1: ran {len(losses)} epochs on "
                                 f"losses {losses}, the stopper says "
                                 f"{reached}")
        ck = load_checkpoint(cfg.checkpoint_dir)
        if ck["epoch"] != reached or latest_step(
                cfg.checkpoint_dir) != reached:
            raise AssertionError(f"patience 1: last checkpoint {ck['epoch']}"
                                 f", epoch reached {reached}")
        print(f"patience 1 ({card}): stopped after epoch {reached} of "
              f"{cfg.num_epochs} on losses {losses}; last checkpoint "
              f"step_{reached}")


def _coo_of(g):
    """The edge arrays ``g`` was built from, in their input order (the
    canonical edges put back through ``eid_orig``), and the builder's
    options that give ``g`` again."""
    import numpy as np

    E = g.num_edges
    eid = g.eid_orig[:E].numpy()
    coo = []
    for t in (g.src, g.dst, g.rel):
        a = np.empty(E, dtype=np.int64)
        a[eid] = t[:E].numpy()
        coo.append(a)
    return coo, dict(num_nodes=g.num_nodes, num_rels=g.num_rels,
                     ntype_offsets=g.ntype_offsets, rel_names=g.rel_names,
                     tile=g.edge_rel_seg.tile,
                     build_compact=g.compact_src is not None,
                     compact_union=g.compact_shared)


def _same_graph(a, b, where):
    """Raise unless ``a`` and ``b`` are equal field for field: tensors in
    dtype, shape and every value, the rest (``None`` included) equal."""
    import torch

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        name = f"{where}.{f.name}"
        if dataclasses.is_dataclass(x) and dataclasses.is_dataclass(y):
            _same_graph(x, y, name)
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y)):
                raise AssertionError(f"{name} differs")
        elif type(x) is not type(y) or x != y:
            raise AssertionError(f"{name}: {x!r} != {y!r}")


def check_host_build(data, label, card):
    """The graph builder through the host library and through its plain
    (numpy) sorts on the same edges: both equal field for field, and equal
    to the loader's graph; each timed on the host clock."""
    from het_tpu_torch.graph.build import build_heterograph

    (src, dst, rel), kw = _coo_of(data.graph)
    seconds, built = {}, {}
    for sorts in ("native", "plain"):
        t0 = time.perf_counter()
        built[sorts] = build_heterograph(src, dst, rel, sorts=sorts, **kw)
        seconds[sorts] = time.perf_counter() - t0
    _same_graph(built["native"], built["plain"], f"{label} native, plain")
    _same_graph(built["native"], data.graph, f"{label} native, loader")
    print(f"[{label}] host build of {len(src)} edges ({card}): native "
          f"{seconds['native']:.3f} s, plain {seconds['plain']:.3f} s, "
          f"equal field for field")
    return seconds


def _best_s(fn, reps):
    """The result of ``fn`` and its least time over ``reps`` calls."""
    best, out = math.inf, None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def check_host_sorts(data, label, card):
    """Each host-library sort against its plain version at the sizes the
    graph's build gives it (the canonical sort of every edge, the source
    order, the in-degrees, the source side's unique pairs, the degree
    order): equal bit for bit, each timed (the best of 3 calls)."""
    import numpy as np
    from het_tpu_torch.graph import convert, native

    g = data.graph
    E, N, R = g.num_edges, g.num_nodes, g.num_rels
    (src, dst, rel), _ = _coo_of(g)
    c_src, c_dst, c_rel = (t[:E].numpy().astype(np.int64)
                           for t in (g.src, g.dst, g.rel))
    deg = np.bincount(c_dst, minlength=N)
    pairs = {
        "canonical_sort": (
            lambda: native.canonical_sort(src, dst, rel, N, R),
            lambda: convert.canonical_sort(src, dst, rel)),
        "counting_argsort": (lambda: native.counting_argsort(c_src, N + 1),
                             lambda: convert.counting_argsort(c_src)),
        "bincount": (lambda: native.bincount(c_dst, N),
                     lambda: np.bincount(c_dst, minlength=N)),
        "unique_pairs": (lambda: native.unique_pairs(c_rel, c_src, N, R),
                         lambda: convert.unique_pairs(c_rel, c_src, N)),
        "degree_sort": (lambda: native.degree_sort(deg),
                        lambda: np.argsort(-deg, kind="stable")),
    }
    table = {}
    for name, (fast, plain) in pairs.items():
        got, t_native = _best_s(fast, 3)
        want, t_plain = _best_s(plain, 3)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            if a.dtype != np.int64 or not np.array_equal(a, b):
                raise AssertionError(f"{label} {name}: native differs from "
                                     "plain")
        table[name] = {"native_s": t_native, "plain_s": t_plain,
                       "plain_over_native": t_plain / t_native}
    print(f"[{label}] host sorts, {E} edges, {N} nodes ({card}):",
          json.dumps(table))
    return table


def check_persist(data, label, card):
    """``save_heterograph`` / ``load_heterograph`` of the graph in a
    temporary directory (removed after): bytes written, save and load
    seconds, the loaded graph equal to the built one."""
    import os
    import tempfile

    from het_tpu_torch.graph import load_heterograph, save_heterograph

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.pt")
        t0 = time.perf_counter()
        save_heterograph(path, data.graph)
        t1 = time.perf_counter()
        size = os.path.getsize(path)
        loaded = load_heterograph(path)
        t2 = time.perf_counter()
    _same_graph(loaded, data.graph, f"{label} loaded")
    out = {"bytes": size, "save_s": t1 - t0, "load_s": t2 - t1}
    print(f"[{label}] graph saved and loaded ({card}): {json.dumps(out)}, "
          f"equal field for field")
    return out


def compare_draws(data, label, card, batches=5):
    """The host library's draw (``NeighborSampler.draw``) and its plain
    version (``draw_plain``) on the minibatch runs' first ``batches``
    batches of seeds at the runs' pads, and once under small caps: each
    keeps the contract (the seeds take the first local ids; local ids are
    distinct nodes; every sampled edge is an edge of the graph, no edge
    more often than the graph holds it; at most ``FANOUT`` in-edges a
    destination; the caps hold); their times (medians)."""
    import numpy as np
    from het_tpu_torch.data.sampling import NeighborSampler
    from het_tpu_torch.train.minibatch import minibatch_pads

    g = data.graph
    E, N, R = g.num_edges, g.num_nodes, g.num_rels
    c_src, c_dst, c_rel = (t[:E].numpy().astype(np.int64)
                           for t in (g.src, g.dst, g.rel))
    keys, held = np.unique((c_dst * N + c_src) * R + c_rel,
                           return_counts=True)
    sampler = NeighborSampler(c_src, c_dst, c_rel, N, R, fanout=FANOUT,
                              num_hops=HOPS, seed=0)
    pad_edges, pad_nodes = minibatch_pads(_mb_config(
        MB_RUNS[MB_MAIN], "cpu", 1))
    order = np.random.default_rng(0).permutation(len(data.train_idx))
    out = {}
    for draw in ("draw", "draw_plain"):
        ms, edges = [], []
        for b in range(batches + 1):
            seeds = data.train_idx[order[b * BATCH:(b + 1) * BATCH]]
            caps = ((pad_edges, pad_nodes) if b < batches
                    else (pad_edges // 50, pad_nodes // 100))
            t0 = time.perf_counter()
            es, ed, er, nm = getattr(sampler, draw)(
                seeds, max_edges=caps[0], max_nodes=caps[1])
            if b < batches:
                ms.append((time.perf_counter() - t0) * 1e3)
                edges.append(len(es))
            k, c = np.unique((nm[ed] * N + nm[es]) * R + er,
                             return_counts=True)
            at = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
            ok = (len(es) <= caps[0] and len(nm) <= caps[1]
                  and np.array_equal(nm[:min(BATCH, caps[1])],
                                     seeds[:caps[1]])
                  and len(np.unique(nm)) == len(nm)
                  and (keys[at] == k).all() and (c <= held[at]).all()
                  and np.bincount(ed, minlength=len(nm)).max(initial=0)
                  <= FANOUT)
            if not ok:
                raise AssertionError(f"{label} {draw}: batch {b} breaks the "
                                     "sampler's contract")
        out[draw] = {"median_ms": statistics.median(ms), "ms": ms,
                     "edges": edges}
    out["plain_over_native"] = (out["draw_plain"]["median_ms"]
                                / out["draw"]["median_ms"])
    print(f"[{label}] draws of {BATCH} seeds, fanout {FANOUT}, {HOPS} hops "
          f"({card}):", json.dumps(out))
    return out


def check_full_scale(dev, card):
    """The slice's path (compact multiply-first, packed, stable="max") on
    synthetic ogbn-mag at FULL_SCALE, FULL_STEPS steps through the kernels
    only: finite losses, the last below the first, the packed form and
    the slice's launches a step; then compact RGCN and compact HGT on
    the same graph (``FULL_OTHERS``: finite losses, their launches), and
    the slice's path in bf16 (BF16_FULL: the f32 run's launches, its
    losses within BF16_F32_RTOL of the f32 run's); each prints its
    step time, edges/s and the peak device memory.  First the segment sum
    and max at every shape of a step of the slice's path there, each
    against its plain version, timed beside its bound, and the sum's bf16
    instantiations at the same shapes.  Last the minibatch path on the
    same graph (MB_FULL): the segment sum at every shape of a sampled
    batch's step, then MB_FULL_BATCHES batches through the kernels
    (``check_minibatch``).  Returns each run's launches, in all and by
    element types, those per-step totals and the packed compact GAT
    walks' entries (``check_compact_gat`` at the benchmark's first cell's
    widths on this graph)."""
    import gc

    import torch
    from het_tpu_torch.data.loaders import load_dataset
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.train import train

    t0 = time.perf_counter()
    data = load_dataset("mag", scale=FULL_SCALE, num_classes=CLASSES,
                        seed=0, data_roots=())
    print(f"[{FULL}] graph built (host library) in "
          f"{time.perf_counter() - t0:.1f} s: {data.graph.describe()}")
    # the host build both ways and the sampler's draws at this size
    check_host_build(data, FULL, card)
    compare_draws(data, FULL, card)
    gc.collect()
    g = data.graph.to(dev)
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    totals = {
        "seg_sum_sorted": seg_sum_run_table(
            FULL, _seg_sum_shapes(g, True, True), dev, flush, gen)[0],
        "seg_max_sorted": seg_max_run_table(
            FULL, _seg_max_shapes(g), dev, flush, gen)[0],
        # the bf16 step's sums at the same shapes (the max reads f32)
        "bf16": seg_sum_run_table(
            BF16_FULL, _seg_sum_shapes(g, True, True), dev, flush, gen,
            pair_of=_bf16_sum_pair)[0]["by_dtype"],
    }
    walks = check_compact_gat(g, dev, flush, FULL)
    del g, flush
    torch.cuda.empty_cache()
    launches, by_dtype, f32_losses = {}, {}, None
    for name, run, steps in ((FULL, SLICE_MAIN, FULL_STEPS),
                             (BF16_FULL, SLICE_MAIN, FULL_STEPS),
                             *FULL_OTHERS):
        r = RUNS[run]
        cfg = _config(dict(r, scale=FULL_SCALE), dev, steps)
        if name == BF16_FULL:
            cfg = _bf16_config(dict(r, scale=FULL_SCALE), dev, steps)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        with _PackedCalls() as packed:
            m = train(cfg, data,
                      log=lambda s, n=name: print(f"[{n} kernel] {s}"))
        launches[name] = kernels.launch_counts()
        by_dtype[name] = kernels.launch_counts_by_dtype()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        _check_packed(name, r, packed.calls, WARMUP + steps + 1)
        _check_losses(name, "kernel", m["loss_list"], steps,
                      steps == FULL_STEPS)
        want = _train_launches(r, steps)
        if launches[name] != want:
            raise AssertionError(f"{name}: launched {launches[name]}, "
                                 f"expected {want}")
        extra = {}
        if name == FULL:
            f32_losses = m["loss_list"]
        if name == BF16_FULL:
            sums = by_dtype[name]["seg_sum_sorted"]
            if set(sums) != {"bf16->f32", "bf16->bf16"} or sum(
                    sums.values()) != want["seg_sum_sorted"]:
                raise AssertionError(f"{name}: sums by dtype {sums}")
            extra["losses_vs_f32_max_rel"] = gap = max(
                abs(a - b) / abs(b) for a, b in zip(m["loss_list"],
                                                    f32_losses))
            if gap > BF16_F32_RTOL:
                raise AssertionError(f"{name}: bf16 losses {m['loss_list']}"
                                     f" vs f32 {f32_losses}")
        E = data.graph.num_edges
        warm = statistics.median(m["step_ms_list"][1:])
        print(f"training {name} ({card}):", json.dumps({
            "edges": E, "losses": m["loss_list"],
            "step_ms": m["step_ms_list"], "median_warm_step_ms": warm,
            "edges_per_s": E / (warm / 1e3), "launches": launches[name],
            "launches_by_dtype": by_dtype[name], "dtype": cfg.dtype,
            "peak_mem_gb": peak, **extra,
            **{key: m[key] for key in REPORT_KEYS}}))
        del m
        gc.collect()
        torch.cuda.empty_cache()
    # this slice's compiled path on the same graph, kernels only, beside
    # the hand-written model at H = 1
    r = dict(COMPILED_RUNS[COMPILED_MAIN], scale=FULL_SCALE,
             steps=COMPILED_FULL_STEPS, plain=False)
    launches[COMPILED_FULL], totals["compiled_summary"] = check_compiled(
        data, dev, card, COMPILED_MAIN, {}, r=r, name=COMPILED_FULL)
    gc.collect()
    torch.cuda.empty_cache()
    # the minibatch path on the same graph: the segment sum at every shape
    # of one sampled batch's step (the table's gradient over all the
    # graph's nodes among them), then MB_FULL_BATCHES batches
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    sub, table = minibatch_inputs(data, MB_MAIN, dev, scale=FULL_SCALE)
    totals["minibatch"] = seg_sum_run_table(
        MB_FULL, _run_seg_sum_shapes(MB_MAIN, sub) + table, dev, flush,
        gen)[0]
    del sub, table, flush
    torch.cuda.empty_cache()
    launches[MB_FULL], totals["minibatch_summary"] = check_minibatch(
        data, dev, card, MB_MAIN, scale=FULL_SCALE, name=MB_FULL,
        batches=MB_FULL_BATCHES, plain=False)
    del data
    gc.collect()
    return launches, by_dtype, totals, walks


# ---------------------------------------------------------------- bench

# bench.step's timed steps (after its warm-up) a variant
BENCH_WARMUP, BENCH_STEPS = 3, 10
# bench.halo_bytes at 0.01 (host only; the CPU tests hold its numbers)
HALO_SCALE = 0.01


def check_bench(dev, card):
    """The benchmark entry points (``het_tpu_torch.bench``).  First
    ``bench.step`` at its default scale, the counts set to 0 just before
    and read just after: its JSON line, all six variants, each kernel
    variant held at its first step to its plain variant (``step.run``
    raises otherwise), each share of the step's bounds in (0, 100], the
    launches a step of each variant equal to ``step.LAUNCHES_A_STEP``
    (none for the plain ones) and the run's counts their sum over its
    steps.  Then each other module once at its smallest form, one case
    each and ``bench.fullscale`` at 0.1; each raises where its kernel
    disagrees with its plain version (the sweep records it: a failed case
    fails the run here).  Prints the phase's seconds."""
    from het_tpu_torch.bench import (compiled, fullscale, halo_bytes, infer,
                                     models, segmm_strategies, skew, step,
                                     sweep)
    from het_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_launches()
    res = step.run(step.DEFAULT_SCALE, str(dev), warmup=BENCH_WARMUP,
                   steps=BENCH_STEPS)
    counts = kernels.launch_counts()
    print("bench.step:", json.dumps(res))
    d = res["detail"]
    missing = [n for n in step.VARIANTS if f"t_{n}_ms" not in d]
    if missing:
        raise AssertionError(f"bench.step: variants {missing} did not run")
    held = {n for n in step.VARIANTS if n.startswith("kernel")}
    if set(d["kernel_vs_plain_max_rel"]) != held:
        raise AssertionError(f"bench.step: held {d['kernel_vs_plain_max_rel']}")
    for name, shares in d["shares"].items():
        for key, pct in shares.items():
            if not 0.0 < pct <= 100.0:
                raise AssertionError(f"bench.step {name}: {key} {pct}")
    if len(d["shares"]) != 4:
        raise AssertionError(f"bench.step: shares of {sorted(d['shares'])}")
    want = {k: 0 for k in counts}
    for name in step.VARIANTS:
        per = step.LAUNCHES_A_STEP.get(name, {})
        if d["launches_a_step"][name] != per:
            raise AssertionError(f"bench.step {name}: launched "
                                 f"{d['launches_a_step'][name]} a step, "
                                 f"expected {per}")
        for k, n in per.items():
            want[k] += n * (1 + BENCH_WARMUP + BENCH_STEPS)
    if counts != want:
        raise AssertionError(f"bench.step: launched {counts}, expected "
                             f"{want}")
    print(f"bench.step ({card}): value {res['value']:.1f} edges/s, "
          f"vs_baseline {res['vs_baseline']:.3f}, strict / traffic shares "
          f"f32 {d['pct_of_roofline_strict_f32']:.3f}% / "
          f"{d['pct_of_traffic_bound_f32']:.3f}%, bf16 "
          f"{d['pct_of_roofline_strict_bf16']:.3f}% / "
          f"{d['pct_of_traffic_bound_bf16']:.3f}%")
    t1 = time.perf_counter()
    dev = str(dev)
    models.run(device=dev, cases=("RGAT+flags",))
    infer.run(device=dev, cases=("RGAT+flags",))
    compiled.run(device=dev, cases=("rgat+flags",))
    rows = sweep.run("quick", device=dev, max_cases=1)
    if rows[-1]["failed"]:
        raise AssertionError(f"bench.sweep: {rows[:-1]}")
    fullscale.run(0.1, dev)
    segmm_strategies.run(dev, cases=("mag_like",))
    skew.run(dev, kinds=("one_hub",))
    t2 = time.perf_counter()
    report = halo_bytes.run(HALO_SCALE)
    if len(report["rows"]) != 6:
        raise AssertionError(f"bench.halo_bytes: {json.dumps(report)}")
    print(f"bench phase: {time.perf_counter() - t0:.1f} s (bench.step "
          f"{t1 - t0:.1f} s, the other modules {t2 - t1:.1f} s, "
          f"bench.halo_bytes {time.perf_counter() - t2:.1f} s)")


# ------------------------------------------------------------ breakdown

HGT_ATTENTION_REPS = 20


def check_hgt_plain_attention(graphs, dev, flush, card):
    """``ops.hgt_plain_attention`` under "raw" and "clip" (the fused
    ``HGTPlainAttention``) on each of ``graphs`` ({"host": bench.
    breakdown's graph, "device": rank 0's shard of the plain runs'
    partition, whose relation offsets live on the card only, as
    ``dp_hgt_plain``'s edge rows read them}) at the breakdown's widths:
    on ``bench.breakdown.hgt_inputs``, the kernels' output and the
    gradients of all five inputs held to the plain versions' (PERF.md §2:
    rtol 1e-4 of the largest magnitude), the kernels' launches a forward
    and backward equal to ``HGTPlainAttention.LAUNCHES``; then, under
    "clip", the fused op's ms against the unfused chain's
    (``hgt_plain_chain``), forward and with every gradient, in turns, and
    the peak device memory of a call of each beyond what was allocated
    before it.  Returns {label: launches}."""
    import torch
    from het_tpu_torch import ops
    from het_tpu_torch.bench.breakdown import hgt_inputs
    from het_tpu_torch.bench.common import TRAIN_RTOL, check_close, time_call
    from het_tpu_torch.ops import kernels
    from het_tpu_torch.ops.fused_agg import HGTPlainAttention
    from het_tpu_torch.ops.spmm import hgt_plain_chain

    def grads(fn, g, xs, mode, impl, ct):
        args = [x.detach().requires_grad_() for x in xs]
        out = fn(g, *args, stable=mode, impl=impl)
        return [out.detach()] + list(torch.autograd.grad(out, args, ct))

    launches, times = {}, {}
    for offsets, g in graphs.items():
        static = g.edge_rel_seg.seg_ptrs_static
        if (static is None) != (offsets == "device"):
            raise AssertionError(f"hgt_plain_attention: {offsets} offsets "
                                 f"{static}")
        t = hgt_inputs(g, dev)
        xs = [t[k] for k in ("msg", "q", "k", "watt", "mu")]
        del t
        gen = torch.Generator().manual_seed(32)
        ct = torch.randn(xs[1].shape, generator=gen).to(dev)
        for mode in ("raw", "clip"):
            label = f"hgt_plain_attention {offsets} {mode}"
            before = kernels.launch_counts()
            got = grads(ops.hgt_plain_attention, g, xs, mode, "kernel", ct)
            counts = {k: n - before[k] for k, n in
                      kernels.launch_counts().items() if n > before[k]}
            if counts != HGTPlainAttention.LAUNCHES[offsets]:
                raise AssertionError(f"{label}: launched {counts}, expected "
                                     f"{HGTPlainAttention.LAUNCHES[offsets]}")
            launches[label.replace(" ", "_")] = counts
            want = grads(ops.hgt_plain_attention, g, xs, mode, "plain", ct)
            gaps = [check_close(f"{label} {what}", a, b, TRAIN_RTOL)
                    for what, a, b in zip(("out", "d_msg", "d_q", "d_k",
                                           "d_watt", "d_mu"), got, want)]
            print(f"{label}: kernels against plain versions, worst "
                  f"{max(gaps):.3g} of rtol (launches {counts})")
            del got, want
        # in turns (fused, chain, chain, fused), each side's two medians
        # averaged; then a call of each alone for its peak memory
        calls = {"fwd": lambda fn: lambda: fn(g, *xs, stable="clip"),
                 "fwd_bwd": lambda fn: lambda: grads(fn, g, xs, "clip",
                                                     "kernel", ct)}
        sides = {"fused": ops.hgt_plain_attention, "chain": hgt_plain_chain}
        row = {"host_hidden": True}
        for kind, call in calls.items():
            for name in ("fused", "chain", "chain", "fused"):
                key = f"{name}_{kind}_ms"
                m = time_call(call(sides[name]), dev, HGT_ATTENTION_REPS,
                              flush)
                row[key] = row.get(key, 0.0) + 0.5 * m["ms"]
                row["host_hidden"] &= m["host_hidden"]
            for name, fn in sides.items():
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                call(fn)()
                torch.cuda.synchronize(dev)
                row[f"{name}_{kind}_peak_mb"] = (
                    torch.cuda.max_memory_allocated(dev) - base) / 1e6
        row["chain_over_fused"] = {
            k: row[f"chain_{k}_ms"] / row[f"fused_{k}_ms"] for k in calls}
        row["edges"] = g.num_edges
        times[offsets] = row
        del xs, ct
    print(f"hgt_plain_attention fused / unfused chain, clip ({card}):",
          json.dumps(times))
    return launches


def check_breakdown(parts, dev, card):
    """``bench.breakdown --quick`` (bench.py's step op by op and HGT's
    plain attention, each kernel row held to its plain row before it is
    timed, each share of its bound in (0, 100]), the counts set to 0 just
    before and read just after: each kernel row's launches a call equal to
    ``breakdown.LAUNCHES_A_CALL`` and the run's counts their sum over its
    calls (the hold's, two untimed, the timed ones); then
    :func:`check_hgt_plain_attention` on the breakdown's graph and on rank
    0's shard of the plain runs' partition.  Prints the phase's
    seconds; returns {run: launches}."""
    import torch
    from het_tpu_torch.bench import breakdown, step
    from het_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.reset_launches()
    rows = breakdown.run(step.DEFAULT_SCALE, str(dev), quick=True)
    counts = kernels.launch_counts()
    want = {k: 0 for k in counts}
    for r in rows[:-1]:
        label = r.get("op", r.get("config")).split("] ", 1)[-1]
        per = breakdown.LAUNCHES_A_CALL.get(label, {})
        if r["impl"] != "kernel" or r["launches_a_call"] != per:
            raise AssertionError(f"bench.breakdown {label}: {r['impl']}, "
                                 f"launched {r['launches_a_call']} a call, "
                                 f"expected {per}")
        if r["kernel_vs_plain_max_rel"] is None:
            raise AssertionError(f"bench.breakdown {label}: not held")
        for k, n in per.items():
            want[k] += n * (3 + breakdown.QUICK_REPS)
    if counts != want or not counts["seg_sum_sorted"]:
        raise AssertionError(f"bench.breakdown: launched {counts}, "
                             f"expected {want}")
    print(f"bench.breakdown --quick ({card}): {len(rows) - 1} rows, "
          f"launches {json.dumps(counts)}")
    t1 = time.perf_counter()
    _, g, _, _ = step.load(step.DEFAULT_SCALE, dev)
    shard = parts["dp_plain"][0][0].to(dev)
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    launches = check_hgt_plain_attention({"host": g, "device": shard}, dev,
                                         flush, card)
    launches["breakdown_quick"] = counts
    print(f"breakdown phase: {time.perf_counter() - t0:.1f} s "
          f"(bench.breakdown {t1 - t0:.1f} s, hgt_plain_attention "
          f"{time.perf_counter() - t1:.1f} s)")
    return launches


def main() -> int:
    import torch

    started = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    from het_tpu_torch.data.loaders import load_dataset
    from het_tpu_torch.ops.kernels import _build

    exact_matmuls()
    dev = torch.device("cuda", 0)
    card = _card_line()
    name = torch.cuda.get_device_name(0)
    # every bound below counts with the H100 SXM row: another card raises
    device_peaks(name)
    print(card)  # nvidia-smi's "name, power.limit"
    print(f"device: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # the host library (graph sorts, the sampler) first, then the kernels
    t0 = time.perf_counter()
    for log in _build.build_all(_build.HOST_SOURCES):
        print(log)
    print(f"host library built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for log in _build.build_all():
        print(log)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    # the synthetic stand-in at each (dataset, scale, union-list) the runs
    # take
    datasets = {}
    for key in sorted({_data_key(r) for r in RUNS.values()}):
        t0 = time.perf_counter()
        datasets[key] = load_dataset(key[0], scale=key[1],
                                     num_classes=key[3], seed=0,
                                     compact_union=key[2], data_roots=())
        g = datasets[key].graph
        print(f"graph ({key[0]}, scale {key[1]}, union {key[2]}) built in "
              f"{time.perf_counter() - t0:.1f} s: {g.describe()}, (dst, rel) "
              f"runs {g.compact_dst.canon_ptr.numel() - 1}, relation-sorted "
              f"edge rows {g.edge_rel_seg.n_rows} "
              f"{g.edge_rel_seg.seg_ptrs_static}")
    data = datasets[_data_key(RUNS[MAIN])]
    # host graph I/O at SCALE: the build both ways, each sort against its
    # plain version, save and load, the sampler's draws both ways
    check_host_build(data, f"mag {SCALE}", card)
    check_host_sorts(data, f"mag {SCALE}", card)
    check_persist(data, f"mag {SCALE}", card)
    compare_draws(data, f"mag {SCALE}", card)
    t0 = time.perf_counter()
    # the link runs' stand-in: their trainer builds the message graph
    link_data = load_dataset("fb15k", scale=LINK_SCALE, num_classes=CLASSES,
                             seed=0, build_compact=False, data_roots=())
    print(f"graph (fb15k, scale {LINK_SCALE}) built in "
          f"{time.perf_counter() - t0:.1f} s: {link_data.graph.describe()}")
    gd = data.graph.to(dev)
    gu = datasets[_data_key(RUNS["union_compact"])].graph.to(dev)
    gp = datasets[_data_key(RUNS[SLICE_MAIN])].graph.to(dev)
    ga = datasets[_data_key(RUNS["gat_arxiv"])].graph.to(dev)

    parts = partition_dp(data)
    # rank 0's shard of each data-parallel run (one copy a partition)
    on_card = {}
    shards = {run: on_card.setdefault(id(s), s[0].to(dev))
              for run, (s, _) in parts.items()}
    # each minibatch run's first batch and the link runs' message graph
    mb = {run: minibatch_inputs(data, run, dev) for run in MB_RUNS}
    gl, link_shapes = link_inputs(link_data, dev)
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    entries = [
        check_seg_sum({"compact_multiply_first": gd, MAIN: gd,
                       SLICE_MAIN: gp, "union_compact_multiply_first": gu,
                       "rgcn_plain": gd, "rgcn_compact": gd, "hgt_plain": gd,
                       "hgt_compact": gd, "hgt_compact_max": gd, "gat": gd,
                       "gat_arxiv": ga, **shards,
                       **dict.fromkeys(COMPILED_RUNS, gd),
                       **{run: sub for run, (sub, _) in mb.items()},
                       **dict.fromkeys(LINK_RUNS, gl)},
                      dev, flush,
                      extra={**{run: t for run, (_, t) in mb.items()},
                             **dict.fromkeys(LINK_RUNS, link_shapes)}),
        check_seg_max({SLICE_MAIN: gp, "plain_max": gd,
                       "hgt_compact_max": gd,
                       "dp_plain_max": shards["dp_plain_max"]}, dev, flush),
        check_dw(gd, gu, shards, dev, flush,
                 {"minibatch_plain": mb["minibatch_plain"][0],
                  "link_plain": gl}),
        *check_fwd_dx(shards, dev, flush, gd),
        check_force_rowmajor(gp, dev, flush),
        *check_seg_sum_bf16({run: gd for run in BF16_RUNS}, dev, flush),
        check_dw_bf16(gd, dev, flush),
    ]
    compare_fused_forms({"compact_multiply_first": gd, SLICE_MAIN: gp}, dev,
                        flush)
    check_rgcn_layer0(gd, dev)
    del flush, gd, gu, gp, ga, shards, on_card, mb, gl, link_shapes
    torch.cuda.empty_cache()

    launches, summaries = {}, {}
    for run, r in RUNS.items():
        launches[run], summaries[run] = check_training(
            datasets[_data_key(r)], dev, card, run)
    ratio = (summaries[MAIN]["kernel"]["median_warm_step_ms"]
             / summaries["compact_multiply_first"]["kernel"]
             ["median_warm_step_ms"])
    print(f"plain / compact multiply-first step time, kernels ({card}): "
          f"{ratio:.3f}")
    ratio = (summaries["rgcn_plain"]["kernel"]["median_warm_step_ms"]
             / summaries["rgcn_compact"]["kernel"]["median_warm_step_ms"])
    print(f"RGCN plain / compact step time, kernels ({card}): {ratio:.3f}")
    ratio = (summaries["hgt_plain"]["kernel"]["median_warm_step_ms"]
             / summaries["hgt_compact"]["kernel"]["median_warm_step_ms"])
    print(f"HGT plain / compact step time, kernels ({card}): {ratio:.3f}")
    for run in COMPILED_RUNS:
        launches[run], summaries[run] = check_compiled(data, dev, card, run,
                                                       summaries)
    for run in MB_RUNS:
        launches[run], summaries[run] = check_minibatch(data, dev, card, run)
    for run in LINK_RUNS:
        launches[run], summaries[run] = check_link(link_data, dev, card, run)
    del link_data
    bf16 = check_bf16_training(datasets, dev, card, summaries)
    check_resume(data, dev, card)
    for key in list(datasets):  # host memory for the full-scale graph
        if key != _data_key(RUNS[MAIN]):
            del datasets[key]
    full_launches, full_by_dtype, full_totals, walks = check_full_scale(
        dev, card)
    entries += walks
    launches.update(full_launches)
    t0 = time.perf_counter()
    launches.update(check_dp(data, parts, dev, card))
    t1 = time.perf_counter()
    launches.update(check_dryruns(card))
    print(f"data-parallel phase: {time.perf_counter() - t0:.1f} s (the "
          f"training runs, the profile, the 2-rank dry run and "
          f"bench.scaling {t1 - t0:.1f} s, the 4-rank dry run "
          f"{time.perf_counter() - t1:.1f} s)")
    # the bf16 instantiations' launches: each typed kernel's count by
    # element types, on this slice's bf16 main path (the dW's on the bf16
    # plain RGAT run, the only one that reaches it)
    by_dtype = {run: counts for run, (_, counts) in bf16.items()}
    by_dtype.update(full_by_dtype)
    launches.update({run: counts for run, (counts, _) in bf16.items()})
    for entry in entries:
        kernel = entry["name"]
        if "[" in kernel:
            base, key = kernel[:-1].split("[")
            main = BF16_DW if base == "segment_matmul_dw" else BF16_MAIN
            entry["launches"] = by_dtype[main][base].get(key, 0)
            entry["launches_by_run"] = {r: c[base].get(key, 0)
                                        for r, c in by_dtype.items()}
            if key in full_totals["bf16"]:
                entry["per_run"][BF16_FULL] = full_totals["bf16"][key]
            continue
        if kernel in full_totals:
            entry["per_run"][FULL] = full_totals[kernel]
        if kernel == "seg_sum_sorted":
            entry["per_run"][MB_FULL] = full_totals["minibatch"]
        # each kernel's launches on its own main path: this slice's
        # minibatch path for the segment sum, the packed max path for the
        # segment max, the single-card plain RGAT for the dW, the
        # data-parallel run for the forward and dX, whose only caller is a
        # shard, the compact multiply-first run for the packed op's walks;
        # no path calls the row copy (nor does het_tpu)
        main = {"segment_matmul_fwd": DP_MAIN, "segment_matmul_dx": DP_MAIN,
                "segment_matmul_dw": MAIN, "seg_sum_sorted": MB_MAIN,
                **dict.fromkeys(WALKS, "compact_multiply_first")}.get(
                    kernel, SLICE_MAIN)
        entry["launches"] = launches[main][kernel]
        entry["launches_by_run"] = {r: counts[kernel]
                                    for r, counts in launches.items()}
    check_bench(dev, card)
    # the breakdown phase's launches beside every other run's
    for run, counts in check_breakdown(parts, dev, card).items():
        for entry in entries:
            if "[" not in entry["name"]:
                entry["launches_by_run"][run] = counts.get(entry["name"], 0)
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
