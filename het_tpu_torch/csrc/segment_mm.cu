// Relation-segmented matmul for Hopper (sm_90a): the forward, the input
// gradient (dX) and the grouped weight gradient (dW) of
//
//     y[i, h, o] = sum_k x[i, (Hx > 1 ? h : 0) * K + k] * W[s(i), h, k, o]
//
// with s(i) the segment whose rows [seg_ptrs[s], seg_ptrs[s+1]) hold row i.
// W is (S, H, K, O) f32, Hx in {1, H}, seg_ptrs (S + 1,) int32 on the
// device, non-decreasing, seg_ptrs[S] <= n_rows.  The offsets are read on
// the device only: the segmentations these kernels serve (the shards of a
// partitioned graph) have no host copy of them.
//
// ------------------------------------------------------------- forward
//
//     y[i, h*O + o] = sum_k x[i, (Hx>1 ? h : 0)*K + k] W[s, h, k, o]
//
// Replaces the TPU kernels het_tpu/ops/pallas/segment_mm.py::_fwd_resident
// (W whole in VMEM) and ::_fwd_streamed (one relation's block DMA'd per
// run of row tiles past the 4 MB VMEM budget); both fold the heads into
// the minor dimension for the MXU, a TPU workaround.  Here one kernel pair
// takes any W: a relation's weight slice is staged per run of rows of that
// relation, never W whole.  A group is the K columns of x that meet Cg
// output columns: per head (Hx = H) group h's K columns against O; for
// shared x (Hx = 1) the one group of K columns against all Cg = H*O, so x
// is read once for every head.
//
// Bound.  Bytes: x read once, y written once, W read once: n_rows * (Hx*K +
// H*O) * 4 + S*H*K*O*4.  Operations: 2 * n_rows * H*K*O.  Two regimes, two
// kernels over one walk (FwdWalk): a block takes a range of rows as
// 64-row tiles cut at segment ends, so that a tile's rows share one
// relation, streams their x rows through a 3-stage cp.async ring
// (zero-filled past the tile and past K; k tiles of 64 where K > 64), and
// stages the relation's (K, BN) weight slice in shared memory once for
// each run of tiles of one relation, by cp.async one commit group ahead
// of the next tile's.  A tile takes one barrier: the copies into the slot
// read last round start after it.  The blocks fill one wave of the card.
//  * narrow, Cg <= 16 (the attention columns W.a_r, C = 4; the layer-1
//    typed linears, 8 and 12): under 2 * 16 * 64 / ((64 + 16) * 4) = 6.4
//    operations a byte at K = 64, so bytes bound: the work is to read
//    every byte of x once with enough rows in flight.
//    segment_matmul_fwd_narrow_kernel gives each row of a tile four lanes
//    that split its k (a float4 of x each for every 16 k), reads W as a
//    broadcast from shared memory, and meets the four lanes by a 2-step
//    reduce-scatter that leaves each a quarter of the row's BN columns
//    (a float4 where BN = 16).  An earlier layout, a row's float4 spread
//    over K/4 lanes with its 4 x Cg weights in registers and a
//    reduce-scatter over 16 lanes, took 101-171 registers and ran C = 8
//    and 12 slower than the kernel it replaced.
//  * wide, Cg > 16 (the typed linears' 64 and 68, the general K = O = 64):
//    16-16.5 operations a byte at K = 64, near the f32 ridge of 67 TFLOP/s
//    over 3.35 TB/s (20), so the FMAs must overlap the loads and few
//    shared-memory loads may feed them.  segment_matmul_fwd_wide_kernel
//    covers Cg in as few column passes of BN in {64, 80, 96} as it can
//    (68: one 80-column pass, x read once), 8 x 4 outputs a thread (eight
//    float4 of x and four of W for 128 FMAs), y stored as float4, its
//    registers capped so that 3 blocks share an SM.
// Rows are read 16 bytes at a time where they are 16-byte aligned;
// otherwise (K not a multiple of 4, x a view that starts off 16 bytes) the
// same kernels load 4 bytes at a time.  Rows outside [seg_ptrs[0],
// seg_ptrs[S]) are written as zeros and never read.  Each output is one
// dot product in a fixed order: deterministic, no atomics.  Plain f32
// FMAs, no tensor cores: their f32 path is TF32, which the port's f32 runs
// (TF32 off) must not take.
//
// ------------------------------------------------------------------ dX
//
//     dx[i, h*K + k] = sum_o ct[i, h*O + o] W[s, h, k, o]     (Hx = H)
//     dx[i, k]       = sum_{h,o} ct[i, h*O + o] W[s, h, k, o] (Hx = 1)
//
// Replaces ::_dx_resident and the streamed ::segment_matmul_rows_dx, TPU
// kernels of the forward's layout that transpose W in their wrapper.  Here
// the dX is the forward with ct in x's place and W read transposed, on the
// same walk and, but for the path's narrow reductions, the same kernels:
// their kDx flag changes only the address of a staged weight entry.  In
// the forward's dimensions (H', G, K', O'), a
// group's K' columns of ct against its O' columns of dx:
//  * Hx = 1: (1, 1, H*O, K), W'[s, 0, j, k] = W[s, j / O, k, j % O]: all
//    of ct's row is one group's reduction, so ct is read once;
//  * Hx = H: (H, H, O, K), W'[s, h, o, k] = W[s, h, k, o].
// The forward's strides then hold as they are (a ct row is H*O floats, a
// dx row Hx*K), the plan is the forward's on these dimensions
// (ops/kernels/segment_mm.py::dx_plan), and a relation's weight slice is
// staged once a run of its rows, its neighbouring columns O floats apart in
// W (a strided L2 read once a run).
//
// Bound.  Bytes: ct read once, dx written once, W read once: n_rows *
// (H*O + Hx*K) * 4 + S*H*K*O*4.  Operations: 2 * n_rows * H*K*O.  On the
// path (H*O = 4, 8, 12 ct columns against K = 64) under 2 * 12 * 64 / ((12
// + 64) * 4) = 5 operations a byte, so bytes bound, and 84-94% of the
// bytes are dx written.  The general K = O = 64 is the forward's shape, 16
// operations a byte.  Three kernels over the walk, by the plan:
//  * a reduction of 1-16 ct columns against dx groups past 16 columns (the
//    path's shapes): segment_matmul_dx_rows_kernel, a dX-only tile laid out
//    for the stores and for little work around them: 16 lanes a row, each
//    with a float4 of 64 dx columns and one store, R FMAs an output, tiles
//    of 256 rows.  The forward's wide kernel, its 64 x 64 tile computing 8
//    x 4 outputs a thread, ran these shapes slower (PERF.md §6);
//  * dx groups of at most 16 columns (per head, K <= 16): the forward's
//    narrow kernel;
//  * the rest, the forward's wide kernel: K = 130 in two 80-column passes,
//    reductions past 64 (the general K = O = 64, H*O = 200) in k tiles of
//    64; its k loop runs to the reduction rounded up to 4, and only those
//    rows of W are staged.
// Rows outside [seg_ptrs[0], seg_ptrs[S]) are written as zeros and never
// read; each output is one dot product in a fixed order; plain f32 FMAs.
//
// ------------------------------------------------------------------- dW
//
//     dW[s, h, k, o] = sum_{i in [seg_ptrs[s], seg_ptrs[s+1])}
//                          x[i, (Hx > 1 ? h : 0) * K + k] * ct[i, h * O + o]
//
// x is (n_rows, Hx * K) f32 with Hx in {1, H}; ct is (n_rows, H * O) f32;
// seg_ptrs (S + 1,) int32 non-decreasing; dW is (S, H, K, O) f32 and a
// segment that owns no rows gives zeros.
//
// Replaces the TPU kernels het_tpu/ops/pallas/segment_mm.py::_dw_resident
// (whole dW resident in VMEM across an in-order grid) and
// ::segment_matmul_rows_dw (one relation's block revisited tile after
// tile once W passes the VMEM budget).  Both carry a sum from one grid
// step to the next; on Hopper blocks run in parallel and in no order, so
// the sum is split in two launches:
//
//  1. chunk pass: every segment is cut into chunks of at most `chunk_rows`
//     rows that never cross a segment boundary, and one block a chunk (and
//     output tile) writes the chunk's (H, K, O) partial sums to scratch.
//     A block finds its own chunk by a block-wide scan of ceil(rows(s) /
//     chunk_rows) over the segments, so no planning launch precedes it;
//     block 0 also writes that prefix (chunk_ptr) for the reduce.  The
//     grid is the upper bound ceil(n_rows / chunk_rows) + S; blocks past
//     the last chunk leave.  The wrapper picks chunk_rows from n_rows, S
//     and the SM count, so that the grid fills the card for several waves
//     while the partials stay within 1/16 of the input bytes;
//  2. reduce: per segment, the chunks' partials summed in chunk order.
// The result is deterministic and uses no atomics.  No row outside
// [seg_ptrs[0], seg_ptrs[S]) is read.
//
// A chunk's output is x_chunk[:, g]^T ct_chunk[:, cols(g)] for each group
// g.  With one x row for all heads (Hx = 1) there is one group, whose NC
// = H * O columns are all of ct, so x is read once for every head; with
// one x row a head (Hx = H), group h is head h's K columns of x against
// its NC = O columns of ct.
//
// Bound.  Bytes: every row of x and ct read once, rows * (Hx*K + H*O) * 4,
// plus the (S, H, K, O) output.  Operations: 2 * rows * H*K*O.  Two
// regimes, two chunk kernels:
//  * narrow, NC <= 16 (the attention-vector dWs, O = 1; the typed linears'
//    H*O = 4, 8, 12 on shards): under 2 * 16 * K / ((K + 16) * 4) = 8
//    operations a byte, so bytes bound; the work is to read every byte
//    once, 16 bytes a lane, with enough rows in flight.
//    dw_narrow_kernel gives a lane one float4 of an x row (4 neighbouring
//    columns, all heads' columns in one pass: Hx*K / 4 lanes a row, so
//    two rows a warp at K = 64 and eight at H*K = 8) and the NC ct values
//    that row's columns meet in registers (a float4 load where NC % 4 ==
//    0; lanes of a row read the same ct addresses, one transaction), and
//    keeps 4 rows of loads in flight.  The lanes of a row team meet by
//    shuffles and the warps in shared memory, in a fixed order.
//  * wide, NC > 16 (the typed linears' H*O = 64 and 68, the general K = O
//    = 64): 2 * K * NC / ((K + NC) * 4) = 16-16.5 operations a byte at K =
//    64, near the f32 ridge of 67 TFLOP/s over 3.35 TB/s (20), so the FMAs
//    must overlap the loads and few shared-memory loads may feed them.
//    dw_wide_kernel keeps a 64 (k) x BN (columns) output tile, BN in {64,
//    80, 96} picked to cover NC in as few column passes as it can (NC =
//    68: one 80-column pass, x read once, no 4-column tail tile), 8 x 4
//    outputs a thread (two float4 of x and one of ct from shared memory
//    for 32 FMAs), and stages 32 rows at a time with cp.async into a ring
//    of 3 stages, so the copies of the next two stages are in flight
//    while one is multiplied.  Wider K and NC take more k tiles and column
//    passes (blockIdx.y).
// Rows are read 16 bytes at a time where they are 16-byte aligned;
// otherwise (K or NC not a multiple of 4, x a view that starts off 16
// bytes) the same kernels load 4 bytes at a time.  Plain f32 FMAs, no
// tensor cores: their f32 path is TF32, which fails the port's limit.
//
// bf16 x and ct (het_tpu's mixed-precision step: plain RGAT's
// attention-vector dW, _dw_resident on bf16 operands) take the same
// kernels instantiated on __nv_bfloat16: the narrow kernel reads 4
// elements a load (8 bytes) where the f32 one reads a float4, the wide
// kernel stages the rows as they are, 16-byte cp.async of 8 elements
// where K, NC and H*O are multiples of 8 and the rows 16-byte aligned,
// else 2-byte loads and stores, and both widen each value to f32 where
// the FMA reads it.  A product of two bf16 values is exact in f32, so
// partials, sums and dW are f32 as for f32 operands and the f32 limit
// holds.  Bound: the same bytes at 2 bytes a bf16 input element, the
// operations at the bf16 rate.  A tensor-core (mma.sync / wgmma) bf16 dW
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// --------------------------------------------------------------- chunks

// The rows [lo, hi) and segment s of a block's chunk.
struct Chunk {
  int64_t lo, hi;
  int s;
};

__device__ __forceinline__ int32_t chunks_of(const int32_t* seg_ptrs, int s,
                                             int rows) {
  const int64_t len = static_cast<int64_t>(__ldg(seg_ptrs + s + 1)) -
                      __ldg(seg_ptrs + s);
  return len > 0 ? static_cast<int32_t>((len + rows - 1) / rows) : 0;
}

// Chunk blockIdx.x of the split of every segment into chunks of at most
// `rows` rows, in segment order; false past the last chunk (the same
// answer for every thread).  The block's T threads scan the chunk counts:
// each thread takes a run of neighbouring segments, the warps scan by
// shuffles and meet in shared memory.  Block (0, 0) also writes chunk_ptr
// (S + 1,), the prefix of chunks a segment, for the reduce.
template <int T>
__device__ bool find_chunk(const int32_t* __restrict__ seg_ptrs,
                           int32_t* __restrict__ chunk_ptr, int S, int rows,
                           Chunk* c) {
  static_assert(T % 32 == 0, "whole warps");
  __shared__ int32_t warp_sum[T / 32];
  __shared__ int32_t found_s, found_first;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (S + T - 1) / T;
  const int s0 = min(t * per, S), s1 = min(s0 + per, S);
  int32_t mine = 0;
  for (int s = s0; s < s1; ++s) mine += chunks_of(seg_ptrs, s, rows);
  int32_t v = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sum[warp] = v;
  if (t == 0) found_s = -1;
  __syncthreads();
  int32_t first = v - mine;  // chunks before segment s0
  for (int w = 0; w < warp; ++w) first += warp_sum[w];
  const int64_t b = blockIdx.x;
  const bool write = blockIdx.x == 0 && blockIdx.y == 0;
  if (write && t == 0) chunk_ptr[0] = 0;
  for (int s = s0; s < s1; ++s) {
    const int32_t n = chunks_of(seg_ptrs, s, rows);
    if (b >= first && b < first + n) {  // one thread at most
      found_s = s;
      found_first = first;
    }
    first += n;
    if (write) chunk_ptr[s + 1] = first;
  }
  __syncthreads();
  const int s = found_s;
  if (s < 0) return false;
  const int64_t start = __ldg(seg_ptrs + s), end = __ldg(seg_ptrs + s + 1);
  c->s = s;
  c->lo = start + (b - found_first) * rows;
  c->hi = c->lo + rows < end ? c->lo + rows : end;
  return true;
}

// ------------------------------------------------------ narrow chunks

constexpr int kNarrowThreads = 128;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowInFlight = 4;  // rows of loads a lane keeps in flight

// Loads of V neighbouring elements of In (f32, or bf16 widened to f32 as
// they are read: a bf16's bits are the high half of the f32 it equals).
template <class In, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float get(const T& a, int e) {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
  }
};

template <>
struct Vec<float, 1> {
  using T = float;
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static float get(const T& a, int) { return a; }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <>
struct Vec<__nv_bfloat16, 4> {  // 8 bytes
  using T = uint2;
  __device__ static T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static float get(const T& a, int e) {
    const uint32_t w = e < 2 ? a.x : a.y;
    return e % 2 ? bf16_hi(w) : bf16_lo(w);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using T = unsigned short;
  __device__ static T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static float get(const T& a, int) {
    return __uint_as_float(static_cast<uint32_t>(a) << 16);
  }
};

// The ct values of one row that a lane's x columns meet: cv[e][o] =
// ct_row[coff[e] + o] for o < ncl, zero past it.  Per head (CE = V) each
// x column e has its head's offset; neighbouring columns of one head
// (`same`) share the first one's values.
template <class In, int NCP, bool kCtVec, int CE>
__device__ __forceinline__ void load_ct(const In* __restrict__ row,
                                        const int (&coff)[CE], int ncl,
                                        bool same, float (&cv)[CE][NCP]) {
  using Q = Vec<In, 4>;
  using E = Vec<In, 1>;
#pragma unroll
  for (int e = 0; e < CE; ++e) {
    if (e > 0 && same) {
#pragma unroll
      for (int o = 0; o < NCP; ++o) cv[e][o] = cv[0][o];
    } else if (kCtVec) {
#pragma unroll
      for (int q = 0; q < NCP / 4; ++q) {
        const typename Q::T f = Q::load(row + coff[e] + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[e][4 * q + j] = Q::get(f, j);
      }
    } else {
#pragma unroll
      for (int o = 0; o < NCP; ++o)
        cv[e][o] = o < ncl ? E::get(E::load(row + coff[e] + o), 0) : 0.f;
    }
  }
}

// In: the element type of x and ct (f32, or bf16 widened where read).
// NCP: the ct columns an x column meets (NCL = O per head, H * O for
// shared x), rounded up to 1, 4, 8, 12 or 16.  kVec: x read 4 elements a
// load (Hx*K % 4 == 0, x 16-byte aligned); kCtVec: ct read 4 elements a
// load (shared x, NCL == NCP, ct 16-byte aligned); kPerHead: Hx = H.  L: lanes a row
// (a power of two; 32 / L rows a warp); a lane holds V neighbouring x
// columns and every pass of the block covers L * V of the Hx*K columns.
template <class In, int NCP, bool kVec, bool kCtVec, bool kPerHead>
__global__ void __launch_bounds__(kNarrowThreads)
segment_matmul_dw_narrow_kernel(const In* __restrict__ x,
                                const In* __restrict__ ct,
                                const int32_t* __restrict__ seg_ptrs,
                                int32_t* __restrict__ chunk_ptr,
                                float* __restrict__ partial, int S, int H,
                                int K, int O, int rows, int L) {
  constexpr int V = kVec ? 4 : 1;
  constexpr int CE = kPerHead ? V : 1;  // ct offsets a lane holds a row
  constexpr int UN = kNarrowInFlight;
  using Op = Vec<In, V>;
  __shared__ float red[32 * V * NCP];
  Chunk c;
  if (!find_chunk<kNarrowThreads>(seg_ptrs, chunk_ptr, S, rows, &c)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = 32 / L, grp = lane / L, sub = lane % L;
  const int NG = kNarrowWarps * G;  // row teams in the block
  const int XW = (kPerHead ? H : 1) * K;
  const int HO = H * O;
  const int ncl = kPerHead ? O : HO;
  const int NV = XW / V;
  const bool same = K % V == 0;  // a lane's V columns lie in one head
  float* out = partial + static_cast<int64_t>(blockIdx.x) * H * K * O;

  for (int v0 = 0; v0 < NV; v0 += L) {
    const bool active = v0 + sub < NV;
    const int j = (v0 + sub) * V;  // the lane's first x column
    int coff[CE];
#pragma unroll
    for (int e = 0; e < CE; ++e) coff[e] = kPerHead ? (j + e) / K * O : 0;
    float acc[V][NCP];
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int o = 0; o < NCP; ++o) acc[e][o] = 0.f;
    if (active) {
      const In* xp = x + j;
      int64_t i = c.lo + warp * G + grp;
      for (; i + (UN - 1) * NG < c.hi; i += UN * NG) {
        typename Op::T xv[UN];
        float cv[UN][CE][NCP];
#pragma unroll
        for (int u = 0; u < UN; ++u) {
          const int64_t r = i + u * NG;
          xv[u] = Op::load(xp + r * XW);
          load_ct<In, NCP, kCtVec, CE>(ct + r * HO, coff, ncl, same,
                                       cv[u]);
        }
#pragma unroll
        for (int u = 0; u < UN; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e)
#pragma unroll
            for (int o = 0; o < NCP; ++o)
              acc[e][o] = fmaf(Op::get(xv[u], e), cv[u][kPerHead ? e : 0][o],
                               acc[e][o]);
      }
      for (; i < c.hi; i += NG) {
        const typename Op::T xv = Op::load(xp + i * XW);
        float cv[CE][NCP];
        load_ct<In, NCP, kCtVec, CE>(ct + i * HO, coff, ncl, same, cv);
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int o = 0; o < NCP; ++o)
            acc[e][o] = fmaf(Op::get(xv, e), cv[kPerHead ? e : 0][o],
                             acc[e][o]);
      }
    }
    // fixed-order trees: a warp's row teams meet by shuffles, then the
    // warps in shared memory in warp order
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int o = 0; o < NCP; ++o)
        for (int d = L; d < 32; d <<= 1)
          acc[e][o] += __shfl_xor_sync(kFull, acc[e][o], d);
    for (int w = 0; w < kNarrowWarps; ++w) {
      if (warp == w && grp == 0 && active) {
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int o = 0; o < NCP; ++o) {
            float& r = red[(sub * V + e) * NCP + o];
            r = w == 0 ? acc[e][o] : r + acc[e][o];
          }
      }
      __syncthreads();
    }
    // a chunk's partial is (H, K, O) per head and (K, H*O) for shared
    // x: x column jj (h*K + k, or k) meets ct column o of its group
    for (int t = threadIdx.x; t < L * V * NCP; t += kNarrowThreads) {
      const int jj = v0 * V + t / NCP, o = t % NCP;
      if (jj < XW && o < ncl) out[static_cast<int64_t>(jj) * ncl + o] = red[t];
    }
    __syncthreads();  // red is rewritten by the next pass
  }
}

// -------------------------------------------------------- wide chunks

constexpr int kWideK = 64;     // k extent of a block's output tile
constexpr int kWideRows = 32;  // rows a stage
constexpr int kWideStages = 3;

template <class In, int BN>
__host__ __device__ constexpr int wide_smem_bytes() {
  return kWideStages * kWideRows * (kWideK + BN) * static_cast<int>(sizeof(In));
}

template <int BN>
__host__ __device__ constexpr int wide_threads() {
  return 2 * BN;
}

// cp.async of V floats (16 bytes through L2 only, or 4); `ok` false fills
// the destination with zeros and reads nothing.
template <int V>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A stage's copy of V elements: cp.async of 16 bytes (through L2 only)
// or of one f32 (4 bytes); a bf16 element alone (2 bytes, below cp.async's
// smallest size) is loaded and stored.  `ok` false fills zeros and reads
// nothing.
template <class In, int V>
__device__ __forceinline__ void stage_copy(In* smem, const In* gmem,
                                           bool ok) {
  if constexpr (sizeof(In) * V == 16) {
    cp_async<4>(reinterpret_cast<float*>(smem),
                reinterpret_cast<const float*>(gmem), ok);
  } else if constexpr (sizeof(In) == 4) {
    cp_async<1>(reinterpret_cast<float*>(smem),
                reinterpret_cast<const float*>(gmem), ok);
  } else {
    *reinterpret_cast<unsigned short*>(smem) =
        ok ? __ldg(reinterpret_cast<const unsigned short*>(gmem)) : 0;
  }
}

// 8 neighbouring k of a staged x row and 4 neighbouring columns of a
// staged ct row, as f32.
template <class In>
__device__ __forceinline__ void stage_read(const In* xr, const In* cr,
                                           float (&av)[8], float (&bv)[4]) {
  if constexpr (sizeof(In) == 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(xr);
    const float4 a1 = *reinterpret_cast<const float4*>(xr + 4);
    const float4 b = *reinterpret_cast<const float4*>(cr);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    bv[0] = b.x; bv[1] = b.y; bv[2] = b.z; bv[3] = b.w;
  } else {
    const uint4 a = *reinterpret_cast<const uint4*>(xr);
    const uint2 b = *reinterpret_cast<const uint2*>(cr);
    av[0] = bf16_lo(a.x); av[1] = bf16_hi(a.x);
    av[2] = bf16_lo(a.y); av[3] = bf16_hi(a.y);
    av[4] = bf16_lo(a.z); av[5] = bf16_hi(a.z);
    av[6] = bf16_lo(a.w); av[7] = bf16_hi(a.w);
    bv[0] = bf16_lo(b.x); bv[1] = bf16_hi(b.x);
    bv[2] = bf16_lo(b.y); bv[3] = bf16_hi(b.y);
  }
}

// blockIdx.y enumerates (head, k tile, column pass); 8 x (BN / 4) threads
// each own 8 x 4 outputs (k = k0 + 8 ty + p, column c = c0 + 4 tx + q).
// A pass's columns are head h's o (Hx = H) or ct's h * O + o (Hx = 1,
// h = 0).  In: the element type of x and ct, staged as it is and widened
// to f32 where the FMAs read it.  kVec: 16-byte copies (K, NC and H*O
// multiples of 16 bytes' elements, x and ct 16-byte aligned).
template <class In, int BN, bool kVec>
__global__ void __launch_bounds__(wide_threads<BN>())
segment_matmul_dw_wide_kernel(const In* __restrict__ x,
                              const In* __restrict__ ct,
                              const int32_t* __restrict__ seg_ptrs,
                              int32_t* __restrict__ chunk_ptr,
                              float* __restrict__ partial, int S, int H,
                              int Hx, int K, int O, int rows) {
  constexpr int T = wide_threads<BN>(), TX = BN / 4;
  constexpr int V = kVec ? 16 / static_cast<int>(sizeof(In)) : 1;
  constexpr int XS = kWideRows * kWideK, CS = kWideRows * BN;  // a stage
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  In* xs = reinterpret_cast<In*>(smem_bytes);
  In* cs = xs + kWideStages * XS;
  Chunk c;
  if (!find_chunk<T>(seg_ptrs, chunk_ptr, S, rows, &c)) return;
  const int NC = Hx > 1 ? O : H * O;
  const int nct = (NC + BN - 1) / BN, nkt = (K + kWideK - 1) / kWideK;
  int tile = blockIdx.y;
  const int c0 = tile % nct * BN;
  tile /= nct;
  const int k0 = tile % nkt * kWideK;
  const int h = tile / nkt;
  const int kw = min(kWideK, K - k0), cw = min(BN, NC - c0);
  const int64_t xld = static_cast<int64_t>(Hx) * K;
  const int64_t cld = static_cast<int64_t>(H) * O;
  const In* xb = x + static_cast<int64_t>(h) * K + k0;
  const In* cb = ct + static_cast<int64_t>(h) * O + c0;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  // rows [r0, r0 + kWideRows) into ring slot `buf`, zeros past the chunk
  // and past the tile's k and column extents
  auto stage = [&](int buf, int64_t r0) {
    In* xd = xs + buf * XS;
    In* cd = cs + buf * CS;
#pragma unroll
    for (int e = threadIdx.x; e < XS / V; e += T) {
      const int r = e / (kWideK / V), q = e % (kWideK / V) * V;
      const int64_t i = r0 + r;
      const bool ok = i < c.hi && q < kw;
      stage_copy<In, V>(xd + r * kWideK + q, ok ? xb + i * xld + q : x, ok);
    }
#pragma unroll
    for (int e = threadIdx.x; e < CS / V; e += T) {
      const int r = e / (BN / V), q = e % (BN / V) * V;
      const int64_t i = r0 + r;
      const bool ok = i < c.hi && q < cw;
      stage_copy<In, V>(cd + r * BN + q, ok ? cb + i * cld + q : ct, ok);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  const int nst = static_cast<int>((c.hi - c.lo + kWideRows - 1) / kWideRows);
#pragma unroll
  for (int st = 0; st < kWideStages - 1; ++st) {
    if (st < nst) stage(st, c.lo + static_cast<int64_t>(st) * kWideRows);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    const int next = st + kWideStages - 1;  // into the slot read last round
    if (next < nst)
      stage(next % kWideStages, c.lo + static_cast<int64_t>(next) * kWideRows);
    cp_async_commit();
    cp_async_wait<kWideStages - 1>();  // stage st has landed
    __syncthreads();
    const In* xd = xs + st % kWideStages * XS + ty * 8;
    const In* cd = cs + st % kWideStages * CS + tx * 4;
#pragma unroll 8
    for (int r = 0; r < kWideRows; ++r) {
      float av[8], bv[4];
      stage_read<In>(xd + r * kWideK, cd + r * BN, av, bv);
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();  // the slot is refilled next round
  }
  cp_async_wait<0>();

  // a chunk's partial is (H, K, O) per head and (K, H*O) for shared x:
  // group h's (K, NC) block, row k, column col
  float* out = partial + static_cast<int64_t>(blockIdx.x) * H * K * O +
               static_cast<int64_t>(h) * K * NC;
  const int col = c0 + tx * 4;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int k = k0 + ty * 8 + p;
    if (k >= K || col >= NC) continue;
    float* row = out + static_cast<int64_t>(k) * NC + col;
    if (kVec) {  // NC % 4 == 0: the 4 columns are in the tile, aligned
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < NC) row[q] = acc[p][q];
    }
  }
}

// ---------------------------------------------------------------- reduce

// out[s] = the sum over the chunks of s of their partials, as (H, K, O).
// A block covers 256 / CL entries j of a chunk's partial; CL lanes an
// entry stride the chunks (four loads in flight, four sums) and meet in
// shared memory in lane order, a fixed order.  For shared x (NC = H*O >
// 0) entry j = k * NC + h * O + o of the (K, H*O) partial is out's (h, k,
// o); per head (NC = 0) the layouts agree.
template <int CL>
__global__ void __launch_bounds__(kThreads)
segment_matmul_dw_reduce_kernel(const float* __restrict__ partial,
                                const int32_t* __restrict__ chunk_ptr,
                                float* __restrict__ out, int64_t NJ, int K,
                                int O, int NC) {
  constexpr int CB = kThreads / CL;
  __shared__ float red[CL][CB];
  const int s = blockIdx.x;
  const int col = threadIdx.x % CB, ln = threadIdx.x / CB;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * CB + col;
  const int c0 = __ldg(chunk_ptr + s), c1 = __ldg(chunk_ptr + s + 1);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (j < NJ) {
    const float* p = partial + j;
    int c = c0 + ln;
    for (; c + 3 * CL < c1; c += 4 * CL) {
      a0 += __ldg(p + static_cast<int64_t>(c) * NJ);
      a1 += __ldg(p + static_cast<int64_t>(c + CL) * NJ);
      a2 += __ldg(p + static_cast<int64_t>(c + 2 * CL) * NJ);
      a3 += __ldg(p + static_cast<int64_t>(c + 3 * CL) * NJ);
    }
    for (; c < c1; c += CL) a0 += __ldg(p + static_cast<int64_t>(c) * NJ);
  }
  red[ln][col] = (a0 + a1) + (a2 + a3);
  __syncthreads();
  if (ln == 0 && j < NJ) {
    float sum = red[0][col];
#pragma unroll
    for (int l = 1; l < CL; ++l) sum += red[l][col];
    int64_t o = j;
    if (NC > 0) {
      const int64_t k = j / NC, c = j % NC;
      o = (c / O * K + k) * O + c % O;
    }
    out[static_cast<int64_t>(s) * NJ + o] = sum;
  }
}

// ------------------------------------------------------------ launches

// Calls fn(kernel) with the chunk kernel a plan names (see
// het_segment_matmul_dw_f32), on elements In; cudaErrorInvalidValue where
// none is built.
template <class In, int NCP, bool kPerHead, class Fn>
cudaError_t with_narrow_ncp(bool vec, bool ct_vec, Fn fn) {
  if (ct_vec) {
    if constexpr (NCP % 4 == 0 && !kPerHead) {
      return vec ? fn(segment_matmul_dw_narrow_kernel<In, NCP, true, true, false>)
                 : fn(segment_matmul_dw_narrow_kernel<In, NCP, false, true, false>);
    }
    return cudaErrorInvalidValue;
  }
  return vec ? fn(segment_matmul_dw_narrow_kernel<In, NCP, true, false, kPerHead>)
             : fn(segment_matmul_dw_narrow_kernel<In, NCP, false, false, kPerHead>);
}

template <class In, bool kPerHead, class Fn>
cudaError_t with_narrow(int cols, bool vec, bool ct_vec, Fn fn) {
  switch (cols) {
    case 1: return with_narrow_ncp<In, 1, kPerHead>(vec, ct_vec, fn);
    case 4: return with_narrow_ncp<In, 4, kPerHead>(vec, ct_vec, fn);
    case 8: return with_narrow_ncp<In, 8, kPerHead>(vec, ct_vec, fn);
    case 12: return with_narrow_ncp<In, 12, kPerHead>(vec, ct_vec, fn);
    case 16: return with_narrow_ncp<In, 16, kPerHead>(vec, ct_vec, fn);
    default: return cudaErrorInvalidValue;
  }
}

// fn(kernel, threads, dynamic shared bytes) for the wide kernel of column
// tile `cols` on elements In, after allowing it that much shared memory
template <class In, bool kVec, int BN, class Fn>
cudaError_t with_wide_bn(Fn fn) {
  constexpr int smem = wide_smem_bytes<In, BN>();
  const auto kernel = segment_matmul_dw_wide_kernel<In, BN, kVec>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err != cudaSuccess ? err : fn(kernel, wide_threads<BN>(), smem);
}

template <class In, class Fn>
cudaError_t with_wide(int cols, bool vec, Fn fn) {
  switch (cols) {
    case 64: return vec ? with_wide_bn<In, true, 64>(fn) : with_wide_bn<In, false, 64>(fn);
    case 80: return vec ? with_wide_bn<In, true, 80>(fn) : with_wide_bn<In, false, 80>(fn);
    case 96: return vec ? with_wide_bn<In, true, 96>(fn) : with_wide_bn<In, false, 96>(fn);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -------------------------------------------------------------- forward

constexpr int kFwdRows = 64;   // rows a tile
constexpr int kFwdDepth = 64;  // k a stage
constexpr int kFwdStages = 3;

// Entry (k, c) of group g's (K, Cg) weight slice of relation s, in the
// kernels' dimensions (H, G, K, O).  Forward: W[s, h, k, o] with (h, o) =
// (g, c) per head (Cg = O) and (c / O, c % O) for shared x (g = 0, Cg =
// H * O).  dX (kDx; see the header): W[s, j / wO, c, j % wO] with j = g * K
// + k, W being (S, G * K / wO, O, wO).
template <bool kDx>
__device__ __forceinline__ const float* w_entry(const float* w, int s, int g,
                                                int H, int G, int K, int O,
                                                int wO, int k, int c) {
  if constexpr (kDx) {
    const int j = g * K + k, h = j / wO;
    return w + static_cast<int64_t>(s) * G * K * O +
           (static_cast<int64_t>(h) * O + c) * wO + (j - h * wO);
  } else {
    const int h = g + c / O;
    return w + ((static_cast<int64_t>(s) * H + h) * K + k) * O +
           (c - (h - g) * O);
  }
}

// The first segment that ends past `row` (S where none does) and its end
// (*end): where S < 32 one offset a lane of the warp, a single round trip,
// else a binary search.  The whole warp calls it.
__device__ __forceinline__ int segment_of(const int32_t* __restrict__ seg_ptrs,
                                          int S, int64_t row, int64_t* end) {
  if (S < 32) {
    const int lane = threadIdx.x & 31;
    const int64_t e = lane < S ? __ldg(seg_ptrs + lane + 1) : 0;
    const unsigned past = __ballot_sync(kFull, lane < S && e > row);
    const int s = past ? __ffs(past) - 1 : S;
    *end = __shfl_sync(kFull, e, s & 31);
    return s;
  }
  int s = 0;
  for (int hi = S; s < hi;) {
    const int mid = (s + hi) >> 1;
    if (__ldg(seg_ptrs + mid + 1) > row) hi = mid; else s = mid + 1;
  }
  *end = s < S ? __ldg(seg_ptrs + s + 1) : 0;
  return s;
}

// One item of a block's walk: k tile kt of the tile of rows [lo, lo + n),
// all in segment s; n = 0 past the last.
struct FwdItem {
  int64_t lo;
  int n, s, kt;
};

// A block's walk over the rows [r0, r1) of x for one group: tiles of at
// most ROWS rows cut at segment ends, so a tile's rows share one
// relation, each in k tiles of kFwdDepth columns (one where K <=
// kFwdDepth), staged by T threads with cp.async of V floats into a ring
// of kFwdStages slots of ROWS rows XST floats apart, zero-filled past the
// tile and past K.  Rows outside [seg_ptrs[0], seg_ptrs[S]) are skipped
// (the kernels write their zeros).  ROWS (kFwdRows but in the dX rows
// tile) bounds a tile; KD is the widest k tile staged (kFwdDepth, or the
// dX rows tile's 16 where K <= 16).
template <int T, int V, int XST, int ROWS = kFwdRows, int KD = kFwdDepth>
struct FwdWalk {
  const float* x;  // the group's first column
  const int32_t* seg_ptrs;
  float* xs;
  int64_t ldx, cur, end, seg_hi;
  int K, nkt, s;
  FwdItem p;  // the tile being staged, and its next k tile in p.kt

  __device__ FwdWalk(const float* xg, const int32_t* sp, float* ring,
                     int64_t ld, int K_, int64_t r0, int64_t r1, int64_t p0,
                     int64_t pS, int S)
      : x(xg), seg_ptrs(sp), xs(ring), ldx(ld), K(K_) {
    nkt = K > kFwdDepth ? (K + kFwdDepth - 1) / kFwdDepth : 1;
    // the segment of r0, not of max(r0, p0): the search then needs no
    // offset loaded before it, and the walk steps over what lies between
    s = segment_of(seg_ptrs, S, r0, &seg_hi);
    cur = r0 > p0 ? r0 : p0;
    end = r1 < pS ? r1 : pS;
    p = FwdItem{0, 0, 0, nkt};
  }

  // the next item, staged into ring slot `slot`: one commit group whether
  // or not there is one
  __device__ FwdItem produce(int slot) {
    if (p.kt >= nkt) {
      p = FwdItem{0, 0, 0, 0};
      if (cur < end) {
        while (cur >= seg_hi) seg_hi = __ldg(seg_ptrs + (++s) + 1);
        const int64_t hi_t = cur + ROWS;
        const int64_t hi = hi_t < seg_hi ? (hi_t < end ? hi_t : end)
                                         : (seg_hi < end ? seg_hi : end);
        p = FwdItem{cur, static_cast<int>(hi - cur), s, 0};
        cur = hi;
      }
    }
    const FwdItem it = p;
    ++p.kt;
    if (it.n > 0) {
      float* xd = xs + slot * (ROWS * XST);
      const int kb = it.kt * kFwdDepth;
      const int kd = min(kFwdDepth, K - kb), kd4 = (kd + 3) & ~3;
#pragma unroll 4
      for (int e = threadIdx.x; e < ROWS * (KD / V); e += T) {
        const int m = e / (KD / V), k = e % (KD / V) * V;
        if (k >= kd4) continue;
        const bool ok = m < it.n && k < kd;
        cp_async<V>(xd + m * XST + k, ok ? x + (it.lo + m) * ldx + kb + k : x,
                    ok);
      }
    }
    cp_async_commit();
    return it;
  }
};

// y's columns [c0, c0 + cw) of group g: float4 stores where they are
// 16-byte aligned
struct FwdOut {
  float* y;  // column c0 of the group in row 0
  int64_t ld;
  int cw;
  bool vec;

  __device__ FwdOut(float* y_, int H, int G, int O, int g, int c0, int cw_)
      : y(y_ + (G > 1 ? static_cast<int64_t>(g) * O : 0) + c0),
        ld(static_cast<int64_t>(H) * O), cw(cw_) {
    vec = ld % 4 == 0 && (G > 1 ? g * O : 0) % 4 == 0 && c0 % 4 == 0 &&
          reinterpret_cast<uintptr_t>(y_) % 16 == 0;
  }

  // N sums of row `row` from column c on
  template <int N>
  __device__ void store(int64_t row, int c, const float* v) const {
    float* dst = y + row * ld + c;
    if (N == 4 && vec && c % 4 == 0 && c + 3 < cw) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < N; ++q)
        if (c + q < cw) dst[q] = v[q];
    }
  }
};

// The column pass of a block: group g, columns c0 .. c0 + BN of Cg.
struct FwdPass {
  int Cg, g, c0, cw;
  __device__ FwdPass(int H, int G, int O, int BN) {
    Cg = G > 1 ? O : H * O;
    const int passes = (Cg + BN - 1) / BN;
    g = blockIdx.y / passes;
    c0 = blockIdx.y % passes * BN;
    cw = min(BN, Cg - c0);
  }
};

// ------------------------------------------------------- narrow forward

constexpr int kFwdNarrowThreads = 256;
constexpr int kFwdSlices = 4;                  // lanes a row: k slices
constexpr int kFwdNarrowStride = kFwdDepth + 16;  // floats a staged row

// One step of a reduce-scatter between lanes d apart: the lower lane keeps
// the sums of acc[0, HALF), the upper lane those of acc[HALF, 2 HALF), each
// now in acc[0, HALF).
template <int HALF, int N>
__device__ __forceinline__ void halve(float (&acc)[N], bool up, int d) {
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const float send = up ? acc[c] : acc[c + HALF];
    const float keep = up ? acc[c + HALF] : acc[c];
    acc[c] = keep + __shfl_xor_sync(kFull, send, d);
  }
}

template <int BN>
__host__ __device__ constexpr int fwd_narrow_smem_bytes() {
  // the ring, and W a k slice after another, 4 floats apart
  return (kFwdStages * kFwdRows * kFwdNarrowStride +
          kFwdSlices * (16 * BN + 4)) * 4;
}

// Cg <= BN <= 16 columns: lane j of a row's four takes the k = 4 j + 16 i
// + q (i, q < 4) of a 64-deep stage, a float4 of x for each i, and the
// BN weights of each k (BN / 4 float4 from shared memory, the same for the
// warp's eight rows: a broadcast).  The stride of 80 floats puts the two
// rows of a quarter warp on different halves of the banks, and W's
// slices 4 banks apart, so no load conflicts.  The four lanes then meet
// by a reduce-scatter (3 BN / 4 shuffles) that leaves lane j the columns
// j BN / 4 .. + BN / 4 of the row, stored as a float4 where BN = 16.
// kDx: the dX in the forward's dimensions (x is ct, y dx; see the header),
// wO the weight's own O.
template <int BN, bool kVec, bool kDx>
__global__ void __launch_bounds__(kFwdNarrowThreads)
segment_matmul_fwd_narrow_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const int32_t* __restrict__ seg_ptrs,
                                 float* __restrict__ y, int64_t n_rows,
                                 int64_t rows, int S, int H, int G, int K,
                                 int O, int wO) {
  constexpr int T = kFwdNarrowThreads, V = kVec ? 4 : 1;
  constexpr int XST = kFwdNarrowStride, XS = kFwdRows * XST;
  constexpr int WSLOT = 16 * BN + 4, Q = BN / 4;
  constexpr int WE = (kFwdDepth * BN + T - 1) / T;  // weights a thread
  static_assert(T == kFwdRows * kFwdSlices, "a row a lane team");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem + kFwdStages * XS;
  const FwdPass ps(H, G, O, BN);
  const FwdOut out(y, H, G, O, ps.g, ps.c0, ps.cw);
  const int m = threadIdx.x / kFwdSlices, j = threadIdx.x % kFwdSlices;
  const int64_t rb0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t rb1 = rb0 + rows < n_rows ? rb0 + rows : n_rows;
  if (rb0 >= rb1) return;
  const int64_t p0 = __ldg(seg_ptrs), pS = __ldg(seg_ptrs + S);
  {  // zeros on the rows of the range that no segment holds
    const float z[Q] = {};
    const int64_t a1 = p0 < rb1 ? p0 : rb1, b0 = pS > rb0 ? pS : rb0;
    for (int64_t r = rb0 + m; r < a1; r += kFwdRows) out.store<Q>(r, j * Q, z);
    for (int64_t r = b0 + m; r < rb1; r += kFwdRows) out.store<Q>(r, j * Q, z);
  }
  FwdWalk<T, V, XST> walk(x + static_cast<int64_t>(ps.g) * K, seg_ptrs, smem,
                          static_cast<int64_t>(G) * K, K, rb0, rb1, p0, pS,
                          S);

  float acc[BN];
#pragma unroll
  for (int c = 0; c < BN; ++c) acc[c] = 0.f;
  FwdItem i0 = walk.produce(0), i1 = walk.produce(1);
  int wseg = -1;
  for (int it = 0; i0.n > 0; ++it) {
    cp_async_wait<kFwdStages - 2>();  // item 0 has landed
    // ... in every thread's copies, and every thread is done with the
    // last round's slot and weights
    __syncthreads();
    const bool new_w = walk.nkt > 1 || i0.s != wseg;
    if (new_w) {
      // relation i0.s's weight slice, rows of k tile i0.kt, zeros past K
      // and past the pass's columns, one commit group ahead of the next
      // tile's
      wseg = i0.s;
      const int kb = i0.kt * kFwdDepth;
#pragma unroll
      for (int i = 0; i < WE; ++i) {
        const int e = threadIdx.x + i * T, kk = e / BN, c = e % BN;
        const bool ok = c < ps.cw && kb + kk < K;
        if (e < kFwdDepth * BN)
          cp_async<1>(ws + kk / 4 % 4 * WSLOT + (kk / 16 * 4 + kk % 4) * BN + c,
                      ok ? w_entry<kDx>(w, i0.s, ps.g, H, G, K, O, wO,
                                        kb + kk, ps.c0 + c) : w, ok);
      }
      cp_async_commit();
    }
    // into the slot read last round
    const FwdItem i2 = walk.produce((it + 2) % kFwdStages);
    if (new_w) {
      cp_async_wait<1>();  // the weights have landed
      __syncthreads();
    }
    const float* xr = smem + it % kFwdStages * XS + m * XST + 4 * j;
    const float* wj = ws + j * WSLOT;
    const int kd = min(kFwdDepth, K - i0.kt * kFwdDepth);
#pragma unroll
    for (int i = 0; i < kFwdDepth / 16; ++i) {
      if (16 * i + 4 * j >= kd) break;  // past K: nothing staged there
      const float4 a = *reinterpret_cast<const float4*>(xr + 16 * i);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < Q; ++c) {
          const float4 b =
              *reinterpret_cast<const float4*>(wj + (4 * i + q) * BN + 4 * c);
          acc[4 * c] = fmaf(av[q], b.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(av[q], b.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(av[q], b.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(av[q], b.w, acc[4 * c + 3]);
        }
      }
    }
    if (i0.kt == walk.nkt - 1) {
      // the row's four lanes: halves, then quarters, of the columns
      halve<BN / 2>(acc, j & 2, 2);
      halve<BN / 4>(acc, j & 1, 1);
      if (m < i0.n) out.store<Q>(i0.lo + m, j * Q, acc);
#pragma unroll
      for (int c = 0; c < BN; ++c) acc[c] = 0.f;
    }
    i0 = i1;
    i1 = i2;
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------- wide forward

constexpr int kFwdWideStride = kFwdDepth + 4;  // floats a staged row

template <int BN>
__host__ __device__ constexpr int fwd_wide_threads() {
  return 2 * BN;  // 8 row groups x BN / 4 column groups
}

template <int BN>
__host__ __device__ constexpr int fwd_wide_smem_bytes() {
  return (kFwdStages * kFwdRows * kFwdWideStride + kFwdDepth * BN) * 4;
}

// Blocks an SM holds by shared memory (3 up to BN = 80, 2 at 96): the
// registers are capped so that they hold as many (one form of this loop
// took 137 registers at BN = 80, which fits 2 blocks, and ran 20% slower)
template <int BN>
__host__ __device__ constexpr int fwd_wide_min_blocks() {
  return BN <= 80 ? 3 : 2;
}

// Cg > 16 columns in passes of BN in {64, 80, 96}.  A thread owns rows ty
// + 8 p (p < 8) and columns 4 tx .. + 3: per 4 k, eight float4 of x and
// four of W from shared memory feed 128 FMAs, the 8 rows innermost; the
// padded stride of 68 floats puts neighbouring row groups on different
// banks.  A thread stages one column of the weight slice (T is a multiple
// of BN).  kDx: the dX in the forward's dimensions (x is ct, y dx; see the
// header), wO the weight's own O; only the rows of W that the k loop reads
// are staged.
template <int BN, bool kVec, bool kDx>
__global__ void __launch_bounds__(fwd_wide_threads<BN>(),
                                  fwd_wide_min_blocks<BN>())
segment_matmul_fwd_wide_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const int32_t* __restrict__ seg_ptrs,
                               float* __restrict__ y, int64_t n_rows,
                               int64_t rows, int S, int H, int G, int K,
                               int O, int wO) {
  constexpr int T = fwd_wide_threads<BN>(), TX = BN / 4, V = kVec ? 4 : 1;
  constexpr int XST = kFwdWideStride, XS = kFwdRows * XST;
  constexpr int WE = kFwdDepth * BN / T;  // weights a thread stages
  static_assert(T % BN == 0, "a thread stages one weight column");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem + kFwdStages * XS;
  const FwdPass ps(H, G, O, BN);
  const FwdOut out(y, H, G, O, ps.g, ps.c0, ps.cw);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  // the weight column this thread stages: W[s, wh, k, wo] (forward)
  const int wc = threadIdx.x % BN, wk = threadIdx.x / BN;
  const int wcc = ps.c0 + wc < ps.Cg ? ps.c0 + wc : 0;
  const int wh = ps.g + wcc / O, wo = wcc - (wh - ps.g) * O;
  const int64_t rb0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t rb1 = rb0 + rows < n_rows ? rb0 + rows : n_rows;
  if (rb0 >= rb1) return;
  const int64_t p0 = __ldg(seg_ptrs), pS = __ldg(seg_ptrs + S);
  {  // zeros on the rows of the range that no segment holds
    const float z[4] = {};
    const int64_t a1 = p0 < rb1 ? p0 : rb1, b0 = pS > rb0 ? pS : rb0;
    for (int64_t r = rb0 + ty; r < a1; r += 8) out.store<4>(r, 4 * tx, z);
    for (int64_t r = b0 + ty; r < rb1; r += 8) out.store<4>(r, 4 * tx, z);
  }
  FwdWalk<T, V, XST> walk(x + static_cast<int64_t>(ps.g) * K, seg_ptrs, smem,
                          static_cast<int64_t>(G) * K, K, rb0, rb1, p0, pS,
                          S);

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  FwdItem i0 = walk.produce(0), i1 = walk.produce(1);
  int wseg = -1;
  for (int it = 0; i0.n > 0; ++it) {
    cp_async_wait<kFwdStages - 2>();  // item 0 has landed
    // ... in every thread's copies, and every thread is done with the
    // last round's slot and weights
    __syncthreads();
    const bool new_w = walk.nkt > 1 || i0.s != wseg;
    if (new_w) {
      // relation i0.s's weight slice, rows of k tile i0.kt, zeros past K
      // and past the pass's columns, one commit group ahead of the next
      // tile's
      wseg = i0.s;
      const int kb = i0.kt * kFwdDepth;
      if constexpr (kDx) {
        const int kd4 = (min(kFwdDepth, K - kb) + 3) & ~3;
#pragma unroll
        for (int i = 0; i < WE; ++i) {
          const int kk = wk + i * (T / BN);
          if (kk >= kd4) break;
          const bool ok = wc < ps.cw && kb + kk < K;
          cp_async<1>(ws + kk * BN + wc,
                      ok ? w_entry<true>(w, i0.s, ps.g, H, G, K, O, wO,
                                         kb + kk, ps.c0 + wc) : w, ok);
        }
      } else {
        const float* wp =
            w + ((static_cast<int64_t>(i0.s) * H + wh) * K + kb) * O + wo;
#pragma unroll
        for (int i = 0; i < WE; ++i) {
          const int kk = wk + i * (T / BN);
          const bool ok = wc < ps.cw && kb + kk < K;
          cp_async<1>(ws + kk * BN + wc,
                      ok ? wp + static_cast<int64_t>(kk) * O : w, ok);
        }
      }
      cp_async_commit();
    }
    // into the slot read last round
    const FwdItem i2 = walk.produce((it + 2) % kFwdStages);
    if (new_w) {
      cp_async_wait<1>();  // the weights have landed
      __syncthreads();
    }
    const float* xb = smem + it % kFwdStages * XS + ty * XST;
    const float* wb = ws + tx * 4;
    const int kd = min(kFwdDepth, K - i0.kt * kFwdDepth), kd4 = (kd + 3) & ~3;
#pragma unroll 2
    for (int kk = 0; kk < kd4; kk += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        a[p] = *reinterpret_cast<const float4*>(xb + 8 * p * XST + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(wb + (kk + q) * BN);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float av = q == 0 ? a[p].x : q == 1 ? a[p].y
                         : q == 2 ? a[p].z : a[p].w;
          acc[p][0] = fmaf(av, b[q].x, acc[p][0]);
          acc[p][1] = fmaf(av, b[q].y, acc[p][1]);
          acc[p][2] = fmaf(av, b[q].z, acc[p][2]);
          acc[p][3] = fmaf(av, b[q].w, acc[p][3]);
        }
      }
    }
    if (i0.kt == walk.nkt - 1) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (ty + 8 * p < i0.n) out.store<4>(i0.lo + ty + 8 * p, 4 * tx, acc[p]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
      }
    }
    i0 = i1;
    i1 = i2;
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------- dX rows

constexpr int kDxRowsThreads = 256;
constexpr int kDxRowsLanes = 16;                    // lanes a row
constexpr int kDxRowsCols = 4 * kDxRowsLanes;       // dx columns a pass
constexpr int kDxRowsTeams = kDxRowsThreads / kDxRowsLanes;  // rows at once
constexpr int kDxRowsTile = 256;   // rows a tile: 16 a row team
constexpr int kDxRowsStride = 16;  // floats a staged ct row: R <= 16

template <int RP>
__host__ __device__ constexpr int dx_rows_smem_bytes() {
  return (kFwdStages * kDxRowsTile * kDxRowsStride + RP * kDxRowsCols) * 4;
}

// The dX where the reduction is narrow (R = H*O, or O a head, <= RP <= 16; RP
// the reduction rounded up to 4: the path's 4, 8 and 12) and dx wide (K >
// 16, in passes of 64 columns), in the forward's dimensions of the header
// (G groups of K = R ct columns against O = dx's K columns, wO the
// weight's own O).  84-94% of the bytes are dx written, and a row's work is
// small (R FMAs an output), so the tile is laid out for the stores and for
// little work around them: a row takes 16 lanes, each of which owns a
// float4 of the pass's 64 columns and stores it once; the row's R ct values
// are a broadcast from the staged tile (a float4 a load, the two rows of a
// warp 16 banks apart) and the R x 64 weight slice is read as float4 from
// shared memory.  The walk's tiles are 256 rows (16 a row team) of at most
// 16 staged floats, so a barrier and a walk step serve 64 KB of dx.  The
// ring and the weight staging are the other kernels'; only the rows of W
// below RP are staged.
template <int RP, bool kVec>
__global__ void __launch_bounds__(kDxRowsThreads)
segment_matmul_dx_rows_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const int32_t* __restrict__ seg_ptrs,
                              float* __restrict__ y, int64_t n_rows,
                              int64_t rows, int S, int H, int G, int K, int O,
                              int wO) {
  constexpr int T = kDxRowsThreads, V = kVec ? 4 : 1, BN = kDxRowsCols;
  constexpr int XST = kDxRowsStride, XS = kDxRowsTile * XST;
  static_assert(RP % 4 == 0 && RP <= XST, "a staged row holds RP floats");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem + kFwdStages * XS;  // (RP, BN)
  const FwdPass ps(H, G, O, BN);
  const FwdOut out(y, H, G, O, ps.g, ps.c0, ps.cw);
  const int lane = threadIdx.x % kDxRowsLanes;
  const int team = threadIdx.x / kDxRowsLanes;
  const int64_t rb0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t rb1 = rb0 + rows < n_rows ? rb0 + rows : n_rows;
  if (rb0 >= rb1) return;
  const int64_t p0 = __ldg(seg_ptrs), pS = __ldg(seg_ptrs + S);
  {  // zeros on the rows of the range that no segment holds
    const float z[4] = {};
    const int64_t a1 = p0 < rb1 ? p0 : rb1, b0 = pS > rb0 ? pS : rb0;
    for (int64_t r = rb0 + team; r < a1; r += kDxRowsTeams)
      out.store<4>(r, 4 * lane, z);
    for (int64_t r = b0 + team; r < rb1; r += kDxRowsTeams)
      out.store<4>(r, 4 * lane, z);
  }
  FwdWalk<T, V, XST, kDxRowsTile, XST> walk(
      x + static_cast<int64_t>(ps.g) * K, seg_ptrs, smem,
      static_cast<int64_t>(G) * K, K, rb0, rb1, p0, pS, S);
  FwdItem i0 = walk.produce(0), i1 = walk.produce(1);
  int wseg = -1;
  for (int it = 0; i0.n > 0; ++it) {
    cp_async_wait<kFwdStages - 2>();  // item 0 has landed
    // ... in every thread's copies, and every thread is done with the
    // last round's slot and weights
    __syncthreads();
    const bool new_w = i0.s != wseg;
    if (new_w) {
      // relation i0.s's weight slice, zeros past K and past the pass's
      // columns, one commit group ahead of the next tile's
      wseg = i0.s;
#pragma unroll
      for (int e = threadIdx.x; e < RP * BN; e += T) {
        const int kk = e / BN, c = e % BN;
        const bool ok = c < ps.cw && kk < K;
        cp_async<1>(ws + e, ok ? w_entry<true>(w, i0.s, ps.g, H, G, K, O, wO,
                                               kk, ps.c0 + c) : w, ok);
      }
      cp_async_commit();
    }
    // into the slot read last round
    const FwdItem i2 = walk.produce((it + 2) % kFwdStages);
    if (new_w) {
      cp_async_wait<1>();  // the weights have landed
      __syncthreads();
    }
    const float* xs = smem + it % kFwdStages * XS;
    const int rows_mine = (i0.n - team + kDxRowsTeams - 1) / kDxRowsTeams;
#pragma unroll 4
    for (int p = 0; p < rows_mine; ++p) {
      const int m = team + p * kDxRowsTeams;
      float a[RP];
#pragma unroll
      for (int q = 0; q < RP / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xs + m * XST + 4 * q);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      float acc[4] = {};
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const float4 b =
            *reinterpret_cast<const float4*>(ws + r * BN + 4 * lane);
        acc[0] = fmaf(a[r], b.x, acc[0]);
        acc[1] = fmaf(a[r], b.y, acc[1]);
        acc[2] = fmaf(a[r], b.z, acc[2]);
        acc[3] = fmaf(a[r], b.w, acc[3]);
      }
      out.store<4>(i0.lo + m, 4 * lane, acc);
    }
    i0 = i1;
    i1 = i2;
  }
  cp_async_wait<0>();
}

// fn(kernel, threads, dynamic shared bytes) for the forward of column tile
// BN (narrow up to 16, wide past it), after allowing it that much shared
// memory
template <bool kVec, bool kDx, int BN, class Fn>
cudaError_t with_fwd_bn(Fn fn) {
  const auto run = [&](auto kernel, int threads, int smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return err != cudaSuccess ? err : fn(kernel, threads, smem);
  };
  if constexpr (BN > 16) {
    return run(segment_matmul_fwd_wide_kernel<BN, kVec, kDx>,
               fwd_wide_threads<BN>(), fwd_wide_smem_bytes<BN>());
  } else {
    return run(segment_matmul_fwd_narrow_kernel<BN, kVec, kDx>,
               kFwdNarrowThreads, fwd_narrow_smem_bytes<BN>());
  }
}

template <bool kDx, class Fn>
cudaError_t with_fwd_dir(int cols, bool vec, Fn fn) {
#define HET_FWD(BN)                                        \
  case BN:                                                 \
    return vec ? with_fwd_bn<true, kDx, BN>(fn)            \
               : with_fwd_bn<false, kDx, BN>(fn);
  switch (cols) {
    HET_FWD(4)
    HET_FWD(8)
    HET_FWD(12)
    HET_FWD(16)
    HET_FWD(64)
    HET_FWD(80)
    HET_FWD(96)
    default: return cudaErrorInvalidValue;
  }
#undef HET_FWD
}

template <int RP, class Fn>
cudaError_t with_dx_rows_rp(bool vec, Fn fn) {
  const auto run = [&](auto kernel) {
    constexpr int smem = dx_rows_smem_bytes<RP>();
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    return err != cudaSuccess ? err : fn(kernel, kDxRowsThreads, smem);
  };
  return vec ? run(segment_matmul_dx_rows_kernel<RP, true>)
             : run(segment_matmul_dx_rows_kernel<RP, false>);
}

// fn(kernel, threads, dynamic shared bytes) for the forward (dx false) or
// the dX of column tile `cols`, or for the dX rows tile of reduction
// `depth` (4, 8, 12 or 16; 0 for the forward's kernels);
// cudaErrorInvalidValue where none is built
template <class Fn>
cudaError_t with_fwd(int cols, int depth, bool vec, bool dx, Fn fn) {
  if (depth > 0) {
    if (!dx || cols != kDxRowsCols) return cudaErrorInvalidValue;
    switch (depth) {
      case 4: return with_dx_rows_rp<4>(vec, fn);
      case 8: return with_dx_rows_rp<8>(vec, fn);
      case 12: return with_dx_rows_rp<12>(vec, fn);
      case 16: return with_dx_rows_rp<16>(vec, fn);
      default: return cudaErrorInvalidValue;
    }
  }
  return dx ? with_fwd_dir<true>(cols, vec, fn)
            : with_fwd_dir<false>(cols, vec, fn);
}

// Blocks of a dW chunk kernel on elements In that one SM holds at once
// (see het_segment_matmul_dw_resident).
template <class In>
int dw_resident(int wide, int cols, int vec, int ct_vec, int per_head) {
  int n = 0;
  cudaError_t err;
  if (wide) {
    err = with_wide<In>(cols, vec, [&](auto kernel, int threads, int smem) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                           threads, smem);
    });
  } else {
    const auto query = [&](auto kernel) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kNarrowThreads, 0);
    };
    err = per_head ? with_narrow<In, true>(cols, vec, ct_vec, query)
                   : with_narrow<In, false>(cols, vec, ct_vec, query);
  }
  return err == cudaSuccess ? n : 0;
}

// The grouped dW on elements In (see het_segment_matmul_dw_f32).
template <class In>
cudaError_t segment_matmul_dw(const In* x, const In* ct,
                              const int32_t* seg_ptrs, int32_t* chunk_ptr,
                              float* partial, float* out, int64_t n_rows,
                              int S, int H, int Hx, int K, int O,
                              int chunk_rows, int64_t chunks, int wide,
                              int cols, int lanes, int vec, int ct_vec,
                              cudaStream_t st) {
  // elements a 16-byte copy of the wide kernel
  constexpr int kWideVec = 16 / static_cast<int>(sizeof(In));
  if (S <= 0 || H <= 0 || K <= 0 || O <= 0) return cudaSuccess;
  if (n_rows < 0 || (Hx != 1 && Hx != H) || chunk_rows <= 0 ||
      chunks < (n_rows + chunk_rows - 1) / chunk_rows + S ||
      chunks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const bool per_head = Hx > 1;
  const int NC = per_head ? O : H * O;
  const int64_t NJ = static_cast<int64_t>(H) * K * O;
  cudaError_t err;
  if (wide) {
    const int64_t tiles = static_cast<int64_t>(per_head ? H : 1) *
                          ((K + kWideK - 1) / kWideK) *
                          ((NC + cols - 1) / cols);
    if (cols <= 0 || tiles > 65535 ||
        (vec && (K % kWideVec || NC % kWideVec || (H * O) % kWideVec ||
                 !aligned16(x) || !aligned16(ct)))) {
      return cudaErrorInvalidValue;
    }
    const dim3 grid(static_cast<unsigned>(chunks),
                    static_cast<unsigned>(tiles));
    err = with_wide<In>(cols, vec, [&](auto kernel, int threads, int smem) {
      kernel<<<grid, threads, smem, st>>>(x, ct, seg_ptrs, chunk_ptr,
                                          partial, S, H, Hx, K, O,
                                          chunk_rows);
      return cudaGetLastError();
    });
  } else {
    if (NC > cols || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
        (vec && ((Hx * K) % 4 || !aligned16(x))) ||
        (ct_vec && (per_head || NC != cols || !aligned16(ct)))) {
      return cudaErrorInvalidValue;
    }
    const dim3 grid(static_cast<unsigned>(chunks));
    const auto launch = [&](auto kernel) {
      kernel<<<grid, kNarrowThreads, 0, st>>>(x, ct, seg_ptrs, chunk_ptr,
                                              partial, S, H, K, O,
                                              chunk_rows, lanes);
      return cudaGetLastError();
    };
    err = per_head ? with_narrow<In, true>(cols, vec, ct_vec, launch)
                   : with_narrow<In, false>(cols, vec, ct_vec, launch);
  }
  if (err != cudaSuccess) return err;

  // chunk lanes per column: about the chunks a segment has
  const int64_t per_seg = chunks / S;
  const int cl = per_seg <= 2 ? 1 : per_seg <= 16 ? 8 : 32;
  const int64_t cb = kThreads / cl;
  const int64_t col_blocks = (NJ + cb - 1) / cb;
  if (col_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 rgrid(static_cast<unsigned>(S),
                   static_cast<unsigned>(col_blocks));
  const int shared_nc = per_head ? 0 : NC;
  if (cl == 1)
    segment_matmul_dw_reduce_kernel<1><<<rgrid, kThreads, 0, st>>>(
        partial, chunk_ptr, out, NJ, K, O, shared_nc);
  else if (cl == 8)
    segment_matmul_dw_reduce_kernel<8><<<rgrid, kThreads, 0, st>>>(
        partial, chunk_ptr, out, NJ, K, O, shared_nc);
  else
    segment_matmul_dw_reduce_kernel<32><<<rgrid, kThreads, 0, st>>>(
        partial, chunk_ptr, out, NJ, K, O, shared_nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the chunk kernel that `wide`, `cols`, `vec`, `ct_vec`,
// `per_head` (as in het_segment_matmul_dw_f32) and `bf16` (the operands'
// element type) name that one SM of the current device holds at once; 0
// if there is no such kernel.
int het_segment_matmul_dw_resident(int wide, int cols, int vec, int ct_vec,
                                   int per_head, int bf16) {
  return bf16 ? dw_resident<__nv_bfloat16>(wide, cols, vec, ct_vec, per_head)
              : dw_resident<float>(wide, cols, vec, ct_vec, per_head);
}

// x (n_rows, Hx*K) f32 and ct (n_rows, H*O) f32, row-major; seg_ptrs
// (S + 1,) int32 on the device, non-decreasing, seg_ptrs[S] <= n_rows; out
// (S, H, K, O) f32; Hx is 1 or H.  The launch plan comes from the wrapper
// (het_tpu_torch/ops/kernels/segment_mm.py::dw_plan): segments are cut
// into chunks of `chunk_rows` rows; the grid takes `chunks` >=
// ceil(n_rows / chunk_rows) + S blocks; `wide` picks the kernel, `cols`
// its ct columns (narrow: 1, 4, 8, 12 or 16, at least NC; wide: the
// column tile, 64, 80 or 96), `lanes` the narrow kernel's lanes a row,
// `vec` and `ct_vec` its wide loads (16 bytes, or 4 elements for the
// narrow kernel).  Scratch: chunk_ptr (S + 1,) int32 and partial (chunks
// * H*K*O,) f32.  Launches on `stream` and returns the first launch error,
// cudaErrorInvalidValue for a plan the operands do not allow (0 on
// success).
int het_segment_matmul_dw_f32(const float* x, const float* ct,
                              const int32_t* seg_ptrs, int32_t* chunk_ptr,
                              float* partial, float* out, int64_t n_rows,
                              int S, int H, int Hx, int K, int O,
                              int chunk_rows, int64_t chunks, int wide,
                              int cols, int lanes, int vec, int ct_vec,
                              void* stream) {
  return static_cast<int>(segment_matmul_dw<float>(
      x, ct, seg_ptrs, chunk_ptr, partial, out, n_rows, S, H, Hx, K, O,
      chunk_rows, chunks, wide, cols, lanes, vec, ct_vec,
      static_cast<cudaStream_t>(stream)));
}

// The same with x and ct bf16 (each product exact in f32; partials and
// out f32).  The wide kernel's 16-byte copies (`vec`) take K, NC and H*O
// multiples of 8.
int het_segment_matmul_dw_bf16(const __nv_bfloat16* x,
                               const __nv_bfloat16* ct,
                               const int32_t* seg_ptrs, int32_t* chunk_ptr,
                               float* partial, float* out, int64_t n_rows,
                               int S, int H, int Hx, int K, int O,
                               int chunk_rows, int64_t chunks, int wide,
                               int cols, int lanes, int vec, int ct_vec,
                               void* stream) {
  return static_cast<int>(segment_matmul_dw<__nv_bfloat16>(
      x, ct, seg_ptrs, chunk_ptr, partial, out, n_rows, S, H, Hx, K, O,
      chunk_rows, chunks, wide, cols, lanes, vec, ct_vec,
      static_cast<cudaStream_t>(stream)));
}

// Blocks of the forward (dx 0) or dX (dx 1) kernel of column tile `cols`,
// dX rows tile `depth` and 16-byte loads `vec` (as in
// het_segment_matmul_fwd_f32) that one SM of the current device holds at
// once; 0 if there is no such kernel.
int het_segment_matmul_fwd_resident(int cols, int depth, int vec, int dx) {
  int n = 0;
  const cudaError_t err =
      with_fwd(cols, depth, vec, dx, [&](auto kernel, int threads, int smem) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                             threads, smem);
      });
  return err == cudaSuccess ? n : 0;
}

// Forward (dx 0): x (n_rows, Hx*K) f32 and W (S, H, K, O) f32, row-major,
// on the device; seg_ptrs as above; y (n_rows, H*O) f32; Hx is 1 or H.
// dX (dx 1): x is ct (n_rows, H*O), y is dx (n_rows, Hx*K), per head when
// Hx = H, summed over the heads when Hx = 1; the same kernels run it in
// the forward's dimensions of the header's dX part.  The launch plan comes
// from the wrapper (het_tpu_torch/ops/kernels/segment_mm.py::fwd_plan, or
// dx_plan): the column tile `cols` (narrow 4, 8, 12 or 16, wide 64, 80 or
// 96), or for the dX the rows tile of `depth` (the reduction rounded up
// to 4, at most 16; 0 otherwise) and 64 columns, `vec` 16-byte loads of x,
// a grid of `blocks` x `tiles` (groups x column passes), each block taking
// `rows` rows.
// Launches on `stream` and returns the launch error, cudaErrorInvalidValue
// for a plan the operands do not allow (0 on success).
int het_segment_matmul_fwd_f32(const float* x, const float* w,
                               const int32_t* seg_ptrs, float* y,
                               int64_t n_rows, int S, int H, int Hx, int K,
                               int O, int dx, int cols, int depth, int vec,
                               int64_t blocks, int tiles, int64_t rows,
                               void* stream) {
  if (n_rows < 0 || S < 0 || H < 0 || K < 0 || O < 0 ||
      (Hx != 1 && Hx != H)) {
    return cudaErrorInvalidValue;
  }
  // the kernels' dimensions: a group's kK columns of x against its Cg
  // columns of y
  const int kH = dx && Hx == 1 ? 1 : H;
  const int kK = dx ? (Hx > 1 ? O : H * O) : K, kO = dx ? K : O;
  const int Cg = Hx > 1 ? kO : kH * kO;
  if (n_rows == 0 || Cg == 0) return cudaSuccess;  // nothing to write
  if (cols <= 0 || rows <= 0 || blocks <= 0 || blocks > 0x7fffffffLL ||
      blocks * rows < n_rows || tiles != Hx * ((Cg + cols - 1) / cols) ||
      tiles > 65535 || (vec && (kK % 4 || !aligned16(x))) ||
      (depth && depth != ((kK + 3) & ~3))) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  return with_fwd(cols, depth, vec, dx, [&](auto kernel, int threads,
                                            int smem) {
    kernel<<<grid, threads, smem, st>>>(x, w, seg_ptrs, y, n_rows, rows, S,
                                        kH, Hx, kK, kO, O);
    return cudaGetLastError();
  });
}

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
