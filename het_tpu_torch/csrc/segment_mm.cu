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
// ------------------------------------------------------- forward and dX
//
//     fwd: y[i, h*O + o]  = sum_k x[i, (Hx>1 ? h : 0)*K + k] W[s, h, k, o]
//     dX:  dx[i, h*K + k] = sum_o ct[i, h*O + o] W[s, h, k, o]   (Hx = H)
//          dx[i, k]       = sum_{h,o} ct[i, h*O + o] W[s, h, k, o] (Hx = 1)
//
// Replace the TPU kernels het_tpu/ops/pallas/segment_mm.py::_fwd_resident
// and ::_fwd_streamed (forward), ::_dx_resident and the streamed
// ::segment_matmul_rows_dx (dX).  Those keep W whole in VMEM, or DMA one
// relation's block per run of row tiles once W passes the VMEM budget,
// and fold the heads into the minor dimension for the MXU; all three are
// TPU workarounds.  Here both directions are one templated kernel, a
// tiled f32 GEMM whose B operand is the block's relation's weight:
//
//  * a block owns a tile of 64 rows and 64 output columns, or 256 rows and
//    16 columns where the output is that narrow (blockIdx.y also picks
//    the head when Hx = H).  It finds the segments that meet its rows by a
//    binary search of seg_ptrs and, for each (one, unless the tile crosses
//    a segment boundary), stages 64- or 32-deep slices of its rows and of
//    that relation's weight columns in shared memory, so any K and H*O
//    fit (S = 535, K = O = 64 and past it: W is never held whole); each
//    thread keeps a 4 x 4 register tile and the block writes the rows of
//    that segment;
//  * rows outside [seg_ptrs[0], seg_ptrs[S]) are written as zeros;
//  * plain f32 fused multiply-adds, no tensor cores: their f32 path is
//    TF32, which the port's f32 runs (TF32 off) must not take.
//
// Bound.  Bytes: x (or ct) read once, y (or dx) written once, W read
// once: n_rows * (Hx*K + H*O) * 4 + S*H*K*O*4.  Operations: 2 * n_rows *
// H*K*O.  At K = O = 64 that is 2 * 64 * 64 / ((64 + 64) * 4) = 16
// operations a byte, near the f32 ridge of 67 TFLOP/s over 3.35 TB/s
// (20); the main path's narrow shapes (O = 1 to 17) are bytes bound.
// A block re-reads its weight columns from L2, never from device memory
// more than once in the bound's sense.
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
// tile once W passes the VMEM budget).  Both lean on the TPU's sequential
// grid to carry a sum from one step to the next; on Hopper blocks run in
// parallel and in no order, so the sum is split instead:
//
//  1. plan: one block turns seg_ptrs into chunk_ptr, the prefix sum of
//     ceil(rows(s) / kChunkRows).  Every segment is cut into chunks of at
//     most kChunkRows rows that never cross a segment boundary, so a small
//     segment count (S = 4 on the plain RGAT path) still fills all SMs;
//  2. chunk pass: one block per chunk (the grid is the upper bound
//     ceil(n_rows / kChunkRows) + S; blocks past the last chunk leave)
//     writes the chunk's (H, K, O) partial sums to a scratch buffer;
//  3. reduce: per segment, the chunks' partials summed in chunk order.
// The result is deterministic and uses no atomics.  No row outside
// [seg_ptrs[0], seg_ptrs[S]) is read.
//
// Bound.  Bytes: every row of x and ct is read once, rows * (Hx*K + H*O)
// * 4 bytes, plus the (S, H, K, O) output.  Operations: 2 * rows * H*K*O.
// Two regimes, two chunk kernels:
//  * O == 1 (the attention-vector gradient of edge_rel_inner, 64 x
//    columns and 4 ct columns a row on the main path): one multiply-add
//    per x element read, so bytes bound.  dw_colsum_kernel reads rows as
//    float4 (16 bytes a lane, neighbouring lanes on neighbouring
//    addresses) when K % 4 == 0, with the lanes of a warp split into
//    groups of the smallest power of two that covers a row, as in
//    seg_reduce.cu; each lane weights its columns by its head's ct value.
//  * O > 1 (the dW of the segment matmul, K = O = 64): 2 * K * O / ((K + O)
//    * 4) = 16 operations a byte, near the f32 ridge.  dw_tiled_kernel
//    stages 16-row slices of a 64 x 64 (k, column) tile in shared memory
//    and keeps a 4 x 4 register tile a thread.  With per-head x (Hx = H)
//    a tile's columns are one head's o; with one x row for all heads (Hx
//    = 1) they run over all H * O columns of ct at once, so x is read
//    once for every head and H * O = 68 fills 2 tiles, not 4 of which 47
//    of 64 columns are empty.  It uses no tensor cores (f32 operands;
//    wgmma and TMA are later work).
// kChunkRows = 2048 keeps each block's loop long enough to hide latency
// and the partials small next to the inputs (1/32 of the x bytes on the
// main path).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkRows = 2048;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- plan

__global__ void __launch_bounds__(kPlanThreads)
segment_matmul_dw_plan_kernel(const int32_t* __restrict__ seg_ptrs,
                              int32_t* __restrict__ chunk_ptr, int S) {
  __shared__ int32_t warp_sum[kPlanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) chunk_ptr[0] = 0;
  int32_t carry = 0;
  for (int base = 0; base < S; base += kPlanThreads) {
    const int s = base + t;
    int32_t v = 0;
    if (s < S) {
      const int32_t len = seg_ptrs[s + 1] - seg_ptrs[s];
      v = len > 0 ? (len + kChunkRows - 1) / kChunkRows : 0;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += y;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int32_t w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;  // inclusive prefix over the warps
    }
    __syncthreads();
    if (s < S) chunk_ptr[s + 1] = carry + v + (warp ? warp_sum[warp - 1] : 0);
    carry += warp_sum[kPlanThreads / 32 - 1];
    __syncthreads();  // warp_sum is rewritten by the next tile
  }
}

// The rows [lo, hi) and segment s of chunk `b`; false past the last chunk.
struct Chunk {
  int64_t lo, hi;
  int s;
};

__device__ __forceinline__ bool find_chunk(
    const int32_t* __restrict__ seg_ptrs,
    const int32_t* __restrict__ chunk_ptr, int S, int64_t b, Chunk* c) {
  if (b >= __ldg(chunk_ptr + S)) return false;
  // the last s with chunk_ptr[s] <= b; empty segments repeat a value and
  // are skipped because the search takes the last of equal entries
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(chunk_ptr + mid) <= b) lo = mid; else hi = mid - 1;
  }
  const int64_t start = __ldg(seg_ptrs + lo);
  const int64_t end = __ldg(seg_ptrs + lo + 1);
  c->s = lo;
  c->lo = start + (b - __ldg(chunk_ptr + lo)) * kChunkRows;
  c->hi = c->lo + kChunkRows < end ? c->lo + kChunkRows : end;
  return true;
}

// -------------------------------------------------------- O == 1 chunks

template <int V>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float get(const T& a, int e) {
    return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
  }
};

template <>
struct Vec<1> {
  using T = float;
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static float get(const T& a, int) { return a; }
};

// Output column j = h * K + k (O == 1); a lane owns V neighbouring
// columns of one head.  V: floats per load (4 needs K % 4 == 0).  L:
// lanes per row group (power of two, 1..32); a warp holds 32 / L groups,
// each on its own rows.
template <int V, int L>
__global__ void __launch_bounds__(kThreads)
segment_matmul_dw_colsum_kernel(const float* __restrict__ x,
                                const float* __restrict__ ct,
                                const int32_t* __restrict__ seg_ptrs,
                                const int32_t* __restrict__ chunk_ptr,
                                float* __restrict__ partial, int S, int H,
                                int Hx, int K) {
  using Op = Vec<V>;
  constexpr int G = 32 / L;
  constexpr int NG = kWarps * G;  // row groups in the block
  __shared__ float red[kWarps][32 * V];
  Chunk c;
  if (!find_chunk(seg_ptrs, chunk_ptr, S, blockIdx.x, &c)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / L, sub = lane % L;
  const int NJ = H * K;
  const int NV = NJ / V;
  const int64_t xs = static_cast<int64_t>(Hx) * K;  // x row stride
  float* out = partial + static_cast<int64_t>(blockIdx.x) * NJ;

  for (int c0 = 0; c0 < NV; c0 += L) {
    const int col = c0 + sub;
    const bool active = col < NV;
    const int j = col * V;
    const int h = active ? j / K : 0;
    const int xcol = Hx > 1 ? j : j - h * K;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    if (active) {
      const float* xp = x + xcol;
      const float* cp = ct + h;  // ct row stride H (O == 1)
      int64_t i = c.lo + warp * G + grp;
      for (; i + 3 * NG < c.hi; i += 4 * NG) {
        const typename Op::T v0 = Op::load(xp + i * xs);
        const typename Op::T v1 = Op::load(xp + (i + NG) * xs);
        const typename Op::T v2 = Op::load(xp + (i + 2 * NG) * xs);
        const typename Op::T v3 = Op::load(xp + (i + 3 * NG) * xs);
        const float w0 = __ldg(cp + i * H);
        const float w1 = __ldg(cp + (i + NG) * H);
        const float w2 = __ldg(cp + (i + 2 * NG) * H);
        const float w3 = __ldg(cp + (i + 3 * NG) * H);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[e] += Op::get(v0, e) * w0;
          acc[e] += Op::get(v1, e) * w1;
          acc[e] += Op::get(v2, e) * w2;
          acc[e] += Op::get(v3, e) * w3;
        }
      }
      for (; i < c.hi; i += NG) {
        const typename Op::T v = Op::load(xp + i * xs);
        const float w = __ldg(cp + i * H);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += Op::get(v, e) * w;
      }
    }
    // fixed-order trees: the warp's groups meet by shuffles, then the
    // warps meet in shared memory in warp order
#pragma unroll
    for (int e = 0; e < V; ++e) {
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        acc[e] += __shfl_xor_sync(kFull, acc[e], o);
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < V; ++e) red[warp][sub * V + e] = acc[e];
    }
    __syncthreads();
    const int t = threadIdx.x;
    if (t < L * V && c0 * V + t < NJ) {
      float sum = red[0][t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w][t];
      out[c0 * V + t] = sum;
    }
    __syncthreads();
  }
}

// --------------------------------------------------------- O > 1 chunks

constexpr int kTile = 64;  // k and o extent of a block's output tile
constexpr int kStage = 16;  // rows staged in shared memory at a time

// blockIdx.y enumerates (head, k tile, column tile); 16 x 16 threads each
// own a 4 x 4 register tile (k = k0 + 4 ty + p, column c = c0 + 4 tx + q).
// A tile's columns are head h's o (Hx = H), or all of ct's h * O + o
// (Hx = 1: one head pass, h = 0).
__global__ void __launch_bounds__(kThreads)
segment_matmul_dw_tiled_kernel(const float* __restrict__ x,
                               const float* __restrict__ ct,
                               const int32_t* __restrict__ seg_ptrs,
                               const int32_t* __restrict__ chunk_ptr,
                               float* __restrict__ partial, int S, int H,
                               int Hx, int K, int O) {
  __shared__ __align__(16) float xs[kStage][kTile];
  __shared__ __align__(16) float cs[kStage][kTile];
  Chunk c;
  if (!find_chunk(seg_ptrs, chunk_ptr, S, blockIdx.x, &c)) return;
  const int NC = Hx > 1 ? O : H * O;  // columns a head pass covers
  const int nkt = (K + kTile - 1) / kTile, nct = (NC + kTile - 1) / kTile;
  int tile = blockIdx.y;
  const int ct_ = tile % nct;
  tile /= nct;
  const int kt = tile % nkt;
  const int h = tile / nkt;
  const int k0 = kt * kTile, c0 = ct_ * kTile;
  const int kw = K - k0 < kTile ? K - k0 : kTile;
  const int cw = NC - c0 < kTile ? NC - c0 : kTile;
  const int64_t x_stride = static_cast<int64_t>(Hx) * K;
  const int64_t c_stride = static_cast<int64_t>(H) * O;
  const float* xb = x + static_cast<int64_t>(h) * K + k0;  // h = 0 if Hx = 1
  const float* cb = ct + static_cast<int64_t>(h) * O + c0;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int64_t r0 = c.lo; r0 < c.hi; r0 += kStage) {
#pragma unroll
    for (int e = threadIdx.x; e < kStage * kTile; e += kThreads) {
      const int r = e / kTile, col = e % kTile;
      const int64_t i = r0 + r;
      const bool row_ok = i < c.hi;
      xs[r][col] = row_ok && col < kw ? __ldg(xb + i * x_stride + col) : 0.f;
      cs[r][col] = row_ok && col < cw ? __ldg(cb + i * c_stride + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&cs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += av[p] * bv[q];
    }
    __syncthreads();
  }
  // partial is (chunk, H, K, O): column c of the pass is (h + c / O, c % O)
  float* out = partial + static_cast<int64_t>(blockIdx.x) * H * K * O;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c0 + tx * 4 + q;
    if (c >= NC) continue;
    const int64_t base = static_cast<int64_t>(h + c / O) * K * O + c % O;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = k0 + ty * 4 + p;
      if (k < K) out[base + static_cast<int64_t>(k) * O] = acc[p][q];
    }
  }
}

// ---------------------------------------------------------------- reduce

// out[s, j] = sum over the chunks of s, in chunk order, of partial[c, j].
// A block covers 256 / CL columns; CL lanes per column stride the chunks
// and meet in shared memory in lane order.
template <int CL>
__global__ void __launch_bounds__(kThreads)
segment_matmul_dw_reduce_kernel(const float* __restrict__ partial,
                                const int32_t* __restrict__ chunk_ptr,
                                float* __restrict__ out, int64_t NJ) {
  constexpr int CB = kThreads / CL;
  __shared__ float red[CL][CB];
  const int s = blockIdx.x;
  const int col = threadIdx.x % CB, ln = threadIdx.x / CB;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * CB + col;
  const int c0 = __ldg(chunk_ptr + s), c1 = __ldg(chunk_ptr + s + 1);
  float acc = 0.f;
  if (j < NJ) {
    for (int c = c0 + ln; c < c1; c += CL)
      acc += __ldg(partial + static_cast<int64_t>(c) * NJ + j);
  }
  red[ln][col] = acc;
  __syncthreads();
  if (ln == 0 && j < NJ) {
    float sum = red[0][col];
#pragma unroll
    for (int l = 1; l < CL; ++l) sum += red[l][col];
    out[static_cast<int64_t>(s) * NJ + j] = sum;
  }
}

template <int V>
void launch_colsum(dim3 grid, const float* x, const float* ct,
                   const int32_t* seg_ptrs, const int32_t* chunk_ptr,
                   float* partial, int S, int H, int Hx, int K,
                   cudaStream_t st) {
  const int nv = H * K / V;
#define HET_COLSUM(L)                                                      \
  segment_matmul_dw_colsum_kernel<V, L><<<grid, kThreads, 0, st>>>(        \
      x, ct, seg_ptrs, chunk_ptr, partial, S, H, Hx, K)
  if (nv <= 1) HET_COLSUM(1);
  else if (nv <= 2) HET_COLSUM(2);
  else if (nv <= 4) HET_COLSUM(4);
  else if (nv <= 8) HET_COLSUM(8);
  else if (nv <= 16) HET_COLSUM(16);
  else HET_COLSUM(32);
#undef HET_COLSUM
}

int64_t max_chunks(int64_t n_rows, int S) {
  return (n_rows + kChunkRows - 1) / kChunkRows + S;
}

// ------------------------------------------------------- forward and dX

// A block's output tile is BM rows by BN columns, 4 x 4 outputs a thread
// (BM / 4 * BN / 4 = kThreads), and it stages BD-deep slices of the
// reduction.  Wide tiles for wide outputs; narrow ones for the attention
// columns of the main path (H*O = 4 or 12), where a 64-column tile would
// leave 15 of every 16 threads without a column.  BD = 64 takes K = 64 in
// one stage, so a block waits for device memory once.
template <int BM, int BN, int BD>
struct Tile {
  static_assert(BM / 4 * (BN / 4) == kThreads, "4 x 4 outputs a thread");
  static constexpr int kRows = BM, kCols = BN, kDepth = BD;
};
using WideTile = Tile<64, 64, 64>;
using NarrowTile = Tile<256, 16, 32>;

// One template for both directions (see the header).  Per group g (the
// head when Hx = H, else the only group): the reduction index r runs over
// R entries of A's columns [a_off, a_off + R), the output index c over C
// columns [o_off, o_off + C) of `out`, and the weight entry for (r, c) is
// W[s, j / O, k, j % O] with (k, j) = (r, j_off + c) forward and
// (c, j_off + r) for dX.
template <bool kDx, typename T>
__global__ void __launch_bounds__(kThreads)
segment_matmul_rows_kernel(const float* __restrict__ a,
                           const float* __restrict__ w,
                           const int32_t* __restrict__ seg_ptrs,
                           float* __restrict__ out, int64_t n_rows, int S,
                           int H, int Hx, int K, int O) {
  constexpr int BM = T::kRows, BN = T::kCols, BD = T::kDepth;
  // +4: the staging stores walk the depth, BM + 4 floats apart
  __shared__ __align__(16) float as[BD][BM + 4];
  __shared__ __align__(16) float ws[BD][BN];
  const int HO = H * O;
  const bool per_head = Hx > 1;
  const int64_t lda = kDx ? HO : static_cast<int64_t>(Hx) * K;
  const int64_t ldo = kDx ? static_cast<int64_t>(Hx) * K : HO;
  const int R = kDx ? (per_head ? O : HO) : K;
  const int C = kDx ? K : (per_head ? O : HO);
  const int ctiles = (C + BN - 1) / BN;
  const int g = blockIdx.y / ctiles;
  const int c0 = (blockIdx.y % ctiles) * BN;
  const int j_off = per_head ? g * O : 0;
  const int a_off = kDx ? j_off : (per_head ? g * K : 0);
  const int o_off = kDx ? (per_head ? g * K : 0) : j_off;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t r1 = r0 + BM < n_rows ? r0 + BM : n_rows;
  const int tx = threadIdx.x % (BN / 4), ty = threadIdx.x / (BN / 4);

  // rows that no segment holds read as zero rows
  const int64_t p0 = __ldg(seg_ptrs), pS = __ldg(seg_ptrs + S);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int64_t i = r0 + ty * 4 + p;
    if (i >= r1 || (i >= p0 && i < pS)) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx * 4 + q;
      if (c < C) out[i * ldo + o_off + c] = 0.f;
    }
  }

  // the first segment that ends past r0
  int s = 0;
  for (int hi = S; s < hi;) {
    const int mid = (s + hi) >> 1;
    if (__ldg(seg_ptrs + mid + 1) > r0) hi = mid; else s = mid + 1;
  }
  for (; s < S; ++s) {
    const int64_t lo_s = __ldg(seg_ptrs + s), hi_s = __ldg(seg_ptrs + s + 1);
    if (lo_s >= r1) break;
    const int64_t ra = lo_s > r0 ? lo_s : r0, rb = hi_s < r1 ? hi_s : r1;
    if (ra >= rb) continue;  // an empty segment
    const float* wsg = w + static_cast<int64_t>(s) * H * K * O;
    float acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

    for (int rk = 0; rk < R; rk += BD) {
      const int depth = R - rk < BD ? R - rk : BD;
      // this segment's rows of A, every load of the stage in flight at
      // once; depth fastest, so neighbouring threads read neighbouring
      // addresses of one row
#pragma unroll
      for (int e = threadIdx.x; e < BM * BD; e += kThreads) {
        const int m = e / BD, d = e % BD;
        const int64_t i = r0 + m;
        as[d][m] = i >= ra && i < rb && d < depth
                       ? __ldg(a + i * lda + a_off + rk + d) : 0.f;
      }
      // the relation's weight slice, output columns fastest
#pragma unroll
      for (int e = threadIdx.x; e < BD * BN; e += kThreads) {
        const int d = e / BN, c = e % BN;
        const int cc = c0 + c;
        float v = 0.f;
        if (d < depth && cc < C) {
          const int k = kDx ? cc : rk + d;
          const int j = j_off + (kDx ? rk + d : cc);
          const int h = j / O;
          v = __ldg(wsg + (static_cast<int64_t>(h) * K + k) * O + (j - h * O));
        }
        ws[d][c] = v;
      }
      __syncthreads();
      auto fma_depth = [&](int d) {
        const float4 av = *reinterpret_cast<const float4*>(&as[d][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&ws[d][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(ar[p], br[q], acc[p][q]);
      };
      if (depth == BD) {  // a full stage: a loop the compiler unrolls
#pragma unroll
        for (int d = 0; d < BD; ++d) fma_depth(d);
      } else {  // the last, short stage (R = 4 or 12: all of it)
#pragma unroll 4
        for (int d = 0; d < depth; ++d) fma_depth(d);
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int64_t i = r0 + ty * 4 + p;
      if (i < ra || i >= rb) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + tx * 4 + q;
        if (c < C) out[i * ldo + o_off + c] = acc[p][q];
      }
    }
  }
}

template <bool kDx, typename T>
int launch_rows_tiled(const float* a, const float* w,
                      const int32_t* seg_ptrs, float* out, int64_t n_rows,
                      int S, int H, int Hx, int K, int O, int C,
                      cudaStream_t st) {
  const int64_t ytiles = static_cast<int64_t>(Hx > 1 ? H : 1) *
                         ((C + T::kCols - 1) / T::kCols);
  const int64_t xtiles = (n_rows + T::kRows - 1) / T::kRows;
  if (ytiles == 0 || xtiles == 0) return cudaSuccess;  // nothing to write
  if (ytiles > 65535 || xtiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(xtiles),
                  static_cast<unsigned>(ytiles));
  segment_matmul_rows_kernel<kDx, T><<<grid, kThreads, 0, st>>>(
      a, w, seg_ptrs, out, n_rows, S, H, Hx, K, O);
  return cudaGetLastError();
}

int launch_rows(bool dx, const float* a, const float* w,
                const int32_t* seg_ptrs, float* out, int64_t n_rows, int S,
                int H, int Hx, int K, int O, void* stream) {
  if (n_rows < 0 || S < 0 || H < 0 || K < 0 || O < 0 ||
      (Hx != 1 && Hx != H)) {
    return cudaErrorInvalidValue;
  }
  // an empty reduction (K = 0 forward, O = 0 dX) still writes zeros
  const int C = dx ? K : (Hx > 1 ? O : H * O);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = C <= NarrowTile::kCols;
#define HET_ROWS(DX, T) \
  launch_rows_tiled<DX, T>(a, w, seg_ptrs, out, n_rows, S, H, Hx, K, O, C, st)
  if (dx) return narrow ? HET_ROWS(true, NarrowTile) : HET_ROWS(true, WideTile);
  return narrow ? HET_ROWS(false, NarrowTile) : HET_ROWS(false, WideTile);
#undef HET_ROWS
}

}  // namespace

extern "C" {

// Chunks the scratch of het_segment_matmul_dw_f32 must hold: `partial`
// takes this many times H*K*O floats, `chunk_ptr` S + 1 int32.
int64_t het_segment_matmul_dw_max_chunks(int64_t n_rows, int S) {
  return max_chunks(n_rows, S);
}

// x (n_rows, Hx*K) f32 and ct (n_rows, H*O) f32, row-major; seg_ptrs
// (S + 1,) int32 on the device, non-decreasing, seg_ptrs[S] <= n_rows;
// chunk_ptr and partial are scratch sized as above; out (S, H, K, O) f32.
// Hx is 1 or H.  Launches on `stream` and returns the first launch error
// (0 on success).
int het_segment_matmul_dw_f32(const float* x, const float* ct,
                              const int32_t* seg_ptrs, int32_t* chunk_ptr,
                              float* partial, float* out, int64_t n_rows,
                              int S, int H, int Hx, int K, int O,
                              void* stream) {
  if (S <= 0 || H <= 0 || K <= 0 || O <= 0) return cudaSuccess;
  if (n_rows < 0 || (Hx != 1 && Hx != H)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t chunks = max_chunks(n_rows, S);
  const int64_t NJ = static_cast<int64_t>(H) * K * O;
  // O > 1: (head pass, k tile, column tile); one head pass of H * O
  // columns when x is shared by the heads
  const int64_t passes = Hx > 1 ? H : 1, cols = Hx > 1 ? O : H * O;
  const int64_t tiles = passes * ((K + kTile - 1) / kTile) *
                        ((cols + kTile - 1) / kTile);
  if (chunks > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidValue;

  segment_matmul_dw_plan_kernel<<<1, kPlanThreads, 0, st>>>(seg_ptrs,
                                                            chunk_ptr, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(static_cast<unsigned>(chunks),
                  O == 1 ? 1u : static_cast<unsigned>(tiles));
  if (O == 1) {
    const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (vec4)
      launch_colsum<4>(grid, x, ct, seg_ptrs, chunk_ptr, partial, S, H, Hx,
                       K, st);
    else
      launch_colsum<1>(grid, x, ct, seg_ptrs, chunk_ptr, partial, S, H, Hx,
                       K, st);
  } else {
    segment_matmul_dw_tiled_kernel<<<grid, kThreads, 0, st>>>(
        x, ct, seg_ptrs, chunk_ptr, partial, S, H, Hx, K, O);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // chunk lanes per column: about the chunks a segment has
  const int64_t per_seg = chunks / S;
  const int cl = per_seg <= 2 ? 1 : per_seg <= 16 ? 8 : 32;
  const int64_t cb = kThreads / cl;
  const int64_t col_blocks = (NJ + cb - 1) / cb;
  if (col_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 rgrid(static_cast<unsigned>(S),
                   static_cast<unsigned>(col_blocks));
  if (cl == 1)
    segment_matmul_dw_reduce_kernel<1><<<rgrid, kThreads, 0, st>>>(
        partial, chunk_ptr, out, NJ);
  else if (cl == 8)
    segment_matmul_dw_reduce_kernel<8><<<rgrid, kThreads, 0, st>>>(
        partial, chunk_ptr, out, NJ);
  else
    segment_matmul_dw_reduce_kernel<32><<<rgrid, kThreads, 0, st>>>(
        partial, chunk_ptr, out, NJ);
  return cudaGetLastError();
}

// Forward: x (n_rows, Hx*K) f32 and W (S, H, K, O) f32, row-major, on the
// device; seg_ptrs as above; y (n_rows, H*O) f32.  Launches on `stream`
// and returns the launch error (0 on success).
int het_segment_matmul_fwd_f32(const float* x, const float* w,
                               const int32_t* seg_ptrs, float* y,
                               int64_t n_rows, int S, int H, int Hx, int K,
                               int O, void* stream) {
  return launch_rows(false, x, w, seg_ptrs, y, n_rows, S, H, Hx, K, O,
                     stream);
}

// dX: ct (n_rows, H*O) f32 and W (S, H, K, O) f32; dx (n_rows, Hx*K) f32,
// per head when Hx = H, summed over the heads when Hx = 1.
int het_segment_matmul_dx_f32(const float* ct, const float* w,
                              const int32_t* seg_ptrs, float* dx,
                              int64_t n_rows, int S, int H, int Hx, int K,
                              int O, void* stream) {
  return launch_rows(true, ct, w, seg_ptrs, dx, n_rows, S, H, Hx, K, O,
                     stream);
}

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
