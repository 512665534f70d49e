// Grouped weight gradient of the relation-segmented matmul, for Hopper
// (sm_90a):
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
//    stages 16-row slices of a 64 x 64 (k, o) tile in shared memory and
//    keeps a 4 x 4 register tile a thread.  It uses no tensor cores (f32
//    operands; wgmma and TMA are later work).
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

// blockIdx.y enumerates (h, k tile, o tile); 16 x 16 threads each own a
// 4 x 4 register tile (k = k0 + 4 ty + p, o = o0 + 4 tx + q).
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
  const int nkt = (K + kTile - 1) / kTile, not_ = (O + kTile - 1) / kTile;
  int tile = blockIdx.y;
  const int ot = tile % not_;
  tile /= not_;
  const int kt = tile % nkt;
  const int h = tile / nkt;
  const int k0 = kt * kTile, o0 = ot * kTile;
  const int kw = K - k0 < kTile ? K - k0 : kTile;
  const int ow = O - o0 < kTile ? O - o0 : kTile;
  const int64_t x_stride = static_cast<int64_t>(Hx) * K;
  const int64_t c_stride = static_cast<int64_t>(H) * O;
  const float* xb = x + (Hx > 1 ? h * K : 0) + k0;
  const float* cb = ct + h * O + o0;
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
      cs[r][col] = row_ok && col < ow ? __ldg(cb + i * c_stride + col) : 0.f;
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
  float* out = partial + static_cast<int64_t>(blockIdx.x) * H * K * O +
               static_cast<int64_t>(h) * K * O;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int k = k0 + ty * 4 + p;
    if (k >= K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + tx * 4 + q;
      if (o < O) out[static_cast<int64_t>(k) * O + o] = acc[p][q];
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
  const int64_t tiles = static_cast<int64_t>(H) * ((K + kTile - 1) / kTile) *
                        ((O + kTile - 1) / kTile);
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

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
