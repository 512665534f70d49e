// Sorted segment reductions and a strided row copy for Hopper (sm_90a).
//
// 1. Sorted segment sum:
//
//     out[r, :] = sum_{e in [row_ptr[r], row_ptr[r+1])} vals[perm ? perm[e] : e, :]
//
// Replaces the TPU work-list segment-sum kernel
// het_tpu/ops/pallas/seg_reduce.py::_seg_sum_wl (kernel body
// _make_wl_kernel), which the JAX package reaches through
// seg_sum_sorted_packed.  It computes the same function, not the same
// way: the TPU version folds narrow payloads into 128-lane rows, splits
// f32 into three bf16 components and reduces with one-hot MXU matmuls over
// host-built work lists, all because the TPU has no gather and no atomics.
// None of that is needed here.
//
// 2. Sorted segment max (the destination max of the exact max-subtracted
// edge softmax):
//
//     out[r, :] = max_{e in [row_ptr[r], row_ptr[r+1])} vals[e, :],
//                 0 where that is not finite (an empty segment, +-inf, NaN)
//
// Replaces het_tpu/ops/pallas/seg_reduce.py::seg_max_dst_pallas_raw (kernel
// body _make_max_kernel).  The TPU version masks a (chunk x nb) block of
// edges against every local node's range and keeps a transposed
// accumulator, both layout workarounds for the TPU's vector unit; here the
// max is the same walk as the sum with max as the combine.
// Max is exact and order-free, so the result equals the plain version bit
// for bit (NaN is kept once met, then mapped to 0 like the other
// non-finite results).
//
// Bound of both: bytes.  A reduction does one add or compare per element
// it reads, so it must move rows_read * C * 4 bytes of values, 4 * rows_read
// bytes of perm (when given), (n + 1) * 4 bytes of row_ptr and n * C * 4
// bytes of output; the arithmetic is negligible against the card's f32
// rate.
//
// Design, aimed at that bound:
//  * one task a row, and a task is a group of S lanes (an edge slot) or
//    G slots of S lanes, S the smallest power of two covering the row's
//    vector columns up to 16; past 16 columns 16 lanes hold two each, so
//    that no lane is left without one (C = 68: 17 float4 columns, lane 0
//    also holds column 16).  A warp thus takes 32 / (S G) rows at once:
//    32 rows of C = 4, 8 of C = 12, two of C = 64, and short rows no
//    longer leave a warp's lanes idle.  At C = 68 a row takes the whole
//    warp, its two slots taking every other edge and meeting in one
//    shuffle, where the rows average 8 edges or more (bounded from sizes
//    the host knows); two rows a warp where they are shorter.  The row
//    pointer is read by neighbouring lanes for neighbouring rows, and a
//    row's output is stored once;
//  * a slot walks its edges in batches of U = 8 / NC, loading the whole
//    batch (through perm when given) before it adds any of it, so 8 loads
//    are in flight per lane; 64 registers a thread at most (4 blocks an
//    SM), since the gathers want warps more than deeper batches;
//  * rows longer than L edges (the wrapper's choice: 64 for C <= 4, 128
//    for C <= 16, 256 above) are split at the multiples of L counted from
//    row_ptr[0].  The row's task takes its edges up to the first multiple
//    past its start and stores that partial raw in out; helper task h
//    takes the edges [h L, (h + 1) L) of the row holding edge h L, where
//    that row is longer than L and began before h L (found by a binary
//    search of a 1025-entry sample of row_ptr in shared memory, then of
//    row_ptr between two samples), and leaves its raw partial in the
//    wrapper's scratch (carry[h], carry_row[h] naming the row, -1 for
//    none).  No task walks more than L edges, so a hub row of thousands
//    of edges costs the time of L.  The helpers' blocks come first in the
//    grid, so that their searches overlap the rows' work;
//  * a last pass, one thread a (helper, column), starts at the first
//    helper of each split row, combines out's raw first part with the
//    helpers' partials in edge order, and applies the reduction's final
//    map once (the max's non-finite -> 0 never touches a partial, so a
//    NaN in one helper's chunk stays NaN until then);
//  * the result is deterministic and needs no atomics: the split depends
//    only on row_ptr and L, each slot adds its edges in edge order, the
//    slots meet in a fixed shuffle and the parts in edge order;
//  * the grid is sized from what the host knows without reading the
//    device: n row tasks and (vals' rows, or perm's length) / L helpers;
//    helpers past the real edges record no row, so the wrapper reads
//    nothing back;
//  * accumulation is in f32, all row and column offsets are 64-bit, no row
//    of vals outside [row_ptr[0], row_ptr[n]) is read (through perm too),
//    and empty rows store the reduction's empty value, finished (0), so
//    the caller may allocate the output uninitialised.
//
// 3. Row copy: a 2-D or 3-D f32 tensor of any strides into a contiguous
// one of the same shape.  Replaces het_tpu/ops/pallas/seg_reduce.py::
// force_rowmajor (kernel body _identity_kernel), which pinned XLA's layout
// to row-major.  Bound: bytes, each element read once and written once.
// The output is walked flat in chunks of four floats, each stored with one
// float4 (the flat output is 16-byte aligned whatever the row width; a
// last partial chunk is stored by floats).  A thread takes chunks T apart
// (T the threads of a grid that fills the card), four at a time, so 16
// loads are in flight per thread; the source position (r, a, b) of a
// chunk is found by division once per thread and then advanced by the
// fixed stride's (dr, da, db) and by one element with carries, so no
// element pays a division.  Stores are coalesced; loads are wherever the
// innermost stride is 1.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// The reductions: the empty value, the combine and the final map.
struct SumOp {
  __device__ static float empty() { return 0.f; }
  __device__ static float op(float a, float b) { return a + b; }
  __device__ static float finish(float a) { return a; }
};

struct MaxOp {
  __device__ static float empty() { return -CUDART_INF_F; }
  // keeps a NaN once met (a NaN compares false either way)
  __device__ static float op(float a, float b) {
    return (a != a || a >= b) ? a : b;
  }
  __device__ static float finish(float a) { return isfinite(a) ? a : 0.f; }
};

template <int V>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static T fill(float v) { return make_float4(v, v, v, v); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  template <class R>
  __device__ static void combine(T& a, const T& b) {
    a.x = R::op(a.x, b.x); a.y = R::op(a.y, b.y);
    a.z = R::op(a.z, b.z); a.w = R::op(a.w, b.w);
  }
  template <class R>
  __device__ static T finish(const T& a) {
    return make_float4(R::finish(a.x), R::finish(a.y), R::finish(a.z),
                       R::finish(a.w));
  }
  __device__ static T shfl_xor(unsigned mask, const T& a, int off) {
    return make_float4(__shfl_xor_sync(mask, a.x, off),
                       __shfl_xor_sync(mask, a.y, off),
                       __shfl_xor_sync(mask, a.z, off),
                       __shfl_xor_sync(mask, a.w, off));
  }
  __device__ static void store(float* p, const T& a) {
    *reinterpret_cast<float4*>(p) = a;
  }
};

template <>
struct Vec<1> {
  using T = float;
  __device__ static T fill(float v) { return v; }
  __device__ static T load(const float* p) { return __ldg(p); }
  template <class R>
  __device__ static void combine(T& a, const T& b) { a = R::op(a, b); }
  template <class R>
  __device__ static T finish(const T& a) { return R::finish(a); }
  __device__ static T shfl_xor(unsigned mask, const T& a, int off) {
    return __shfl_xor_sync(mask, a, off);
  }
  __device__ static void store(float* p, const T& a) { *p = a; }
};

constexpr int kThreads = 256;
// 4 blocks of 256 threads an SM at least: the registers a thread may hold
// (64) then leave room for the warps that hide the gathers' latency
constexpr int kMinBlocks = 4;
// row_ptr entries a helper block samples before its tasks search
constexpr int kSample = 1024;

// Store one lane's columns of a row: raw, or through the final map.
template <class R, int V, int NC>
__device__ __forceinline__ void store_cols(
    float* p, const int (&off)[NC], const bool (&act)[NC],
    const typename Vec<V>::T (&acc)[NC], bool raw) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (act[k]) {
      Vec<V>::store(p + off[k],
                    raw ? acc[k] : Vec<V>::template finish<R>(acc[k]));
    }
  }
}

// R: the reduction.  V: floats a vector load (4 or 1).  S: lanes an edge
// slot (a power of two, 1..32).  NC: columns a lane (1 or 2).  G: edge
// slots a task (S * G <= 32), taking every G-th edge of the task's range
// and meeting in a fixed shuffle at its end.  Blocks below
// `helper_blocks` run the helper tasks (one a chunk of L edges), the rest
// one task a row.
template <class R, int V, int S, int NC, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_reduce_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ perm,
                  float* __restrict__ out, int32_t* __restrict__ carry_row,
                  float* __restrict__ carry, int64_t n, int C, int64_t L,
                  int64_t helpers, int64_t helper_blocks) {
  using Op = Vec<V>;
  using T = typename Op::T;
  constexpr int U = 8 / NC;                   // edges a batch of a slot
  constexpr int kTasks = kThreads / (S * G);  // tasks a block
  const int sub = threadIdx.x % S;
  const int slot = (threadIdx.x / S) % G;
  const int32_t lo = __ldg(row_ptr);
  int64_t a, b;  // the task's edges, counted from row_ptr[0]
  float* dst;
  bool raw;
  if (blockIdx.x < helper_blocks) {
    // helper h: the edges [h L, (h + 1) L) of a row longer than L that
    // began before h L.  The block first samples row_ptr at kSample + 1
    // evenly spaced rows (one round of loads), so that each task's search
    // of the device's row_ptr spans n / kSample rows, not n
    __shared__ int32_t sample[kSample + 1];
    for (int i = threadIdx.x; i <= kSample; i += kThreads) {
      sample[i] = __ldg(row_ptr + static_cast<int64_t>(i) * n / kSample);
    }
    __syncthreads();
    const int64_t h =
        static_cast<int64_t>(blockIdx.x) * kTasks + threadIdx.x / (S * G);
    if (h >= helpers) return;  // the lanes of a task leave together
    const int64_t m = static_cast<int64_t>(sample[kSample]) - lo;
    const int64_t e = h * L;
    int64_t row = -1;
    if (e < m) {
      // the row holding edge e is j - 1 for the first j with
      // row_ptr[j] - lo > e: first the first sample past e ...
      int x = 1, y = kSample;
      while (x < y) {
        const int mid = (x + y) >> 1;
        if (static_cast<int64_t>(sample[mid]) - lo > e) {
          y = mid;
        } else {
          x = mid + 1;
        }
      }
      // ... then j between the sampled rows before it and at it
      int64_t jx = static_cast<int64_t>(x - 1) * n / kSample + 1;
      int64_t jy = static_cast<int64_t>(x) * n / kSample;
      while (jx < jy) {
        const int64_t mid = (jx + jy) >> 1;
        if (static_cast<int64_t>(__ldg(row_ptr + mid)) - lo > e) {
          jy = mid;
        } else {
          jx = mid + 1;
        }
      }
      const int64_t r = jx - 1;
      const int64_t start = static_cast<int64_t>(__ldg(row_ptr + r)) - lo;
      const int64_t end = static_cast<int64_t>(__ldg(row_ptr + r + 1)) - lo;
      if (end - start > L && e > start) {
        row = r;
        a = e;
        b = e + L < end ? e + L : end;
      }
    }
    if (sub == 0 && slot == 0) carry_row[h] = static_cast<int32_t>(row);
    if (row < 0) return;
    dst = carry + h * C;
    raw = true;
  } else {
    // row r: all its edges, or for a row longer than L those before the
    // first multiple of L past its start (helpers take the rest)
    const int64_t row =
        static_cast<int64_t>(blockIdx.x - helper_blocks) * kTasks +
        threadIdx.x / (S * G);
    if (row >= n) return;
    const int64_t start = static_cast<int64_t>(__ldg(row_ptr + row)) - lo;
    const int64_t end = static_cast<int64_t>(__ldg(row_ptr + row + 1)) - lo;
    raw = end - start > L;
    a = start;
    b = end;
    if (raw) {  // rare: no division on the common path
      const int64_t cut = (start / L + 1) * L;
      if (cut < end) b = cut;
    }
    dst = out + row * C;
  }
  const int cv = C / V;  // vector columns a row
  for (int c0 = 0; c0 < cv; c0 += S * NC) {
    int off[NC];
    bool act[NC];
    T acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = c0 + sub + k * S;
      act[k] = col < cv;
      off[k] = col * V;
      acc[k] = Op::fill(R::empty());
    }
    for (int64_t e = a + slot; e < b; e += U * G) {
      T v[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t k = e + u * G;
        const int64_t r =
            k < b ? (perm ? static_cast<int64_t>(__ldg(perm + lo + k))
                          : lo + k)
                  : -1;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          v[u][c] = (r >= 0 && act[c]) ? Op::load(vals + r * C + off[c])
                                       : Op::fill(R::empty());
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) Op::template combine<R>(acc[c], v[u][c]);
      }
    }
    if (G > 1) {
      // the task's lanes, a power-of-two block of the warp
      const unsigned mask =
          S * G == 32 ? 0xffffffffu
                      : ((1u << (S * G)) - 1u) << (threadIdx.x & 31 &
                                                   ~(S * G - 1));
#pragma unroll
      for (int o = S; o < S * G; o <<= 1) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          Op::template combine<R>(acc[c], Op::shfl_xor(mask, acc[c], o));
        }
      }
    }
    if (slot == 0) store_cols<R, V, NC>(dst, off, act, acc, raw);
  }
}

// Last pass, one thread a (helper, column): at the first helper of each
// split row, the column's first part (stored raw in out) combined with
// the helpers' partials in edge order, stored finished.
template <class R>
__global__ void __launch_bounds__(kThreads)
seg_reduce_fixup_kernel(const int32_t* __restrict__ carry_row,
                        const float* __restrict__ carry,
                        float* __restrict__ out, int C, int64_t helpers) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= helpers * C) return;
  const int64_t h = t / C;
  const int c = static_cast<int>(t - h * C);
  const int32_t r = carry_row[h];
  if (r < 0 || (h > 0 && carry_row[h - 1] == r)) return;
  float* o = out + static_cast<int64_t>(r) * C + c;
  float acc = *o;
  for (int64_t k = h; k < helpers && carry_row[k] == r; ++k) {
    acc = R::op(acc, carry[k * C + c]);
  }
  *o = R::finish(acc);
}

template <class R, int V, int S, int NC, int G>
cudaError_t launch_rows(const float* vals, const int32_t* row_ptr,
                        const int32_t* perm, float* out, int32_t* carry_row,
                        float* carry, int64_t n, int C, int64_t L,
                        int64_t helpers, cudaStream_t stream) {
  constexpr int kTasks = kThreads / (S * G);
  const int64_t helper_blocks = (helpers + kTasks - 1) / kTasks;
  const int64_t blocks = helper_blocks + (n + kTasks - 1) / kTasks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  seg_reduce_kernel<R, V, S, NC, G><<<static_cast<unsigned>(blocks),
                                      kThreads, 0, stream>>>(
      vals, row_ptr, perm, out, carry_row, carry, n, C, L, helpers,
      helper_blocks);
  return cudaGetLastError();
}

template <class R, int V>
cudaError_t launch_v(const float* vals, const int32_t* row_ptr,
                     const int32_t* perm, float* out, int32_t* carry_row,
                     float* carry, int64_t n, int C, int64_t L,
                     int64_t helpers, cudaStream_t s) {
  const int cv = C / V;
#define HET_ROWS(S_, NC_, G_)                                          \
  launch_rows<R, V, S_, NC_, G_>(vals, row_ptr, perm, out, carry_row,   \
                                 carry, n, C, L, helpers, s)
  // S: the smallest power of two covering cv up to 16; past that 16
  // lanes with two columns each (cv = 17: no lane without a column), and
  // past 32 columns 32 lanes with two (past 64, passes of 64)
  if (cv == 1) return HET_ROWS(1, 1, 1);
  if (cv == 2) return HET_ROWS(2, 1, 1);
  if (cv <= 4) return HET_ROWS(4, 1, 1);
  if (cv <= 8) return HET_ROWS(8, 1, 1);
  if (cv <= 16) return HET_ROWS(16, 1, 1);
  if (cv <= 32) {
    // rows of 8 edges or more on average (bounded from the host's sizes):
    // one row a warp, two slots of 16 lanes; shorter: two rows a warp
    return helpers * L >= 8 * n ? HET_ROWS(16, 2, 2) : HET_ROWS(16, 2, 1);
  }
  return HET_ROWS(32, 2, 1);
#undef HET_ROWS
}

template <class R>
cudaError_t launch(const float* vals, const int32_t* row_ptr,
                   const int32_t* perm, float* out, int32_t* carry_row,
                   float* carry, int64_t n, int C, int64_t L,
                   int64_t helpers, cudaStream_t s) {
  if (L <= 0 || helpers <= 0 || n > 0x7ffffffeLL)
    return cudaErrorInvalidValue;
  const bool vec4 = (C % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(vals) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(carry) % 16 == 0);
  cudaError_t err =
      vec4 ? launch_v<R, 4>(vals, row_ptr, perm, out, carry_row, carry, n,
                            C, L, helpers, s)
           : launch_v<R, 1>(vals, row_ptr, perm, out, carry_row, carry, n,
                            C, L, helpers, s);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (helpers * C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  seg_reduce_fixup_kernel<R><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(carry_row, carry, out, C, helpers);
  return cudaGetLastError();
}

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;  // chunks of four floats a thread at once
constexpr int kCopyBlocks = 132 * 8;  // 2048 threads on each of 132 SMs

// Source position (r, a, b) of a flat output element of the (R, A, B)
// copy.
struct Pos {
  int64_t r;
  int a, b;
};

__device__ __forceinline__ Pos pos_of(int64_t f, int A, int B) {
  const int64_t W = static_cast<int64_t>(A) * B;
  Pos p;
  p.r = f / W;
  const int c = static_cast<int>(f - p.r * W);
  p.a = c / B;
  p.b = c - p.a * B;
  return p;
}

// p advanced by one element
__device__ __forceinline__ void step_one(Pos& p, int A, int B) {
  if (++p.b == B) {
    p.b = 0;
    if (++p.a == A) {
      p.a = 0;
      ++p.r;
    }
  }
}

// p advanced by d, d given as its own position (dr, da, db): one carry
// from b into a, one from a into r at most
__device__ __forceinline__ void advance_by(Pos& p, const Pos& d, int A,
                                           int B) {
  p.b += d.b;
  if (p.b >= B) {
    p.b -= B;
    ++p.a;
  }
  p.a += d.a;
  if (p.a >= A) {
    p.a -= A;
    ++p.r;
  }
  p.r += d.r;
}

// out (R, A, B) contiguous from x at element strides (s0, s1, s2): chunk k
// holds flat elements 4k .. 4k + 3; thread t takes chunks t, t + T, ...,
// kCopyUnroll of them at a time.
__global__ void __launch_bounds__(kCopyThreads)
strided_copy_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int64_t R, int A, int B, int64_t s0, int64_t s1,
                    int64_t s2) {
  const int64_t total = R * A * B;
  const int64_t chunks = (total + 3) / 4;
  const int64_t T = static_cast<int64_t>(gridDim.x) * kCopyThreads;
  int64_t k = static_cast<int64_t>(blockIdx.x) * kCopyThreads + threadIdx.x;
  if (k >= chunks) return;
  Pos p = pos_of(4 * k, A, B);
  const Pos step = pos_of(4 * T, A, B);
  for (; k < chunks; k += kCopyUnroll * T) {
    float v[kCopyUnroll][4];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      Pos q = p;
      const int64_t f = 4 * (k + u * T);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[u][j] = f + j < total
                      ? __ldg(x + q.r * s0 + q.a * s1 + q.b * s2)
                      : 0.f;
        step_one(q, A, B);
      }
      advance_by(p, step, A, B);
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int64_t f = 4 * (k + u * T);
      if (f + 3 < total) {
        *reinterpret_cast<float4*>(out + f) =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      } else {
        for (int j = 0; j < 4 && f + j < total; ++j) out[f + j] = v[u][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// vals (rows, C) f32 row-major; row_ptr (n + 1,) int32 non-decreasing;
// perm (m,) int32 or NULL; out (n, C) f32.  Every index the row pointer
// covers must address a row of vals (through perm when given).  Rows
// longer than L edges are split at the multiples of L (counted from
// row_ptr[0]) over `helpers` helper tasks, which must cover every edge:
// helpers * L >= row_ptr[n] - row_ptr[0].  Scratch from the caller:
// carry_row (helpers,) int32 and carry (helpers, C) f32, 16-byte aligned.
// Launches the reduction and its combine pass on `stream` and returns the
// first launch error (0 on success).
int het_seg_sum_sorted_f32(const float* vals, const int32_t* row_ptr,
                           const int32_t* perm, float* out, int64_t n, int C,
                           int64_t L, int64_t helpers, int32_t* carry_row,
                           float* carry, void* stream) {
  if (n <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch<SumOp>(
      vals, row_ptr, perm, out, carry_row, carry, n, C, L, helpers,
      static_cast<cudaStream_t>(stream)));
}

// The same contract with max for sum and no perm: out[r] is the column-wise
// max of rows [row_ptr[r], row_ptr[r+1]) of vals, 0 where not finite.
int het_seg_max_sorted_f32(const float* vals, const int32_t* row_ptr,
                           float* out, int64_t n, int C, int64_t L,
                           int64_t helpers, int32_t* carry_row, float* carry,
                           void* stream) {
  if (n <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch<MaxOp>(
      vals, row_ptr, nullptr, out, carry_row, carry, n, C, L, helpers,
      static_cast<cudaStream_t>(stream)));
}

// x: (R, A, B) f32 elements at element strides (s0, s1, s2) (a 2-D tensor
// passes A = 1, s1 = 0), A * B < 2^31; out: the contiguous (R, A, B) copy,
// 16-byte aligned.
int het_strided_copy_f32(const float* x, float* out, int64_t R, int A, int B,
                         int64_t s0, int64_t s1, int64_t s2, void* stream) {
  if (R <= 0 || A <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t want = (R * A * B + 4 * kCopyThreads - 1) / (4 * kCopyThreads);
  const unsigned blocks =
      static_cast<unsigned>(want < kCopyBlocks ? want : kCopyBlocks);
  strided_copy_kernel<<<blocks, kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, R, A, B, s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
