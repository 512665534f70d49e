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
//    the caller may allocate the output uninitialised;
//  * the sum also reads bf16 rows (het_tpu's mixed-precision payloads,
//    its pack_dt) into f32 or bf16 sums.  A bf16 row is loaded 8, 4, 2 or
//    1 elements at a time (16, 8, 4 or 2 bytes: the widest that C and the
//    addresses allow), widened to f32 as it is added (a bf16's bits are
//    the high half of the f32 it equals), and accumulated in f32 as an
//    f32 row is, partials and carries included; a bf16 sum is rounded
//    once, to nearest even, where it is stored.  A split row's first part
//    then waits in f32 scratch (head) rather than in the bf16 output, so
//    the fixup rounds the whole row's sum once.  Bound: the same bytes at
//    2 bytes a bf16 element.
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

#include <cuda_bf16.h>
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

// A lane's V neighbouring columns of a row, accumulated in f32.
template <int V>
struct Acc {
  float v[V];
};

// Loads of V neighbouring elements of In: f32 (16 or 4 bytes) or bf16
// (16, 8, 4 or 2 bytes), combined into an f32 accumulator as they are
// read (a bf16's bits are the high half of the f32 it equals).
template <class In, int V>
struct Ld;

template <>
struct Ld<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static Raw fill(float v) { return make_float4(v, v, v, v); }
  __device__ static void get(const Raw& r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};

template <>
struct Ld<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static Raw fill(float v) { return v; }
  __device__ static void get(const Raw& r, float (&f)[1]) { f[0] = r; }
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the bf16 pair in a 32-bit word, low half first
__device__ __forceinline__ void bf16_pair(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <>
struct Ld<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw fill(float v) {
    const uint32_t w = bf16_bits(v) * 0x10001u;
    return make_uint4(w, w, w, w);
  }
  __device__ static void get(const Raw& r, float (&f)[8]) {
    bf16_pair(r.x, f[0], f[1]); bf16_pair(r.y, f[2], f[3]);
    bf16_pair(r.z, f[4], f[5]); bf16_pair(r.w, f[6], f[7]);
  }
};

template <>
struct Ld<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static Raw fill(float v) {
    const uint32_t w = bf16_bits(v) * 0x10001u;
    return make_uint2(w, w);
  }
  __device__ static void get(const Raw& r, float (&f)[4]) {
    bf16_pair(r.x, f[0], f[1]); bf16_pair(r.y, f[2], f[3]);
  }
};

template <>
struct Ld<__nv_bfloat16, 2> {
  using Raw = uint32_t;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ static Raw fill(float v) { return bf16_bits(v) * 0x10001u; }
  __device__ static void get(const Raw& r, float (&f)[2]) {
    bf16_pair(r, f[0], f[1]);
  }
};

template <>
struct Ld<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static Raw fill(float v) {
    return static_cast<unsigned short>(bf16_bits(v));
  }
  __device__ static void get(const Raw& r, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

template <class R, int V>
__device__ __forceinline__ void acc_fill(Acc<V>& a, float v) {
#pragma unroll
  for (int j = 0; j < V; ++j) a.v[j] = v;
}

template <class R, class In, int V>
__device__ __forceinline__ void acc_add(Acc<V>& a,
                                        const typename Ld<In, V>::Raw& r) {
  float f[V];
  Ld<In, V>::get(r, f);
#pragma unroll
  for (int j = 0; j < V; ++j) a.v[j] = R::op(a.v[j], f[j]);
}

template <class R, int V>
__device__ __forceinline__ void acc_shfl_combine(Acc<V>& a, unsigned mask,
                                                 int off) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    a.v[j] = R::op(a.v[j], __shfl_xor_sync(mask, a.v[j], off));
}

// V floats stored as they are (16, 8 or 4 bytes a store)
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  } else {
    *p = f[0];
  }
}

// V floats rounded once to bf16 (round to nearest even) and stored (16,
// 8, 4 or 2 bytes a store)
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p,
                                           const float (&f)[V]) {
  if constexpr (V == 1) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(bf16_bits(f[0]));
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j)
      w[j] = bf16_bits(f[2 * j]) | (bf16_bits(f[2 * j + 1]) << 16);
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// The reduction's final map applied and the result stored as Out.
template <class R, class Out, int V>
__device__ __forceinline__ void store_finished(Out* p, const Acc<V>& a) {
  float f[V];
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = R::finish(a.v[j]);
  if constexpr (sizeof(Out) == 4) {
    store_f32<V>(p, f);
  } else {
    store_bf16<V>(p, f);
  }
}

constexpr int kThreads = 256;
// 4 blocks of 256 threads an SM at least: the registers a thread may hold
// (64) then leave room for the warps that hide the gathers' latency
constexpr int kMinBlocks = 4;
// row_ptr entries a helper block samples before its tasks search
constexpr int kSample = 1024;

// R: the reduction.  In, Out: the element types of vals and out (f32 or
// bf16; the sums are f32 either way, rounded once where Out is bf16).  V:
// elements a load (f32: 4 or 1; bf16: 8, 4, 2 or 1).  S: lanes an edge
// slot (a power of two, 1..32).  NC: columns a lane (1 or 2).  G: edge
// slots a task (S * G <= 32), taking every G-th edge of the task's range
// and meeting in a fixed shuffle at its end.  Blocks below
// `helper_blocks` run the helper tasks (one a chunk of L edges), the rest
// one task a row.  A split row's first part is stored raw (f32) in out
// where Out is f32, else in head[h] for its first helper h, so that a
// bf16 result is rounded once, after the parts are combined.
template <class R, class In, class Out, int V, int S, int NC, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_reduce_kernel(const In* __restrict__ vals,
                  const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ perm,
                  Out* __restrict__ out, float* __restrict__ head,
                  int32_t* __restrict__ carry_row,
                  float* __restrict__ carry, int64_t n, int C, int64_t L,
                  int64_t helpers, int64_t helper_blocks) {
  using Raw = typename Ld<In, V>::Raw;
  constexpr int U = 8 / NC;                   // edges a batch of a slot
  constexpr int kTasks = kThreads / (S * G);  // tasks a block
  const int sub = threadIdx.x % S;
  const int slot = (threadIdx.x / S) % G;
  const int32_t lo = __ldg(row_ptr);
  int64_t a, b;  // the task's edges, counted from row_ptr[0]
  float* raw_dst = nullptr;  // where a raw (f32) partial goes
  Out* dst = nullptr;        // where a finished row goes
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
    raw_dst = carry + h * C;
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
    dst = out + row * C;
    if (raw) {  // rare: no division on the common path
      const int64_t cut = (start / L + 1) * L;
      if (cut < end) b = cut;
      if constexpr (sizeof(Out) == 4) {
        raw_dst = reinterpret_cast<float*>(dst);
      } else {
        raw_dst = head + (b / L) * C;  // b is the row's first helper's edge
      }
    }
  }
  const int cv = C / V;  // vector columns a row
  for (int c0 = 0; c0 < cv; c0 += S * NC) {
    int off[NC];
    bool act[NC];
    Acc<V> acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = c0 + sub + k * S;
      act[k] = col < cv;
      off[k] = col * V;
      acc_fill<R, V>(acc[k], R::empty());
    }
    for (int64_t e = a + slot; e < b; e += U * G) {
      Raw v[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t k = e + u * G;
        const int64_t r =
            k < b ? (perm ? static_cast<int64_t>(__ldg(perm + lo + k))
                          : lo + k)
                  : -1;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          v[u][c] = (r >= 0 && act[c]) ? Ld<In, V>::load(vals + r * C + off[c])
                                       : Ld<In, V>::fill(R::empty());
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_add<R, In, V>(acc[c], v[u][c]);
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
        for (int c = 0; c < NC; ++c) acc_shfl_combine<R, V>(acc[c], mask, o);
      }
    }
    if (slot == 0) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (!act[k]) continue;
        if (raw) {
          store_f32<V>(raw_dst + off[k], acc[k].v);
        } else {
          store_finished<R, Out, V>(dst + off[k], acc[k]);
        }
      }
    }
  }
}

// Last pass, one thread a (helper, column): at the first helper h of
// each split row, the column's first part (stored raw in out where Out is
// f32, else in head[h]) combined with the helpers' partials in edge
// order, stored finished.
template <class R, class Out>
__global__ void __launch_bounds__(kThreads)
seg_reduce_fixup_kernel(const int32_t* __restrict__ carry_row,
                        const float* __restrict__ carry,
                        const float* __restrict__ head,
                        Out* __restrict__ out, int C, int64_t helpers) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= helpers * C) return;
  const int64_t h = t / C;
  const int c = static_cast<int>(t - h * C);
  const int32_t r = carry_row[h];
  if (r < 0 || (h > 0 && carry_row[h - 1] == r)) return;
  Out* o = out + static_cast<int64_t>(r) * C + c;
  float acc;
  if constexpr (sizeof(Out) == 4) {
    acc = *o;
  } else {
    acc = head[h * C + c];
  }
  for (int64_t k = h; k < helpers && carry_row[k] == r; ++k) {
    acc = R::op(acc, carry[k * C + c]);
  }
  if constexpr (sizeof(Out) == 4) {
    *o = R::finish(acc);
  } else {
    *o = __float2bfloat16_rn(R::finish(acc));
  }
}

template <class R, class In, class Out, int V, int S, int NC, int G>
cudaError_t launch_rows(const In* vals, const int32_t* row_ptr,
                        const int32_t* perm, Out* out, float* head,
                        int32_t* carry_row, float* carry, int64_t n, int C,
                        int64_t L, int64_t helpers, cudaStream_t stream) {
  constexpr int kTasks = kThreads / (S * G);
  const int64_t helper_blocks = (helpers + kTasks - 1) / kTasks;
  const int64_t blocks = helper_blocks + (n + kTasks - 1) / kTasks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  seg_reduce_kernel<R, In, Out, V, S, NC, G>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          vals, row_ptr, perm, out, head, carry_row, carry, n, C, L,
          helpers, helper_blocks);
  return cudaGetLastError();
}

template <class R, class In, class Out, int V>
cudaError_t launch_v(const In* vals, const int32_t* row_ptr,
                     const int32_t* perm, Out* out, float* head,
                     int32_t* carry_row, float* carry, int64_t n, int C,
                     int64_t L, int64_t helpers, cudaStream_t s) {
  const int cv = C / V;
#define HET_ROWS(S_, NC_, G_)                                              \
  launch_rows<R, In, Out, V, S_, NC_, G_>(vals, row_ptr, perm, out, head,   \
                                          carry_row, carry, n, C, L,        \
                                          helpers, s)
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

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest load of V elements that C and the pointers allow: f32 rows
// read 4 floats (16 bytes) or 1; bf16 rows 8, 4, 2 or 1 elements (16, 8,
// 4 or 2 bytes), the output stored V elements at a time as well.
template <class R, class In, class Out>
cudaError_t launch(const In* vals, const int32_t* row_ptr,
                   const int32_t* perm, Out* out, float* head,
                   int32_t* carry_row, float* carry, int64_t n, int C,
                   int64_t L, int64_t helpers, cudaStream_t s) {
  if (L <= 0 || helpers <= 0 || n > 0x7ffffffeLL)
    return cudaErrorInvalidValue;
  // V elements a load where C, vals, out and the f32 scratch allow it
  const auto fits = [&](int V) {
    return C % V == 0 && aligned(vals, V * sizeof(In)) &&
           aligned(out, V * sizeof(Out)) &&
           aligned(carry, 4 * V < 16 ? 4 * V : 16) &&
           (head == nullptr || aligned(head, 4 * V < 16 ? 4 * V : 16));
  };
  cudaError_t err;
  if constexpr (sizeof(In) == 4) {
    err = fits(4) ? launch_v<R, In, Out, 4>(vals, row_ptr, perm, out, head,
                                            carry_row, carry, n, C, L,
                                            helpers, s)
                  : launch_v<R, In, Out, 1>(vals, row_ptr, perm, out, head,
                                            carry_row, carry, n, C, L,
                                            helpers, s);
  } else {
#define HET_V(V_)                                                          \
  launch_v<R, In, Out, V_>(vals, row_ptr, perm, out, head, carry_row,      \
                           carry, n, C, L, helpers, s)
    err = fits(8) ? HET_V(8) : fits(4) ? HET_V(4) : fits(2) ? HET_V(2)
                                                            : HET_V(1);
#undef HET_V
  }
  if (err != cudaSuccess) return err;
  const int64_t blocks = (helpers * C + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  seg_reduce_fixup_kernel<R, Out><<<static_cast<unsigned>(blocks), kThreads,
                                    0, s>>>(carry_row, carry, head, out, C,
                                            helpers);
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
      vals, row_ptr, perm, out, static_cast<float*>(nullptr), carry_row,
      carry, n, C, L, helpers, static_cast<cudaStream_t>(stream)));
}

// The same contract with vals bf16: the sums are f32, out f32.
int het_seg_sum_sorted_bf16_f32(const __nv_bfloat16* vals,
                                const int32_t* row_ptr, const int32_t* perm,
                                float* out, int64_t n, int C, int64_t L,
                                int64_t helpers, int32_t* carry_row,
                                float* carry, void* stream) {
  if (n <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch<SumOp>(
      vals, row_ptr, perm, out, static_cast<float*>(nullptr), carry_row,
      carry, n, C, L, helpers, static_cast<cudaStream_t>(stream)));
}

// The same contract with vals and out bf16: the sums are f32, each rounded
// once (to nearest even) where it is stored.  Scratch head (helpers, C)
// f32, 16-byte aligned, holds the first part of each split row.
int het_seg_sum_sorted_bf16_bf16(const __nv_bfloat16* vals,
                                 const int32_t* row_ptr, const int32_t* perm,
                                 __nv_bfloat16* out, int64_t n, int C,
                                 int64_t L, int64_t helpers,
                                 int32_t* carry_row, float* carry,
                                 float* head, void* stream) {
  if (n <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch<SumOp>(
      vals, row_ptr, perm, out, head, carry_row, carry, n, C, L, helpers,
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
      vals, row_ptr, nullptr, out, static_cast<float*>(nullptr), carry_row,
      carry, n, C, L, helpers, static_cast<cudaStream_t>(stream)));
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
