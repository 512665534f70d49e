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
// max is the same warp-per-row walk as the sum with max as the combine.
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
//  * one warp per output row; the row's edge range is walked by the warp
//    and the gather through perm is fused into the load, so no permuted
//    copy of vals is ever written;
//  * columns are read as float4 when C % 4 == 0 (16 bytes a lane,
//    neighbouring lanes on neighbouring addresses), else as floats;
//  * a warp is split into G groups of S lanes, S the smallest power of two
//    covering the row's vector columns (capped at 32): narrow payloads
//    read G edges at once, and the groups' partial results meet in a fixed
//    shuffle tree, so the result is deterministic and needs no atomics;
//  * the edge loop is unrolled by four so that four independent loads are
//    in flight per lane;
//  * accumulation is in f32, all row and column offsets are 64-bit, and
//    each output row is stored once; empty rows store the reduction's
//    empty value (0), so the caller may allocate the output uninitialised.
// What it does not do yet: rows far longer than the average (hub nodes)
// run serially in one warp, and with C = 4 a lone group of one lane per
// edge leaves lanes idle on short rows.
//
// 3. Row copy: a 2-D or 3-D f32 tensor of any strides into a contiguous
// one of the same shape.  Replaces het_tpu/ops/pallas/seg_reduce.py::
// force_rowmajor (kernel body _identity_kernel), which pinned XLA's layout
// to row-major.  Bound: bytes, each element read once and written once.
// One warp an output row, grid-stride over rows, 64-bit row offsets:
// writes are coalesced, and reads are too wherever the innermost stride
// is 1.

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
  __device__ static T shfl_xor(const T& a, int off) {
    T r;
    r.x = __shfl_xor_sync(0xffffffffu, a.x, off);
    r.y = __shfl_xor_sync(0xffffffffu, a.y, off);
    r.z = __shfl_xor_sync(0xffffffffu, a.z, off);
    r.w = __shfl_xor_sync(0xffffffffu, a.w, off);
    return r;
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
  __device__ static T shfl_xor(const T& a, int off) {
    return __shfl_xor_sync(0xffffffffu, a, off);
  }
  __device__ static void store(float* p, const T& a) { *p = a; }
};

constexpr int kWarpsPerBlock = 8;

// R: the reduction.  V: floats per vector load (4 or 1).  S: lanes per edge
// group (power of two, 1..32); the warp holds 32 / S groups.
template <class R, int V, int S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_reduce_sorted_kernel(const float* __restrict__ vals,
                         const int32_t* __restrict__ row_ptr,
                         const int32_t* __restrict__ perm,
                         float* __restrict__ out, int64_t n, int C) {
  using Op = Vec<V>;
  using T = typename Op::T;
  constexpr int G = 32 / S;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together: row is warp-uniform
  const int grp = lane / S;
  const int sub = lane % S;
  const int cv = C / V;  // vector columns per row
  const int start = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);

  for (int c0 = 0; c0 < cv; c0 += S) {
    const int col = c0 + sub;
    const bool active = col < cv;
    const int off = col * V;
    T acc = Op::fill(R::empty());
    if (active) {
      int e = start + grp;
      for (; e + 3 * G < end; e += 4 * G) {
        const int64_t r0 = perm ? __ldg(perm + e) : e;
        const int64_t r1 = perm ? __ldg(perm + e + G) : e + G;
        const int64_t r2 = perm ? __ldg(perm + e + 2 * G) : e + 2 * G;
        const int64_t r3 = perm ? __ldg(perm + e + 3 * G) : e + 3 * G;
        const T v0 = Op::load(vals + r0 * C + off);
        const T v1 = Op::load(vals + r1 * C + off);
        const T v2 = Op::load(vals + r2 * C + off);
        const T v3 = Op::load(vals + r3 * C + off);
        Op::template combine<R>(acc, v0);
        Op::template combine<R>(acc, v1);
        Op::template combine<R>(acc, v2);
        Op::template combine<R>(acc, v3);
      }
      for (; e < end; e += G) {
        const int64_t r = perm ? __ldg(perm + e) : e;
        Op::template combine<R>(acc, Op::load(vals + r * C + off));
      }
    }
    // fixed-order tree over the groups: lanes with equal `sub` meet
#pragma unroll
    for (int o = S; o < 32; o <<= 1)
      Op::template combine<R>(acc, Op::shfl_xor(acc, o));
    if (grp == 0 && active)
      Op::store(out + row * C + off, Op::template finish<R>(acc));
  }
}

template <class R, int V>
cudaError_t launch_v(const float* vals, const int32_t* row_ptr,
                     const int32_t* perm, float* out, int64_t n, int C,
                     cudaStream_t stream) {
  const int cv = C / V;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  if (cv <= 1) {
    seg_reduce_sorted_kernel<R, V, 1><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 2) {
    seg_reduce_sorted_kernel<R, V, 2><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 4) {
    seg_reduce_sorted_kernel<R, V, 4><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 8) {
    seg_reduce_sorted_kernel<R, V, 8><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 16) {
    seg_reduce_sorted_kernel<R, V, 16><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else {
    seg_reduce_sorted_kernel<R, V, 32><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  }
  return cudaGetLastError();
}

template <class R>
cudaError_t launch(const float* vals, const int32_t* row_ptr,
                   const int32_t* perm, float* out, int64_t n, int C,
                   cudaStream_t s) {
  if ((n + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool vec4 = (C % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(vals) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return vec4 ? launch_v<R, 4>(vals, row_ptr, perm, out, n, C, s)
              : launch_v<R, 1>(vals, row_ptr, perm, out, n, C, s);
}

constexpr int kCopyWarps = 8;

// Row r of out (W = A * B contiguous floats) from x at r * s0: one warp a
// row, grid-stride over rows; column c = a * B + b reads a * s1 + b * s2.
__global__ void __launch_bounds__(kCopyWarps * 32)
strided_copy_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int64_t R, int A, int B, int64_t s0, int64_t s1,
                    int64_t s2) {
  const int W = A * B;
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kCopyWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kCopyWarps +
                   (threadIdx.x >> 5);
       r < R; r += step) {
    const float* xr = x + r * s0;
    float* outr = out + r * W;
    for (int c = lane; c < W; c += 32) {
      const int a = c / B;
      const int b = c - a * B;
      outr[c] = __ldg(xr + a * s1 + b * s2);
    }
  }
}

}  // namespace

extern "C" {

// vals (rows, C) f32 row-major; row_ptr (n + 1,) int32 non-decreasing;
// perm (m,) int32 or NULL; out (n, C) f32.  Every index the row pointer
// covers must address a row of vals (through perm when given).  Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
int het_seg_sum_sorted_f32(const float* vals, const int32_t* row_ptr,
                           const int32_t* perm, float* out, int64_t n, int C,
                           void* stream) {
  if (n <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch<SumOp>(vals, row_ptr, perm, out, n, C,
                                        static_cast<cudaStream_t>(stream)));
}

// The same contract with max for sum and no perm: out[r] is the column-wise
// max of rows [row_ptr[r], row_ptr[r+1]) of vals, 0 where not finite.
int het_seg_max_sorted_f32(const float* vals, const int32_t* row_ptr,
                           float* out, int64_t n, int C, void* stream) {
  if (n <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch<MaxOp>(vals, row_ptr, nullptr, out, n, C,
                                        static_cast<cudaStream_t>(stream)));
}

// x: (R, A, B) f32 elements at element strides (s0, s1, s2) (a 2-D tensor
// passes A = 1, s1 = 0), A * B < 2^31; out: the contiguous (R, A, B) copy.
int het_strided_copy_f32(const float* x, float* out, int64_t R, int A, int B,
                         int64_t s0, int64_t s1, int64_t s2, void* stream) {
  if (R <= 0 || A <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const int64_t want = (R + kCopyWarps - 1) / kCopyWarps;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  strided_copy_kernel<<<blocks, kCopyWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, R, A, B, s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
