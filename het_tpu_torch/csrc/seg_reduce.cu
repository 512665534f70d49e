// Sorted segment sum for Hopper (sm_90a):
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
// Bound: bytes.  The kernel does one add per element it reads, so it must
// move rows_read * C * 4 bytes of values, 4 * rows_read bytes of perm
// (when given), (n + 1) * 4 bytes of row_ptr and n * C * 4 bytes of output;
// the adds are negligible against the card's f32 rate.
//
// Design, aimed at that bound:
//  * one warp per output row; the row's edge range is walked by the warp
//    and the gather through perm is fused into the load, so no permuted
//    copy of vals is ever written;
//  * columns are read as float4 when C % 4 == 0 (16 bytes a lane,
//    neighbouring lanes on neighbouring addresses), else as floats;
//  * a warp is split into G groups of S lanes, S the smallest power of two
//    covering the row's vector columns (capped at 32): narrow payloads
//    read G edges at once, and the groups' partial sums meet in a fixed
//    shuffle tree, so the result is deterministic and needs no atomics;
//  * the edge loop is unrolled by four so that four independent loads are
//    in flight per lane;
//  * accumulation is in f32 and each output row is stored once; empty
//    rows store zeros, so the caller may allocate the output uninitialised.
// What it does not do yet: rows far longer than the average (hub nodes)
// run serially in one warp, and with C = 4 a lone group of one lane per
// edge leaves lanes idle on short rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
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
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void add(T& a, const T& b) { a += b; }
  __device__ static T shfl_xor(const T& a, int off) {
    return __shfl_xor_sync(0xffffffffu, a, off);
  }
  __device__ static void store(float* p, const T& a) { *p = a; }
};

constexpr int kWarpsPerBlock = 8;

// V: floats per vector load (4 or 1).  S: lanes per edge group (power of
// two, 1..32); the warp holds 32 / S groups.
template <int V, int S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_sum_sorted_kernel(const float* __restrict__ vals,
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
    T acc = Op::zero();
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
        Op::add(acc, v0);
        Op::add(acc, v1);
        Op::add(acc, v2);
        Op::add(acc, v3);
      }
      for (; e < end; e += G) {
        const int64_t r = perm ? __ldg(perm + e) : e;
        Op::add(acc, Op::load(vals + r * C + off));
      }
    }
    // fixed-order tree over the groups: lanes with equal `sub` meet
#pragma unroll
    for (int o = S; o < 32; o <<= 1) Op::add(acc, Op::shfl_xor(acc, o));
    if (grp == 0 && active) Op::store(out + row * C + off, acc);
  }
}

template <int V>
cudaError_t launch_v(const float* vals, const int32_t* row_ptr,
                     const int32_t* perm, float* out, int64_t n, int C,
                     cudaStream_t stream) {
  const int cv = C / V;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  if (cv <= 1) {
    seg_sum_sorted_kernel<V, 1><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 2) {
    seg_sum_sorted_kernel<V, 2><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 4) {
    seg_sum_sorted_kernel<V, 4><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 8) {
    seg_sum_sorted_kernel<V, 8><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else if (cv <= 16) {
    seg_sum_sorted_kernel<V, 16><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  } else {
    seg_sum_sorted_kernel<V, 32><<<grid, block, 0, stream>>>(vals, row_ptr, perm, out, n, C);
  }
  return cudaGetLastError();
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
  if ((n + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = (C % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(vals) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const cudaError_t err = vec4 ? launch_v<4>(vals, row_ptr, perm, out, n, C, s)
                               : launch_v<1>(vals, row_ptr, perm, out, n, C, s);
  return static_cast<int>(err);
}

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
