// The packed compact GAT op's per-edge terms, computed inside sorted
// segment walks for Hopper (sm_90a).
//
// fe (UCs, H*(1+D)) holds the source compact rows, per head the lanes
// [el | feat_0 .. feat_{D-1}] (the packed multiply-first projection); er
// (UCd, H) the destination compact rows; src_map and dst_map take a
// canonical edge to its source and destination compact rows; act is a
// leaky ReLU of slope `slope`, then a clip at +-clip where asked.  For an
// edge e into destination v, per head h:
//
//     raw_e = el[src_map[e], h] + er[dst_map[e], h]     z_e = exp(act(raw_e))
//
// 1. compact_gat_packed_fwd, a walk of the destination CSR (in_row_ptr):
//
//     s[v, h]      = sum_{dst(e)=v} z_e
//     out[v, h, :] = sum_{dst(e)=v} z_e feat[src_map[e], h, :] / s[v, h]
//                    (0 where s[v, h] = 0)
//
// 2. compact_gat_packed_bwd_dst, the same walk, from the output's
//    cotangent ct (N, H, D) and the forward's s and out:
//
//     alpha_e = z_e / s[v, h]   (0 where s[v, h] = 0)
//     draw_e  = alpha_e (<feat_e, ct[v, h]> - <out[v, h], ct[v, h]>)
//               act'(raw_e)
//
//    written as draw and alpha (EP, H) in canonical order; rows outside
//    the walked edges are not written;
//
// 3. compact_gat_packed_bwd_src, a walk of the source compact rows
//    (edge_row_ptr, reading edge e = perm[k]):
//
//     d_fe[r, h] = [sum_e draw_e | sum_e alpha_e ct[dst[e], h, :]]
//
//    in fe's packed layout.
//
// Together they replace het_tpu/ops/pallas/fused_agg.py::
// _make_compact_fused_packed_op: its _fwd (the edge-map gathers, the
// payload [z | z*feat] and its reduce over in_row_ptr by _seg_sum_wl) and
// its backward rule _bwd (the recomputed gathers, the destination gather
// of [ct | s | t2], the payload pay3 and its source-side reduce by
// _seg_sum_wl).  There every per-edge term is written to device memory
// between one XLA op and the next; here the terms live in registers, and
// only draw and alpha (2 H floats an edge) cross from pass 2 to pass 3
// and to the caller's (dst, rel)-run sum of draw (d_er).
//
// Bound: bytes.  An edge costs a few dozen operations a head, far under
// the card's f32 rate, against these bytes an edge at H = 8, D = 8:
// pass 1 reads its two edge-map entries (8), a source row (288) and a
// destination row of er (32), 328 in all; pass 2 reads the same and
// writes draw and alpha (64); pass 3 reads perm and dst (8), draw and
// alpha (64) and a row of ct (256).  The per-destination rows (s, out,
// ct in pass 2; the outputs) and the row pointers add little, the rows
// being about a tenth as many as the edges.
//
// Design, aimed at that bound (the walk is seg_reduce.cu's):
//  * a lane owns one head and up to kCols = 8 of its feature columns: a
//    head takes nch lanes (D / 8 rounded up to a power of two; 1 at D = 8)
//    and a slot of S lanes, a power of two, covers the heads (8 lanes at H
//    = 8, D = 8), with passes where H nch passes 32.  A lane computes raw
//    and z of its head itself, from its own loads of el and er, so that no
//    shuffle stands between a load and its use; pass 2's two dot products
//    over D meet across a head's nch lanes in a fixed shuffle;
//  * a task is one row walked by G slots (1, 2 or 4: as many as keep two
//    batches of edges each, from the mean row length the host knows)
//    taking every G-th edge and meeting in a fixed shuffle at the row's
//    end;
//  * a slot loads a batch of kBatch = 2 edges' indices, then all their
//    rows, before it uses any of them, so that the loads are in flight
//    together; 64 registers a thread at most (4 blocks an SM).  Measured
//    at the benchmark's first cell's shapes (H100, the three walks of a
//    layer, 21.1M edges): this shape 11.9 ms; a batch of 4 at up to 80
//    registers 16.0, of 8 at 128 registers 23.0; 5 or 6 blocks an SM, or
//    G = 4 on the destination rows of 11 edges, slower;
//  * rows longer than L edges are split at the multiples of L counted from
//    row_ptr[0], found as in seg_reduce.cu (helper tasks after a search of
//    a sample of row_ptr in shared memory).  Pass 2 reduces nothing across
//    edges: a helper reads its row's s, out and ct and writes its edges'
//    terms.  Passes 1 and 3 leave each split row's first part raw in the
//    output and each helper's partial in scratch, and a last launch adds
//    them in edge order (pass 1 then divides by s);
//  * the results are deterministic and no atomics are used: the split
//    rests only on row_ptr and L, each slot adds its edges in edge order,
//    and slots, lanes and parts meet in a fixed order;
//  * arithmetic is f32 throughout, exp by expf and the division IEEE (no
//    fast-math flags): the compare's limits sit close above the chain's
//    readings.  All offsets are 64-bit, and no edge outside [row_ptr[0],
//    row_ptr[n]) is read.
//
// The kernels' names carry "compact_gat_packed", which the port's trace
// table (utils/profile_step.py::CATEGORIES) reads as its own category.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// row_ptr entries a helper block samples before its tasks search
constexpr int kSample = 1024;
// feature columns a lane: a head's columns take D / kCols lanes
constexpr int kCols = 8;
// edges a slot loads before it uses any of them
constexpr int kBatch = 2;
// blocks of 256 threads an SM at least (64 registers a thread): the
// gathers want warps in flight more than deeper batches
constexpr int kMinBlocks = 4;

// The activation and its derivative (zero outside the clip).
struct Act {
  float slope;
  float clip;
  int clipped;

  __device__ __forceinline__ float inner(float raw) const {
    return raw >= 0.f ? raw : slope * raw;
  }
  __device__ __forceinline__ float apply(float raw) const {
    const float a = inner(raw);
    return clipped ? fminf(fmaxf(a, -clip), clip) : a;
  }
  __device__ __forceinline__ float deriv(float raw) const {
    const float d = raw >= 0.f ? 1.f : slope;
    return (!clipped || fabsf(inner(raw)) <= clip) ? d : 0.f;
  }
};

// A lane's head and feature columns: columns [c0, c0 + nc) of head h.  A
// lane past the last head has h >= H and nc = 0.
struct Lane {
  int h, c0, nc;
};

__device__ __forceinline__ Lane lane_of(int unit, int H, int D, int nch) {
  Lane l;
  l.h = unit / nch;
  l.c0 = (unit - l.h * nch) * kCols;
  const int left = D - l.c0;
  l.nc = l.h < H ? (left < kCols ? (left > 0 ? left : 0) : kCols) : 0;
  return l;
}

// The edges a task walks, [a, b) counted from row_ptr[0]: a row task
// takes a row's edges, or for a row longer than L those before the first
// multiple of L past its start (`split`: helpers take the rest); helper h
// takes the edges [h L, (h + 1) L) of the row holding edge h L, where that
// row is longer than L and began before h L (row -1 where there is none).
struct Task {
  int64_t row, helper, a, b;
  bool split;
};

// The task of the calling thread's group of `lanes` lanes, as
// seg_reduce.cu's seg_reduce_kernel finds it: blocks below helper_blocks
// run helpers, the rest one task a row.  False where the group has no
// task (past the rows or the helpers).  Every thread of a block calls it.
__device__ __forceinline__ bool find_task(const int32_t* __restrict__ row_ptr,
                                          int64_t n, int64_t L,
                                          int64_t helpers,
                                          int64_t helper_blocks, int lanes,
                                          int32_t* sample, Task& t) {
  const int64_t tasks = kThreads / lanes;
  const int64_t lo = __ldg(row_ptr);
  if (blockIdx.x < helper_blocks) {
    for (int i = threadIdx.x; i <= kSample; i += kThreads) {
      sample[i] = __ldg(row_ptr + static_cast<int64_t>(i) * n / kSample);
    }
    __syncthreads();
    t.helper = static_cast<int64_t>(blockIdx.x) * tasks + threadIdx.x / lanes;
    if (t.helper >= helpers) return false;
    t.row = -1;
    t.split = false;
    const int64_t m = static_cast<int64_t>(sample[kSample]) - lo;
    const int64_t e = t.helper * L;
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
        t.row = r;
        t.a = e;
        t.b = e + L < end ? e + L : end;
      }
    }
    return true;
  }
  t.row = static_cast<int64_t>(blockIdx.x - helper_blocks) * tasks +
          threadIdx.x / lanes;
  if (t.row >= n) return false;
  t.helper = -1;
  t.a = static_cast<int64_t>(__ldg(row_ptr + t.row)) - lo;
  t.b = static_cast<int64_t>(__ldg(row_ptr + t.row + 1)) - lo;
  t.split = t.b - t.a > L;
  if (t.split) t.b = (t.a / L + 1) * L;  // before the row's end, as it is long
  return true;
}

// The mask of the `width` lanes (a power of two) holding the calling lane.
__device__ __forceinline__ unsigned group_mask(int width) {
  return width == 32 ? 0xffffffffu
                     : ((1u << width) - 1u) << (threadIdx.x & 31 &
                                                ~(width - 1));
}

// v summed over a head's nch neighbouring lanes (a power of two), in a
// fixed order; `mask` holds them.
__device__ __forceinline__ float head_sum(float v, int nch, unsigned mask) {
  for (int o = 1; o < nch; o <<= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// A batch of a slot's edges: edge k = e + u G for u < kBatch, those past
// b left out (index -1), and through perm where given.
template <int G>
__device__ __forceinline__ void batch_edges(const int32_t* __restrict__ perm,
                                            int64_t lo, int64_t e, int64_t b,
                                            int64_t (&edge)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int64_t k = e + u * G;
    edge[u] = k < b ? (perm ? static_cast<int64_t>(__ldg(perm + lo + k))
                            : lo + k)
                    : -1;
  }
}

// A batch's source rows (el and the lane's feature columns) and er, for
// passes 1 and 2: zeros for an edge left out or an idle lane.
template <int G>
__device__ __forceinline__ void batch_rows(
    const float* __restrict__ fe, const float* __restrict__ er,
    const int32_t* __restrict__ src_map, const int32_t* __restrict__ dst_map,
    const int64_t (&edge)[kBatch], const Lane& l, int H, int D,
    float (&el)[kBatch], float (&erv)[kBatch], float (&f)[kBatch][kCols]) {
  const int W = H * (D + 1);
  const bool live = l.h < H;
  int64_t rs[kBatch], rd[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const bool ok = edge[u] >= 0;
    rs[u] = ok ? static_cast<int64_t>(__ldg(src_map + edge[u])) : -1;
    rd[u] = ok ? static_cast<int64_t>(__ldg(dst_map + edge[u])) : -1;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const bool ok = live && rs[u] >= 0;
    const float* p = fe + (ok ? rs[u] * W + l.h * (D + 1) : 0);
    el[u] = ok ? __ldg(p) : 0.f;
    erv[u] = ok ? __ldg(er + rd[u] * H + l.h) : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      f[u][c] = (ok && c < l.nc) ? __ldg(p + 1 + l.c0 + c) : 0.f;
    }
  }
}

// Pass 1.  S: lanes a slot; G: slots a task.  A row task of an unsplit
// row stores s and out finished; a split row's task stores its raw sums
// (s, and out undivided), a helper its partial in carry[h] = [s (H) | num
// (H D)], for the fix-up.
template <int S, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_gat_packed_fwd_walk(const float* __restrict__ fe,
                            const float* __restrict__ er,
                            const int32_t* __restrict__ src_map,
                            const int32_t* __restrict__ dst_map,
                            const int32_t* __restrict__ row_ptr,
                            float* __restrict__ s, float* __restrict__ out,
                            int32_t* __restrict__ carry_row,
                            float* __restrict__ carry, int64_t n, int H,
                            int D, int nch, Act act, int64_t L,
                            int64_t helpers, int64_t helper_blocks) {
  __shared__ int32_t sample[kSample + 1];
  Task t;
  if (!find_task(row_ptr, n, L, helpers, helper_blocks, S * G, sample, t))
    return;
  const int sub = threadIdx.x % S;
  const int slot = (threadIdx.x / S) % G;
  if (t.helper >= 0 && sub == 0 && slot == 0)
    carry_row[t.helper] = static_cast<int32_t>(t.row);
  if (t.row < 0) return;  // the lanes of a task leave together
  const int64_t lo = __ldg(row_ptr);
  const int64_t HD = static_cast<int64_t>(H) * D;
  for (int u0 = 0; u0 < H * nch; u0 += S) {
    const Lane l = lane_of(u0 + sub, H, D, nch);
    float zs = 0.f;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int64_t e = t.a + slot; e < t.b; e += kBatch * G) {
      int64_t edge[kBatch];
      float el[kBatch], erv[kBatch], f[kBatch][kCols];
      batch_edges<G>(nullptr, lo, e, t.b, edge);
      batch_rows<G>(fe, er, src_map, dst_map, edge, l, H, D, el, erv, f);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (edge[u] < 0) continue;  // alike on the slot's lanes
        const float z = expf(act.apply(el[u] + erv[u]));
        zs += z;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(z, f[u][c], acc[c]);
      }
    }
    if (G > 1) {
      const unsigned mask = group_mask(S * G);
#pragma unroll
      for (int o = S; o < S * G; o <<= 1) {
        zs += __shfl_xor_sync(mask, zs, o);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[c] += __shfl_xor_sync(mask, acc[c], o);
      }
    }
    if (slot != 0 || l.h >= H) continue;
    float* sp;
    float* np;
    if (t.helper >= 0) {
      sp = carry + t.helper * (H + HD) + l.h;
      np = carry + t.helper * (H + HD) + H + l.h * D + l.c0;
    } else {
      sp = s + t.row * H + l.h;
      np = out + t.row * HD + l.h * D + l.c0;
    }
    if (l.c0 == 0) *sp = zs;
    const bool raw = t.helper >= 0 || t.split;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < l.nc) np[c] = raw ? acc[c] : (zs != 0.f ? acc[c] / zs : 0.f);
    }
  }
}

// Pass 1's fix-up, one thread a (helper, head): at the first helper of
// each split row, the row's raw first part plus the helpers' partials in
// edge order, then out divided by s.
__global__ void __launch_bounds__(kThreads)
compact_gat_packed_fwd_fixup(const int32_t* __restrict__ carry_row,
                             const float* __restrict__ carry,
                             float* __restrict__ s, float* __restrict__ out,
                             int H, int D, int64_t helpers) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= helpers * H) return;
  const int64_t h = t / H;
  const int head = static_cast<int>(t - h * H);
  const int32_t r = carry_row[h];
  if (r < 0 || (h > 0 && carry_row[h - 1] == r)) return;
  const int64_t C = H + static_cast<int64_t>(H) * D;
  float sv = s[static_cast<int64_t>(r) * H + head];
  for (int64_t k = h; k < helpers && carry_row[k] == r; ++k)
    sv += carry[k * C + head];
  s[static_cast<int64_t>(r) * H + head] = sv;
  float* o = out + (static_cast<int64_t>(r) * H + head) * D;
  for (int d = 0; d < D; ++d) {
    float v = o[d];
    for (int64_t k = h; k < helpers && carry_row[k] == r; ++k)
      v += carry[k * C + H + static_cast<int64_t>(head) * D + d];
    o[d] = sv != 0.f ? v / sv : 0.f;
  }
}

// Pass 2.  A task reads its row's s, out and ct once, then writes draw
// and alpha for each of its edges (the head's first lane).
template <int S, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_gat_packed_bwd_dst_walk(const float* __restrict__ fe,
                                const float* __restrict__ er,
                                const int32_t* __restrict__ src_map,
                                const int32_t* __restrict__ dst_map,
                                const int32_t* __restrict__ row_ptr,
                                const float* __restrict__ s,
                                const float* __restrict__ out,
                                const float* __restrict__ ct,
                                float* __restrict__ draw,
                                float* __restrict__ alpha, int64_t n, int H,
                                int D, int nch, Act act, int64_t L,
                                int64_t helpers, int64_t helper_blocks) {
  __shared__ int32_t sample[kSample + 1];
  Task t;
  if (!find_task(row_ptr, n, L, helpers, helper_blocks, S * G, sample, t))
    return;
  if (t.row < 0) return;
  const int sub = threadIdx.x % S;
  const int slot = (threadIdx.x / S) % G;
  const unsigned mask = group_mask(S);  // the slot's lanes
  const int64_t lo = __ldg(row_ptr);
  for (int u0 = 0; u0 < H * nch; u0 += S) {
    const Lane l = lane_of(u0 + sub, H, D, nch);
    const bool live = l.h < H;
    // the row's terms: s, ct and t2 = <out, ct> for the lane's head
    const int64_t at = (t.row * H + l.h) * D + l.c0;
    const float sv = live ? __ldg(s + t.row * H + l.h) : 0.f;
    float c[kCols];
    float t2 = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const bool ok = k < l.nc;
      c[k] = ok ? __ldg(ct + at + k) : 0.f;
      t2 = fmaf(ok ? __ldg(out + at + k) : 0.f, c[k], t2);
    }
    t2 = head_sum(t2, nch, mask);
    for (int64_t e = t.a + slot; e < t.b; e += kBatch * G) {
      int64_t edge[kBatch];
      float el[kBatch], erv[kBatch], f[kBatch][kCols];
      batch_edges<G>(nullptr, lo, e, t.b, edge);
      batch_rows<G>(fe, er, src_map, dst_map, edge, l, H, D, el, erv, f);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (edge[u] < 0) continue;  // alike on the slot's lanes
        const float raw = el[u] + erv[u];
        const float z = expf(act.apply(raw));
        const float al = sv != 0.f ? z / sv : 0.f;
        float t1 = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) t1 = fmaf(f[u][k], c[k], t1);
        t1 = head_sum(t1, nch, mask);
        if (live && l.c0 == 0) {
          const int64_t i = edge[u] * H + l.h;
          draw[i] = al * (t1 - t2) * act.deriv(raw);
          alpha[i] = al;
        }
      }
    }
  }
}

// Pass 3.  Rows as pass 1: an unsplit or split row's task stores its
// sums in d_fe (the fix-up adds the helpers' partials), a helper in
// carry[h] (H (1 + D), d_fe's layout).
template <int S, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_gat_packed_bwd_src_walk(const float* __restrict__ draw,
                                const float* __restrict__ alpha,
                                const float* __restrict__ ct,
                                const int32_t* __restrict__ dst,
                                const int32_t* __restrict__ row_ptr,
                                const int32_t* __restrict__ perm,
                                float* __restrict__ d_fe,
                                int32_t* __restrict__ carry_row,
                                float* __restrict__ carry, int64_t n, int H,
                                int D, int nch, int64_t L, int64_t helpers,
                                int64_t helper_blocks) {
  __shared__ int32_t sample[kSample + 1];
  Task t;
  if (!find_task(row_ptr, n, L, helpers, helper_blocks, S * G, sample, t))
    return;
  const int sub = threadIdx.x % S;
  const int slot = (threadIdx.x / S) % G;
  if (t.helper >= 0 && sub == 0 && slot == 0)
    carry_row[t.helper] = static_cast<int32_t>(t.row);
  if (t.row < 0) return;
  const int64_t lo = __ldg(row_ptr);
  const int64_t W = static_cast<int64_t>(H) * (D + 1);
  for (int u0 = 0; u0 < H * nch; u0 += S) {
    const Lane l = lane_of(u0 + sub, H, D, nch);
    const bool live = l.h < H;
    float d_el = 0.f;
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int64_t e = t.a + slot; e < t.b; e += kBatch * G) {
      int64_t edge[kBatch];
      batch_edges<G>(perm, lo, e, t.b, edge);
      int64_t v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = edge[u] >= 0 ? static_cast<int64_t>(__ldg(dst + edge[u])) : -1;
      float dr[kBatch], al[kBatch], cv[kBatch][kCols];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool ok = live && edge[u] >= 0;
        dr[u] = ok ? __ldg(draw + edge[u] * H + l.h) : 0.f;
        al[u] = ok ? __ldg(alpha + edge[u] * H + l.h) : 0.f;
        const float* p = ct + (ok ? (v[u] * H + l.h) * D + l.c0 : 0);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          cv[u][c] = (ok && c < l.nc) ? __ldg(p + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (edge[u] < 0) continue;  // alike on the slot's lanes
        d_el += dr[u];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(al[u], cv[u][c], acc[c]);
      }
    }
    if (G > 1) {
      const unsigned mask = group_mask(S * G);
#pragma unroll
      for (int o = S; o < S * G; o <<= 1) {
        d_el += __shfl_xor_sync(mask, d_el, o);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[c] += __shfl_xor_sync(mask, acc[c], o);
      }
    }
    if (slot != 0 || !live) continue;
    float* p = (t.helper >= 0 ? carry + t.helper * W : d_fe + t.row * W) +
               l.h * (D + 1);
    if (l.c0 == 0) p[0] = d_el;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < l.nc) p[1 + l.c0 + c] = acc[c];
    }
  }
}

// Pass 3's fix-up, one thread a (helper, column): at the first helper of
// each split row, the row's first part plus the helpers' partials in edge
// order.
__global__ void __launch_bounds__(kThreads)
compact_gat_packed_bwd_src_fixup(const int32_t* __restrict__ carry_row,
                                 const float* __restrict__ carry,
                                 float* __restrict__ d_fe, int64_t W,
                                 int64_t helpers) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= helpers * W) return;
  const int64_t h = t / W;
  const int64_t c = t - h * W;
  const int32_t r = carry_row[h];
  if (r < 0 || (h > 0 && carry_row[h - 1] == r)) return;
  float* o = d_fe + static_cast<int64_t>(r) * W + c;
  float v = *o;
  for (int64_t k = h; k < helpers && carry_row[k] == r; ++k)
    v += carry[k * W + c];
  *o = v;
}

// The walks' shape: lanes a head (nch), lanes a slot (S) and slots a task
// (G), from H, D, the rows and the edges they hold (an upper bound the
// host knows).
struct Shape {
  int nch, S, G;
};

int pow2_at_least(int64_t x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

Shape shape_of(int H, int D, int64_t n, int64_t edges) {
  Shape sh;
  sh.nch = pow2_at_least((D + kCols - 1) / kCols);
  const int64_t units = static_cast<int64_t>(H) * sh.nch;
  sh.S = pow2_at_least(units < 32 ? units : 32);
  // as many slots as keep two batches of edges each, on rows of mean
  // length
  const int64_t mean = edges / (n > 0 ? n : 1);
  sh.G = 1;
  while (sh.G < 4 && sh.S * sh.G * 2 <= 32 && mean >= 4 * sh.G * kBatch)
    sh.G <<= 1;
  return sh;
}

// The walks' grid: helper blocks first, then one task a row.
struct Grid {
  int64_t helper_blocks, blocks;
};

Grid grid_of(int lanes, int64_t n, int64_t helpers) {
  const int64_t tasks = kThreads / lanes;
  Grid g;
  g.helper_blocks = (helpers + tasks - 1) / tasks;
  g.blocks = g.helper_blocks + (n + tasks - 1) / tasks;
  return g;
}

// f.template run<S, G>() for the shape's S and G (S G <= 32).
template <int S, class F>
cudaError_t with_slots(int G, const F& f) {
  if constexpr (S * 4 <= 32) {
    if (G == 4) return f.template run<S, 4>();
  }
  if constexpr (S * 2 <= 32) {
    if (G == 2) return f.template run<S, 2>();
  }
  return f.template run<S, 1>();
}

template <class F>
cudaError_t with_shape(const Shape& sh, const F& f) {
  switch (sh.S) {
    case 1: return with_slots<1>(sh.G, f);
    case 2: return with_slots<2>(sh.G, f);
    case 4: return with_slots<4>(sh.G, f);
    case 8: return with_slots<8>(sh.G, f);
    case 16: return with_slots<16>(sh.G, f);
    case 32: return with_slots<32>(sh.G, f);
    default: return cudaErrorInvalidValue;
  }
}

struct Fwd {
  const float* fe;
  const float* er;
  const int32_t* src_map;
  const int32_t* dst_map;
  const int32_t* row_ptr;
  float* s;
  float* out;
  int32_t* carry_row;
  float* carry;
  int64_t n;
  int H, D, nch;
  Act act;
  int64_t L, helpers;
  cudaStream_t stream;

  template <int S, int G>
  cudaError_t run() const {
    const Grid g = grid_of(S * G, n, helpers);
    if (g.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    compact_gat_packed_fwd_walk<S, G>
        <<<static_cast<unsigned>(g.blocks), kThreads, 0, stream>>>(
            fe, er, src_map, dst_map, row_ptr, s, out, carry_row, carry, n,
            H, D, nch, act, L, helpers, g.helper_blocks);
    return cudaGetLastError();
  }
};

struct BwdDst {
  const float* fe;
  const float* er;
  const int32_t* src_map;
  const int32_t* dst_map;
  const int32_t* row_ptr;
  const float* s;
  const float* out;
  const float* ct;
  float* draw;
  float* alpha;
  int64_t n;
  int H, D, nch;
  Act act;
  int64_t L, helpers;
  cudaStream_t stream;

  template <int S, int G>
  cudaError_t run() const {
    const Grid g = grid_of(S * G, n, helpers);
    if (g.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    compact_gat_packed_bwd_dst_walk<S, G>
        <<<static_cast<unsigned>(g.blocks), kThreads, 0, stream>>>(
            fe, er, src_map, dst_map, row_ptr, s, out, ct, draw, alpha, n, H,
            D, nch, act, L, helpers, g.helper_blocks);
    return cudaGetLastError();
  }
};

struct BwdSrc {
  const float* draw;
  const float* alpha;
  const float* ct;
  const int32_t* dst;
  const int32_t* row_ptr;
  const int32_t* perm;
  float* d_fe;
  int32_t* carry_row;
  float* carry;
  int64_t n;
  int H, D, nch;
  int64_t L, helpers;
  cudaStream_t stream;

  template <int S, int G>
  cudaError_t run() const {
    const Grid g = grid_of(S * G, n, helpers);
    if (g.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    compact_gat_packed_bwd_src_walk<S, G>
        <<<static_cast<unsigned>(g.blocks), kThreads, 0, stream>>>(
            draw, alpha, ct, dst, row_ptr, perm, d_fe, carry_row, carry, n, H,
            D, nch, L, helpers, g.helper_blocks);
    return cudaGetLastError();
  }
};

constexpr int kMaxD = kCols * 32;  // a head's lanes fit in a warp

bool bad_sizes(int64_t n, int H, int D, int64_t L, int64_t helpers) {
  return n > 0x7ffffffeLL || H <= 0 || D <= 0 || D > kMaxD || L <= 0 ||
         helpers <= 0;
}

Act act_of(float slope, int clipped, float clip) {
  Act a;
  a.slope = slope;
  a.clip = clip;
  a.clipped = clipped;
  return a;
}

unsigned fixup_blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Pass 1.  fe (UCs, H (1 + D)) and er (UCd, H) f32 row-major; src_map,
// dst_map (EP,) int32 compact rows of every canonical edge the row
// pointer covers; row_ptr (n + 1,) int32 non-decreasing; s (n, H) and out
// (n, H, D) f32, written whole.  `edges` bounds the walked edges (EP);
// rows longer than L edges are split over `helpers` helper tasks, which
// must cover every edge: helpers * L >= row_ptr[n] - row_ptr[0].
// Scratch: carry_row (helpers,) int32, carry (helpers, H (1 + D)) f32.
// 1 <= D <= 256.  Launches the walk and its fix-up on `stream`; returns
// the first launch error (0 on success).
int het_compact_gat_packed_fwd(const float* fe, const float* er,
                               const int32_t* src_map, const int32_t* dst_map,
                               const int32_t* row_ptr, float* s, float* out,
                               int64_t n, int H, int D, int64_t edges,
                               float slope, int clipped, float clip,
                               int64_t L, int64_t helpers,
                               int32_t* carry_row, float* carry,
                               void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(n, H, D, L, helpers))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(H, D, n, edges);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Fwd f{fe, er, src_map, dst_map, row_ptr, s, out, carry_row, carry,
              n, H, D, sh.nch, act_of(slope, clipped, clip), L, helpers, st};
  cudaError_t err = with_shape(sh, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_gat_packed_fwd_fixup<<<fixup_blocks(helpers * H), kThreads, 0,
                                 st>>>(carry_row, carry, s, out, H, D,
                                       helpers);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  As pass 1, with s (n, H), out (n, H, D) and ct (n, H, D) f32
// read; draw and alpha (EP, H) f32 written on the walked edges only.  No
// scratch: each helper writes its own edges.
int het_compact_gat_packed_bwd_dst(const float* fe, const float* er,
                                   const int32_t* src_map,
                                   const int32_t* dst_map,
                                   const int32_t* row_ptr, const float* s,
                                   const float* out, const float* ct,
                                   float* draw, float* alpha, int64_t n,
                                   int H, int D, int64_t edges, float slope,
                                   int clipped, float clip, int64_t L,
                                   int64_t helpers, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(n, H, D, L, helpers))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(H, D, n, edges);
  const BwdDst f{fe,   er, src_map, dst_map, row_ptr, s, out, ct, draw,
                 alpha, n,  H,       D,       sh.nch,
                 act_of(slope, clipped, clip), L, helpers,
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(with_shape(sh, f));
}

// Pass 3.  draw, alpha (EP, H) and ct (N, H, D) f32; dst (EP,) int32, the
// destination of every edge perm names; row_ptr (n + 1,) int32 over the
// source compact rows, perm (EP,) int32 the edges in their order; d_fe
// (n, H (1 + D)) f32, written whole.  Split rows and scratch as pass 1,
// carry (helpers, H (1 + D)) f32.
int het_compact_gat_packed_bwd_src(const float* draw, const float* alpha,
                                   const float* ct, const int32_t* dst,
                                   const int32_t* row_ptr,
                                   const int32_t* perm, float* d_fe,
                                   int64_t n, int H, int D, int64_t edges,
                                   int64_t L, int64_t helpers,
                                   int32_t* carry_row, float* carry,
                                   void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(n, H, D, L, helpers))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(H, D, n, edges);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdSrc f{draw, alpha, ct, dst,    row_ptr, perm, d_fe, carry_row,
                 carry, n,    H,  D,      sh.nch,  L,    helpers, st};
  cudaError_t err = with_shape(sh, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t W = static_cast<int64_t>(H) * (D + 1);
  compact_gat_packed_bwd_src_fixup<<<fixup_blocks(helpers * W), kThreads, 0,
                                     st>>>(carry_row, carry, d_fe, W,
                                           helpers);
  return static_cast<int>(cudaGetLastError());
}

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
