// HGT's plain layer core, its per-edge terms computed inside sorted
// segment walks for Hopper (sm_90a).
//
// v, k (src_space, H dk) and q (N, H dk) hold node rows; W_att and W_msg
// (R, H, dk, dk) and mu (R, H) the per-relation weights.  For an edge
// e = (u -> v, relation r), per head h (row vectors, x W = sum_i x_i W[i,:]):
//
//     score_e = <q[v] W_att[r], k[u]>    raw_e = score_e mu[r]
//     z_e     = exp(clip(raw_e))         msg_e = v[u] W_msg[r]
//
// 1. hgt_plain_fwd, a walk of the destination CSR (in_row_ptr):
//
//     s[v]   = sum_{dst(e)=v} z_e
//     out[v] = sum_{dst(e)=v} z_e msg_e / s[v]    (0 where s[v] = 0)
//
//    and score (EP, H) in canonical order, 0 on the edges it does not walk;
//
// 2. hgt_plain_bwd_dst, the same walk, from the output's cotangent ct
//    (N, H, dk), the forward's s, out and score:
//
//     alpha_e  = z_e / s[v]    (0 where s[v] = 0)
//     draw_e   = alpha_e (<msg_e, ct[v]> - <out[v], ct[v]>) clip'(raw_e)
//     dscore_e = draw_e mu[r]
//     d_q[v]   = sum_e dscore_e k[u] W_att[r]^T
//
//    written as draw and alpha (EP, H), d_q (N, H dk), and per run of
//    one destination and one relation (a (dst, rel) run of canonical
//    order) the rows q[v], ct[v], kd = sum_e dscore_e k[u] and va = sum_e
//    alpha_e v[u], stored in relation order: d_W_att[r] = sum q^T kd and
//    d_W_msg[r] = sum va^T ct over relation r's runs are then the grouped
//    dW of segment_mm.cu, which sums its chunks in a fixed order.  It also
//    writes score and draw at each edge's relation-sorted edge row
//    (inv[e]), where d_mu's grouped dW reads them without a take;
//
// 3. hgt_plain_bwd_src, a walk of the source CSR (out_row_ptr, reading
//    edge e = perm[p], canonical ids):
//
//     d_k[u] = sum_e dscore_e q[v] W_att[r]
//     d_v[u] = sum_e alpha_e ct[v] W_msg[r]^T
//
// Together they replace het_tpu/ops/pallas/fused_agg.py::
// _make_hgt_plain_full_op: its _fwd (the edge-row gathers of q, k and v,
// both segment matmuls, the read-back of [score | msg] through seg.inv and
// the reduce of [z | z*msg]) and its backward rule _bwd (all of that
// again, the destination gather of [ct | s | t2], the take of [dscore |
// alpha*ctd] through seg.perm, both matmul pullbacks, the reduce of d_q
// and the packed reduce of [dscore*attq | d_v]).  There every (EP, H dk)
// term is written to device memory between one op and the next; here the
// terms live in registers, and only score, draw and alpha (H floats an
// edge each) and the runs' rows (a tenth of the edges' count) reach it.
//
// Bound: bytes.  At H = 8, dk = 8, per edge: pass 1 reads src and rel (8)
// and the rows k[u] and v[u] (512) and writes score (32); pass 2 reads
// the same and score and writes draw and alpha (64), 616 in all; pass 3
// reads perm, dst and rel (12), draw and alpha (64) and the rows q[v] and
// ct[v] (512).  Pass 2's copies of score and draw in relation order add
// inv (4) and two scattered 32-byte writes (64), which spare the caller
// two takes of (EP, H) rows through a permutation (12.7 ms each at 21.1M
// edges, as narrow gathers run).  The rows a destination or a source reads and writes once,
// and the runs' rows, add about a tenth.  The arithmetic is a few hundred
// operations an edge, far under the card's f32 rate, once the linear maps
// are reassociated per run (below).
//
// Design, aimed at that bound (the walk and its split are compact_gat.cu's
// and seg_reduce.cu's):
//  * a lane owns one head, all dk of its columns in registers, so every
//    per-edge term and every dk x dk product is the lane's own; a slot of
//    S lanes (H rounded up to a power of two) walks one task, a row or a
//    helper's part of a long one;
//  * the maps are applied once a run, not once an edge: a run of one
//    relation in a walk's order shares W[r], so pass 1 keeps q[v] W_att[r]
//    and sums z_e v[u] before one product with W_msg[r]; pass 2 keeps
//    W_msg[r] ct[v] and sums dscore_e k[u] before one product with
//    W_att[r]^T; pass 3 walks each source's edges in (source, relation)
//    order (a permutation the caller keeps once a graph) and sums
//    dscore_e q[v] and alpha_e ct[v] before one product each;
//  * the weights and mu of every relation sit in shared memory when they
//    fit (kSmemBytes; laid out [r][i][j][h] there, so a slot's lanes read
//    neighbouring banks), else each product reads them from global
//    memory, where L1 and L2 keep the run's block: the choice follows
//    from R, H and dk alone;
//  * a slot loads a batch of kBatch edges' indices, then all their rows,
//    before it uses any of them, 16-byte loads where dk allows.  Measured
//    at hgt.mag.plain's shapes (H100, a layer's three walks, 21.1M edges):
//    a batch of 1 edge 22.0 ms, of 2 28.1 ms (80 registers a thread at
//    most, both spilling a little at dk = 8), of 4 at up to 128 registers
//    41.6 ms; rows split at 64, 128 or 256 edges within 3%;
//  * rows longer than L edges are split at the multiples of L counted from
//    row_ptr[0] and the parts found as in compact_gat.cu.  Passes 1 and 3
//    leave a split row's first part raw and each helper's partial in
//    scratch, and a last launch adds them in edge order (pass 1 then
//    divides by s).  Pass 2 does so for d_q, and each run's rows are
//    stored by the task that holds the run's first edge, while a helper
//    whose first run began before its part leaves that run's kd and va in
//    scratch for the fix-up to add;
//  * the results are deterministic and no atomics are used: the split
//    rests only on row_ptr and L, each slot adds its edges in their order
//    and parts meet in a fixed order;
//  * arithmetic is f32 throughout, exp by expf and the division IEEE (no
//    fast-math flags, no TF32).  All offsets are 64-bit, and no edge
//    outside [row_ptr[0], row_ptr[n]) is walked.
//
// The kernels' names carry "hgt_plain", and none of the fragments by which
// a trace files kernels into its categories (benchmark/trace.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// row_ptr entries a helper block samples before its tasks search
constexpr int kSample = 1024;
// edges a slot loads before it uses any of them
constexpr int kBatch = 1;
// blocks of 256 threads an SM at least (80 registers a thread)
constexpr int kMinBlocks = 3;
// the weights in shared memory at most, beside the sample (bytes)
constexpr int64_t kSmemBytes = 40 * 1024;
constexpr int kMaxH = 32;

// The clip and its derivative (zero outside the clip); the activation is
// the identity.
struct Clip {
  float clip;
  int clipped;

  __device__ __forceinline__ float apply(float raw) const {
    return clipped ? fminf(fmaxf(raw, -clip), clip) : raw;
  }
  __device__ __forceinline__ float deriv(float raw) const {
    return (!clipped || fabsf(raw) <= clip) ? 1.f : 0.f;
  }
};

// The per-relation weights in global memory, W (R, H, dk, dk) and mu
// (R, H), and whether a block copies them into shared memory.
struct Weights {
  const float* att;
  const float* msg;
  const float* mu;
  int R;
  int staged;
};

// A weight as a lane reads it: from the block's shared copy ([r][i][j][h])
// where there is one, else from global memory ([r][h][i][j]).
template <int DK>
struct W {
  const float* g;
  const float* s;
  int H;

  __device__ __forceinline__ float at(int r, int h, int i, int j) const {
    return s ? s[((r * DK + i) * DK + j) * H + h]
             : __ldg(g + ((static_cast<int64_t>(r) * H + h) * DK + i) * DK +
                     j);
  }
};

// The block's views of the weights, copied into shared memory first where
// w.staged.  Every thread of the block calls it.
template <int DK>
__device__ __forceinline__ void weights_of(const Weights& w, int H,
                                           float* sm, W<DK>& att, W<DK>& msg,
                                           const float*& mu) {
  att = W<DK>{w.att, nullptr, H};
  msg = W<DK>{w.msg, nullptr, H};
  mu = w.mu;
  if (!w.staged) return;
  const int per = w.R * H * DK * DK;
  for (int x = threadIdx.x; x < per; x += kThreads) {
    const int j = x % DK;
    const int i = (x / DK) % DK;
    const int h = (x / (DK * DK)) % H;
    const int r = x / (DK * DK * H);
    const int y = ((r * DK + i) * DK + j) * H + h;
    sm[y] = __ldg(w.att + x);
    sm[per + y] = __ldg(w.msg + x);
  }
  for (int x = threadIdx.x; x < w.R * H; x += kThreads)
    sm[2 * per + x] = __ldg(w.mu + x);
  __syncthreads();
  att.s = sm;
  msg.s = sm + per;
  mu = sm + 2 * per;
}

// y += x W[r, h] (y_j += sum_i x_i W[i, j])
template <int DK>
__device__ __forceinline__ void add_xw(const float (&x)[DK], const W<DK>& w,
                                       int r, int h, float (&y)[DK]) {
#pragma unroll
  for (int i = 0; i < DK; ++i) {
#pragma unroll
    for (int j = 0; j < DK; ++j) y[j] = fmaf(x[i], w.at(r, h, i, j), y[j]);
  }
}

// y += W[r, h] x (y_i += sum_j W[i, j] x_j)
template <int DK>
__device__ __forceinline__ void add_wx(const W<DK>& w, int r, int h,
                                       const float (&x)[DK], float (&y)[DK]) {
#pragma unroll
  for (int i = 0; i < DK; ++i) {
#pragma unroll
    for (int j = 0; j < DK; ++j) y[i] = fmaf(w.at(r, h, i, j), x[j], y[i]);
  }
}

template <int DK>
__device__ __forceinline__ void zero(float (&x)[DK]) {
#pragma unroll
  for (int j = 0; j < DK; ++j) x[j] = 0.f;
}

template <int DK>
__device__ __forceinline__ float dot(const float (&x)[DK],
                                     const float (&y)[DK]) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < DK; ++j) acc = fmaf(x[j], y[j], acc);
  return acc;
}

// y += a x
template <int DK>
__device__ __forceinline__ void axpy(float a, const float (&x)[DK],
                                     float (&y)[DK]) {
#pragma unroll
  for (int j = 0; j < DK; ++j) y[j] = fmaf(a, x[j], y[j]);
}

// A head's dk floats at p (16-byte loads where dk is a multiple of 4, the
// row pointer being aligned), or zeros where !ok.
template <int DK>
__device__ __forceinline__ void load_head(const float* __restrict__ p,
                                          bool ok, float (&x)[DK]) {
  if (!ok) {
    zero(x);
    return;
  }
  if constexpr (DK % 4 == 0) {
#pragma unroll
    for (int c = 0; c < DK / 4; ++c) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + c);
      x[4 * c] = t.x;
      x[4 * c + 1] = t.y;
      x[4 * c + 2] = t.z;
      x[4 * c + 3] = t.w;
    }
  } else if constexpr (DK % 2 == 0) {
#pragma unroll
    for (int c = 0; c < DK / 2; ++c) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p) + c);
      x[2 * c] = t.x;
      x[2 * c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < DK; ++c) x[c] = __ldg(p + c);
  }
}

template <int DK>
__device__ __forceinline__ void store_head(float* __restrict__ p,
                                           const float (&x)[DK]) {
  if constexpr (DK % 4 == 0) {
#pragma unroll
    for (int c = 0; c < DK / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < DK; ++c) p[c] = x[c];
  }
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

// The task of the calling thread's slot of `lanes` lanes (compact_gat.cu's
// find_task): blocks below helper_blocks run helpers, the rest one task a
// row.  False where the slot has no task (past the rows or the helpers).
// Every thread of a block calls it.
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
      int x = 1, y = kSample;
      while (x < y) {
        const int mid = (x + y) >> 1;
        if (static_cast<int64_t>(sample[mid]) - lo > e) {
          y = mid;
        } else {
          x = mid + 1;
        }
      }
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
  if (t.split) t.b = (t.a / L + 1) * L;
  return true;
}

// A batch of a slot's edges: edge k = e + u for u < kBatch, those past b
// left out (index -1), and through perm where given.
__device__ __forceinline__ void batch_edges(const int32_t* __restrict__ perm,
                                            int64_t lo, int64_t e, int64_t b,
                                            int64_t (&edge)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int64_t k = e + u;
    edge[u] = k < b ? (perm ? static_cast<int64_t>(__ldg(perm + lo + k))
                            : lo + k)
                    : -1;
  }
}

// A batch's other endpoints (through `ends`, src or dst) and relations,
// -1 for an edge left out.
__device__ __forceinline__ void batch_ends(const int32_t* __restrict__ ends,
                                           const int32_t* __restrict__ rel,
                                           const int64_t (&edge)[kBatch],
                                           int64_t (&node)[kBatch],
                                           int (&r)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const bool ok = edge[u] >= 0;
    node[u] = ok ? static_cast<int64_t>(__ldg(ends + edge[u])) : -1;
    r[u] = ok ? __ldg(rel + edge[u]) : -1;
  }
}

// Pass 1.  A lane walks its head h of a task's edges; a row task of an
// unsplit row stores s and out finished, of a split row its raw sums (s,
// and out undivided), a helper its partial in carry[helper] = [s (H) |
// num (H dk)], for the fix-up.  Helpers also write score's zeros on the
// edges outside the walk in their slice [h L, (h + 1) L) of [0, edges).
template <int DK>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hgt_plain_fwd_walk(const float* __restrict__ v, const float* __restrict__ q,
                   const float* __restrict__ k, Weights w,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ rel,
                   const int32_t* __restrict__ row_ptr, float* __restrict__ s,
                   float* __restrict__ out, float* __restrict__ score,
                   int32_t* __restrict__ carry_row, float* __restrict__ carry,
                   int64_t n, int64_t edges, int H, int S, Clip act,
                   int64_t L, int64_t helpers, int64_t helper_blocks) {
  extern __shared__ float sm[];
  __shared__ int32_t sample[kSample + 1];
  W<DK> watt, wmsg;
  const float* mu;
  weights_of<DK>(w, H, sm, watt, wmsg, mu);
  Task t;
  if (!find_task(row_ptr, n, L, helpers, helper_blocks, S, sample, t)) return;
  const int h = threadIdx.x % S;
  const bool live = h < H;
  const int hw = live ? h : 0;  // an idle lane reads head 0's weights
  const int64_t lo = __ldg(row_ptr);
  if (t.helper >= 0) {
    const int64_t hi = __ldg(row_ptr + n);
    const int64_t e0 = t.helper * L;
    const int64_t e1 = e0 + L < edges ? e0 + L : edges;
    if (live) {
      for (int64_t e = e0; e < e1 && e < lo; ++e) score[e * H + h] = 0.f;
      for (int64_t e = e0 > hi ? e0 : hi; e < e1; ++e) score[e * H + h] = 0.f;
    }
    if (h == 0) carry_row[t.helper] = static_cast<int32_t>(t.row);
  }
  if (t.row < 0) return;  // the lanes of a task leave together
  const int64_t HD = static_cast<int64_t>(H) * DK;
  float qv[DK], attq[DK], acc[DK], o[DK];
  load_head<DK>(q + t.row * HD + h * DK, live, qv);
  zero(attq);
  zero(acc);
  zero(o);
  float zs = 0.f, mur = 0.f;
  int cur = -1;
  for (int64_t e = t.a; e < t.b; e += kBatch) {
    int64_t edge[kBatch], node[kBatch];
    int r[kBatch];
    float kr[kBatch][DK], vr[kBatch][DK];
    batch_edges(nullptr, lo, e, t.b, edge);
    batch_ends(src, rel, edge, node, r);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = live && node[u] >= 0;
      load_head<DK>(k + node[u] * HD + h * DK, ok, kr[u]);
      load_head<DK>(v + node[u] * HD + h * DK, ok, vr[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (edge[u] < 0) continue;  // alike on the slot's lanes
      if (r[u] != cur) {
        if (cur >= 0) add_xw(acc, wmsg, cur, hw, o);
        cur = r[u];
        zero(attq);
        add_xw(qv, watt, cur, hw, attq);
        mur = mu[cur * H + hw];
        zero(acc);
      }
      const float sc = dot(attq, kr[u]);
      const float z = expf(act.apply(sc * mur));
      zs += z;
      axpy(z, vr[u], acc);
      if (live) score[edge[u] * H + h] = sc;
    }
  }
  if (cur >= 0) add_xw(acc, wmsg, cur, hw, o);
  if (!live) return;
  if (t.helper >= 0) {
    // [s | num] a helper: H (1 + dk) floats, not 16-byte aligned
    float* c = carry + t.helper * (H + HD);
    c[h] = zs;
#pragma unroll
    for (int j = 0; j < DK; ++j) c[H + h * DK + j] = o[j];
    return;
  }
  s[t.row * H + h] = zs;
  if (!t.split) {
#pragma unroll
    for (int j = 0; j < DK; ++j) o[j] = zs != 0.f ? o[j] / zs : 0.f;
  }
  store_head<DK>(out + t.row * HD + h * DK, o);
}

// Pass 1's fix-up, one thread a (helper, head): at the first helper of
// each split row, the row's raw first part plus the helpers' partials in
// edge order, then out divided by s.
__global__ void __launch_bounds__(kThreads)
hgt_plain_fwd_fixup(const int32_t* __restrict__ carry_row,
                    const float* __restrict__ carry, float* __restrict__ s,
                    float* __restrict__ out, int H, int dk, int64_t helpers) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= helpers * H) return;
  const int64_t h = t / H;
  const int head = static_cast<int>(t - h * H);
  const int32_t r = carry_row[h];
  if (r < 0 || (h > 0 && carry_row[h - 1] == r)) return;
  const int64_t C = H + static_cast<int64_t>(H) * dk;
  float sv = s[static_cast<int64_t>(r) * H + head];
  for (int64_t k = h; k < helpers && carry_row[k] == r; ++k)
    sv += carry[k * C + head];
  s[static_cast<int64_t>(r) * H + head] = sv;
  float* o = out + (static_cast<int64_t>(r) * H + head) * dk;
  for (int d = 0; d < dk; ++d) {
    float x = o[d];
    for (int64_t k = h; k < helpers && carry_row[k] == r; ++k)
      x += carry[k * C + H + static_cast<int64_t>(head) * dk + d];
    o[d] = sv != 0.f ? x / sv : 0.f;
  }
}

// Pass 2.  A task reads its row's q, ct, s and out once, then writes draw
// and alpha for each of its edges, and score and draw again at the edge's
// row inv[e] of score_rows and draw_rows.  Runs are numbered in canonical order:
// row v's first is row_run[v], run j starts at edge run_ptr[j], and its
// rows go to slot run_slot[j] of the relation-ordered run_* outputs.  A
// row task stores d_q (raw where the row is split); a helper leaves its
// d_q in carry[helper] = [d_q (H dk) | kd (H dk) | va (H dk)], with the
// kd and va of its first run where that run began before its part
// (carry_run, else -1), for the fix-up.
template <int DK>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hgt_plain_bwd_dst_walk(
    const float* __restrict__ v, const float* __restrict__ q,
    const float* __restrict__ k, Weights w, const int32_t* __restrict__ src,
    const int32_t* __restrict__ rel, const int32_t* __restrict__ row_ptr,
    const int32_t* __restrict__ run_ptr, const int32_t* __restrict__ row_run,
    const int32_t* __restrict__ run_slot, const float* __restrict__ score,
    const float* __restrict__ s, const float* __restrict__ out,
    const float* __restrict__ ct, const int32_t* __restrict__ inv,
    float* __restrict__ draw, float* __restrict__ alpha,
    float* __restrict__ score_rows, float* __restrict__ draw_rows,
    float* __restrict__ d_q,
    float* __restrict__ run_q, float* __restrict__ run_ct,
    float* __restrict__ run_kd, float* __restrict__ run_va,
    int32_t* __restrict__ carry_row, int32_t* __restrict__ carry_run,
    float* __restrict__ carry, int64_t n, int H, int S, Clip act, int64_t L,
    int64_t helpers, int64_t helper_blocks) {
  extern __shared__ float sm[];
  __shared__ int32_t sample[kSample + 1];
  W<DK> watt, wmsg;
  const float* mu;
  weights_of<DK>(w, H, sm, watt, wmsg, mu);
  Task t;
  if (!find_task(row_ptr, n, L, helpers, helper_blocks, S, sample, t)) return;
  const int h = threadIdx.x % S;
  const bool live = h < H;
  const int hw = live ? h : 0;
  if (t.helper >= 0 && h == 0) {
    carry_row[t.helper] = static_cast<int32_t>(t.row);
    carry_run[t.helper] = -1;
  }
  if (t.row < 0) return;
  const int64_t lo = __ldg(row_ptr);
  const int64_t HD = static_cast<int64_t>(H) * DK;
  const int64_t at = t.row * HD + h * DK;
  float qv[DK], cv[DK], ctw[DK], kd[DK], va[DK], dq[DK];
  load_head<DK>(q + at, live, qv);
  load_head<DK>(ct + at, live, cv);
  load_head<DK>(out + at, live, ctw);  // out's row, for t2 alone
  const float t2 = dot(ctw, cv);
  const float sv = live ? __ldg(s + t.row * H + h) : 0.f;
  zero(ctw);
  zero(kd);
  zero(va);
  zero(dq);
  // the run of the task's first edge; `direct` while the run in hand
  // began in this task
  int64_t run = __ldg(row_run + t.row);
  bool direct = true;
  if (t.helper >= 0) {
    const int64_t first = lo + t.a;
    int64_t x = run, y = __ldg(row_run + t.row + 1);
    while (y - x > 1) {
      const int64_t mid = (x + y) >> 1;
      if (static_cast<int64_t>(__ldg(run_ptr + mid)) <= first) {
        x = mid;
      } else {
        y = mid;
      }
    }
    run = x;
    direct = static_cast<int64_t>(__ldg(run_ptr + run)) == first;
  }
  --run;  // the first edge's relation moves it on
  float mur = 0.f;
  int cur = -1;
  // the run in hand done: d_q's part, and its rows stored or carried
  auto flush = [&]() {
    add_wx(watt, cur, hw, kd, dq);
    if (!live) return;
    if (direct) {
      const int64_t o = static_cast<int64_t>(__ldg(run_slot + run)) * HD +
                        h * DK;
      store_head<DK>(run_q + o, qv);
      store_head<DK>(run_ct + o, cv);
      store_head<DK>(run_kd + o, kd);
      store_head<DK>(run_va + o, va);
    } else {
      float* c = carry + t.helper * 3 * HD + h * DK;
      store_head<DK>(c + HD, kd);
      store_head<DK>(c + 2 * HD, va);
      if (h == 0) carry_run[t.helper] = static_cast<int32_t>(run);
    }
  };
  for (int64_t e = t.a; e < t.b; e += kBatch) {
    int64_t edge[kBatch], node[kBatch], row[kBatch];
    int r[kBatch];
    float sc[kBatch], kr[kBatch][DK], vr[kBatch][DK];
    batch_edges(nullptr, lo, e, t.b, edge);
    batch_ends(src, rel, edge, node, r);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = live && node[u] >= 0;
      row[u] = ok ? static_cast<int64_t>(__ldg(inv + edge[u])) : 0;
      sc[u] = ok ? __ldg(score + edge[u] * H + h) : 0.f;
      load_head<DK>(k + node[u] * HD + h * DK, ok, kr[u]);
      load_head<DK>(v + node[u] * HD + h * DK, ok, vr[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (edge[u] < 0) continue;  // alike on the slot's lanes
      if (r[u] != cur) {
        if (cur >= 0) {
          flush();
          direct = true;
        }
        cur = r[u];
        ++run;
        zero(ctw);
        add_wx(wmsg, cur, hw, cv, ctw);
        mur = mu[cur * H + hw];
        zero(kd);
        zero(va);
      }
      const float raw = sc[u] * mur;
      const float z = expf(act.apply(raw));
      const float al = sv != 0.f ? z / sv : 0.f;
      const float dr = al * (dot(vr[u], ctw) - t2) * act.deriv(raw);
      if (live) {
        draw[edge[u] * H + h] = dr;
        alpha[edge[u] * H + h] = al;
        score_rows[row[u] * H + h] = sc[u];
        draw_rows[row[u] * H + h] = dr;
      }
      axpy(dr * mur, kr[u], kd);
      axpy(al, vr[u], va);
    }
  }
  if (cur >= 0) flush();
  if (!live) return;
  store_head<DK>(t.helper >= 0 ? carry + t.helper * 3 * HD + h * DK
                               : d_q + at,
                 dq);
}

// Pass 2's fix-up, one thread a (helper, column): at the first helper of
// each split row, d_q's first part plus the helpers' partials in edge
// order; at the first helper of each run carried, the run's stored kd and
// va plus the helpers' parts in edge order.
__global__ void __launch_bounds__(kThreads)
hgt_plain_bwd_dst_fixup(const int32_t* __restrict__ carry_row,
                        const int32_t* __restrict__ carry_run,
                        const float* __restrict__ carry,
                        const int32_t* __restrict__ run_slot,
                        float* __restrict__ d_q, float* __restrict__ run_kd,
                        float* __restrict__ run_va, int64_t HD,
                        int64_t helpers) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= helpers * HD) return;
  const int64_t h = t / HD;
  const int64_t c = t - h * HD;
  const int64_t C = 3 * HD;
  const int32_t r = carry_row[h];
  if (r >= 0 && (h == 0 || carry_row[h - 1] != r)) {
    float* o = d_q + static_cast<int64_t>(r) * HD + c;
    float x = *o;
    for (int64_t k = h; k < helpers && carry_row[k] == r; ++k)
      x += carry[k * C + c];
    *o = x;
  }
  const int32_t run = carry_run[h];
  if (run >= 0 && (h == 0 || carry_run[h - 1] != run)) {
    const int64_t o = static_cast<int64_t>(run_slot[run]) * HD + c;
    float x = run_kd[o], y = run_va[o];
    for (int64_t k = h; k < helpers && carry_run[k] == run; ++k) {
      x += carry[k * C + HD + c];
      y += carry[k * C + 2 * HD + c];
    }
    run_kd[o] = x;
    run_va[o] = y;
  }
}

// Pass 3.  A task walks a source's edges through perm, in (source,
// relation) order; rows as pass 1: a row task stores d_k and d_v (raw
// where the row is split, the fix-up adding the helpers' partials), a
// helper its partial in carry[helper] = [d_k (H dk) | d_v (H dk)].
template <int DK>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hgt_plain_bwd_src_walk(const float* __restrict__ q,
                       const float* __restrict__ ct, Weights w,
                       const int32_t* __restrict__ dst,
                       const int32_t* __restrict__ rel,
                       const int32_t* __restrict__ row_ptr,
                       const int32_t* __restrict__ perm,
                       const float* __restrict__ draw,
                       const float* __restrict__ alpha,
                       float* __restrict__ d_k, float* __restrict__ d_v,
                       int32_t* __restrict__ carry_row,
                       float* __restrict__ carry, int64_t n, int H, int S,
                       int64_t L, int64_t helpers, int64_t helper_blocks) {
  extern __shared__ float sm[];
  __shared__ int32_t sample[kSample + 1];
  W<DK> watt, wmsg;
  const float* mu;
  weights_of<DK>(w, H, sm, watt, wmsg, mu);
  Task t;
  if (!find_task(row_ptr, n, L, helpers, helper_blocks, S, sample, t)) return;
  const int h = threadIdx.x % S;
  const bool live = h < H;
  const int hw = live ? h : 0;
  if (t.helper >= 0 && h == 0)
    carry_row[t.helper] = static_cast<int32_t>(t.row);
  if (t.row < 0) return;
  const int64_t lo = __ldg(row_ptr);
  const int64_t HD = static_cast<int64_t>(H) * DK;
  float dk[DK], dv[DK], aq[DK], ac[DK];
  zero(dk);
  zero(dv);
  zero(aq);
  zero(ac);
  float mur = 0.f;
  int cur = -1;
  for (int64_t e = t.a; e < t.b; e += kBatch) {
    int64_t edge[kBatch], node[kBatch];
    int r[kBatch];
    float dr[kBatch], al[kBatch], qr[kBatch][DK], cr[kBatch][DK];
    batch_edges(perm, lo, e, t.b, edge);
    batch_ends(dst, rel, edge, node, r);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = live && node[u] >= 0;
      dr[u] = ok ? __ldg(draw + edge[u] * H + h) : 0.f;
      al[u] = ok ? __ldg(alpha + edge[u] * H + h) : 0.f;
      load_head<DK>(q + node[u] * HD + h * DK, ok, qr[u]);
      load_head<DK>(ct + node[u] * HD + h * DK, ok, cr[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (edge[u] < 0) continue;  // alike on the slot's lanes
      if (r[u] != cur) {
        if (cur >= 0) {
          add_xw(aq, watt, cur, hw, dk);
          add_wx(wmsg, cur, hw, ac, dv);
        }
        cur = r[u];
        mur = mu[cur * H + hw];
        zero(aq);
        zero(ac);
      }
      axpy(dr[u] * mur, qr[u], aq);
      axpy(al[u], cr[u], ac);
    }
  }
  if (cur >= 0) {
    add_xw(aq, watt, cur, hw, dk);
    add_wx(wmsg, cur, hw, ac, dv);
  }
  if (!live) return;
  if (t.helper >= 0) {
    float* c = carry + t.helper * 2 * HD + h * DK;
    store_head<DK>(c, dk);
    store_head<DK>(c + HD, dv);
    return;
  }
  store_head<DK>(d_k + t.row * HD + h * DK, dk);
  store_head<DK>(d_v + t.row * HD + h * DK, dv);
}

// Pass 3's fix-up, one thread a (helper, column of [d_k | d_v]): at the
// first helper of each split row, the row's first part plus the helpers'
// partials in edge order.
__global__ void __launch_bounds__(kThreads)
hgt_plain_bwd_src_fixup(const int32_t* __restrict__ carry_row,
                        const float* __restrict__ carry,
                        float* __restrict__ d_k, float* __restrict__ d_v,
                        int64_t HD, int64_t helpers) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= helpers * 2 * HD) return;
  const int64_t h = t / (2 * HD);
  const int64_t c = t - h * 2 * HD;
  const int32_t r = carry_row[h];
  if (r < 0 || (h > 0 && carry_row[h - 1] == r)) return;
  float* o = (c < HD ? d_k + c : d_v + c - HD) + static_cast<int64_t>(r) * HD;
  float x = *o;
  for (int64_t k = h; k < helpers && carry_row[k] == r; ++k)
    x += carry[k * 2 * HD + c];
  *o = x;
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The walks' launch: helper blocks first, then one task a row, S lanes a
// task; the weights staged where they fit.
struct Launch {
  unsigned blocks;
  int64_t helper_blocks;
  int S;
  size_t smem;
  bool ok;
};

Launch launch_of(int64_t n, int64_t helpers, int H, int R, int dk) {
  Launch l;
  l.S = pow2_at_least(H);
  const int64_t tasks = kThreads / l.S;
  l.helper_blocks = (helpers + tasks - 1) / tasks;
  const int64_t blocks = l.helper_blocks + (n + tasks - 1) / tasks;
  l.ok = blocks <= 0x7fffffffLL;
  l.blocks = static_cast<unsigned>(blocks);
  const int64_t floats = static_cast<int64_t>(R) * H * (2 * dk * dk + 1);
  l.smem = floats * 4 <= kSmemBytes ? static_cast<size_t>(floats * 4) : 0;
  return l;
}

bool bad_sizes(int64_t n, int H, int dk, int R, int64_t L, int64_t helpers) {
  return n > 0x7ffffffeLL || H <= 0 || H > kMaxH || R <= 0 || L <= 0 ||
         helpers <= 0 ||
         (dk != 1 && dk != 2 && dk != 4 && dk != 8 && dk != 16);
}

Clip clip_of(int clipped, float clip) {
  Clip c;
  c.clip = clip;
  c.clipped = clipped;
  return c;
}

Weights weights_arg(const float* w_att, const float* w_msg, const float* mu,
                    int R, const Launch& l) {
  Weights w;
  w.att = w_att;
  w.msg = w_msg;
  w.mu = mu;
  w.R = R;
  w.staged = l.smem > 0;
  return w;
}

unsigned fixup_blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// f.template run<DK>() for dk in {1, 2, 4, 8, 16}.
template <class F>
cudaError_t with_width(int dk, const F& f) {
  switch (dk) {
    case 1: return f.template run<1>();
    case 2: return f.template run<2>();
    case 4: return f.template run<4>();
    case 8: return f.template run<8>();
    case 16: return f.template run<16>();
    default: return cudaErrorInvalidValue;
  }
}

struct Fwd {
  const float *v, *q, *k;
  Weights w;
  const int32_t *src, *rel, *row_ptr;
  float *s, *out, *score;
  int32_t* carry_row;
  float* carry;
  int64_t n, edges;
  int H;
  Clip act;
  int64_t L, helpers;
  Launch l;
  cudaStream_t stream;

  template <int DK>
  cudaError_t run() const {
    hgt_plain_fwd_walk<DK><<<l.blocks, kThreads, l.smem, stream>>>(
        v, q, k, w, src, rel, row_ptr, s, out, score, carry_row, carry, n,
        edges, H, l.S, act, L, helpers, l.helper_blocks);
    return cudaGetLastError();
  }
};

struct BwdDst {
  const float *v, *q, *k;
  Weights w;
  const int32_t *src, *rel, *row_ptr, *run_ptr, *row_run, *run_slot;
  const float *score, *s, *out, *ct;
  const int32_t* inv;
  float *draw, *alpha, *score_rows, *draw_rows, *d_q, *run_q, *run_ct,
      *run_kd, *run_va;
  int32_t *carry_row, *carry_run;
  float* carry;
  int64_t n;
  int H;
  Clip act;
  int64_t L, helpers;
  Launch l;
  cudaStream_t stream;

  template <int DK>
  cudaError_t run() const {
    hgt_plain_bwd_dst_walk<DK><<<l.blocks, kThreads, l.smem, stream>>>(
        v, q, k, w, src, rel, row_ptr, run_ptr, row_run, run_slot, score, s,
        out, ct, inv, draw, alpha, score_rows, draw_rows, d_q, run_q, run_ct,
        run_kd, run_va, carry_row, carry_run, carry, n, H, l.S, act, L,
        helpers, l.helper_blocks);
    return cudaGetLastError();
  }
};

struct BwdSrc {
  const float *q, *ct;
  Weights w;
  const int32_t *dst, *rel, *row_ptr, *perm;
  const float *draw, *alpha;
  float *d_k, *d_v;
  int32_t* carry_row;
  float* carry;
  int64_t n;
  int H;
  int64_t L, helpers;
  Launch l;
  cudaStream_t stream;

  template <int DK>
  cudaError_t run() const {
    hgt_plain_bwd_src_walk<DK><<<l.blocks, kThreads, l.smem, stream>>>(
        q, ct, w, dst, rel, row_ptr, perm, draw, alpha, d_k, d_v, carry_row,
        carry, n, H, l.S, L, helpers, l.helper_blocks);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Pass 1.  v, k (src_space, H dk), q (n, H dk), w_att and w_msg (R, H, dk,
// dk), mu (R, H) f32 row-major, 16-byte aligned; src and rel (edges,)
// int32 of every canonical edge; row_ptr (n + 1,) int32 non-decreasing,
// within [0, edges]; s (n, H) and out (n, H dk) f32, written whole; score
// (edges, H) f32, written whole (0 outside the walked edges).  Rows
// longer than L edges are split over `helpers` helper tasks, which must
// cover every edge: helpers * L >= edges.  Scratch: carry_row (helpers,)
// int32, carry (helpers, H (1 + dk)) f32.  dk in {1, 2, 4, 8, 16}, H <=
// 32.  Launches the walk and its fix-up on `stream`; returns the first
// launch error (0 on success).
int het_hgt_plain_fwd(const float* v, const float* q, const float* k,
                      const float* w_att, const float* w_msg,
                      const float* mu, const int32_t* src,
                      const int32_t* rel, const int32_t* row_ptr, float* s,
                      float* out, float* score, int64_t n, int H, int dk,
                      int R, int64_t edges, int clipped, float clip,
                      int64_t L, int64_t helpers, int32_t* carry_row,
                      float* carry, void* stream) {
  if (bad_sizes(n, H, dk, R, L, helpers) || helpers * L < edges)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = launch_of(n, helpers, H, R, dk);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Fwd f{v,         q,     k,     weights_arg(w_att, w_msg, mu, R, l),
              src,       rel,   row_ptr, s, out, score, carry_row, carry,
              n,         edges, H,     clip_of(clipped, clip), L, helpers,
              l,         st};
  cudaError_t err = with_width(dk, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  hgt_plain_fwd_fixup<<<fixup_blocks(helpers * H), kThreads, 0, st>>>(
      carry_row, carry, s, out, H, dk, helpers);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  As pass 1, with score (edges, H), s (n, H), out and ct (n, H
// dk) f32 read; run_ptr (runs + 1,) int32 the first edge of each (dst,
// rel) run of canonical order, row_run (n + 1,) int32 each row's first
// run, run_slot (runs,) int32 each run's row in the run_* outputs; inv
// (edges,) int32 each edge's row of score_rows and draw_rows.  Written:
// draw and alpha (edges, H), and score_rows and draw_rows at inv, on the
// walked edges only, d_q (n, H dk) whole, run_q, run_ct, run_kd and
// run_va (runs, H dk) whole.
// Scratch: carry_row and carry_run (helpers,) int32, carry (helpers, 3 H
// dk) f32.
int het_hgt_plain_bwd_dst(
    const float* v, const float* q, const float* k, const float* w_att,
    const float* w_msg, const float* mu, const int32_t* src,
    const int32_t* rel, const int32_t* row_ptr, const int32_t* run_ptr,
    const int32_t* row_run, const int32_t* run_slot, const float* score,
    const float* s, const float* out, const float* ct, const int32_t* inv,
    float* draw, float* alpha, float* score_rows, float* draw_rows,
    float* d_q, float* run_q, float* run_ct, float* run_kd, float* run_va,
    int64_t n, int H, int dk, int R, int64_t edges,
    int clipped, float clip, int64_t L, int64_t helpers, int32_t* carry_row,
    int32_t* carry_run, float* carry, void* stream) {
  if (bad_sizes(n, H, dk, R, L, helpers) || helpers * L < edges)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = launch_of(n, helpers, H, R, dk);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdDst f{v,          q,         k,
                 weights_arg(w_att, w_msg, mu, R, l),
                 src,        rel,       row_ptr,    run_ptr, row_run,
                 run_slot,   score,     s,          out,     ct,
                 inv,        draw,      alpha,      score_rows,
                 draw_rows,  d_q,       run_q,      run_ct,  run_kd,
                 run_va,     carry_row, carry_run,  carry,   n,
                 H,          clip_of(clipped, clip), L,       helpers,
                 l,          st};
  cudaError_t err = with_width(dk, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t HD = static_cast<int64_t>(H) * dk;
  hgt_plain_bwd_dst_fixup<<<fixup_blocks(helpers * HD), kThreads, 0, st>>>(
      carry_row, carry_run, carry, run_slot, d_q, run_kd, run_va, HD,
      helpers);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3.  q and ct (N, H dk) f32, w_att, w_msg and mu as pass 1; dst and
// rel (EP,) int32 of every edge perm names; row_ptr (n + 1,) int32 over
// the sources, perm (EP,) int32 the edges in (source, relation) order;
// draw and alpha (EP, H) f32; d_k and d_v (n, H dk) f32, written whole.
// Split rows and scratch as pass 1, carry (helpers, 2 H dk) f32; `edges`
// bounds the walked positions of perm.
int het_hgt_plain_bwd_src(const float* q, const float* ct,
                          const float* w_att, const float* w_msg,
                          const float* mu, const int32_t* dst,
                          const int32_t* rel, const int32_t* row_ptr,
                          const int32_t* perm, const float* draw,
                          const float* alpha, float* d_k, float* d_v,
                          int64_t n, int H, int dk, int R, int64_t edges,
                          int64_t L, int64_t helpers, int32_t* carry_row,
                          float* carry, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (bad_sizes(n, H, dk, R, L, helpers) || helpers * L < edges)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = launch_of(n, helpers, H, R, dk);
  if (!l.ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdSrc f{q,     ct,      weights_arg(w_att, w_msg, mu, R, l),
                 dst,   rel,     row_ptr, perm, draw, alpha, d_k, d_v,
                 carry_row, carry, n, H, L, helpers, l, st};
  cudaError_t err = with_width(dk, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t HD = static_cast<int64_t>(H) * dk;
  hgt_plain_bwd_src_fixup<<<fixup_blocks(helpers * 2 * HD), kThreads, 0,
                            st>>>(carry_row, carry, d_k, d_v, HD, helpers);
  return static_cast<int>(cudaGetLastError());
}

const char* het_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
