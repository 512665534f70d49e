// Host graph operations of het_tpu_torch: the canonical (dst, rel, src)
// edge sort, the counting argsort, degree counting, unique (relation,
// node) pairs, the degree sort and the fanout neighbour sampler.
//
// The port's copy of het_tpu's native library (native/graphops.cpp): the
// same entry points computing the same results, so that both packages
// build the same graphs and draw the same minibatches from one seed.
// Built with g++ at first use (het_tpu_torch/ops/kernels/_build.py) and
// bound through ctypes (het_tpu_torch/graph/native.py).  A plain C
// interface; every array is int64 and allocated by the caller.  Keys are
// not range-checked here: the Python wrappers check them first.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Stable counting sort of the indices 0..n-1 (or of order_in, when given)
// by key; writes the permutation.  keys must lie in [0, num_keys).
void hetg_counting_sort(const int64_t* keys, int64_t n, int64_t num_keys,
                        const int64_t* order_in, int64_t* order_out) {
  std::vector<int64_t> counts(static_cast<size_t>(num_keys) + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    counts[keys[order_in ? order_in[i] : i] + 1]++;
  for (int64_t k = 0; k < num_keys; ++k) counts[k + 1] += counts[k];
  for (int64_t i = 0; i < n; ++i) {
    int64_t e = order_in ? order_in[i] : i;
    order_out[counts[keys[e]]++] = e;
  }
}

// Canonical edge order: stable sort by (dst, rel, src) in three LSD
// counting passes.  order_out receives canonical position -> edge index.
void hetg_canonical_sort(const int64_t* src, const int64_t* dst,
                         const int64_t* rel, int64_t n, int64_t num_nodes,
                         int64_t num_rels, int64_t* order_out) {
  std::vector<int64_t> tmp1(n), tmp2(n);
  hetg_counting_sort(src, n, num_nodes + 1, nullptr, tmp1.data());
  hetg_counting_sort(rel, n, num_rels, tmp1.data(), tmp2.data());
  hetg_counting_sort(dst, n, num_nodes + 1, tmp2.data(), order_out);
}

// Degree histogram: counts[v] = occurrences of v in ids.
void hetg_bincount(const int64_t* ids, int64_t n, int64_t num_bins,
                   int64_t* counts) {
  std::memset(counts, 0, sizeof(int64_t) * num_bins);
  for (int64_t i = 0; i < n; ++i) counts[ids[i]]++;
}

// Unique (rel, node) pairs, sorted by (rel, node), and the inverse map of
// each input pair into them.  uniq_rel / uniq_node hold >= n entries,
// inverse n.  Returns the number of unique pairs.
int64_t hetg_unique_pairs(const int64_t* rel, const int64_t* node, int64_t n,
                          int64_t num_nodes, int64_t num_rels,
                          int64_t* uniq_rel, int64_t* uniq_node,
                          int64_t* inverse) {
  std::vector<int64_t> tmp(n), order(n);
  hetg_counting_sort(node, n, num_nodes + 1, nullptr, tmp.data());
  hetg_counting_sort(rel, n, num_rels, tmp.data(), order.data());
  int64_t nu = 0;
  int64_t prev_r = -1, prev_v = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t e = order[i];
    if (rel[e] != prev_r || node[e] != prev_v) {
      prev_r = rel[e];
      prev_v = node[e];
      uniq_rel[nu] = prev_r;
      uniq_node[nu] = prev_v;
      nu++;
    }
    inverse[e] = nu - 1;
  }
  return nu;
}

// Node ids by descending degree, ties in id order (a stable sort).
void hetg_degree_sort(const int64_t* deg, int64_t num_nodes,
                      int64_t* node_order) {
  std::vector<int64_t> idx(num_nodes);
  for (int64_t i = 0; i < num_nodes; ++i) idx[i] = i;
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    return deg[a] > deg[b];
  });
  std::memcpy(node_order, idx.data(), sizeof(int64_t) * num_nodes);
}

// Uniform fanout sampling of in-neighbourhoods.
//
// ptr / nbr_src / nbr_rel: the in-CSR over destinations (ptr holds
// num_nodes + 1 entries).  The seeds take local ids [0, n_seeds), a
// repeated seed its first one; nodes found later take the next ids in
// order of discovery, hop by hop.  A frontier node takes all its
// in-edges when its in-degree is at most fanout, else fanout distinct
// ones drawn by Floyd's algorithm from std::mt19937_64(rng_seed) (the
// same stream as het_tpu's sampler, so one seed draws one batch in both
// packages).  edges_* hold >= max_edges entries and node_map >=
// max_nodes; a hop stops at the first node whose edges would pass
// max_edges, and past max_nodes a new node is dropped with its edge.
//
// local: node -> local id, num_nodes entries, all -1 on entry; the entries
// this call sets are reset to -1 before it returns, so one buffer serves
// every draw.  Returns the edge count; *n_nodes_out receives the node
// count.
int64_t hetg_sample_fanout(const int64_t* ptr, const int64_t* nbr_src,
                           const int64_t* nbr_rel, const int64_t* seeds,
                           int64_t n_seeds, int64_t fanout, int64_t num_hops,
                           uint64_t rng_seed, int64_t max_edges,
                           int64_t max_nodes, int64_t* local,
                           int64_t* edges_s, int64_t* edges_d,
                           int64_t* edges_r, int64_t* node_map,
                           int64_t* n_nodes_out) {
  std::vector<int64_t> frontier, next;
  std::mt19937_64 rng(rng_seed);
  int64_t n_nodes = 0, n_edges = 0;
  for (int64_t i = 0; i < n_seeds && n_nodes < max_nodes; ++i) {
    int64_t s = seeds[i];
    if (local[s] < 0) {
      local[s] = n_nodes;
      node_map[n_nodes++] = s;
      frontier.push_back(s);
    }
  }
  std::vector<int64_t> picks;
  for (int64_t hop = 0; hop < num_hops; ++hop) {
    next.clear();
    for (int64_t v : frontier) {
      int64_t lo = ptr[v], hi = ptr[v + 1], deg = hi - lo;
      if (deg == 0) continue;
      picks.clear();
      if (deg <= fanout) {
        for (int64_t t = lo; t < hi; ++t) picks.push_back(t);
      } else {
        // Floyd's algorithm: fanout distinct draws from [lo, hi)
        for (int64_t j = deg - fanout; j < deg; ++j) {
          int64_t t = lo + static_cast<int64_t>(rng() % (uint64_t)(j + 1));
          if (std::find(picks.begin(), picks.end(), t) != picks.end())
            t = lo + j;
          picks.push_back(t);
        }
      }
      if (n_edges + static_cast<int64_t>(picks.size()) > max_edges) break;
      for (int64_t t : picks) {
        int64_t u = nbr_src[t];
        if (local[u] < 0) {
          if (n_nodes >= max_nodes) continue;
          local[u] = n_nodes;
          node_map[n_nodes++] = u;
          next.push_back(u);
        }
        edges_s[n_edges] = local[u];
        edges_d[n_edges] = local[v];
        edges_r[n_edges] = nbr_rel[t];
        n_edges++;
      }
    }
    frontier.swap(next);
    if (frontier.empty()) break;
  }
  for (int64_t i = 0; i < n_nodes; ++i) local[node_map[i]] = -1;
  *n_nodes_out = n_nodes;
  return n_edges;
}

int64_t hetg_version() { return 3; }

}  // extern "C"
