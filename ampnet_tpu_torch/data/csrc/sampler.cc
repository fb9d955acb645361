// Native GraphSAINT sampling core (the port's copy of the JAX package's
// ampnet_tpu/data/csrc/sampler.cc, the same three entry points and the same
// random streams, so that one seed gives one subgraph stream in both).
//
// The pointer-chasing parts of GraphSAINT sampling stay on the host: uniform
// random walks over CSR, induced-subgraph extraction, and the normalization
// statistics pre-pass. The device only ever sees static-shape padded arrays.
//
// Exposed as a plain C ABI consumed via ctypes
// (ampnet_tpu_torch/data/native.py), which builds it with g++ at first use.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// Uniform random walks over CSR adjacency.
//   indptr  [n+1], indices [nnz]  — CSR over senders
//   starts  [num_walks]           — start nodes
//   out     [num_walks * (walk_length+1)]
// Nodes without out-edges stay put (torch_sparse random_walk semantics).
void ampnet_random_walk(
    const int64_t* indptr, const int32_t* indices, int64_t n,
    const int64_t* starts, int64_t num_walks, int64_t walk_length,
    uint64_t seed, int64_t* out) {
  std::mt19937_64 rng(seed);
  for (int64_t w = 0; w < num_walks; ++w) {
    int64_t cur = starts[w];
    int64_t* row = out + w * (walk_length + 1);
    row[0] = cur;
    for (int64_t t = 1; t <= walk_length; ++t) {
      int64_t lo = indptr[cur], hi = indptr[cur + 1];
      if (hi > lo) {
        cur = indices[lo + (int64_t)(rng() % (uint64_t)(hi - lo))];
      }
      row[t] = cur;
    }
  }
}

// Induced subgraph: given a sorted unique node set, emit the original edge
// ids whose endpoints are both in the set.
//   node_set [k] sorted unique node ids
//   in_set_scratch [n] caller-provided zeroed byte scratch (reused)
//   edge CSR over senders: src_indptr [n+1], dst_sorted [nnz] (receivers in
//   sender order), edge_ids [nnz] (original edge id per CSR slot)
// Returns the count of emitted edges (written to out_edge_ids).
int64_t ampnet_induced_edges(
    const int64_t* node_set, int64_t k,
    uint8_t* in_set_scratch, int64_t n,
    const int64_t* src_indptr, const int32_t* dst_sorted,
    const int64_t* edge_ids,
    int64_t* out_edge_ids, int64_t out_cap) {
  for (int64_t i = 0; i < k; ++i) in_set_scratch[node_set[i]] = 1;
  int64_t cnt = 0;
  for (int64_t i = 0; i < k && cnt < out_cap; ++i) {
    int64_t v = node_set[i];
    for (int64_t e = src_indptr[v]; e < src_indptr[v + 1]; ++e) {
      if (in_set_scratch[dst_sorted[e]]) {
        if (cnt < out_cap) out_edge_ids[cnt++] = edge_ids[e];
      }
    }
  }
  for (int64_t i = 0; i < k; ++i) in_set_scratch[node_set[i]] = 0;
  return cnt;
}

// GraphSAINT normalization pre-pass: repeatedly sample random-walk
// subgraphs, counting node and edge occurrences until
// total_sampled_nodes >= n * coverage. Returns the number of subgraphs
// sampled ("num_samples" in the reference's norm formula,
// visualize_graphsaint_subgraphs.py:137-173).
//
// DETERMINISTIC parallel design: each sample index k draws from its own
// RNG stream seeded by (seed, k), and threads process chunks of
// consecutive k with a barrier (join) between chunks — the stop decision
// only looks at COMPLETED chunks, so the set of processed samples (and
// therefore every count) is a pure function of (graph, seed), not of
// scheduler timing. (The original design let each thread run free until
// a shared atomic crossed the target: the per-thread round counts —
// and so the norms — varied run-to-run under a fixed seed, and the
// target was only consulted once per num_steps round per thread,
// overshooting by up to threads*num_steps samples.) num_steps is kept
// in the ABI but no longer sets the check granularity.
int64_t ampnet_norm_prepass(
    const int64_t* indptr, const int32_t* indices, int64_t n,
    const int64_t* src_indptr, const int32_t* dst_sorted,
    const int64_t* edge_ids, int64_t nnz,
    int64_t batch_size, int64_t walk_length, int64_t coverage,
    int64_t num_steps, uint64_t seed, int64_t num_threads,
    double* node_count, double* edge_count) {
  (void)num_steps;
  if (num_threads <= 0) num_threads = 1;
  const int64_t target = n * coverage;
  const int64_t kSamplesPerThread = 4;  // per chunk: amortizes spawns,
  // bounds deterministic overshoot at threads*4 samples

  std::vector<std::vector<double>> ncs(num_threads), ecs(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    ncs[t].assign(n, 0.0);
    ecs[t].assign(nnz, 0.0);
  }

  int64_t total_sampled = 0, num_samples = 0, chunk = 0;
  while (total_sampled < target) {
    std::vector<int64_t> chunk_nodes(num_threads, 0);
    auto worker = [&](int t) {
      std::vector<int64_t> starts(batch_size),
          walks(batch_size * (walk_length + 1));
      std::vector<uint8_t> scratch(n, 0);
      std::vector<int64_t> nodes;
      double* nc = ncs[t].data();
      double* ec = ecs[t].data();
      for (int64_t i = 0; i < kSamplesPerThread; ++i) {
        const int64_t k =
            (chunk * num_threads + t) * kSamplesPerThread + i;
        std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (uint64_t)(k + 1));
        for (int64_t b = 0; b < batch_size; ++b)
          starts[b] = (int64_t)(rng() % (uint64_t)n);
        ampnet_random_walk(indptr, indices, n, starts.data(), batch_size,
                           walk_length, rng(), walks.data());
        nodes.assign(walks.begin(), walks.end());
        std::sort(nodes.begin(), nodes.end());
        nodes.erase(std::unique(nodes.begin(), nodes.end()), nodes.end());
        for (int64_t v : nodes) nc[v] += 1.0;
        for (int64_t v : nodes) scratch[v] = 1;
        for (int64_t v : nodes)
          for (int64_t e = src_indptr[v]; e < src_indptr[v + 1]; ++e)
            if (scratch[dst_sorted[e]]) ec[edge_ids[e]] += 1.0;
        for (int64_t v : nodes) scratch[v] = 0;
        chunk_nodes[t] += (int64_t)nodes.size();
      }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
    for (int t = 0; t < num_threads; ++t) total_sampled += chunk_nodes[t];
    num_samples += num_threads * kSamplesPerThread;
    ++chunk;
  }

  // sequential merge in fixed thread order (counts are integer-valued
  // doubles, so this is exact regardless)
  for (int t = 0; t < num_threads; ++t) {
    for (int64_t i = 0; i < n; ++i) node_count[i] += ncs[t][i];
    for (int64_t i = 0; i < nnz; ++i) edge_count[i] += ecs[t][i];
  }
  return num_samples;
}

}  // extern "C"
