// The walk of K8's tensor-core bodies over the receiver-chunked layout
// (format.py::build_chunked_csr): the live slots of a block's receivers in
// order, shared by the 3xTF32 body (edge_attention_chunked_tc.cu) and the
// bf16 one (edge_attention_chunked_tc_bf16.cu). The producer of a block's
// ring of gathered rows and its consumer each keep one.
#pragma once

#include <cuda_runtime.h>

namespace {

// The live slots of the receivers first, first + gridDim.x, ... in order:
// receiver n's slots are chunk_start[n] * chunk .. (chunk_start[n] +
// chunk_count[n]) * chunk - 1, a slot with validity 0 skipped. Every thread
// of a block keeps the same cursor.
struct ChunkWalk {
  int node, k, end;

  __device__ void start(const int* cstart, const int* ccount, int chunk, int first,
                        int num_nodes) {
    node = first;
    k = first < num_nodes ? cstart[first] * chunk : 0;
    end = first < num_nodes ? k + ccount[first] * chunk : 0;
  }

  // the next live slot, or -1 past the last receiver
  __device__ int next(const int* cstart, const int* ccount, const int* valid, int chunk,
                      int num_nodes) {
    for (;;) {
      while (k >= end) {
        node += gridDim.x;
        if (node >= num_nodes) return -1;
        k = cstart[node] * chunk;
        end = k + ccount[node] * chunk;
      }
      const int slot = k++;
      if (valid[slot] != 0) return slot;
    }
  }
};

}  // namespace
