// K1 on Hopper's tensor cores: the per-receiver sums of per-edge attention,
// f32 in 3xTF32, with the next edges' gathers in flight. The kernel body is
// edge_attention_tc.cuh (shared with K2's attention launch,
// edge_attention_layer_tc.cu); the design notes are there.
//
// Replaces the TPU forward kernels of ampnet_tpu/ops/pallas/
// edge_attention_fused.py _fused_kernel_vmem_v2 (:691, body
// _tile_attention_accumulate :379) and _fused_kernel_vmem_v4 (:942): per
// receiver, the SUM over live in-edges of the multi-head message
// softmax(Q K^T / sqrt(dh)) V (raw scaled scores with softmax=0). Beyond the
// instantiated range the wrapper routes to K1's CUDA-core body,
// ampnet_edge_attention_sums_simt in edge_attention.cu.

#include "edge_attention_tc.cuh"

extern "C" {

// K1. q: [num_nodes*sp] rows of d floats, row stride ldq; kv: rows of k|v
// (2d floats), row stride ldkv, kv and ldkv 16-byte aligned; out:
// [num_nodes*sp, d] contiguous. d / num_heads <= 32; S <= 48 with num_heads *
// ceil(S/16) <= 12 (8 up to S=24, the rule K4 needs), or 48 < S <= 64 with
// d / num_heads a multiple of 8 (one block per receiver and head).
int ampnet_edge_attention_sums(const float* q, int ldq, const float* kv, int ldkv,
                               const int* tile_senders, const int* tile_valid,
                               const int* recv_ptr, const int* recv_slots, float* out,
                               int num_nodes, int s, int sp, int d, int num_heads,
                               int softmax, void* stream) {
  return dispatch_sums_tc<false>(q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr,
                                 recv_slots, nullptr, nullptr, nullptr, out, num_nodes, s, sp,
                                 d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What a K1 launch over num_nodes receivers at (s, d, num_heads) would run
// with, without launching: info[0..6] = registers per thread, local memory
// bytes per thread (spills), blocks per SM, ring stages, grid, threads per
// block, dynamic shared memory bytes.
int ampnet_edge_attention_sums_info(int num_nodes, int s, int d, int num_heads, int* info) {
  return dispatch_sums_tc<false>(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, num_nodes, s, s, d,
                                 num_heads, 1, nullptr, info);
}

}  // extern "C"
