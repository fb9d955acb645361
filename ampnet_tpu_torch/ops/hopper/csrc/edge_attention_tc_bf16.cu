// K1's bf16 body on Hopper's tensor cores: the per-receiver sums of per-edge
// attention over bf16 q and k|v rows, or over f32 rows whose products are
// rounded to bf16 (mxu_bf16), in bf16 products with f32 sums. The kernel
// body is edge_attention_tc_bf16.cuh (shared with K2's bf16 attention
// launch, edge_attention_layer_tc_bf16.cu); the design notes are there.
//
// Replaces, in bf16, the TPU forward kernels of ampnet_tpu/ops/pallas/
// edge_attention_fused.py _fused_kernel_vmem_v2 (:691, body
// _tile_attention_accumulate :379) and _fused_kernel_vmem_v4 (:942). Its
// 3xTF32 body for f32 rows is edge_attention_tc.cu. Within the tensor cores'
// range only; beyond it the wrapper runs the CUDA-core bf16 body
// (edge_attention.cu).

#include "edge_attention_tc_bf16.cuh"

extern "C" {

// K1, bf16 rows. q: [num_nodes*sp] rows of d bf16, row stride ldq; kv: rows
// of k|v (2d bf16), row stride ldkv, kv and ldkv in whole 16-byte pieces;
// out: [num_nodes*sp, d] f32, contiguous. d / num_heads <= 32; S <= 48 with
// num_heads * ceil(S/16) <= 12 (8 up to S=24), or 48 < S <= 64 with d /
// num_heads a multiple of 8.
int ampnet_edge_attention_sums_bf16(const __nv_bfloat16* q, int ldq, const __nv_bfloat16* kv,
                                    int ldkv, const int* tile_senders, const int* tile_valid,
                                    const int* recv_ptr, const int* recv_slots, float* out,
                                    int num_nodes, int s, int sp, int d, int num_heads,
                                    int softmax, void* stream) {
  return dispatch_sums_bf16<false, __nv_bfloat16>(
      q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, nullptr, nullptr,
      nullptr, out, num_nodes, s, sp, d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// K1, f32 rows with the products' operands rounded to bf16 (mxu_bf16); the
// arguments of ampnet_edge_attention_sums (edge_attention_tc.cu).
int ampnet_edge_attention_sums_mxu(const float* q, int ldq, const float* kv, int ldkv,
                                   const int* tile_senders, const int* tile_valid,
                                   const int* recv_ptr, const int* recv_slots, float* out,
                                   int num_nodes, int s, int sp, int d, int num_heads,
                                   int softmax, void* stream) {
  return dispatch_sums_bf16<false, float>(
      q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, nullptr, nullptr,
      nullptr, out, num_nodes, s, sp, d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What a launch of either would run with, without launching (info as
// ampnet_edge_attention_sums_info in edge_attention_tc.cu).
int ampnet_edge_attention_sums_bf16_info(int num_nodes, int s, int d, int num_heads,
                                         int* info) {
  return dispatch_sums_bf16<false, __nv_bfloat16>(
      nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

int ampnet_edge_attention_sums_mxu_info(int num_nodes, int s, int d, int num_heads, int* info) {
  return dispatch_sums_bf16<false, float>(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, nullptr, nullptr, nullptr,
                                          num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
