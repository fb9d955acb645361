// K2 on Hopper's tensor cores: the whole AMPConv layer for a forward that
// keeps nothing, in two launches, f32 in 3xTF32 (mma_tf32.cuh).
//
// Replaces the TPU kernel ampnet_tpu/ops/pallas/edge_attention_fused.py
// _fused_kernel_vmem_v6 (:763): the QKV projection (its :822-840), the
// per-receiver mean of per-edge attention (each edge pre-scaled by 1/degree),
// the out-projection and b_out on live rows. There the projection runs
// inside the kernel into VMEM scratch that persists across the sequential
// tile grid; thread blocks on 132 SMs share no scratch, so:
//
// (a) ampnet_edge_attention_layer_projection: qkv = x @ w_qkv + b_qkv into
//     device memory (M = NT*SP rows, K = D, N = 3D: 67,584 x 128 x 384 at
//     the S=20 Cora shapes), the tiled 3xTF32 product of projection_tc.cuh.
// (b) ampnet_edge_attention_layer: K1's tensor-core walk over the projected
//     rows (edge_attention_tc.cuh, kLayer) with the 1/degree fold and the
//     out-projection epilogue.
//
// K7 (edge_attention_layer_mm, the TPU kernel _fused_kernel_vmem_v6_mm,
// :865) runs the same projection launch (a) on the tensor cores, and its
// last launch here too: ampnet_edge_attention_layer_mm_out_projection, the
// same tiled product with the mean as a row scale, b_out on live rows and
// zero pad rows (projection_tc.cuh, kMean).
//
// Beyond the tensor-core range the wrappers route to the CUDA-core bodies
// (qkv_projection.cu, then ampnet_edge_attention_layer_simt in
// edge_attention.cu for K2, K6's CUDA-core body for K7).

#include "edge_attention_tc.cuh"
#include "projection_tc.cuh"

namespace {

// c[m, n] = a[m, k] @ b[k, n] + bias[n]; lda, ldb, k and n multiples of 4,
// a and b 16-byte aligned (the wrapper checks it)
__global__ void __launch_bounds__(kPThreads)
projection_tc_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
                     const float* __restrict__ bias, float* __restrict__ c, int ldc, int m,
                     int n, int k) {
  projection_tc_tile<false>(a, lda, b, ldb, bias, nullptr, 1, 1, c, ldc, m, n, k);
}

// K7's last launch: c = (row_scale[r / sp] * a) @ b, + bias on live rows,
// pad token rows 0
__global__ void __launch_bounds__(kPThreads)
mean_out_tc_kernel(const float* __restrict__ a, int lda, const float* __restrict__ row_scale,
                   const float* __restrict__ b, const float* __restrict__ bias,
                   float* __restrict__ c, int ldc, int m, int n, int k, int sp, int s) {
  projection_tc_tile<true>(a, lda, b, n, bias, row_scale, sp, s, c, ldc, m, n, k);
}

}  // namespace

extern "C" {

// (a) qkv = x @ w_qkv + b_qkv. x: [m, k] (row stride ldx), w_qkv: [k, n]
// contiguous, b_qkv: [n], qkv: [m, n] (row stride ldqkv, even). x, w_qkv
// 16-byte aligned, ldx, k and n multiples of 4.
int ampnet_edge_attention_layer_projection(const float* x, int ldx, const float* w_qkv,
                                           const float* b_qkv, float* qkv, int ldqkv, int m,
                                           int n, int k, void* stream) {
  if (const int err = projection_tc_error(x, ldx, w_qkv, n, qkv, ldqkv, n, k)) return err;
  if (m > 0 && n > 0) {
    const dim3 grid((m + kPM - 1) / kPM, (n + kPN - 1) / kPN);
    projection_tc_kernel<<<grid, kPThreads, 0, (cudaStream_t)stream>>>(x, ldx, w_qkv, n, b_qkv,
                                                                       qkv, ldqkv, m, n, k);
  }
  return (int)cudaGetLastError();
}

// K7's last launch: c = (invdeg[row / sp] * sums) @ w_out (+ b_out on rows
// of a live receiver); rows with row % sp >= s are written as 0. sums: [m,
// k] (row stride lda), invdeg: [m / sp], w_out: [k, n] contiguous, b_out:
// [n], c: [m, n] (row stride ldc); the alignment of (a).
int ampnet_edge_attention_layer_mm_out_projection(const float* sums, int lda,
                                                  const float* invdeg, const float* w_out,
                                                  const float* b_out, float* c, int ldc, int m,
                                                  int n, int k, int sp, int s, void* stream) {
  if (const int err = projection_tc_error(sums, lda, w_out, n, c, ldc, n, k)) return err;
  if (m > 0 && n > 0) {
    const dim3 grid((m + kPM - 1) / kPM, (n + kPN - 1) / kPN);
    mean_out_tc_kernel<<<grid, kPThreads, 0, (cudaStream_t)stream>>>(sums, lda, invdeg, w_out,
                                                                     b_out, c, ldc, m, n, k,
                                                                     sp, s);
  }
  return (int)cudaGetLastError();
}

// (b) the attention launch over projected rows (q|k|v packed per row, row
// stride ldqkv, 16-byte aligned with d a multiple of 4): invdeg
// [num_nodes], w_out [d, d] (in, out), b_out [d]; out: [num_nodes*sp, d].
// The range of K1.
int ampnet_edge_attention_layer(const float* qkv, int ldqkv, const int* tile_senders,
                                const int* tile_valid, const int* recv_ptr,
                                const int* recv_slots, const float* invdeg, const float* w_out,
                                const float* b_out, float* out, int num_nodes, int s, int sp,
                                int d, int num_heads, int softmax, void* stream) {
  return dispatch_sums_tc<true>(qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid, recv_ptr,
                                recv_slots, invdeg, w_out, b_out, out, num_nodes, s, sp, d,
                                num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What an attention launch of K2 would run with (info as
// ampnet_edge_attention_sums_info).
int ampnet_edge_attention_layer_info(int num_nodes, int s, int d, int num_heads, int* info) {
  return dispatch_sums_tc<true>(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, num_nodes, s, s, d,
                                num_heads, 1, nullptr, info);
}

// (b) with w_out staged in shared memory once per block instead of read
// from L2 (the same result bit for bit); chip_smoke.py times the two.
int ampnet_edge_attention_layer_staged_w(const float* qkv, int ldqkv, const int* tile_senders,
                                         const int* tile_valid, const int* recv_ptr,
                                         const int* recv_slots, const float* invdeg,
                                         const float* w_out, const float* b_out, float* out,
                                         int num_nodes, int s, int sp, int d, int num_heads,
                                         int softmax, void* stream) {
  return dispatch_sums_tc<true, true>(qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid,
                                      recv_ptr, recv_slots, invdeg, w_out, b_out, out,
                                      num_nodes, s, sp, d, num_heads, softmax,
                                      (cudaStream_t)stream, nullptr);
}

int ampnet_edge_attention_layer_staged_w_info(int num_nodes, int s, int d, int num_heads,
                                              int* info) {
  return dispatch_sums_tc<true, true>(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, nullptr, num_nodes, s,
                                      s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
