// Row projection C = A @ B + bias on Hopper (sm_90a), f32 on the CUDA
// cores: the first launch of K2's CUDA-core route and the first and the
// last of K7's (edge_attention_layer, edge_attention_layer_mm beyond the
// tensor-core range, or on rows the 16-byte copies cannot take). Within it
// both project on the tensor cores (projection_tc.cuh, launched from
// edge_attention_layer_tc.cu).
//
// Replaces the in-kernel QKV projection of _fused_kernel_vmem_v6
// (ampnet_tpu/ops/pallas/edge_attention_fused.py:822-840). There, grid
// step 0 projects K|V for every node into VMEM scratch that persists
// across the sequential tile grid, and each tile projects its own Q. Thread
// blocks on 132 SMs run in no order and share no scratch, so the whole
// q|k|v projection runs first as its own launch into device memory and
// the attention launch reads it.
//
// Bound (H100 SXM): at the S=20 Cora shapes (M = 2816*24 rows, K = 128,
// N = 384) the product is 6.6 GFLOP (0.10 ms at 67 TFLOP/s f32) against
// 138 MB of traffic (0.04 ms at 3.35 TB/s): bound by operations. A plain
// shared-memory tiled product on the CUDA cores: 64 x 64 output tiles,
// 16-deep k steps, a 4 x 4 register block per thread.
//
// bf16 (the *_bf16 entry points, the CUDA-core route of a bf16 model's K2
// and K7 beyond the bf16 tensor cores' range): the same product over bf16
// x, w_qkv, b_qkv (K7: w_out, b_out), the tiles in f32, each operand
// converted as it is loaded; the sum (plus the bias) in f32, rounded once to
// bf16, as the bf16 tiled product of edge_attention_layer_tc_bf16.cu rounds.
// K7's mean, a row scale of the f32 sums, is rounded to bf16 before its
// product (v6_mm's bf16 mean).
//
// K7's last CUDA-core launch (ampnet_mean_out_projection) replaces the
// epilogue of _fused_kernel_vmem_v6_mm (:932-939, with inv_col of :920 and
// _mm_scatter_epilogue :1121-1122): the edge-group kernel leaves no block
// that owns a finished receiver (its sums meet in device memory through
// atomics), so the mean as a per-receiver row scale AFTER the reduce, the
// out-projection and the bias on live rows are this launch: the same tiled
// product with row r of A scaled by invdeg[r / sp], the bias added where
// invdeg > 0, and pad token rows (r % sp >= s) written as 0. A receiver of
// degree 0 has zero sums and invdeg 0 and comes out exactly 0.

#include <type_traits>

#include "common.cuh"
#include "rows_bf16.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

// kMean: the K7 epilogue (row scale, live-row bias, zero pad rows); A is
// then the f32 sums. T: the type of b, bias and c (and of A without kMean).
template <bool kMean, typename T>
__global__ void __launch_bounds__(kThreads)
projection_kernel(const std::conditional_t<kMean, float, T>* __restrict__ a, int lda,
                  const T* __restrict__ b,
                  const T* __restrict__ bias,
                  const float* __restrict__ row_scale, int sp, int s,
                  T* __restrict__ c, int ldc, int m, int n, int k) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  __shared__ float as[kBK][kBM + 4];  // A tile, transposed: as[kk][row]
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  float acc[kTM][kTN] = {};

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int l = tid; l < kBM * kBK; l += kThreads) {
      const int r = l / kBK, kk = l % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = (gr < m && gk < k) ? to_f32(a[(size_t)gr * lda + gk]) : 0.0f;
      if (kMean && gr < m) v *= row_scale[gr / sp];
      as[kk][r] = kMean && kBf16 ? round_bf16(v) : v;  // bf16: the mean rounded
    }
    for (int l = tid; l < kBK * kBN; l += kThreads) {
      const int kk = l / kBN, cc = l % kBN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? to_f32(b[(size_t)gk * n + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[kTM], rb[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ra[i] = as[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) rb[j] = bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= m) continue;
    const bool pad = kMean && gr % sp >= s;
    const bool live = !kMean || row_scale[gr / sp] > 0.0f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx * kTN + j;
      if (gc < n)
        c[(size_t)gr * ldc + gc] =
            from_f32<T>(pad ? 0.0f : live ? acc[i][j] + to_f32(bias[gc]) : acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

// a: [m, k] (row stride lda), b: [k, n] contiguous, bias: [n],
// c: [m, n] (row stride ldc).
int ampnet_qkv_projection(const float* a, int lda, const float* b,
                          const float* bias, float* c, int ldc, int m, int n,
                          int k, void* stream) {
  if (m > 0 && n > 0) {
    dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
    projection_kernel<false, float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        a, lda, b, bias, nullptr, 1, 1, c, ldc, m, n, k);
  }
  return (int)cudaGetLastError();
}

// The same over bf16 a, b and bias into bf16 c (f32 sums, rounded once).
int ampnet_qkv_projection_bf16(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b,
                               const __nv_bfloat16* bias, __nv_bfloat16* c, int ldc, int m,
                               int n, int k, void* stream) {
  if (m > 0 && n > 0) {
    dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
    projection_kernel<false, __nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        a, lda, b, bias, nullptr, 1, 1, c, ldc, m, n, k);
  }
  return (int)cudaGetLastError();
}

// c = (invdeg[row / sp] * sums) @ w_out (+ b_out on rows of a live receiver);
// rows with row % sp >= s are written as 0. sums: [m, k] (row stride lda),
// invdeg: [m / sp], w_out: [k, n] contiguous, b_out: [n], c: [m, n].
int ampnet_mean_out_projection(const float* sums, int lda, const float* invdeg,
                               const float* w_out, const float* b_out, float* c,
                               int ldc, int m, int n, int k, int sp, int s,
                               void* stream) {
  if (m > 0 && n > 0) {
    dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
    projection_kernel<true, float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        sums, lda, w_out, b_out, invdeg, sp, s, c, ldc, m, n, k);
  }
  return (int)cudaGetLastError();
}

// K7's last launch in bf16: f32 sums, bf16 w_out and b_out, bf16 c; the
// mean rounded to bf16, the f32 sum plus the bias on live rows rounded once.
int ampnet_mean_out_projection_bf16(const float* sums, int lda, const float* invdeg,
                                    const __nv_bfloat16* w_out, const __nv_bfloat16* b_out,
                                    __nv_bfloat16* c, int ldc, int m, int n, int k, int sp,
                                    int s, void* stream) {
  if (m > 0 && n > 0) {
    dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
    projection_kernel<true, __nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        sums, lda, w_out, b_out, invdeg, sp, s, c, ldc, m, n, k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
