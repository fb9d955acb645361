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
//     the S=20 Cora shapes, 6.6 GFLOP, 0.10 ms at the 67 TFLOP/s f32 rate,
//     against 138 MB, 0.04 ms at 3.35 TB/s: bound by operations). A tiled
//     product on mma.sync m16n8k8: 64 x 64 output tiles of four warps, each
//     warp 32 x 32 (2 x 4 fragments), k-tiles of 16 floats double-buffered
//     in shared memory by 16-byte cp.async.cg (the next tile lands while the
//     current one multiplies). Row strides 20 (A) and 72 (B) floats keep both
//     fragment patterns free of bank conflicts. Each A fragment is split
//     into TF32 hi/lo once for four products, each B fragment once for two.
//     Rows past M read a valid row and are not stored; columns past K or N
//     are zero-filled (cp.async with source size 0).
// (b) ampnet_edge_attention_layer: K1's tensor-core walk over the projected
//     rows (edge_attention_tc.cuh, kLayer) with the 1/degree fold and the
//     out-projection epilogue.
//
// Beyond the tensor-core range the wrapper routes to K2's CUDA-core bodies
// (qkv_projection.cu, then ampnet_edge_attention_layer_simt in
// edge_attention.cu). K7 keeps calling qkv_projection.cu.

#include "edge_attention_tc.cuh"

namespace {

constexpr int kPM = 64, kPN = 64, kPK = 16;  // block tile and k-tile
constexpr int kPThreads = 128;               // 4 warps, 2 x 2, each 32 x 32
constexpr int kLdA = kPK + 4, kLdB = kPN + 8;

// c[m, n] = a[m, k] @ b[k, n] + bias[n]; lda, ldb, k and n multiples of 4,
// a and b 16-byte aligned (the wrapper checks it)
__global__ void __launch_bounds__(kPThreads)
projection_tc_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
                     const float* __restrict__ bias, float* __restrict__ c, int ldc, int m,
                     int n, int k) {
  __shared__ __align__(16) float as[2][kPM * kLdA];
  __shared__ __align__(16) float bs[2][kPK * kLdB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kPM, col0 = blockIdx.y * kPN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int ktiles = (k + kPK - 1) / kPK;

  auto load = [&](int buf, int k0) {
    for (int e = threadIdx.x; e < kPM * kPK / 4; e += kPThreads) {
      const int r = e / (kPK / 4), cc = 4 * (e % (kPK / 4));
      const bool in = k0 + cc < k;
      const int gr = min(row0 + r, m - 1);
      cp_async16_zfill(&as[buf][r * kLdA + cc], a + (size_t)gr * lda + (in ? k0 + cc : 0), in);
    }
    for (int e = threadIdx.x; e < kPK * kPN / 4; e += kPThreads) {
      const int r = e / (kPN / 4), cc = 4 * (e % (kPN / 4));
      const bool in = k0 + r < k && col0 + cc < n;
      cp_async16_zfill(&bs[buf][r * kLdB + cc],
                       b + (in ? (size_t)(k0 + r) * ldb + col0 + cc : 0), in);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load(0, 0);
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) {
      load((kt + 1) & 1, (kt + 1) * kPK);
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();  // tile kt has landed for every thread
    const float* A = as[kt & 1];
    const float* B = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kPK; kk += 8) {
      FragA fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a0 = A + (wm + 16 * i + g) * kLdA + kk + t;
        fa[i] = split_a(a0[0], a0[8 * kLdA], a0[4], a0[8 * kLdA + 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* b0 = B + (kk + t) * kLdB + wn + 8 * j + g;
        const FragB fb = split_b(b0[0], b0[4 * kLdB]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_3xtf32(acc[i][j], fa[i], fb);
      }
    }
    __syncthreads();  // every warp is done with tile kt before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + wn + 8 * j + 2 * t;  // even, and n is a multiple of 4
      if (col >= n) continue;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + 16 * i + g + 8 * h;
        if (row < m)
          *reinterpret_cast<float2*>(c + (size_t)row * ldc + col) =
              make_float2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
      }
    }
}

}  // namespace

extern "C" {

// (a) qkv = x @ w_qkv + b_qkv. x: [m, k] (row stride ldx), w_qkv: [k, n]
// contiguous, b_qkv: [n], qkv: [m, n] (row stride ldqkv, even). x, w_qkv
// 16-byte aligned, ldx, k and n multiples of 4.
int ampnet_edge_attention_layer_projection(const float* x, int ldx, const float* w_qkv,
                                           const float* b_qkv, float* qkv, int ldqkv, int m,
                                           int n, int k, void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((m + kPM - 1) / kPM, (n + kPN - 1) / kPN);
    projection_tc_kernel<<<grid, kPThreads, 0, (cudaStream_t)stream>>>(x, ldx, w_qkv, n, b_qkv,
                                                                       qkv, ldqkv, m, n, k);
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
