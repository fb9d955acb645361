// The row projection C = A @ B + bias on Hopper's tensor cores, f32 in
// 3xTF32 (mma_tf32.cuh): one copy of the tiled product that K2's projection
// launch (edge_attention_layer_tc.cu) and K7's first and last launches
// (edge_attention_layer_mm, the same file) run.
//
// Replaces the QKV projection of the TPU kernels _fused_kernel_vmem_v6
// (ampnet_tpu/ops/pallas/edge_attention_fused.py:822-840) and
// _fused_kernel_vmem_v6_mm (:865), and the latter's epilogue (:932-939, with
// inv_col of :920): the mean as a per-receiver row scale of the summed
// messages, then the out-projection and b_out on live rows.
//
// Bound (H100 SXM), at the S=20 Cora shapes: the q|k|v projection (M =
// NT*SP = 67,584 rows, K = D = 128, N = 3D) is 6.6 GFLOP, 0.04 ms at the
// tensor cores' 495 TFLOP/s for three TF32 products each, against 138 MB,
// 0.04 ms at 3.35 TB/s; the out-projection (N = D) a third of both. The
// tile:
//
// * 64 x 64 output tiles of four warps, each warp 32 x 32 (2 x 4 fragments
//   of mma.sync m16n8k8), k-tiles of 16 floats double-buffered in shared
//   memory by 16-byte cp.async.cg: the next tile lands while the current
//   one multiplies. Row strides 20 (A) and 72 (B) floats keep both fragment
//   patterns free of bank conflicts. Each A fragment is split into TF32
//   hi/lo once for four products, each B fragment once for two.
// * Rows past M read a valid row and are not stored; columns past K or N
//   are zero-filled (cp.async with source size 0).
// * kMean, K7's epilogue: row r of A is scaled by row_scale[r / sp] (the
//   receiver's 1/degree) as its fragment is built, before the split: the
//   mean is formed before the out-product, as the TPU kernel forms it;
//   the bias is added only where row_scale > 0; rows with r % sp >= s (pad
//   token rows) are written as 0. A receiver of degree 0 (zero sums, scale
//   0) comes out exactly 0.
//
// Needs lda, ldb, K and N multiples of 4, A and B 16-byte aligned, ldc
// even and C 8-byte aligned (projection_tc_error; the wrappers check it).
#pragma once

#include "mma_tf32.cuh"

namespace {

constexpr int kPM = 64, kPN = 64, kPK = 16;  // block tile and k-tile
constexpr int kPThreads = 128;               // 4 warps, 2 x 2, each 32 x 32
constexpr int kLdA = kPK + 4, kLdB = kPN + 8;

// cudaErrorInvalidValue where the tile's 16-byte copies and 8-byte stores
// cannot take the operands, else 0
inline int projection_tc_error(const float* a, int lda, const float* b, int ldb,
                               const float* c, int ldc, int n, int k) {
  const bool ok = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 && lda % 4 == 0 &&
                  ldb % 4 == 0 && k % 4 == 0 && n % 4 == 0 && (uintptr_t)c % 8 == 0 &&
                  ldc % 2 == 0;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// One block's 64 x 64 tile of c[m, n] = a[m, k] @ b[k, n] + bias[n] (kMean:
// the K7 epilogue above, row_scale [m / sp])
template <bool kMean>
__device__ __forceinline__ void projection_tc_tile(
    const float* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
    const float* __restrict__ bias, const float* __restrict__ row_scale, int sp, int s,
    float* __restrict__ c, int ldc, int m, int n, int k) {
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

  // kMean: the scale of the lane's four A rows (wm + 16i + g + 8h)
  float rs[2][2];
  if (kMean) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rs[i][h] = row_scale[min(row0 + wm + 16 * i + g + 8 * h, m - 1) / sp];
  }

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
        if (kMean)
          fa[i] = split_a(a0[0] * rs[i][0], a0[8 * kLdA] * rs[i][1], a0[4] * rs[i][0],
                          a0[8 * kLdA + 4] * rs[i][1]);
        else
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
        if (row < m) {
          float2 v = make_float2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
          if (kMean) {
            if (row % sp >= s) v = make_float2(0.0f, 0.0f);
            else if (!(rs[i][h] > 0.0f)) v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
          *reinterpret_cast<float2*>(c + (size_t)row * ldc + col) = v;
        }
      }
    }
}

}  // namespace
