// K2's bf16 body on Hopper's tensor cores: the whole AMPConv layer for a
// forward that keeps nothing, in two launches, in bf16 products with f32
// sums (mma.sync m16n8k16, mma_bf16.cuh); and K2's attention launch for f32
// rows under mxu_bf16.
//
// Replaces, in bf16, the TPU kernel ampnet_tpu/ops/pallas/
// edge_attention_fused.py _fused_kernel_vmem_v6 (:763), rounding where it
// rounds:
//
// (a) ampnet_edge_attention_layer_projection_bf16: qkv = x @ w_qkv + b_qkv
//     over bf16 x and w_qkv, summed in f32, the bias added in f32 and the
//     sum rounded once to bf16 (its kvscr / qscr stores, :822-840). 64 x 64
//     output tiles of four warps, each warp 32 x 32 (2 x 4 fragments of
//     m16n8k16), k-tiles of 32 values double-buffered in shared memory by
//     16-byte cp.async.cg; A's fragments are 32-bit loads of bf16 pairs (row
//     stride 40 values), B's two 16-bit loads each (row stride 72). At the
//     S=20 Cora shapes (M = 67,584 rows of SP = 32, K = 128, N = 384) 6.6
//     GFLOP, 6.7 us at 989 TFLOP/s, against 69 MB of bf16, 21 us at 3.35
//     TB/s: bound by bytes.
// (b) ampnet_edge_attention_layer_bf16: K1's bf16 walk over the projected
//     rows (edge_attention_tc_bf16.cuh, kLayer) with the 1/degree fold, the
//     mean rounded to bf16, the out-projection in bf16 products, the result
//     rounded to bf16 and b_out added in bf16 on live rows (:851-860).
// (b') ampnet_edge_attention_layer_mxu: the same walk over f32 rows with
//     the attention's operands rounded to bf16; the projection (launch (a)
//     of edge_attention_layer_tc.cu) and the out-projection stay 3xTF32, as
//     the TPU kernel's mxu_bf16 reaches its attention body only.
//
// (c) ampnet_edge_attention_layer_mm_out_projection_bf16: K7's last launch
//     in bf16 (_fused_kernel_vmem_v6_mm, :865, epilogue :920-939), the
//     tiled product of (a) with the f32 sums as A: the mean as a row scale
//     in f32, rounded to bf16 as A's fragment is built, mean @ w_out in bf16
//     products, b_out added in f32 on live rows and the sum rounded once to
//     bf16, pad rows 0. K7's first launch on bf16 rows is (a), its attention
//     K6's bf16 body (edge_attention_groups_tc_bf16.cu).
//
// Within the tensor cores' range only; beyond it the wrappers run the
// CUDA-core bf16 launches (qkv_projection.cu, edge_attention.cu,
// edge_attention_groups.cu).

#include "edge_attention_tc_bf16.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;  // block tile and k-tile
constexpr int kBThreads = 128;               // 4 warps, 2 x 2, each 32 x 32
constexpr int kBLdA = kBK + 8, kBLdB = kBN + 8;

// cudaErrorInvalidValue where the tile's 16-byte copies and 4-byte stores
// cannot take the operands, else 0 (A of bf16 or, for K7's epilogue, of f32
// values: lda in whole 16-byte pieces either way)
template <typename TA>
inline int projection_bf16_error(const TA* a, int lda, const __nv_bfloat16* b, int ldb,
                                 const __nv_bfloat16* c, int ldc, int n, int k) {
  const bool ok = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                  lda % (16 / (int)sizeof(TA)) == 0 && ldb % 8 == 0 && k % 8 == 0 &&
                  n % 8 == 0 && (uintptr_t)c % 4 == 0 && ldc % 2 == 0;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// kMean: K7's epilogue reads the f32 per-receiver sums as A; else A is bf16
template <bool kMean>
using ProjA = std::conditional_t<kMean, float, __nv_bfloat16>;

// One block's 64 x 64 tile of c[m, n] = bf16(a[m, k] @ b[k, n] + bias[n]),
// the sum in f32. kMean, K7's epilogue (_fused_kernel_vmem_v6_mm :920-939):
// A is the f32 sums, row r scaled by row_scale[r / sp] (the receiver's
// 1/degree) in f32 and rounded to bf16 as its fragment is built (the mean in
// x's type, then mean @ w_out); the bias is added in f32 only where
// row_scale > 0, and the f32 sum rounds once to bf16 (v6_mm's out + b_out *
// live, then its astype); rows with r % sp >= s (pad token rows) are written
// as 0. The f32 A tile (row stride 40 floats) is read as float2 pairs free of
// bank conflicts within each half-warp.
template <bool kMean>
__device__ __forceinline__ void projection_bf16_tile(
    const ProjA<kMean>* __restrict__ a, int lda, const __nv_bfloat16* __restrict__ b, int ldb,
    const __nv_bfloat16* __restrict__ bias, const float* __restrict__ row_scale, int sp, int s,
    __nv_bfloat16* __restrict__ c, int ldc, int m, int n, int k) {
  using TA = ProjA<kMean>;
  constexpr int kPer = 16 / sizeof(TA);  // values of A per 16-byte copy
  __shared__ __align__(16) TA as[2][kBM * kBLdA];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kBK * kBLdB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int ktiles = (k + kBK - 1) / kBK;

  auto load = [&](int buf, int k0) {
    for (int e = threadIdx.x; e < kBM * kBK / kPer; e += kBThreads) {
      const int r = e / (kBK / kPer), cc = kPer * (e % (kBK / kPer));
      const bool in = k0 + cc < k;
      const int gr = min(row0 + r, m - 1);
      cp_async16_zfill(&as[buf][r * kBLdA + cc], a + (size_t)gr * lda + (in ? k0 + cc : 0), in);
    }
    for (int e = threadIdx.x; e < kBK * kBN / 8; e += kBThreads) {
      const int r = e / (kBN / 8), cc = 8 * (e % (kBN / 8));
      const bool in = k0 + r < k && col0 + cc < n;
      cp_async16_zfill(&bs[buf][r * kBLdB + cc],
                       b + (in ? (size_t)(k0 + r) * ldb + col0 + cc : 0), in);
    }
    cp_async_commit();
  };

  // kMean: the scale of the lane's four A rows (wm + 16i + g + 8h)
  float rs[2][2];
  if constexpr (kMean) {
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
      load((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();  // tile kt has landed for every thread
    const TA* A = as[kt & 1];
    const __nv_bfloat16* B = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const TA* a0 = A + (wm + 16 * i + g) * kBLdA + kk + 2 * t;
        if constexpr (kMean) {  // the mean, rounded to bf16
          const float2 p0 = *reinterpret_cast<const float2*>(a0);
          const float2 p1 = *reinterpret_cast<const float2*>(a0 + 8 * kBLdA);
          const float2 p2 = *reinterpret_cast<const float2*>(a0 + 8);
          const float2 p3 = *reinterpret_cast<const float2*>(a0 + 8 * kBLdA + 8);
          fa[i][0] = pack_f32(p0.x * rs[i][0], p0.y * rs[i][0]);
          fa[i][1] = pack_f32(p1.x * rs[i][1], p1.y * rs[i][1]);
          fa[i][2] = pack_f32(p2.x * rs[i][0], p2.y * rs[i][0]);
          fa[i][3] = pack_f32(p3.x * rs[i][1], p3.y * rs[i][1]);
        } else {
          fa[i][0] = *reinterpret_cast<const uint32_t*>(a0);
          fa[i][1] = *reinterpret_cast<const uint32_t*>(a0 + 8 * kBLdA);
          fa[i][2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
          fa[i][3] = *reinterpret_cast<const uint32_t*>(a0 + 8 * kBLdA + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* b0 = B + (kk + 2 * t) * kBLdB + wn + 8 * j + g;
        const uint32_t fb[2] = {pack_bf16(b0[0], b0[kBLdB]),
                                pack_bf16(b0[8 * kBLdB], b0[9 * kBLdB])};
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], fa[i], fb);
      }
    }
    __syncthreads();  // every warp is done with tile kt before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + wn + 8 * j + 2 * t;  // even, and n is a multiple of 8
      if (col >= n) continue;
      const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + 16 * i + g + 8 * h;
        if (row < m) {
          uint32_t v = pack_f32(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
          if constexpr (kMean) {
            if (row % sp >= s) v = 0u;
            else if (!(rs[i][h] > 0.0f)) v = pack_f32(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
          *reinterpret_cast<uint32_t*>(c + (size_t)row * ldc + col) = v;
        }
      }
    }
}

// c[m, n] = bf16(a[m, k] @ b[k, n] + bias[n]), the sum in f32
__global__ void __launch_bounds__(kBThreads)
projection_bf16_kernel(const __nv_bfloat16* __restrict__ a, int lda,
                       const __nv_bfloat16* __restrict__ b, int ldb,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ c,
                       int ldc, int m, int n, int k) {
  projection_bf16_tile<false>(a, lda, b, ldb, bias, nullptr, 1, 1, c, ldc, m, n, k);
}

// K7's last launch in bf16: c = bf16((row_scale[r / sp] * a rounded to
// bf16) @ b + bias on live rows), pad token rows 0
__global__ void __launch_bounds__(kBThreads)
mean_out_bf16_kernel(const float* __restrict__ a, int lda, const float* __restrict__ row_scale,
                     const __nv_bfloat16* __restrict__ b, const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ c, int ldc, int m, int n, int k, int sp,
                     int s) {
  projection_bf16_tile<true>(a, lda, b, n, bias, row_scale, sp, s, c, ldc, m, n, k);
}

}  // namespace

extern "C" {

// (a) qkv = x @ w_qkv + b_qkv in bf16. x: [m, k] bf16 (row stride ldx),
// w_qkv: [k, n] contiguous, b_qkv: [n], qkv: [m, n] (row stride ldqkv,
// even). x, w_qkv 16-byte aligned, ldx, k and n multiples of 8.
int ampnet_edge_attention_layer_projection_bf16(const __nv_bfloat16* x, int ldx,
                                                const __nv_bfloat16* w_qkv,
                                                const __nv_bfloat16* b_qkv, __nv_bfloat16* qkv,
                                                int ldqkv, int m, int n, int k, void* stream) {
  if (const int err = projection_bf16_error(x, ldx, w_qkv, n, qkv, ldqkv, n, k)) return err;
  if (m > 0 && n > 0) {
    const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
    projection_bf16_kernel<<<grid, kBThreads, 0, (cudaStream_t)stream>>>(
        x, ldx, w_qkv, n, b_qkv, qkv, ldqkv, m, n, k);
  }
  return (int)cudaGetLastError();
}

// K7's last launch on bf16 rows: c = bf16((invdeg[row / sp] * sums rounded
// to bf16) @ w_out + b_out on rows of a live receiver); rows with row % sp
// >= s are written as 0. sums: [m, k] f32 (row stride lda, a multiple of
// 4), invdeg: [m / sp] f32, w_out: [k, n] bf16 contiguous, b_out: [n] bf16,
// c: [m, n] bf16 (row stride ldc, even); sums and w_out 16-byte aligned, k
// and n multiples of 8.
int ampnet_edge_attention_layer_mm_out_projection_bf16(const float* sums, int lda,
                                                       const float* invdeg,
                                                       const __nv_bfloat16* w_out,
                                                       const __nv_bfloat16* b_out,
                                                       __nv_bfloat16* c, int ldc, int m, int n,
                                                       int k, int sp, int s, void* stream) {
  if (const int err = projection_bf16_error(sums, lda, w_out, n, c, ldc, n, k)) return err;
  if (m > 0 && n > 0) {
    const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
    mean_out_bf16_kernel<<<grid, kBThreads, 0, (cudaStream_t)stream>>>(
        sums, lda, invdeg, w_out, b_out, c, ldc, m, n, k, sp, s);
  }
  return (int)cudaGetLastError();
}

// (b) the attention launch over bf16 projected rows (q|k|v packed per row,
// row stride ldqkv, 16-byte aligned with d a multiple of 8): invdeg
// [num_nodes] f32, w_out [d, d] (in, out) and b_out [d] bf16; out:
// [num_nodes*sp, d] bf16. The range of K1.
int ampnet_edge_attention_layer_bf16(const __nv_bfloat16* qkv, int ldqkv,
                                     const int* tile_senders, const int* tile_valid,
                                     const int* recv_ptr, const int* recv_slots,
                                     const float* invdeg, const __nv_bfloat16* w_out,
                                     const __nv_bfloat16* b_out, __nv_bfloat16* out,
                                     int num_nodes, int s, int sp, int d, int num_heads,
                                     int softmax, void* stream) {
  return dispatch_sums_bf16<true, __nv_bfloat16>(
      qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid, recv_ptr, recv_slots, invdeg,
      w_out, b_out, out, num_nodes, s, sp, d, num_heads, softmax, (cudaStream_t)stream,
      nullptr);
}

// (b') the attention launch over f32 projected rows with the attention's
// operands rounded to bf16; the arguments of ampnet_edge_attention_layer
// (edge_attention_layer_tc.cu), out f32.
int ampnet_edge_attention_layer_mxu(const float* qkv, int ldqkv, const int* tile_senders,
                                    const int* tile_valid, const int* recv_ptr,
                                    const int* recv_slots, const float* invdeg,
                                    const float* w_out, const float* b_out, float* out,
                                    int num_nodes, int s, int sp, int d, int num_heads,
                                    int softmax, void* stream) {
  return dispatch_sums_bf16<true, float>(qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid,
                                         recv_ptr, recv_slots, invdeg, w_out, b_out, out,
                                         num_nodes, s, sp, d, num_heads, softmax,
                                         (cudaStream_t)stream, nullptr);
}

// What an attention launch of either would run with (info as
// ampnet_edge_attention_sums_info in edge_attention_tc.cu).
int ampnet_edge_attention_layer_bf16_info(int num_nodes, int s, int d, int num_heads,
                                          int* info) {
  return dispatch_sums_bf16<true, __nv_bfloat16>(
      nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

int ampnet_edge_attention_layer_mxu_info(int num_nodes, int s, int d, int num_heads,
                                         int* info) {
  return dispatch_sums_bf16<true, float>(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, nullptr, nullptr, nullptr,
                                         num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
