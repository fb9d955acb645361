// The per-edge steps of pass R on Hopper's tensor cores in bf16 products
// with f32 sums (mma.sync m16n8k16, mma_bf16.cuh), as one warp takes them
// for its (head, 16-row query tile) of a receiver: K3's bf16 body
// (edge_attention_bwd_dq_tc_bf16.cu, dQ per receiver), run by K5's bf16
// body too (edge_attention_bwd_stream_tc_bf16.cu, dQ per receiver and each
// edge's dK | dV rows), as the 3xTF32 bodies share
// edge_attention_bwd_dq_tc.cuh. The rounding points, the bound and the
// trouble spots are described in edge_attention_bwd_dq_tc_bf16.cu.
//
// K3 calls softmax_backward_bf16 and store_dq_bf16. Its fragment loads and
// its two product loops, S | dW and dQ += dS K, stay inline in its kernel,
// and load_qdm_frags_bf16, edge_scores_bf16 and dq_accumulate_bf16 below
// repeat them for K5, as the 3xTF32 header does for its two loops: behind
// a function boundary the same code compiles to another instruction
// schedule for K3 (163 instead of 160 registers at S=40; its fragment loads
// alone rename registers; cuobjdump on an H100 build), while these two
// leave its SASS as it was. The two copies round at the same points and
// must change together, until the product-policy template queued in
// ROADMAP.md (§A 2b) lets K3 call these and drops its inline copy. K3's wide
// body (48 < S <= 64, a block of one head) already calls all five, on a
// ring that holds only its head's columns (kr the stage, vr = kr + dh, ldr =
// 2dh + 8); a wide body of K5 can call them the same way, at any NKT.
//
// The lane is (g, t) = (lane / 4, lane % 4); the warp's rows are r0 = m0 +
// g and r1 = r0 + 8 of its tile; its head's columns start at hc; kr / vr
// point at the head's columns of the sender's K and V rows in the ring (row
// stride ldr, bf16). qa / da are the lane's A fragments of Q times the bf16
// 1/sqrt(dh) (rounded to bf16) and of dMsg, two k-steps of 16 head columns.
#pragma once

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// qa and da from the head's columns of the warp's two rows of Q (q0, q1)
// and of dMsg (d0, d1): rows past s and columns past dh read as 0
__device__ __forceinline__ void load_qdm_frags_bf16(uint32_t (&qa)[2][4], uint32_t (&da)[2][4],
                                                    const bf16* q0, const bf16* q1,
                                                    const bf16* d0, const bf16* d1, int r0,
                                                    int r1, int s, int dh, int t, float qscale) {
  const bf16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * kk + 8 * h + 2 * t;
      qa[kk][2 * h] = pack_bf16(r0 < s && c < dh ? scaled_bf16(q0[c], qscale) : zero,
                                r0 < s && c + 1 < dh ? scaled_bf16(q0[c + 1], qscale) : zero);
      qa[kk][2 * h + 1] =
          pack_bf16(r1 < s && c < dh ? scaled_bf16(q1[c], qscale) : zero,
                    r1 < s && c + 1 < dh ? scaled_bf16(q1[c + 1], qscale) : zero);
      da[kk][2 * h] = pair_bf16(d0, c, r0 < s ? dh : 0);
      da[kk][2 * h + 1] = pair_bf16(d1, c, r1 < s ? dh : 0);
    }
}

// dW = dMsg V^T and S = (Q scale) K^T: 16 queries x 8*NKT keys into fresh
// f32 tiles (K3 takes S only for the softmax; K5's W needs it either way)
template <int NKT>
__device__ __forceinline__ void edge_scores_bf16(float (&sc)[NKT][4], float (&dw)[NKT][4],
                                                 const uint32_t (&qa)[2][4],
                                                 const uint32_t (&da)[2][4], const bf16* kr,
                                                 const bf16* vr, int ldr, int s, int dh, int g,
                                                 int t) {
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dw[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (16 * kk >= dh) break;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int key = 8 * j + g;
      const int lim = key < s ? dh : 0;
      const bf16* vp = vr + key * ldr;
      const uint32_t bv[2] = {pair_bf16(vp, 16 * kk + 2 * t, lim),
                              pair_bf16(vp, 16 * kk + 8 + 2 * t, lim)};
      mma_bf16(dw[j], da[kk], bv);
      const bf16* kp = kr + key * ldr;
      const uint32_t bk[2] = {pair_bf16(kp, 16 * kk + 2 * t, lim),
                              pair_bf16(kp, 16 * kk + 8 + 2 * t, lim)};
      mma_bf16(sc[j], qa[kk], bk);
    }
  }
}

// The softmax over keys and its backward in f32, in place, as the JAX body
// writes them: sc becomes W = e / sum(e), dw becomes dS = W (dW - sum(dW
// W)). Rows g (values 0, 1) and g + 8 (values 2, 3), each reduced across
// the quad (__shfl_xor 1, 2). Without the softmax dS = dW and W is the raw
// scores: pad keys read K and V as 0, so both are 0 there.
template <int NKT>
__device__ __forceinline__ void softmax_backward_bf16(float (&sc)[NKT][4], float (&dw)[NKT][4],
                                                      int s, int t) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    const int key = 8 * j + 2 * t;
    if (key >= s) sc[j][0] = sc[j][2] = -INFINITY;
    if (key + 1 >= s) sc[j][1] = sc[j][3] = -INFINITY;
    mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
    mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[j][e] = expf(sc[j][e] - mx0);
      sc[j][2 + e] = expf(sc[j][2 + e] - mx1);
      sum0 += sc[j][e];
      sum1 += sc[j][2 + e];
    }
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  float dot0 = 0.0f, dot1 = 0.0f;  // sum(dW W) of the row
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[j][e] = sc[j][e] / sum0;  // W = e / sum(e), as the JAX body divides
      sc[j][2 + e] = sc[j][2 + e] / sum1;
      dot0 = fmaf(dw[j][e], sc[j][e], dot0);
      dot1 = fmaf(dw[j][2 + e], sc[j][2 + e], dot1);
    }
  }
  dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
  dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
  dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
  dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dw[j][e] = sc[j][e] * (dw[j][e] - dot0);
      dw[j][2 + e] = sc[j][2 + e] * (dw[j][2 + e] - dot1);
    }
}

// acc += (dS K) scale: dS rounded to bf16 as the A operand over 16 keys a
// k-step (its C fragments packed pairwise); each edge's 16 x dh tile summed
// in a fresh f32 tile, scaled by 1/sqrt(dh) in f32 and added in IEEE f32
// (JAX's dq_g * scale, then acc + block)
template <int NKT>
__device__ __forceinline__ void dq_accumulate_bf16(float (&acc)[4][4], const float (&dw)[NKT][4],
                                                   const bf16* kr, int ldr, int s, int dh, int g,
                                                   int t, float scale) {
  constexpr int kPSteps = (NKT + 1) / 2;
  uint32_t pa[kPSteps][4];
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk) {
    pa[kk][0] = pack_f32(dw[2 * kk][0], dw[2 * kk][1]);
    pa[kk][1] = pack_f32(dw[2 * kk][2], dw[2 * kk][3]);
    pa[kk][2] = 2 * kk + 1 < NKT ? pack_f32(dw[2 * kk + 1][0], dw[2 * kk + 1][1]) : 0u;
    pa[kk][3] = 2 * kk + 1 < NKT ? pack_f32(dw[2 * kk + 1][2], dw[2 * kk + 1][3]) : 0u;
  }
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    if (8 * nn >= dh) break;
    const int c = 8 * nn + g;
    float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // this edge's dQ tile
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const int key = 16 * kk + 2 * t;
      const bf16* k0 = kr + key * ldr;
      const uint32_t b[2] = {
          column_pair_bf16(k0, ldr, c, dh, key < s, key + 1 < s),
          column_pair_bf16(k0 + 8 * ldr, ldr, c, dh, key + 8 < s, key + 9 < s)};
      mma_bf16(m, pa[kk], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = __fadd_rn(acc[nn][e], __fmul_rn(m[e], scale));
  }
}

// The warp's 16 x dh rows of dQ at orow (row stride d, the head's first
// column): rows past S and columns past dh not written
__device__ __forceinline__ void store_dq_bf16(float* orow, const float (&acc)[4][4], int r0,
                                              int r1, int s, int d, int dh, int t) {
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    if (8 * nn >= dh) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, c = 8 * nn + 2 * t + (e & 1);
      if (r < s && c < dh) orow[(size_t)r * d + c] = acc[nn][e];
    }
  }
}

}  // namespace
