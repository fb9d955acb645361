// The per-edge steps of pass R on Hopper's tensor cores, f32 in 3xTF32
// (mma_tf32.cuh), as one warp takes them for its (head, 16-row query tile)
// of a receiver: K3's (edge_attention_bwd_dq_tc.cu, dQ per receiver), run
// by K5 too (edge_attention_bwd_stream_tc.cu, dQ per receiver and each
// edge's dK | dV rows). The design, its bound and its trouble spots are
// described in edge_attention_bwd_dq_tc.cu.
//
// K3 calls softmax_backward and store_dq. Its two product loops, S | dW and
// dQ += dS K, stay inline in its kernel at S <= 48, and edge_scores and
// dq_accumulate below repeat them for K5: behind a function boundary the
// same loops of inline mma.sync compile to another instruction schedule for
// K3 (the same 157 registers at S=40, 121 instead of 122 at S=20; cuobjdump
// on an H100 build), while these two leave its SASS as it was. K3's wide
// body (48 < S <= 64, a block of one head) calls all four on a ring that
// holds only its head's columns (kr the stage, vr = kr + dh, ldr = 2dh + 4);
// a wide body of K5 can call them the same way, at any NKT.
//
// The lane is (g, t) = (lane / 4, lane % 4); the warp's rows are r0 = m0 +
// g and r1 = r0 + 8 of its tile; its head's columns start at hc; kr / vr
// point at the head's columns of the sender's K and V rows in the ring (row
// stride ldr). `load(i)` gives the lane's A
// fragment of Q / sqrt(dh) (i = kk) or of dMsg (i = 4 + kk) for the head's
// columns 8kk .. 8kk + 7, as four f32 (r0, c0), (r1, c0), (r0, c1), (r1, c1)
// with c0 = 8kk + t, c1 = c0 + 4; rows past S and columns past dh read 0.
#pragma once

#include "mma_tf32.cuh"

namespace {

// S = (Q / sqrt(dh)) K^T and dW = dMsg V^T, 16 queries x 8*NKT keys, into
// fresh tiles: K3's loops, with S taken also without the softmax (K5 forms
// W from the raw scores then).
template <int NKT, typename LoadA>
__device__ __forceinline__ void edge_scores(float (&sc)[NKT][4], float (&dw)[NKT][4], LoadA load,
                                            const float* kr, const float* vr, int ldr, int s,
                                            int dh, int g, int t) {
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = dw[j][e] = 0.0f;
#pragma unroll 1  // unrolled, the fragments of all k-steps stay live: spills
  for (int kk = 0; kk < 4; ++kk) {
    if (8 * kk >= dh) break;
    const FragA am = split_a(load(4 + kk));
    const int c0 = 8 * kk + t, c1 = c0 + 4;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int key = 8 * j + g;
      const float* vp = vr + key * ldr;
      mma_3xtf32(dw[j], am, split_b(key < s && c0 < dh ? vp[c0] : 0.0f,
                                    key < s && c1 < dh ? vp[c1] : 0.0f));
    }
    const FragA aq = split_a(load(kk));
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int key = 8 * j + g;
      const float* kp = kr + key * ldr;
      mma_3xtf32(sc[j], aq, split_b(key < s && c0 < dh ? kp[c0] : 0.0f,
                                    key < s && c1 < dh ? kp[c1] : 0.0f));
    }
  }
}

// The softmax over keys and its backward, in place: dw becomes dS = W (dW
// - rowsum(dW W)) times the slot's validity w (dS = dW w with softmax=0).
// With kWeights sc becomes W w (the raw scaled scores times w with
// softmax=0); else it is left as exp(s - max). Rows g (C values 0, 1) and
// g + 8 (C values 2, 3): every row's max, sum(e) and sum(dW e) are the
// thread's own values reduced across the quad (__shfl_xor 1, 2).
template <int NKT, bool kWeights>
__device__ __forceinline__ void softmax_backward(float (&sc)[NKT][4], float (&dw)[NKT][4], int s,
                                                 float w, int softmax, int t) {
  if (softmax) {
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
    float sum0 = 0.0f, sum1 = 0.0f, dot0 = 0.0f, dot1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = expf(sc[j][e] - mx0);
        sc[j][2 + e] = expf(sc[j][2 + e] - mx1);
        sum0 += sc[j][e];
        sum1 += sc[j][2 + e];
        dot0 = fmaf(dw[j][e], sc[j][e], dot0);
        dot1 = fmaf(dw[j][2 + e], sc[j][2 + e], dot1);
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 1);
    dot0 += __shfl_xor_sync(0xffffffffu, dot0, 2);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 1);
    dot1 += __shfl_xor_sync(0xffffffffu, dot1, 2);
    const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
    dot0 *= inv0;  // rowsum(dW W) of the row
    dot1 *= inv1;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dw[j][e] = sc[j][e] * inv0 * (dw[j][e] - dot0) * w;
        dw[j][2 + e] = sc[j][2 + e] * inv1 * (dw[j][2 + e] - dot1) * w;
        if (kWeights) {  // W w, the same W = e / sum(e) that dS took
          sc[j][e] = sc[j][e] * inv0 * w;
          sc[j][2 + e] = sc[j][2 + e] * inv1 * w;
        }
      }
  } else {  // dS = dW; pad keys read K and V as 0, so their scores and dW are 0
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dw[j][e] *= w;
        if (kWeights) sc[j][e] *= w;
      }
  }
}

// dQ += dS K (1/sqrt(dh) applied once, when dQ is written): dS's C fragment
// is the A fragment (c_as_a), K's B fragment reads keys 2t and 2t + 1
template <int NKT>
__device__ __forceinline__ void dq_accumulate(float (&acc)[4][4], const float (&ds)[NKT][4],
                                              const float* kr, int ldr, int s, int dh, int g,
                                              int t) {
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    const FragA a = c_as_a(ds[j]);
    const int key = 8 * j + 2 * t;
    const float* k0 = kr + key * ldr;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      if (8 * nn >= dh) break;
      const int c = 8 * nn + g;
      mma_3xtf32(acc[nn], a, split_b(key < s && c < dh ? k0[c] : 0.0f,
                                     key + 1 < s && c < dh ? k0[ldr + c] : 0.0f));
    }
  }
}

// The warp's 16 x dh rows of dQ (scaled by 1/sqrt(dh)) at orow (row stride
// d, the head's first column): rows past S and columns past dh not written
__device__ __forceinline__ void store_dq(float* orow, const float (&acc)[4][4], int r0, int r1,
                                         int s, int d, int dh, float scale, int t) {
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    if (8 * nn >= dh) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, c = 8 * nn + 2 * t + (e & 1);
      if (r < s && c < dh) orow[(size_t)r * d + c] = acc[nn][e] * scale;
    }
  }
}

}  // namespace
