// The per-edge attention steps that the edge-group and the chunked forward
// kernels share (edge_attention_groups.cu, edge_attention_chunked.cu): row
// loads into shared memory, the score product, the per-edge softmax and the
// value product, f32 on the CUDA cores with the register tiles of
// edge_attention.cu (2 queries x 4 keys for the scores, 4 query rows x 1
// column for the messages). Any block size; every function is called by
// all threads of the block and none synchronises. kBf16 (the 'simt_bf16'
// bodies): the rows' values are converted to f32 as they are loaded, the
// loads round q times the scale, k and v to bf16, and the weights (or the
// raw scaled scores) round to bf16 before the value product: the JAX bodies'
// rounding points, with each product's sum in f32.
//
// Shared-memory shapes (s2 = s rounded up to 2, s4 to 4, ld = d + 1; pad
// rows are zeroed once by the caller and never written, so the tiles read
// them without guards):
//   qs [s2][ld]            query rows, pre-scaled by 1/sqrt(dh)
//   ks [s4][ld]            one edge's key rows
//   vs [rows][d]           value rows (of one edge, or of a piece of a chunk
//                          side by side: s rows per edge)
//   ps [h][s4][ldp]        scores, then weights; ldp >= the key columns
#pragma once

#include "common.cuh"
#include "rows_bf16.cuh"

constexpr int kLoadsInFlight = 8;  // global loads each thread issues before a store

// dst[i * ld_dst + c] = mul * src[(row0 + i) * ld_src + col0 + c] for i < s,
// c < ncols (kBf16: rounded to bf16). Neighbouring threads take
// neighbouring columns of one row.
template <bool kBf16 = false, typename T = float>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, size_t row0,
                                          int ld_src, int col0, int ncols, int s,
                                          float* dst, int ld_dst, float mul) {
  const int total = s * ncols;
  const int nth = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += nth * kLoadsInFlight) {
    float r[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int e = e0 + u * nth;
      if (e < total) r[u] = to_f32(src[(row0 + e / ncols) * (size_t)ld_src + col0 + e % ncols]);
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int e = e0 + u * nth;
      if (e < total)
        dst[(e / ncols) * ld_dst + e % ncols] = kBf16 ? round_bf16(r[u] * mul) : r[u] * mul;
    }
  }
}

// ps[(h * s4 + i) * ldp + j] = sum_c qs[i][h * dh + c] * ks[j][h * dh + c] for
// i, j < s, for `edges` key blocks side by side: block e reads
// ks + e * s4 * ld and writes columns e * s .. e * s + s - 1. kBf16 without
// the softmax: the raw scores are the value product's operand, rounded.
template <bool kBf16 = false>
__device__ __forceinline__ void score_tiles(const float* qs, const float* ks, float* ps,
                                            int ldp, int edges, int s, int d,
                                            int num_heads, int softmax = 1) {
  const int dh = d / num_heads, ld = d + 1;
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  const int n_ip = s2 / 2, n_jq = s4 / 4;
  const int n_tile = edges * num_heads * n_ip * n_jq;
  for (int t = threadIdx.x; t < n_tile; t += blockDim.x) {
    const int jq = t % n_jq;
    int r = t / n_jq;
    const int ip = r % n_ip;
    r /= n_ip;
    const int h = r % num_heads, e = r / num_heads;
    const float* q0 = qs + (2 * ip) * ld + h * dh;
    const float* k0 = ks + (e * s4 + 4 * jq) * ld + h * dh;
    float a[2][4] = {};
#pragma unroll 4
    for (int c = 0; c < dh; ++c) {
      const float x0 = q0[c], x1 = q0[ld + c];
      const float y0 = k0[c], y1 = k0[ld + c], y2 = k0[2 * ld + c], y3 = k0[3 * ld + c];
      a[0][0] = fmaf(x0, y0, a[0][0]); a[0][1] = fmaf(x0, y1, a[0][1]);
      a[0][2] = fmaf(x0, y2, a[0][2]); a[0][3] = fmaf(x0, y3, a[0][3]);
      a[1][0] = fmaf(x1, y0, a[1][0]); a[1][1] = fmaf(x1, y1, a[1][1]);
      a[1][2] = fmaf(x1, y2, a[1][2]); a[1][3] = fmaf(x1, y3, a[1][3]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = 2 * ip + u;
      if (i >= s) break;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = 4 * jq + v;
        if (j < s)
          ps[(h * s4 + i) * ldp + e * s + j] = kBf16 && !softmax ? round_bf16(a[u][v]) : a[u][v];
      }
    }
  }
}

// Softmax over each edge's own s key columns, in place: one warp per (head,
// query row, edge) segment, so every edge keeps its own maximum and its own
// denominator whatever shares its row (kBf16: the weights rounded to bf16).
template <bool kBf16 = false>
__device__ __forceinline__ void softmax_segments(float* ps, int ldp, int edges, int s,
                                                 int num_heads) {
  const int s4 = (s + 3) / 4 * 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int n_seg = num_heads * s * edges;
  for (int g = warp; g < n_seg; g += warps) {
    const int e = g % edges, row = g / edges;
    float* p = ps + ((row / s) * s4 + row % s) * ldp + e * s;
    float m = -INFINITY;
    for (int j = lane; j < s; j += 32) m = fmaxf(m, p[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < s; j += 32) {
      const float ex = expf(p[j] - m);
      p[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < s; j += 32) p[j] = kBf16 ? round_bf16(p[j] / sum) : p[j] / sum;
  }
}

// emit(i, c, sum_j ps[(head(c) * s4 + i) * ldp + j] * vs[j * d + c]) for
// i < s, c < d, the sum over the first `contract` columns: one edge's
// message (contract = s), or the sum of a piece's messages (contract = the
// piece's edges x s). Each thread gets the same (i, c) on every call.
template <class Emit>
__device__ __forceinline__ void message_tiles(const float* ps, int ldp, const float* vs,
                                              int contract, int s, int d, int num_heads,
                                              Emit emit) {
  const int dh = d / num_heads;
  const int s4 = (s + 3) / 4 * 4;
  const int n_msg = (s4 / 4) * d;
  for (int t = threadIdx.x; t < n_msg; t += blockDim.x) {
    const int c = t % d, i0 = 4 * (t / d);
    const float* p = ps + ((c / dh) * s4 + i0) * ldp;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int j = 0; j < contract; ++j) {
      const float v = vs[j * d + c];
      a0 = fmaf(p[j], v, a0);
      a1 = fmaf(p[ldp + j], v, a1);
      a2 = fmaf(p[2 * ldp + j], v, a2);
      a3 = fmaf(p[3 * ldp + j], v, a3);
    }
    emit(i0, c, a0);
    if (i0 + 1 < s) emit(i0 + 1, c, a1);
    if (i0 + 2 < s) emit(i0 + 2, c, a2);
    if (i0 + 3 < s) emit(i0 + 3, c, a3);
  }
}
