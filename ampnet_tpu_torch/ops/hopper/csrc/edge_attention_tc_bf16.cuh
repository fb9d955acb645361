// The per-receiver walk of K1 (the sums, edge_attention_tc_bf16.cu) and K2's
// attention launch (the whole layer, edge_attention_layer_tc_bf16.cu) on
// Hopper's tensor cores in bf16 products with f32 sums (mma.sync m16n8k16,
// mma_bf16.cuh): the bf16 body beside the 3xTF32 one of edge_attention_tc.cuh,
// whose walk, ring and warp layout it keeps. Its per-edge steps (Q's
// fragments, the score tile, the softmax, P V and the message's add) are
// device functions that the bf16 edge-group kernel
// (edge_attention_groups_tc_bf16.cu, K6 and K9) calls too.
//
// Replaces, for bf16 rows and for f32 rows under mxu_bf16, the bodies of
// ampnet_tpu/ops/pallas/edge_attention_fused.py _fused_kernel_vmem_v2 (:691,
// body _tile_attention_accumulate :379), _fused_kernel_vmem_v4 (:942) and the
// attention and epilogue of _fused_kernel_vmem_v6 (:763). It rounds where
// they round (JAX :560-561, 576-580, 851-860):
//
// * the scores' operands: q times 1/sqrt(dh) in the rows' type (bf16 rows:
//   the bf16 scale, 0.1767578125 at dh = 32), rounded to bf16; k as it is
//   (f32 rows: rounded). Summed in f32 by the tensor cores: a bf16 product
//   is exact in f32, so the kernel and its plain version differ only in the
//   order of f32 sums.
// * the softmax in f32 (W = e / sum(e)), then W rounded to bf16 as the A
//   operand of P V: the score tile's C fragments pack pairwise into it
//   (mma_bf16.cuh); v as it is (f32 rows: rounded).
// * each edge's message (16 x dh per warp) is summed in a fresh f32 tile,
//   then scaled by the slot's validity (with kLayer times 1/degree) and added
//   to the receiver's f32 sums with IEEE f32 operations: JAX's msg * v, then
//   acc + block.
// * kLayer, bf16 rows: the f32 mean rounds to bf16, mean @ w_out takes bf16
//   products into f32, the result rounds to bf16, and b_out is added in bf16
//   on live rows; the output is bf16. kLayer, f32 rows (mxu_bf16): JAX
//   rounds only the attention's operands, so the epilogue is the 3xTF32
//   body's, with an f32 output.
//
// Bound (H100 SXM) at the S=40 Cora shapes: 8.47 GFLOP of products, 8.6 us
// at the 989 TFLOP/s bf16 rate, against the bytes of bf16 rows (q, k|v once
// each, ~47 MB) and the f32 sums (~56 MB), ~31 us at 3.35 TB/s: bound by
// bytes. The design is the 3xTF32 body's (one warp per (head, 16-row query
// tile), a ring of gathered k|v rows filled by 16-byte cp.async, a
// persistent grid over receivers, no atomics: bit-reproducible); a product
// is one mma.sync where 3xTF32 takes three and the hi/lo splits, and bf16
// rows halve the ring's stages (row stride 2D + 8 values, free of bank
// conflicts for the B loads at D = 128). Q's fragments (two k-steps of 16
// head columns) are kept in shared memory by the lane that owns them, as in
// the 3xTF32 body: in registers they spilled at S=40 (24 bytes a thread
// under the 80 registers of two blocks per SM).
//
// Trouble spots as in the 3xTF32 body: pad query rows read as 0 and are
// never written; pad keys of the last key tile are scored -inf and read as
// 0 (their ring rows hold an earlier edge's values); dh not a multiple of 16
// is zero-padded; rows S..SP-1 of the output are written as 0. Within the
// tensor cores' range only (S <= 48, dh <= 32, at most 12 warps, 8 up to
// S=24; for K1 also 48 < S <= 64 with dh a multiple of 8): beyond it the
// wrappers run the CUDA-core bf16 bodies.
//
// K1 at 48 < S <= 64 (path J's S=64) takes the 3xTF32 body's grid of
// (receivers, heads), edge_attention_tc.cuh: a block of one head (4 warps)
// gathers that head's columns of K|V (row stride 2dh + 8 values: 36 words at
// dh = 32, free of bank conflicts as 2D + 8 at D = 128), 9 KB a stage of bf16
// rows; registers capped at 168 a thread (3 blocks of 128 threads per SM: at
// 128, f32 rows under mxu_bf16 spilled).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kBf16MaxWarps = 12;
constexpr int kBf16MaxThreads = 32 * kBf16MaxWarps;

// the ring's row stride in values of T: 2d plus one 16-byte piece
template <typename T>
__host__ __device__ constexpr int ring_pad() { return 16 / (int)sizeof(T); }

// ---- the per-edge steps of one warp (head hc.., query rows r0 = m0 + g and
// r1 = r0 + 8 of its 16-row tile), shared with the bf16 edge-group kernel
// (edge_attention_groups_tc_bf16.cu)

// A fragments of (Q * scale) rounded to bf16 of node row block qrow0, two
// k-steps of 16 head columns, into the lane's own slots of qfrag (rows past
// s and columns past dh read as 0: the next node's rows are never read)
template <typename T>
__device__ __forceinline__ void load_q_frags_bf16(uint4* qfrag, const T* __restrict__ q,
                                                  size_t qrow0, int ldq, int hc, int r0, int r1,
                                                  int s, int dh, int t, float scale) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const T* q0 = q + (qrow0 + r0) * ldq + hc;
    const T* q1 = q + (qrow0 + r1) * ldq + hc;
    uint32_t qa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns 16kk + 2t (+1), then + 8
      const int c = 16 * kk + 8 * h + 2 * t;
      qa[2 * h] = pack_bf16(r0 < s && c < dh ? scaled_bf16(q0[c], scale) : zero,
                            r0 < s && c + 1 < dh ? scaled_bf16(q0[c + 1], scale) : zero);
      qa[2 * h + 1] = pack_bf16(r1 < s && c < dh ? scaled_bf16(q1[c], scale) : zero,
                                r1 < s && c + 1 < dh ? scaled_bf16(q1[c + 1], scale) : zero);
    }
    qfrag[kk * blockDim.x] = make_uint4(qa[0], qa[1], qa[2], qa[3]);
  }
}

// sc = the 16 queries x 8*NKT keys score tile, f32, against the keys kr (a
// ring stage at the warp's head column, row stride ldr)
template <int NKT, typename T>
__device__ __forceinline__ void score_tile_bf16(float (&sc)[NKT][4], const uint4* qfrag,
                                                const T* kr, int ldr, int s, int dh, int g,
                                                int t) {
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (16 * kk >= dh) break;
    const uint4 a4 = qfrag[kk * blockDim.x];
    const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int key = 8 * j + g;
      const T* kp = kr + key * ldr;
      const int lim = key < s ? dh : 0;
      const uint32_t b[2] = {pair_bf16(kp, 16 * kk + 2 * t, lim),
                             pair_bf16(kp, 16 * kk + 8 + 2 * t, lim)};
      mma_bf16(sc[j], a, b);
    }
  }
}

// The row softmax of sc in place, W = e / sum(e) as the JAX body divides:
// rows g (sc[j][0..1]) and g + 8 (sc[j][2..3]), over the keys
template <int NKT>
__device__ __forceinline__ void softmax_rows_bf16(float (&sc)[NKT][4], int s, int t) {
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
    sc[j][0] = expf(sc[j][0] - mx0);
    sc[j][1] = expf(sc[j][1] - mx0);
    sc[j][2] = expf(sc[j][2] - mx1);
    sc[j][3] = expf(sc[j][3] - mx1);
    sum0 += sc[j][0] + sc[j][1];
    sum1 += sc[j][2] + sc[j][3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    sc[j][0] = sc[j][0] / sum0;
    sc[j][1] = sc[j][1] / sum0;
    sc[j][2] = sc[j][2] / sum1;
    sc[j][3] = sc[j][3] / sum1;
  }
}

// o += wgt * (W V): W (the softmax's weights, or the raw scaled scores) in
// bf16 as the A operand of P V over 16 keys a k-step, the values vr (the
// ring stage's V half) as they are (f32 rows: rounded); the edge's message
// is summed in a fresh f32 tile, then scaled by wgt and added to o in IEEE
// f32 (JAX's msg * v, then acc + block)
template <int NKT, typename T>
__device__ __forceinline__ void pv_accumulate_bf16(const float (&sc)[NKT][4], float (&o)[4][4],
                                                   const T* vr, int ldr, int s, int dh, int g,
                                                   int t, float wgt) {
  constexpr int kPSteps = (NKT + 1) / 2;
  uint32_t pa[kPSteps][4];
#pragma unroll
  for (int kk = 0; kk < kPSteps; ++kk) {
    pa[kk][0] = pack_f32(sc[2 * kk][0], sc[2 * kk][1]);
    pa[kk][1] = pack_f32(sc[2 * kk][2], sc[2 * kk][3]);
    pa[kk][2] = 2 * kk + 1 < NKT ? pack_f32(sc[2 * kk + 1][0], sc[2 * kk + 1][1]) : 0u;
    pa[kk][3] = 2 * kk + 1 < NKT ? pack_f32(sc[2 * kk + 1][2], sc[2 * kk + 1][3]) : 0u;
  }
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    if (8 * nn >= dh) break;
    const int c = 8 * nn + g;
    float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // this edge's message tile
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const int key = 16 * kk + 2 * t;
      const T* v0 = vr + key * ldr;
      const uint32_t b[2] = {
          column_pair_bf16(v0, ldr, c, dh, key < s, key + 1 < s),
          column_pair_bf16(v0 + 8 * ldr, ldr, c, dh, key + 8 < s, key + 9 < s)};
      mma_bf16(m, pa[kk], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nn][e] = __fadd_rn(o[nn][e], __fmul_rn(m[e], wgt));
  }
}

// K2's output type: the rows' type (bf16, or f32 under mxu_bf16); K1's: f32
template <bool kLayer, typename T>
using SumsOut = std::conditional_t<kLayer, T, float>;

template <int NKT, bool kLayer, typename T>
__global__ void __launch_bounds__(NKT > 6 ? kWideThreads : kBf16MaxThreads,
                                  NKT > 6 ? 3
                                          : NKT == 4 || NKT == 6 || (kLayer && NKT == 5) ? 1 : 2)
sums_bf16_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ kv, int ldkv,
                 const int* __restrict__ tile_senders, const int* __restrict__ tile_valid,
                 const int* __restrict__ recv_ptr, const int* __restrict__ recv_slots,
                 const float* __restrict__ invdeg, const T* __restrict__ w_out,
                 const T* __restrict__ b_out, SumsOut<kLayer, T>* __restrict__ out,
                 int num_nodes, int s, int sp, int d, int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  const int dh = d / num_heads;
  constexpr bool kWide = NKT > 6;       // a block of one head, blockIdx.y
  const int head = kWide ? blockIdx.y : warp / mtiles;
  const int hc = head * dh;             // the warp's head, first column
  const int gw = kWide ? dh : d;        // the block's columns of K (and of V)
  const int rc = kWide ? 0 : hc;        // the warp's head in the ring
  const int m0 = 16 * (warp % mtiles);  // the warp's first query row
  const float scale = head_scale<T>(dh);
  // [2][threads] uint4: each lane's own Q fragments (registers decide the
  // blocks per SM: in registers they spilled); with kLayer the staged mean
  // [16 * mtiles][d + pad] in the rows' type; then the ring
  uint4* qfrag = reinterpret_cast<uint4*>(smem_raw) + threadIdx.x;
  const int ldm = d + ring_pad<T>();
  T* mean = reinterpret_cast<T*>(smem_raw + 2 * sizeof(uint4) * blockDim.x);
  T* ring = mean + (kLayer ? 16 * mtiles * ldm : 0);
  const int ldr = 2 * gw + ring_pad<T>();
  const int stage_values = s * ldr;

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(recv_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
    if (slot >= 0)
      fill_heads(ring + i * stage_values, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s, d,
                 hc - rc, gw);
    cp_async_commit();
  }
  int stage = 0;  // the stage of the next live edge

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t qrow0 = (size_t)n * sp;
    const int r0 = m0 + g, r1 = r0 + 8;
    const float inv_n = kLayer ? invdeg[n] : 1.0f;
    load_q_frags_bf16(qfrag, q, qrow0, ldq, hc, r0, r1, s, dh, t, scale);
    float o[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.0f;

    const int end = recv_ptr[n + 1];
    for (int k = recv_ptr[n]; k < end; ++k) {
      const int valid = tile_valid[recv_slots[k]];
      if (valid == 0) continue;  // the same for every thread of the block
      cp_async_wait(stages - 2);
      __syncthreads();  // this edge's stage has landed; the previous one is free
      const T* kr = ring + stage * stage_values + rc;
      const T* vr = kr + gw;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4];  // scores: 16 queries x 8*NKT keys, f32
      score_tile_bf16<NKT>(sc, qfrag, kr, ldr, s, dh, g, t);

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (slot >= 0)
          fill_heads(ring + free_stage * stage_values, ldr, kv, (size_t)tile_senders[slot] * sp,
                     ldkv, s, d, hc - rc, gw);
        cp_async_commit();
      }

      // else the raw scaled scores; pad keys score 0 (their k read as 0)
      if (softmax) softmax_rows_bf16<NKT>(sc, s, t);
      pv_accumulate_bf16<NKT>(sc, o, vr, ldr, s, dh, g, t, (float)valid * inv_n);
    }

    using O = SumsOut<kLayer, T>;
    O* orow = out + qrow0 * d;
    if constexpr (!kLayer) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        if (8 * nn >= dh) break;
        const int c = hc + 8 * nn + 2 * t;
        if (r0 < s) {
          if (c - hc < dh) orow[r0 * d + c] = o[nn][0];
          if (c + 1 - hc < dh) orow[r0 * d + c + 1] = o[nn][1];
        }
        if (r1 < s) {
          if (c - hc < dh) orow[r1 * d + c] = o[nn][2];
          if (c + 1 - hc < dh) orow[r1 * d + c + 1] = o[nn][3];
        }
      }
    } else if (inv_n == 0.0f) {  // degree 0 (the same for the whole block)
      for (int e = threadIdx.x; e < s * d; e += blockDim.x) orow[e] = from_f32<O>(0.0f);
    } else {
      __syncthreads();  // every warp is done with the previous receiver's mean
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {  // the mean in the rows' type
        if (8 * nn >= dh) break;
        const int c = 8 * nn + 2 * t;
        T* m_0 = mean + (m0 + g) * ldm + hc;
        T* m_1 = m_0 + 8 * ldm;
        if constexpr (std::is_same_v<T, float>) {
          if (c < dh) m_0[c] = o[nn][0], m_1[c] = o[nn][2];
          if (c + 1 < dh) m_0[c + 1] = o[nn][1], m_1[c + 1] = o[nn][3];
        } else {
          if (c < dh) m_0[c] = __float2bfloat16_rn(o[nn][0]), m_1[c] = __float2bfloat16_rn(o[nn][2]);
          if (c + 1 < dh)
            m_0[c + 1] = __float2bfloat16_rn(o[nn][1]), m_1[c + 1] = __float2bfloat16_rn(o[nn][3]);
        }
      }
      __syncthreads();
      // out rows of this warp's query tile x the 8-column tiles head, head + H,
      // ..., w_out (resident in L2) read from global memory
      const int ntiles = (d + 7) / 8;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
      const T* a0 = mean + (m0 + g) * ldm;
      const T* a1 = a0 + 8 * ldm;
      if constexpr (std::is_same_v<T, float>) {  // mxu_bf16: the 3xTF32 epilogue
#pragma unroll 1
        for (int kk = 0; kk < (d + 7) / 8; ++kk) {
          const int c0 = 8 * kk + t, c1 = c0 + 4;
          const FragA a = split_a(c0 < d ? a0[c0] : 0.0f, c0 < d ? a1[c0] : 0.0f,
                                  c1 < d ? a0[c1] : 0.0f, c1 < d ? a1[c1] : 0.0f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 8 * (head + i * num_heads) + g;
            if (head + i * num_heads >= ntiles) break;
            mma_3xtf32(o[i], a,
                       split_b(c0 < d && col < d ? __ldg(w_out + (size_t)c0 * d + col) : 0.0f,
                               c1 < d && col < d ? __ldg(w_out + (size_t)c1 * d + col) : 0.0f));
          }
        }
      } else {  // bf16 rows: the mean and w_out in bf16 products
#pragma unroll 1
        for (int kk = 0; kk < (d + 15) / 16; ++kk) {
          const int c = 16 * kk + 2 * t;
          const uint32_t a[4] = {pair_bf16(a0, c, d), pair_bf16(a1, c, d),
                                 pair_bf16(a0, c + 8, d), pair_bf16(a1, c + 8, d)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 8 * (head + i * num_heads) + g;
            if (head + i * num_heads >= ntiles) break;
            const T* wc = w_out + col;
            const bool in = col < d;
            const uint32_t b[2] = {
                column_pair_bf16(wc + (size_t)c * d, d, 0, 1, in && c < d, in && c + 1 < d),
                column_pair_bf16(wc + (size_t)(c + 8) * d, d, 0, 1, in && c + 8 < d,
                                 in && c + 9 < d)};
            mma_bf16(o[i], a, b);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = head + i * num_heads;
        if (nt >= ntiles) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = 8 * nt + 2 * t + (e & 1);
          if (r < s && c < d) {
            if constexpr (std::is_same_v<T, float>) {
              orow[r * d + c] = o[i][e] + b_out[c];
            } else {  // round the product, then add b_out in bf16
              const float y = __bfloat162float(__float2bfloat16_rn(o[i][e]));
              orow[r * d + c] = __float2bfloat16_rn(y + __bfloat162float(b_out[c]));
            }
          }
        }
      }
    }
    if (!kWide || blockIdx.y == 0)
      for (int e = s * d + threadIdx.x; e < sp * d; e += blockDim.x) orow[e] = from_f32<O>(0.0f);
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per receiver
// and head group), or, with info, what it would run with.
template <int NKT, bool kLayer, typename T>
int launch_sums_bf16(const T* q, int ldq, const T* kv, int ldkv, const int* tile_senders,
                     const int* tile_valid, const int* recv_ptr, const int* recv_slots,
                     const float* invdeg, const T* w_out, const T* b_out,
                     SumsOut<kLayer, T>* out, int num_nodes, int s, int sp, int d,
                     int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int heads = block_heads(s, num_heads);
  const int gw = heads * (d / num_heads);
  const int threads = 32 * heads * ((s + 15) / 16);
  // Q fragments; with kLayer the staged mean
  const size_t fixed = (size_t)threads * 2 * sizeof(uint4) +
      (kLayer ? (size_t)16 * ((s + 15) / 16) * (d + ring_pad<T>()) * sizeof(T) : 0);
  const size_t stage_bytes = (size_t)s * (2 * gw + ring_pad<T>()) * sizeof(T);
  const int err = ring_plan_bytes(sums_bf16_kernel<NKT, kLayer, T>, threads, s, gw, fixed,
                                  stage_bytes, plan);
  if (err) return err;
  const dim3 grid = ring_grid(plan, num_nodes, num_heads / heads);
  if (info) return ring_info(sums_bf16_kernel<NKT, kLayer, T>, plan, grid.x * grid.y, info);
  if (grid.x > 0)
    sums_bf16_kernel<NKT, kLayer, T><<<grid, threads, plan.smem, stream>>>(
        q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, invdeg, w_out, b_out,
        out, num_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

template <bool kLayer, typename T>
int dispatch_sums_bf16(const T* q, int ldq, const T* kv, int ldkv, const int* tile_senders,
                       const int* tile_valid, const int* recv_ptr, const int* recv_slots,
                       const float* invdeg, const T* w_out, const T* b_out,
                       SumsOut<kLayer, T>* out, int num_nodes, int s, int sp, int d,
                       int num_heads, int softmax, cudaStream_t stream, int* info) {
  if (!wide_shape_ok(s, d, num_heads) || (kLayer && s > 48)) return (int)cudaErrorInvalidValue;
#define AMPNET_SUMS_BF16_CASE(N)                                                            \
  case N:                                                                                   \
    return launch_sums_bf16<N, kLayer, T>(q, ldq, kv, ldkv, tile_senders, tile_valid,       \
                                          recv_ptr, recv_slots, invdeg, w_out, b_out, out,  \
                                          num_nodes, s, sp, d, num_heads, softmax, stream,  \
                                          info);
  switch ((s + 7) / 8) {
    AMPNET_SUMS_BF16_CASE(1) AMPNET_SUMS_BF16_CASE(2) AMPNET_SUMS_BF16_CASE(3)
    AMPNET_SUMS_BF16_CASE(4) AMPNET_SUMS_BF16_CASE(5) AMPNET_SUMS_BF16_CASE(6)
  }
  if constexpr (!kLayer) {
    switch ((s + 7) / 8) { AMPNET_SUMS_BF16_CASE(7) AMPNET_SUMS_BF16_CASE(8) }
  }
#undef AMPNET_SUMS_BF16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
