// The per-receiver walk on Hopper's tensor cores that K1 (edge_attention_tc.cu,
// the per-receiver sums) and K2's attention launch (edge_attention_layer_tc.cu,
// the whole layer) share: f32 in 3xTF32 (mma_tf32.cuh), with the next edges'
// gathers in flight. One kernel template; kLayer adds K2's two steps. Its
// per-edge steps (Q's fragments, the score tile, the softmax and P V) are
// device functions that the edge-group kernel (edge_attention_groups_tc.cu,
// K6 and K9) calls too.
//
// Per receiver, the SUM over live in-edges of the multi-head message
// softmax(Q K^T / sqrt(dh)) V (raw scaled scores with softmax=0); with kLayer
// each edge is pre-scaled by the receiver's 1/degree (the sum is the MEAN),
// and the epilogue takes mean @ w_out and adds b_out on live rows.
//
// Bound (H100 SXM): 4*S^2*D FLOP per live edge (8.5 GFLOP at the S=40 Cora
// shapes, 0.13 ms at the 67 TFLOP/s f32 rate) against ~226 MB of compulsory
// traffic (0.07 ms at 3.35 TB/s): bound by operations at the f32 rate. The
// CUDA-core body (edge_attention.cu) is held back by shared-memory loads (6
// words per 8 FMAs), by residency (107.8 KB of shared memory a block) and by
// a synchronous 40 KB gather at the start of every edge. Here:
//
// * One warp per (head, 16-row query tile): 12 warps at S=40, 8 at S=20.
//   Per edge the warp takes the 16 x S score tile on mma.sync m16n8k8 into
//   registers, the row softmax there (max and sum over the thread's values,
//   then across the quad with __shfl_xor 1 and 2; expf), and adds P V into
//   its 16 x dh output accumulator O, also in registers. The score tile's C
//   fragment is P V's A fragment with no shuffle (mma_tf32.cuh), so V's B
//   fragment reads keys 2t and 2t + 1. Q's fragments are loaded once per
//   receiver, scaled by 1/sqrt(dh), and kept as f32: splitting them into
//   TF32 hi/lo costs 48 instructions an edge, and 16 more registers would
//   cost the second block per SM.
// * Shared memory holds a ring of 2 or 3 stages of gathered K|V rows (S x
//   2D f32, row stride 2D + 4 so that both fragment patterns are free of
//   bank conflicts at D = 128 and 100), filled with 16-byte cp.async.cg and
//   one commit group per edge: the next edges' rows are in flight while the
//   current edge computes, and one __syncthreads per edge both publishes a
//   stage and frees the previous one. The launch picks 3 stages unless 2
//   keep more blocks on an SM.
// * A persistent grid (blocks per SM x SMs, from the occupancy of the
//   instantiation) walks receivers n = blockIdx.x, + gridDim.x, ...; the
//   ring runs across receiver boundaries, so receivers of in-degree 0-4 do
//   not drain the pipeline. A slot masked at run time is never gathered.
// * Each receiver's rows are summed by one block in in-edge order: no
//   atomics, bit-reproducible.
// * kLayer, the epilogue (K2): the out-projection needs every head's
//   columns of a row, which live in other warps. The warps stage the S x D
//   mean in shared memory beside the ring (the ring already carries the
//   next receiver's gathers), then each warp takes its query tile's rows
//   times w_out for the 8-column output tiles head, head + H, ... on
//   mma.sync in 3xTF32, reading w_out (64 KB at D=128, resident in L2)
//   from global memory. kStageW instead stages w_out in shared memory once
//   per block (row stride D + 8: free of bank conflicts), which costs the
//   second block per SM at S=20; chip_smoke.py times the two in turns. Two
//   block barriers per live receiver. A receiver of degree 0 (the runtime
//   mask's degree: invdeg 0) writes exact zeros without the product.
//
// Trouble spots: pad query rows (rows S .. of a 16-row tile are the NEXT
// node's rows in q) are read as 0 and never written; rows S..SP-1 of the
// output are written as 0. Pad keys of the last 8-key tile (the sender's pad
// token rows, which hold the projection's bias) are not read: their scores
// are -inf before the softmax and their values 0. Head widths that are not
// a multiple of 8 (D=100, H=4: dh=25) are zero-padded within the head.
// Instantiated for S <= 48 (NKT = ceil(S/8) key tiles), dh <= 32 and at most
// 12 warps (8 up to S=24, K4's rule), and for K1 alone (not K2, K6, K9) at
// 48 < S <= 64 (NKT = 7, 8), below; the wrappers route other shapes to the
// CUDA-core bodies, and rows the 16-byte copies cannot take as well.
//
// K1 at 48 < S <= 64 (path J's S=64): a block of every head would take 16
// warps at H=4, one block per SM, and a ring of 64 KB an edge. Instead the
// grid is (receivers, heads): a block takes one head of a receiver (4 warps,
// its 4 query tiles) and gathers only that head's columns of K|V (S x 2dh,
// row stride 2dh + 4: free of bank conflicts at dh = 32, as 2D + 4 at D =
// 128), so the bytes read stay those of every head once. At S=64, dh=32 a
// stage is 17 KB; the registers are capped at 168 a thread (3 blocks of 128
// threads per SM: at 128 S = 49-56 spilled); a warp's 16 x 64 score tile is
// sc[8][4].
// A receiver's rows of one head are summed by one block in in-edge order:
// still no atomics, bit-reproducible.
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;

// ---- the per-edge steps of one warp (head hc.., query rows r0 = m0 + g and
// r1 = r0 + 8 of its 16-row tile), shared with the edge-group kernel
// (edge_attention_groups_tc.cu)

// A fragments of Q / sqrt(dh) of node row block qrow0, one per 8 head
// columns, into the lane's own slots of qfrag (rows past s and columns past
// dh read as 0: the next node's rows are never read)
__device__ __forceinline__ void load_q_frags(float4* qfrag, const float* __restrict__ q,
                                             size_t qrow0, int ldq, int hc, int r0, int r1,
                                             int s, int dh, int t, float scale) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c0 = 8 * kk + t, c1 = c0 + 4;
    const float* q0 = q + (qrow0 + r0) * ldq + hc;
    const float* q1 = q + (qrow0 + r1) * ldq + hc;
    qfrag[kk * blockDim.x] = make_float4(r0 < s && c0 < dh ? q0[c0] * scale : 0.0f,
                                         r1 < s && c0 < dh ? q1[c0] * scale : 0.0f,
                                         r0 < s && c1 < dh ? q0[c1] * scale : 0.0f,
                                         r1 < s && c1 < dh ? q1[c1] * scale : 0.0f);
  }
}

// sc = the 16 queries x 8*NKT keys score tile against the keys kr (a ring
// stage at the warp's head column, row stride ldr)
template <int NKT>
__device__ __forceinline__ void score_tile(float (&sc)[NKT][4], const float4* qfrag,
                                           const float* kr, int ldr, int s, int dh, int g,
                                           int t) {
#pragma unroll
  for (int j = 0; j < NKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll 1  // unrolled, the fragments of all k-steps stay live: spills
  for (int kk = 0; kk < 4; ++kk) {
    if (8 * kk >= dh) break;
    const FragA a = split_a(qfrag[kk * blockDim.x]);
    const int c0 = 8 * kk + t, c1 = c0 + 4;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      const int key = 8 * j + g;
      const float* kp = kr + key * ldr;
      mma_3xtf32(sc[j], a, split_b(key < s && c0 < dh ? kp[c0] : 0.0f,
                                   key < s && c1 < dh ? kp[c1] : 0.0f));
    }
  }
}

// The row softmax of sc times w (with softmax=0 the raw scores times w),
// then o += P V against the values vr (the ring stage's V half)
template <int NKT>
__device__ __forceinline__ void softmax_pv(float (&sc)[NKT][4], float (&o)[4][4],
                                           const float* vr, int ldr, int s, int dh, int g,
                                           int t, float w, int softmax) {
  if (softmax) {  // rows g (sc[j][0..1]) and g + 8 (sc[j][2..3])
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
    const float inv0 = w / sum0, inv1 = w / sum1;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
      sc[j][0] *= inv0;
      sc[j][1] *= inv0;
      sc[j][2] *= inv1;
      sc[j][3] *= inv1;
    }
  } else {  // pad keys scored 0 (their rows read as 0)
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= w;
  }

  // O += P V: P's A fragment is the score tile's C fragment
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    const FragA a = c_as_a(sc[j]);
    const int key = 8 * j + 2 * t;
    const float* v0 = vr + key * ldr;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      if (8 * nn >= dh) break;
      const int c = 8 * nn + g;
      mma_3xtf32(o[nn], a, split_b(key < s && c < dh ? v0[c] : 0.0f,
                                   key + 1 < s && c < dh ? v0[ldr + c] : 0.0f));
    }
  }
}

// Two blocks of up to 384 threads per SM leave 80 registers a thread: enough
// without spills for S <= 24 and S = 33-40 (NKT = 1-3, 5), not for S = 25-32
// and 41-48 (NKT = 4, 6), which get one block per SM (ptxas, on sm_90a). With
// kLayer at S = 33-40 the staged mean leaves room for one block anyway (and
// at 80 registers it spilled).
// At NKT = 7, 8 (K1 only) blocks of one head, registers capped for 3 per SM
// (at 4, 128 registers, S = 49-56 spilled).
template <int NKT, bool kLayer, bool kStageW = false>
__global__ void __launch_bounds__(NKT > 6 ? kWideThreads : kMaxThreads,
                                  NKT > 6 ? 3
                                          : NKT == 4 || NKT == 6 || (kLayer && NKT == 5) ? 1 : 2)
sums_tc_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ kv,
               int ldkv, const int* __restrict__ tile_senders,
               const int* __restrict__ tile_valid, const int* __restrict__ recv_ptr,
               const int* __restrict__ recv_slots, const float* __restrict__ invdeg,
               const float* __restrict__ w_out, const float* __restrict__ b_out,
               float* __restrict__ out, int num_nodes, int s, int sp, int d, int num_heads,
               int softmax, int stages) {
  extern __shared__ __align__(16) float smem[];
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
  const float scale = 1.0f / sqrtf((float)dh);
  // [4][threads] float4: each lane's own Q fragments; with kLayer the
  // staged mean [16 * mtiles][d + 4]; with kStageW w_out [d][d + 8]; then
  // the ring
  float4* qfrag = reinterpret_cast<float4*>(smem) + threadIdx.x;
  const int ldm = d + 4, ldw = d + 8;
  float* mean = smem + 16 * blockDim.x;
  float* wsm = mean + (kLayer ? 16 * mtiles * ldm : 0);
  float* ring = wsm + (kStageW ? d * ldw : 0);
  const int ldr = 2 * gw + 4;
  const int stage_floats = s * ldr;
  if (kStageW)  // read after the epilogue's first barrier
    for (int e = threadIdx.x; e < d * d; e += blockDim.x) wsm[(e / d) * ldw + e % d] = w_out[e];

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(recv_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
    if (slot >= 0)
      fill_heads(ring + i * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s, d,
                 hc - rc, gw);
    cp_async_commit();
  }
  int stage = 0;  // the stage of the next live edge

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t qrow0 = (size_t)n * sp;
    const int r0 = m0 + g, r1 = r0 + 8;
    const float inv_n = kLayer ? invdeg[n] : 1.0f;
    // A fragments of Q / sqrt(dh), kept in shared memory by the lane that
    // owns them (registers decide the blocks per SM)
    load_q_frags(qfrag, q, qrow0, ldq, hc, r0, r1, s, dh, t, scale);
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
      const float* kr = ring + stage * stage_floats + rc;
      const float* vr = kr + gw;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4];  // scores: 16 queries x 8*NKT keys
      score_tile<NKT>(sc, qfrag, kr, ldr, s, dh, g, t);

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (slot >= 0)
          fill_heads(ring + free_stage * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp,
                     ldkv, s, d, hc - rc, gw);
        cp_async_commit();
      }

      softmax_pv<NKT>(sc, o, vr, ldr, s, dh, g, t, (float)valid * inv_n, softmax);
    }

    float* orow = out + qrow0 * d;
    if (!kLayer) {
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
      for (int e = threadIdx.x; e < s * d; e += blockDim.x) orow[e] = 0.0f;
    } else {
      __syncthreads();  // every warp is done with the previous receiver's mean
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        if (8 * nn >= dh) break;
        const int c = 8 * nn + 2 * t;
        float* m_0 = mean + (m0 + g) * ldm + hc;
        float* m_1 = m_0 + 8 * ldm;
        if (c < dh) m_0[c] = o[nn][0], m_1[c] = o[nn][2];
        if (c + 1 < dh) m_0[c + 1] = o[nn][1], m_1[c + 1] = o[nn][3];
      }
      __syncthreads();
      // out rows of this warp's query tile x the 8-column tiles head, head + H,
      // ...; w_out's B values of the next k-step load while this one multiplies
      // (the edge loop's tiles are dead: the registers are free)
      const int ntiles = (d + 7) / 8, ksteps = (d + 7) / 8;
      float wb[4][2];
      auto load_w = [&](int kk) {
        const int c0 = 8 * kk + t, c1 = c0 + 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * (head + i * num_heads) + g;
          if (kStageW) {
            wb[i][0] = c0 < d && c < d ? wsm[c0 * ldw + c] : 0.0f;
            wb[i][1] = c1 < d && c < d ? wsm[c1 * ldw + c] : 0.0f;
          } else {
            wb[i][0] = c0 < d && c < d ? __ldg(w_out + (size_t)c0 * d + c) : 0.0f;
            wb[i][1] = c1 < d && c < d ? __ldg(w_out + (size_t)c1 * d + c) : 0.0f;
          }
        }
      };
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
      load_w(0);
#pragma unroll 1
      for (int kk = 0; kk < ksteps; ++kk) {
        const int c0 = 8 * kk + t, c1 = c0 + 4;
        const float* a0 = mean + (m0 + g) * ldm;
        const float* a1 = a0 + 8 * ldm;
        const FragA a = split_a(c0 < d ? a0[c0] : 0.0f, c0 < d ? a1[c0] : 0.0f,
                                c1 < d ? a0[c1] : 0.0f, c1 < d ? a1[c1] : 0.0f);
        FragB b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = split_b(wb[i][0], wb[i][1]);
        if (kk + 1 < ksteps) load_w(kk + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (head + i * num_heads >= ntiles) break;
          mma_3xtf32(o[i], a, b[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = head + i * num_heads;
        if (nt >= ntiles) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = 8 * nt + 2 * t + (e & 1);
          if (r < s && c < d) orow[r * d + c] = o[i][e] + b_out[c];
        }
      }
    }
    if (!kWide || blockIdx.y == 0)
      for (int e = s * d + threadIdx.x; e < sp * d; e += blockDim.x) orow[e] = 0.0f;
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per receiver
// and head group), or, with info, what it would run with.
template <int NKT, bool kLayer, bool kStageW>
int launch_sums_tc(const float* q, int ldq, const float* kv, int ldkv, const int* tile_senders,
                   const int* tile_valid, const int* recv_ptr, const int* recv_slots,
                   const float* invdeg, const float* w_out, const float* b_out, float* out,
                   int num_nodes, int s, int sp, int d, int num_heads, int softmax,
                   cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int heads = block_heads(s, num_heads);
  const int threads = 32 * heads * ((s + 15) / 16);
  // Q fragments, with kLayer the staged mean, with kStageW w_out
  const size_t fixed = (size_t)threads * 16 * sizeof(float) +
                       (kLayer ? (size_t)16 * ((s + 15) / 16) * (d + 4) * sizeof(float) : 0) +
                       (kStageW ? (size_t)d * (d + 8) * sizeof(float) : 0);
  const int err = ring_plan(sums_tc_kernel<NKT, kLayer, kStageW>, threads, s,
                            heads * (d / num_heads), fixed, plan);
  if (err) return err;
  const dim3 grid = ring_grid(plan, num_nodes, num_heads / heads);
  if (info) return ring_info(sums_tc_kernel<NKT, kLayer, kStageW>, plan, grid.x * grid.y, info);
  if (grid.x > 0)
    sums_tc_kernel<NKT, kLayer, kStageW><<<grid, threads, plan.smem, stream>>>(
        q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, invdeg, w_out, b_out,
        out, num_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

template <bool kLayer, bool kStageW = false>
int dispatch_sums_tc(const float* q, int ldq, const float* kv, int ldkv,
                     const int* tile_senders, const int* tile_valid, const int* recv_ptr,
                     const int* recv_slots, const float* invdeg, const float* w_out,
                     const float* b_out, float* out, int num_nodes, int s, int sp, int d,
                     int num_heads, int softmax, cudaStream_t stream, int* info) {
  if (!wide_shape_ok(s, d, num_heads) || (kLayer && s > 48)) return (int)cudaErrorInvalidValue;
#define AMPNET_SUMS_TC_CASE(N)                                                               \
  case N:                                                                                    \
    return launch_sums_tc<N, kLayer, kStageW>(q, ldq, kv, ldkv, tile_senders, tile_valid,    \
                                              recv_ptr, recv_slots, invdeg, w_out, b_out, out, \
                                              num_nodes, s, sp, d, num_heads, softmax, stream, \
                                              info);
  switch ((s + 7) / 8) {
    AMPNET_SUMS_TC_CASE(1) AMPNET_SUMS_TC_CASE(2) AMPNET_SUMS_TC_CASE(3)
    AMPNET_SUMS_TC_CASE(4) AMPNET_SUMS_TC_CASE(5) AMPNET_SUMS_TC_CASE(6)
  }
  if constexpr (!kLayer) {
    switch ((s + 7) / 8) { AMPNET_SUMS_TC_CASE(7) AMPNET_SUMS_TC_CASE(8) }
  }
#undef AMPNET_SUMS_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace
