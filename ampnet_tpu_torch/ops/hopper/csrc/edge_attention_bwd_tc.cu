// K4 on Hopper's tensor cores: pass S of the scatter-free backward, the
// per-sender sums dK = dS^T Q / sqrt(dh) and dV = W^T dMsg over live
// out-edges, f32 in 3xTF32 (mma_tf32.cuh), with the next edges' gathers in
// flight.
//
// Replaces the TPU kernels of ampnet_tpu/ops/pallas/
// edge_attention_bwd_scatterfree.py _dkv_kernel_vmem (:280) and
// _dkv_kernel_dma (:319), math _dkv_group_math (:105): per edge, recompute
// the scores and the softmax, dW = dMsg V^T, the softmax backward dS = W (dW
// - rowsum(dW W)) (dS = dW and W the raw scaled scores with softmax=0), then
// dV = W^T dMsg and dK = dS^T Q / sqrt(dh), summed per SENDER. Beyond the
// instantiated range the wrapper routes to K4's CUDA-core body,
// ampnet_edge_attention_bwd_dkv_simt in edge_attention_bwd.cu.
//
// Bound (H100 SXM): 8*S^2*D FLOP per live edge (16.9 GFLOP at the S=40 Cora
// shapes, 0.25 ms at the 67 TFLOP/s f32 rate) against ~338 MB (0.10 ms at
// 3.35 TB/s): bound by operations at the f32 rate. The predecessor read 2
// shared-memory words per 8 FMAs in its last products, held one block of
// 174.7 KB per SM and gathered each edge's rows synchronously. Here:
//
// * One warp per (head, 16-row key tile of the block's own sender): 12 warps
//   at S=40, 8 at S=20. The warp's K rows (pre-scaled by 1/sqrt(dh)) and V
//   rows are A fragments loaded once per sender and kept, as f32, in shared
//   memory by the lane that owns them (split into TF32 hi/lo once per edge
//   and 8 columns; in registers they cost spills); its 16 x dh sums of dK
//   and dV stay in registers. Each warp splits the B elements it reads; a
//   pass that split each landed stage once per block (one more barrier per
//   edge) was slower on an H100.
// * Per edge the warp forms S^T = K Q^T / sqrt(dh) and dW^T = V dMsg^T (keys
//   x queries) on mma.sync with the receiver's [Q | dMsg] rows as B. The
//   softmax runs over keys, the M dimension, which spans the head's 2 (S=20)
//   or 3 (S=40) warps: the per-query max, then the sums of e = exp(s - max)
//   and of dW e, are reduced across the quad's rows with __shfl_xor 4, 8, 16
//   and across the head's warps through a small shared scratch and a named
//   barrier per head (bar.sync 1 + head, 32 x warps per head); rowsum(dW W)
//   is sum(dW e) / sum(e). The partials are added in warp order, so every
//   warp of the head gets the same numbers.
// * dV += W^T dMsg and dK += dS^T Q: the S^T / dS^T C fragments are the A
//   fragments (c_as_a), dMsg and Q the B fragments, read from the ring at
//   queries 2t and 2t + 1.
// * The alternative, S query-major as K3 takes it with W and dS staged in
//   shared memory for the transposed products, needs ~61 KB more shared
//   memory at S=40 and two more block barriers per edge; this design keeps
//   everything per edge in registers.
// * Shared memory holds the ring of gathered [Q | dMsg] rows (2 or 3 stages
//   of S x 2D f32, row stride 2D + 4), filled with 16-byte cp.async.cg one
//   commit group per edge, and the scratch. A persistent grid walks senders
//   n = blockIdx.x, + gridDim.x, ..., the ring across sender boundaries.
// * Each sender's rows are summed by one block in slot order: no atomics,
//   bit-reproducible.
//
// Trouble spots: pad key rows of a 16-row tile (the NEXT node's rows) are
// read as 0, scored -inf in the softmax and never written; pad query rows
// of the last 8-query tile are read as 0 (their W is finite and meets a 0
// dMsg row, their dS is 0); rows S..SP-1 of the output are written as 0;
// dh not a multiple of 8 is zero-padded within the head. Instantiated for
// S <= 48 (NQT = ceil(S/8) query tiles), dh <= 32 and at most 12 warps (8
// up to S=24), and for 48 < S <= 64 with dh a multiple of 8, below; the
// wrapper routes other shapes to the CUDA-core body.
//
// 48 < S <= 64 (path J's S=64): a block of every head would take 16 warps
// at H=4 and, at 201 KB of shared memory already at S=48, not fit. The
// grid is (senders, heads) instead: a block takes one head of a sender, its
// 4 key tiles (4 warps), so the softmax over keys stays within the block's
// warps, and it gathers only that head's columns of the receivers' [Q |
// dMsg] (S x 2dh, row stride 2dh + 4), so the bytes read stay those of
// every head once. At S=64, dh=32: 17 KB a stage, 16 KB of K|V fragments,
// 1.5 KB of scratch. The 16 x 64 tiles S^T and dW^T (64 registers) spilled
// in one pass even at 255 registers, so the queries run in two groups of 4
// tiles (two pairs of head barriers an edge; dV's and dK's sums over the
// queries keep their order); registers capped at 168, 3 blocks of 128
// threads per SM. Each
// (sender, head) is summed by one block in slot order: bit-reproducible.

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;

__device__ __forceinline__ void head_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float quad_rows_max(float v) {  // over g (lane bits 2-4)
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

__device__ __forceinline__ float quad_rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// up to S=24 (at most 8 warps) the registers are capped for two blocks per
// SM; at S > 48, blocks of one head, three per SM
template <int NQT>
__global__ void __launch_bounds__(NQT > 6 ? kWideThreads : NQT <= 3 ? 256 : kMaxThreads,
                                  NQT > 6 ? 3 : NQT <= 3 ? 2 : 1)
dkv_tc_kernel(const float* __restrict__ qdm, int ldqdm, const float* __restrict__ kv,
              int ldkv, const int* __restrict__ snd_receivers,
              const int* __restrict__ snd_valid, const int* __restrict__ snd_ptr,
              const int* __restrict__ snd_slots, float* __restrict__ dkv, int num_nodes,
              int s, int sp, int d, int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) float smem[];
  // query tiles a pass: all up to S=48; beyond, groups of 4 (the 16 x 64
  // tiles S^T and dW^T in one pass spilled at 255 registers)
  constexpr int kQG = NQT > 6 ? 4 : NQT;
  constexpr int kCols = 8 * kQG;  // query columns of the scratch
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  constexpr bool kWide = NQT > 6;  // a block of one head, blockIdx.y
  const int bh = kWide ? 0 : warp / mtiles, mt = warp % mtiles;  // the warp's head in the block
  const int dh = d / num_heads;
  const int heads = kWide ? 1 : num_heads;
  const int hc = (kWide ? blockIdx.y : bh) * dh;  // the warp's head, first column
  const int gw = kWide ? dh : d;  // the block's columns of Q (and of dMsg)
  const int ldr = 2 * gw + 4;
  const int stage_floats = s * ldr;
  const int k0 = 16 * mt;  // the warp's first key row
  const float scale = 1.0f / sqrtf((float)dh);
  // [8][threads] float4: each lane's own K and V fragments; the ring; the
  // scratch [3][heads][mtiles][kCols]: max, sum(e), sum(dW e) partials
  float4* kvfrag = reinterpret_cast<float4*>(smem) + threadIdx.x;
  float* ring = smem + 32 * blockDim.x;
  const int nred = heads * mtiles * kCols;
  float* rmax = ring + stages * stage_floats + bh * mtiles * kCols;
  float* rsum = rmax + nred;
  float* rdot = rsum + nred;
  const int bar_id = 1 + bh, bar_threads = 32 * mtiles;

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(snd_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(snd_ptr, snd_slots, snd_valid, num_nodes);
    if (slot >= 0)
      fill_heads(ring + i * stage_floats, ldr, qdm, (size_t)snd_receivers[slot] * sp, ldqdm, s,
                 d, (kWide ? hc : 0), gw);
    cp_async_commit();
  }
  int stage = 0;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
    const int r0 = k0 + g, r1 = r0 + 8;
    // A fragments of K / sqrt(dh) and of V, kept in shared memory by the
    // lane that owns them (registers decide the blocks per SM)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = 8 * kk + t, c1 = c0 + 4;
      const float* p0 = kv + (own0 + r0) * ldkv + hc;
      const float* p1 = kv + (own0 + r1) * ldkv + hc;
      kvfrag[kk * blockDim.x] = make_float4(r0 < s && c0 < dh ? p0[c0] * scale : 0.0f,
                                            r1 < s && c0 < dh ? p1[c0] * scale : 0.0f,
                                            r0 < s && c1 < dh ? p0[c1] * scale : 0.0f,
                                            r1 < s && c1 < dh ? p1[c1] * scale : 0.0f);
      kvfrag[(4 + kk) * blockDim.x] = make_float4(r0 < s && c0 < dh ? p0[d + c0] : 0.0f,
                                                  r1 < s && c0 < dh ? p1[d + c0] : 0.0f,
                                                  r0 < s && c1 < dh ? p0[d + c1] : 0.0f,
                                                  r1 < s && c1 < dh ? p1[d + c1] : 0.0f);
    }
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nn][e] = dv[nn][e] = 0.0f;

    const int end = snd_ptr[n + 1];
    for (int k = snd_ptr[n]; k < end; ++k) {
      const int valid = snd_valid[snd_slots[k]];
      if (valid == 0) continue;  // the same for every thread of the block
      cp_async_wait(stages - 2);
      __syncthreads();  // this edge's stage has landed; the previous one is free
      const float* qr = ring + stage * stage_floats + (kWide ? 0 : hc);
      const float* mr = qr + gw;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      // the queries in groups of kQG tiles (one group up to S=48): per group
      // S^T and dW^T, the softmax over keys, then dV and dK, whose sums over
      // queries run in the same order as in one pass
      auto query_group = [&](int j0) {
        // S^T and dW^T: 16 keys x 8*kQG queries
        float st[kQG][4], dw[kQG][4];
#pragma unroll
        for (int j = 0; j < kQG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dw[j][e] = 0.0f;
#pragma unroll 1  // unrolled, NQT = 5 and 6 spill at 168 registers
        for (int kk = 0; kk < 4; ++kk) {
          if (8 * kk >= dh) break;
          const FragA ak = split_a(kvfrag[kk * blockDim.x]);
          const FragA av = split_a(kvfrag[(4 + kk) * blockDim.x]);
          const int c0 = 8 * kk + t, c1 = c0 + 4;
#pragma unroll
          for (int j = 0; j < kQG; ++j) {
            const int qi = 8 * (j0 + j) + g;  // past s (the last group's tail): read as 0
            const float* qp = qr + qi * ldr;
            const float* mp = mr + qi * ldr;
            mma_3xtf32(st[j], ak, split_b(qi < s && c0 < dh ? qp[c0] : 0.0f,
                                          qi < s && c1 < dh ? qp[c1] : 0.0f));
            mma_3xtf32(dw[j], av, split_b(qi < s && c0 < dh ? mp[c0] : 0.0f,
                                          qi < s && c1 < dh ? mp[c1] : 0.0f));
          }
        }

        if (j0 == 0) {  // the gather of the edge stages - 1 ahead, while the products run
          const int slot = prod.next(snd_ptr, snd_slots, snd_valid, num_nodes);
          if (slot >= 0)
            fill_heads(ring + free_stage * stage_floats, ldr, qdm,
                       (size_t)snd_receivers[slot] * sp, ldqdm, s, d, (kWide ? hc : 0), gw);
          cp_async_commit();
        }

        const float w = (float)valid;
        if (softmax) {  // per query column (C columns 2t + e), over the head's keys
          if (r0 >= s)
#pragma unroll
            for (int j = 0; j < kQG; ++j) st[j][0] = st[j][1] = -INFINITY;
          if (r1 >= s)
#pragma unroll
            for (int j = 0; j < kQG; ++j) st[j][2] = st[j][3] = -INFINITY;
#pragma unroll
          for (int j = 0; j < kQG; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float m = quad_rows_max(fmaxf(st[j][e], st[j][2 + e]));
              if (g == 0) rmax[mt * kCols + 8 * j + 2 * t + e] = m;
            }
          head_barrier(bar_id, bar_threads);
#pragma unroll
          for (int j = 0; j < kQG; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t + e;
              float mx = rmax[col];
              for (int u = 1; u < mtiles; ++u) mx = fmaxf(mx, rmax[u * kCols + col]);
              st[j][e] = expf(st[j][e] - mx);
              st[j][2 + e] = expf(st[j][2 + e] - mx);
              const float sum = quad_rows_sum(st[j][e] + st[j][2 + e]);
              const float dot =
                  quad_rows_sum(fmaf(dw[j][e], st[j][e], dw[j][2 + e] * st[j][2 + e]));
              if (g == 0) {
                rsum[mt * kCols + col] = sum;
                rdot[mt * kCols + col] = dot;
              }
            }
          head_barrier(bar_id, bar_threads);
#pragma unroll
          for (int j = 0; j < kQG; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t + e;
              float sum = rsum[col], dot = rdot[col];
              for (int u = 1; u < mtiles; ++u) {
                sum += rsum[u * kCols + col];
                dot += rdot[u * kCols + col];
              }
              dot = dot / sum;  // rowsum(dW W) of this query
              const float inv = 1.0f / sum;
#pragma unroll
              for (int r = 0; r < 4; r += 2) {
                const float wt = st[j][r + e] * inv;
                st[j][r + e] = wt * w;
                dw[j][r + e] = wt * (dw[j][r + e] - dot) * w;
              }
            }
        } else {
#pragma unroll
          for (int j = 0; j < kQG; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              st[j][e] *= w;
              dw[j][e] *= w;
            }
        }

        // dV += W^T dMsg, dK += dS^T Q (1/sqrt(dh) applied once, at the end)
#pragma unroll
        for (int j = 0; j < kQG; ++j) {
          const FragA aw = c_as_a(st[j]);
          const FragA as = c_as_a(dw[j]);
          const int qi = 8 * (j0 + j) + 2 * t;
          const float* q0 = qr + qi * ldr;
          const float* m0 = mr + qi * ldr;
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            if (8 * nn >= dh) break;
            const int c = 8 * nn + g;
            mma_3xtf32(dv[nn], aw, split_b(qi < s && c < dh ? m0[c] : 0.0f,
                                           qi + 1 < s && c < dh ? m0[ldr + c] : 0.0f));
            mma_3xtf32(dk[nn], as, split_b(qi < s && c < dh ? q0[c] : 0.0f,
                                           qi + 1 < s && c < dh ? q0[ldr + c] : 0.0f));
          }
        }
      };
      if constexpr (NQT > 6) {
#pragma unroll 1
        for (int j0 = 0; j0 < NQT; j0 += kQG) query_group(j0);
      } else {
        query_group(0);
      }
    }

    float* orow = dkv + own0 * 2 * d + hc;
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      if (8 * nn >= dh) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, c = 8 * nn + 2 * t + (e & 1);
        if (r < s && c < dh) {
          orow[(size_t)r * 2 * d + c] = dk[nn][e] * scale;
          orow[(size_t)r * 2 * d + d + c] = dv[nn][e];
        }
      }
    }
    float* pad = dkv + own0 * 2 * d;
    if (!kWide || blockIdx.y == 0)
      for (int e = s * 2 * d + threadIdx.x; e < sp * 2 * d; e += blockDim.x) pad[e] = 0.0f;
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per sender
// and head group), or, with info, what it would run with.
template <int NQT>
int launch(const float* qdm, int ldqdm, const float* kv, int ldkv, const int* snd_receivers,
           const int* snd_valid, const int* snd_ptr, const int* snd_slots, float* dkv,
           int num_nodes, int s, int sp, int d, int num_heads, int softmax,
           cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int heads = block_heads(s, num_heads);
  const int threads = 32 * heads * ((s + 15) / 16);
  // K and V fragments, the scratch
  const size_t fixed = (size_t)threads * 32 * sizeof(float) +
                       (size_t)3 * (threads / 32) * 8 * (NQT > 6 ? 4 : NQT) * sizeof(float);
  const int err = ring_plan(dkv_tc_kernel<NQT>, threads, s, heads * (d / num_heads), fixed, plan);
  if (err) return err;
  const dim3 grid = ring_grid(plan, num_nodes, num_heads / heads);
  if (info) return ring_info(dkv_tc_kernel<NQT>, plan, grid.x * grid.y, info);
  if (grid.x > 0)
    dkv_tc_kernel<NQT><<<grid, threads, plan.smem, stream>>>(
        qdm, ldqdm, kv, ldkv, snd_receivers, snd_valid, snd_ptr, snd_slots, dkv, num_nodes, s,
        sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch(const float* qdm, int ldqdm, const float* kv, int ldkv, const int* snd_receivers,
             const int* snd_valid, const int* snd_ptr, const int* snd_slots, float* dkv,
             int num_nodes, int s, int sp, int d, int num_heads, int softmax,
             cudaStream_t stream, int* info) {
  if (!wide_shape_ok(s, d, num_heads)) return (int)cudaErrorInvalidValue;
#define AMPNET_K4_CASE(N)                                                                   \
  case N:                                                                                   \
    return launch<N>(qdm, ldqdm, kv, ldkv, snd_receivers, snd_valid, snd_ptr, snd_slots, dkv, \
                     num_nodes, s, sp, d, num_heads, softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_K4_CASE(1) AMPNET_K4_CASE(2) AMPNET_K4_CASE(3)
    AMPNET_K4_CASE(4) AMPNET_K4_CASE(5) AMPNET_K4_CASE(6)
    AMPNET_K4_CASE(7) AMPNET_K4_CASE(8)
  }
#undef AMPNET_K4_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K4. qdm: rows of q|dsum (2d floats, stride ldqdm, both 16-byte aligned);
// kv: rows of k|v (2d floats, stride ldkv); snd_receivers / snd_valid over
// the sender-tiled slots, snd_ptr / snd_slots the sender-major index; dkv:
// [num_nodes*sp, 2d] contiguous rows of dk|dv. d / num_heads <= 32; S <= 48
// with num_heads * ceil(S/16) <= 12 (8 up to S=24), or 48 < S <= 64 with
// d / num_heads a multiple of 8.
int ampnet_edge_attention_bwd_dkv(const float* qdm, int ldqdm, const float* kv, int ldkv,
                                  const int* snd_receivers, const int* snd_valid,
                                  const int* snd_ptr, const int* snd_slots, float* dkv,
                                  int num_nodes, int s, int sp, int d, int num_heads,
                                  int softmax, void* stream) {
  return dispatch(qdm, ldqdm, kv, ldkv, snd_receivers, snd_valid, snd_ptr, snd_slots, dkv,
                  num_nodes, s, sp, d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What a K4 launch would run with, without launching (info as
// ampnet_edge_attention_sums_info).
int ampnet_edge_attention_bwd_dkv_info(int num_nodes, int s, int d, int num_heads, int* info) {
  return dispatch(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                  num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
