// K3 on Hopper's tensor cores: pass R of the scatter-free backward, the
// per-receiver sums dQ = dS K / sqrt(dh) over live in-edges, f32 in 3xTF32
// (mma_tf32.cuh), with the next edges' gathers in flight.
//
// Replaces the TPU kernels of ampnet_tpu/ops/pallas/
// edge_attention_bwd_scatterfree.py _dq_kernel_vmem (:167) and _dq_kernel_dma
// (:211), math _dq_group_math (:61): per edge, recompute the scores and the
// softmax, dW = dMsg V^T, the softmax backward dS = W (dW - rowsum(dW W)) (dS
// = dW with softmax=0), then dQ = dS K / sqrt(dh), summed per RECEIVER.
// Beyond the instantiated range the wrapper routes to K3's CUDA-core body,
// ampnet_edge_attention_bwd_dq_simt in edge_attention_bwd.cu. K5's
// tensor-core body (edge_attention_bwd_stream_tc.cu) runs the same per-edge
// steps: the softmax backward and the dQ store below are device functions
// of edge_attention_bwd_dq_tc.cuh, which also repeats the two product loops
// that stay inline here (see there why).
//
// Bound (H100 SXM): 6*S^2*D FLOP per live edge (12.7 GFLOP at the S=40 Cora
// shapes, 0.19 ms at the 67 TFLOP/s f32 rate) against ~282 MB (0.08 ms at
// 3.35 TB/s): bound by operations at the f32 rate. The CUDA-core body reads
// shared memory for every FMA, holds one block of 512 threads per SM and
// gathers each edge's rows synchronously. Here K1's receiver design
// (edge_attention_tc.cuh):
//
// * One warp per (head, 16-row query tile of the receiver): 12 warps at
//   S=40, 8 at S=20. The warp's Q rows (pre-scaled by 1/sqrt(dh)) and dMsg
//   rows are A fragments loaded once per receiver and kept, as f32, in
//   shared memory by the lane that owns them (split into TF32 hi/lo per edge
//   and 8 columns); its 16 x dh sums of dQ stay in registers.
// * Per edge the warp takes S = Q K^T and dW = dMsg V^T (queries x keys) on
//   mma.sync from the sender's K|V rows in the ring, as K1 takes its
//   scores. The softmax runs over keys, the N dimension, so every row's max,
//   sum(e) and sum(dW e) are the thread's own values reduced across the quad
//   (__shfl_xor 1, 2): no exchange between warps (K4 needs one).
//   rowsum(dW W) = sum(dW e) / sum(e).
// * dQ += dS K: dS's C fragment is the A fragment (c_as_a), K's B fragment
//   reads keys 2t and 2t + 1, the pattern K1 reads V in. 1/sqrt(dh) is
//   applied once, when dQ is written.
// * Shared memory holds the fragments and the ring of gathered K|V rows (2
//   or 3 stages of S x 2D f32, row stride 2D + 4), one commit group per
//   edge; a persistent grid walks receivers n = blockIdx.x, + gridDim.x,
//   ..., the ring across receiver boundaries; a slot masked at run time is
//   never gathered.
// * Each receiver's rows are summed by one block in in-edge order: no
//   atomics, bit-reproducible.
//
// Occupancy: the three tiles of an edge (S, dW and dS in dW's place, 2 x
// NKT fragments) and the dQ sums need more than the 80 registers of two
// blocks of 384 threads, so from S=25 on one block of up to 384 threads runs
// per SM (168 registers), as K4; up to S=24 (at most 8 warps) two blocks of
// 256 threads (128 registers).
//
// Trouble spots: pad query rows of a 16-row tile (the NEXT node's rows) read
// as 0 for Q and dMsg: their dW is 0, so their dS is 0, and they are never
// written; pad keys of the last 8-key tile are scored -inf (W = 0) and read
// as 0; rows S..SP-1 of the output are written as 0; dh not a multiple of 8
// is zero-padded within the head; a receiver without a live edge writes
// exact zeros. Instantiated for S <= 48 (NKT = ceil(S/8) key tiles), dh <= 32
// and at most 12 warps (8 up to S=24), and for 48 < S <= 64 with dh a
// multiple of 8, below.
//
// 48 < S <= 64 (path J's S=64): a block of every head would take 16 warps at
// H=4; at one block of 384 threads per SM and 168 registers its warps' S and
// dW tiles (2 x 8 key tiles, 64 registers) do not fit. The grid is
// (receivers, heads) instead, as K1's and K4's at these S
// (mma_tf32.cuh: wide_shape_ok, fill_heads, ring_grid): a block takes one
// head of a receiver, its 4 query tiles (4 warps), and gathers only that
// head's columns of the senders' K|V rows (S x 2dh, row stride 2dh + 4: 17 KB
// a stage at dh = 32), so the bytes read stay those of every head once. Each
// warp runs the per-edge steps of edge_attention_bwd_dq_tc.cuh (edge_scores,
// softmax_backward, dq_accumulate, store_dq) on the head's ring, as K5's
// tensor-core body runs them; K5's wide body can call them the same way.
// Registers: the two ways out the 16-warp layout left open, keys split over
// two warps (an exchange of the row max, sum(e) and sum(dW e) through shared
// memory and a named barrier per edge) or S and dW recomputed in two key
// halves (a third more products), are not needed: K3 keeps one 16 x dh sum
// (16 registers) where K4 keeps two, so a warp's 16 x 64 tiles S and dW, its
// dQ sums and one split fragment fit the 255 registers of two blocks of 128
// threads per SM in one pass (K4's one pass spilled there and runs its queries
// in two groups). Each (receiver, head) is summed by one block in in-edge
// order: no atomics, bit-reproducible. With softmax=0 the scores are taken
// all the same (edge_scores, shared with K5), a third of the products unused.
// Bound at path J's shapes (2,752 nodes, D=128, 10,344 live edges): 6*S^2*D
// FLOP per live edge, 32.5 GFLOP, 0.20 ms at 495 TFLOP/s counted three times,
// against ~450 MB (q, dsum, k|v read, dQ written: 0.13 ms): bound by
// operations.

#include "common.cuh"
#include "edge_attention_bwd_dq_tc.cuh"

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;

template <int NKT>
__global__ void __launch_bounds__(NKT <= 3 ? 256 : kMaxThreads, NKT <= 3 ? 2 : 1)
dq_tc_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ dm, int lddm,
             const float* __restrict__ kv, int ldkv, const int* __restrict__ tile_senders,
             const int* __restrict__ tile_valid, const int* __restrict__ recv_ptr,
             const int* __restrict__ recv_slots, float* __restrict__ dq, int num_nodes, int s,
             int sp, int d, int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) float smem[];
  // [8][threads] float4: each lane's own Q and dMsg fragments; then the ring
  float4* frag = reinterpret_cast<float4*>(smem) + threadIdx.x;
  float* ring = smem + 32 * blockDim.x;
  const int ldr = 2 * d + 4;
  const int stage_floats = s * ldr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  const int dh = d / num_heads;
  const int hc = (warp / mtiles) * dh;  // the warp's head, first column
  const int m0 = 16 * (warp % mtiles);  // the warp's first query row
  const float scale = 1.0f / sqrtf((float)dh);

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(recv_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
    if (slot >= 0)
      fill_stage(ring + i * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s, d);
    cp_async_commit();
  }
  int stage = 0;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
    const int r0 = m0 + g, r1 = r0 + 8;
    // A fragments of Q / sqrt(dh) and of dMsg, kept in shared memory by the
    // lane that owns them (registers decide the blocks per SM)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = 8 * kk + t, c1 = c0 + 4;
      const float* q0 = q + (own0 + r0) * ldq + hc;
      const float* q1 = q + (own0 + r1) * ldq + hc;
      const float* d0 = dm + (own0 + r0) * lddm + hc;
      const float* d1 = dm + (own0 + r1) * lddm + hc;
      frag[kk * blockDim.x] = make_float4(r0 < s && c0 < dh ? q0[c0] * scale : 0.0f,
                                          r1 < s && c0 < dh ? q1[c0] * scale : 0.0f,
                                          r0 < s && c1 < dh ? q0[c1] * scale : 0.0f,
                                          r1 < s && c1 < dh ? q1[c1] * scale : 0.0f);
      frag[(4 + kk) * blockDim.x] = make_float4(r0 < s && c0 < dh ? d0[c0] : 0.0f,
                                                r1 < s && c0 < dh ? d1[c0] : 0.0f,
                                                r0 < s && c1 < dh ? d0[c1] : 0.0f,
                                                r1 < s && c1 < dh ? d1[c1] : 0.0f);
    }
    float acc[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nn][e] = 0.0f;

    const int end = recv_ptr[n + 1];
    for (int k = recv_ptr[n]; k < end; ++k) {
      const int valid = tile_valid[recv_slots[k]];
      if (valid == 0) continue;  // the same for every thread of the block
      cp_async_wait(stages - 2);
      __syncthreads();  // this edge's stage has landed; the previous one is free
      const float* kr = ring + stage * stage_floats + hc;
      const float* vr = kr + d;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      // S and dW: 16 queries x 8*NKT keys
      float sc[NKT][4], dw[NKT][4];
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dw[j][e] = 0.0f;
#pragma unroll 1  // unrolled, the fragments of all k-steps stay live: spills
      for (int kk = 0; kk < 4; ++kk) {
        if (8 * kk >= dh) break;
        const FragA am = split_a(frag[(4 + kk) * blockDim.x]);
        const int c0 = 8 * kk + t, c1 = c0 + 4;
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
          const int key = 8 * j + g;
          const float* vp = vr + key * ldr;
          mma_3xtf32(dw[j], am, split_b(key < s && c0 < dh ? vp[c0] : 0.0f,
                                        key < s && c1 < dh ? vp[c1] : 0.0f));
        }
        if (softmax) {
          const FragA aq = split_a(frag[kk * blockDim.x]);
#pragma unroll
          for (int j = 0; j < NKT; ++j) {
            const int key = 8 * j + g;
            const float* kp = kr + key * ldr;
            mma_3xtf32(sc[j], aq, split_b(key < s && c0 < dh ? kp[c0] : 0.0f,
                                          key < s && c1 < dh ? kp[c1] : 0.0f));
          }
        }
      }

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (slot >= 0)
          fill_stage(ring + free_stage * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp,
                     ldkv, s, d);
        cp_async_commit();
      }

      softmax_backward<NKT, false>(sc, dw, s, (float)valid, softmax, t);
      // dQ += dS K: dS's A fragment is its C fragment
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const FragA a = c_as_a(dw[j]);
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

    store_dq(dq + own0 * d + hc, acc, r0, r1, s, d, dh, scale, t);
    float* pad = dq + own0 * d;
    for (int e = s * d + threadIdx.x; e < sp * d; e += blockDim.x) pad[e] = 0.0f;
  }
  cp_async_wait(0);
}

// 48 < S <= 64: a block of one head (blockIdx.y), 4 warps, one per query
// tile; the registers capped for two blocks per SM (see above)
template <int NKT>
__global__ void __launch_bounds__(kWideThreads, 2)
dq_tc_wide_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ dm,
                  int lddm, const float* __restrict__ kv, int ldkv,
                  const int* __restrict__ tile_senders, const int* __restrict__ tile_valid,
                  const int* __restrict__ recv_ptr, const int* __restrict__ recv_slots,
                  float* __restrict__ dq, int num_nodes, int s, int sp, int d, int num_heads,
                  int softmax, int stages) {
  extern __shared__ __align__(16) float smem[];
  // [8][threads] float4: each lane's own Q and dMsg fragments; then the ring
  // of the head's K | V columns
  float4* frag = reinterpret_cast<float4*>(smem) + threadIdx.x;
  float* ring = smem + 32 * kWideThreads;
  const int dh = d / num_heads;
  const int ldr = 2 * dh + 4;
  const int stage_floats = s * ldr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hc = blockIdx.y * dh;  // the block's head, first column
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // the warp's query rows
  const float scale = 1.0f / sqrtf((float)dh);
  auto load = [&](int i) { return frag[i * kWideThreads]; };

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(recv_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
    if (slot >= 0)
      fill_heads(ring + i * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s, d,
                 hc, dh);
    cp_async_commit();
  }
  int stage = 0;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = 8 * kk + t, c1 = c0 + 4;
      const float* q0 = q + (own0 + r0) * ldq + hc;
      const float* q1 = q + (own0 + r1) * ldq + hc;
      const float* d0 = dm + (own0 + r0) * lddm + hc;
      const float* d1 = dm + (own0 + r1) * lddm + hc;
      frag[kk * kWideThreads] = make_float4(r0 < s && c0 < dh ? q0[c0] * scale : 0.0f,
                                            r1 < s && c0 < dh ? q1[c0] * scale : 0.0f,
                                            r0 < s && c1 < dh ? q0[c1] * scale : 0.0f,
                                            r1 < s && c1 < dh ? q1[c1] * scale : 0.0f);
      frag[(4 + kk) * kWideThreads] = make_float4(r0 < s && c0 < dh ? d0[c0] : 0.0f,
                                                  r1 < s && c0 < dh ? d1[c0] : 0.0f,
                                                  r0 < s && c1 < dh ? d0[c1] : 0.0f,
                                                  r1 < s && c1 < dh ? d1[c1] : 0.0f);
    }
    float acc[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nn][e] = 0.0f;

    const int end = recv_ptr[n + 1];
    for (int k = recv_ptr[n]; k < end; ++k) {
      const int valid = tile_valid[recv_slots[k]];
      if (valid == 0) continue;  // the same for every thread of the block
      cp_async_wait(stages - 2);
      __syncthreads();  // this edge's stage has landed; the previous one is free
      const float* kr = ring + stage * stage_floats;
      const float* vr = kr + dh;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4], dw[NKT][4];
      edge_scores<NKT>(sc, dw, load, kr, vr, ldr, s, dh, g, t);

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (slot >= 0)
          fill_heads(ring + free_stage * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp,
                     ldkv, s, d, hc, dh);
        cp_async_commit();
      }

      softmax_backward<NKT, false>(sc, dw, s, (float)valid, softmax, t);
      dq_accumulate<NKT>(acc, dw, kr, ldr, s, dh, g, t);
    }

    store_dq(dq + own0 * d + hc, acc, r0, r1, s, d, dh, scale, t);
    if (blockIdx.y == 0) {
      float* pad = dq + own0 * d;
      for (int e = s * d + threadIdx.x; e < sp * d; e += kWideThreads) pad[e] = 0.0f;
    }
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per receiver),
// or, with info, what it would run with.
template <int NKT>
int launch(const float* q, int ldq, const float* dm, int lddm, const float* kv, int ldkv,
           const int* tile_senders, const int* tile_valid, const int* recv_ptr,
           const int* recv_slots, float* dq, int num_nodes, int s, int sp, int d,
           int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t fixed = (size_t)threads * 32 * sizeof(float);  // Q and dMsg fragments
  const int err = ring_plan(dq_tc_kernel<NKT>, threads, s, d, fixed, plan);
  if (err) return err;
  const int grid = num_nodes < plan.blocks_per_sm * plan.sms ? num_nodes
                                                             : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(dq_tc_kernel<NKT>, plan, grid, info);
  if (grid > 0)
    dq_tc_kernel<NKT><<<grid, threads, plan.smem, stream>>>(
        q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, dq,
        num_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

// The wide launch: a grid of (receivers, heads), blocks of 4 warps
template <int NKT>
int launch_wide(const float* q, int ldq, const float* dm, int lddm, const float* kv, int ldkv,
                const int* tile_senders, const int* tile_valid, const int* recv_ptr,
                const int* recv_slots, float* dq, int num_nodes, int s, int sp, int d,
                int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const size_t fixed = (size_t)kWideThreads * 32 * sizeof(float);  // Q and dMsg fragments
  const int err = ring_plan(dq_tc_wide_kernel<NKT>, kWideThreads, s, d / num_heads, fixed, plan);
  if (err) return err;
  const dim3 grid = ring_grid(plan, num_nodes, num_heads);
  if (info) return ring_info(dq_tc_wide_kernel<NKT>, plan, grid.x * grid.y, info);
  if (grid.x > 0)
    dq_tc_wide_kernel<NKT><<<grid, kWideThreads, plan.smem, stream>>>(
        q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, dq,
        num_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch(const float* q, int ldq, const float* dm, int lddm, const float* kv, int ldkv,
             const int* tile_senders, const int* tile_valid, const int* recv_ptr,
             const int* recv_slots, float* dq, int num_nodes, int s, int sp, int d,
             int num_heads, int softmax, cudaStream_t stream, int* info) {
  if (!wide_shape_ok(s, d, num_heads)) return (int)cudaErrorInvalidValue;
#define AMPNET_K3_CASE(N, L)                                                                 \
  case N:                                                                                    \
    return L<N>(q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots,  \
                dq, num_nodes, s, sp, d, num_heads, softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_K3_CASE(1, launch) AMPNET_K3_CASE(2, launch) AMPNET_K3_CASE(3, launch)
    AMPNET_K3_CASE(4, launch) AMPNET_K3_CASE(5, launch) AMPNET_K3_CASE(6, launch)
    AMPNET_K3_CASE(7, launch_wide) AMPNET_K3_CASE(8, launch_wide)
  }
#undef AMPNET_K3_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K3. q, dsum: [num_nodes*sp] rows of d floats (row strides ldq, lddsum);
// kv: rows of k|v (2d floats, row stride ldkv, both 16-byte aligned);
// tile_senders / tile_valid over the receiver-tiled slots, recv_ptr /
// recv_slots the receiver-major index; dq: [num_nodes*sp, d] contiguous.
// d / num_heads <= 32; S <= 48 with num_heads * ceil(S/16) <= 12 (8 up to
// S=24), or 48 < S <= 64 with d / num_heads a multiple of 8.
int ampnet_edge_attention_bwd_dq(const float* q, int ldq, const float* dsum, int lddsum,
                                 const float* kv, int ldkv, const int* tile_senders,
                                 const int* tile_valid, const int* recv_ptr,
                                 const int* recv_slots, float* dq, int num_nodes, int s, int sp,
                                 int d, int num_heads, int softmax, void* stream) {
  return dispatch(q, ldq, dsum, lddsum, kv, ldkv, tile_senders, tile_valid, recv_ptr,
                  recv_slots, dq, num_nodes, s, sp, d, num_heads, softmax,
                  (cudaStream_t)stream, nullptr);
}

// What a K3 launch would run with, without launching (info as
// ampnet_edge_attention_sums_info).
int ampnet_edge_attention_bwd_dq_info(int num_nodes, int s, int d, int num_heads, int* info) {
  return dispatch(nullptr, 0, nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                  nullptr, num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
