// K3's bf16 body on Hopper's tensor cores: pass R of the scatter-free
// backward over bf16 q, k|v and dsum rows, the per-receiver sums dQ = dS K /
// sqrt(dh) over live in-edges, in bf16 products with f32 sums (mma.sync
// m16n8k16, mma_bf16.cuh); dQ is f32. Its 3xTF32 body for f32 rows is
// edge_attention_bwd_dq_tc.cu, whose walk, ring and warp layout it keeps.
//
// Replaces, in bf16, the TPU kernels of ampnet_tpu/ops/pallas/
// edge_attention_bwd_scatterfree.py _dq_kernel_vmem (:167) and _dq_kernel_dma
// (:211), math _dq_group_math (:61), rounding where it rounds (:79-101):
// the scores take q times the bf16 1/sqrt(dh), rounded to bf16, against k;
// dW = dMsg V^T takes the bf16 rows as they are; the softmax and its
// backward run in f32 as the JAX body writes them (W = e / sum(e), dS = W
// (dW - sum(dW W))); dS rounds to bf16 as the A operand of dS K (its C
// fragments packed pairwise); each edge's 16 x dh tile of dS K is summed in a
// fresh f32 tile, scaled by 1/sqrt(dh) in f32 and added to the receiver's f32
// sums (JAX's dq_g * scale, then acc + block).
//
// Bound (H100 SXM) at the S=40 Cora shapes: 12.7 GFLOP of products, 12.8 us
// at 989 TFLOP/s, against the bf16 rows (q, dsum, k|v, ~94 MB) and the f32
// dQ (~56 MB), ~45 us at 3.35 TB/s: bound by bytes. One warp per (head,
// 16-row query tile); the warp's Q and dMsg fragments stay in registers; the
// ring holds bf16 k|v rows (row stride 2D + 8); a persistent grid walks
// receivers; no atomics: bit-reproducible. Within the tensor cores' range
// only (S <= 48, dh <= 32, at most 12 warps, 8 up to S=24; and 48 < S <= 64
// with dh a multiple of 8); beyond it the wrapper runs the CUDA-core bf16
// body (edge_attention_bwd.cu). Trouble spots as in the 3xTF32 body. The
// softmax backward and the store of dQ are device functions in
// edge_attention_bwd_dq_tc_bf16.cuh, which K5's bf16 body
// (edge_attention_bwd_stream_tc_bf16.cu) runs with the rest of these steps.
//
// 48 < S <= 64 (path J's S=64) takes the 3xTF32 body's grid of (receivers,
// heads): a block of one head (4 warps, one per query tile; the softmax over
// keys within each warp) gathers that head's columns of the senders' k|v
// (row stride 2dh + 8 values), 9 KB a stage at dh = 32, and each warp runs
// the steps of edge_attention_bwd_dq_tc_bf16.cuh (load_qdm_frags_bf16,
// edge_scores_bf16, softmax_backward_bf16, dq_accumulate_bf16,
// store_dq_bf16), which K5's wide bf16 body can call the same way. Their
// rounding points are this body's own at S <= 48. A warp's S and dW tiles at
// 64 keys are 64 registers; the registers are capped at 255 for two blocks
// of 128 threads per SM, in one pass (the 3xTF32 body says why). Bound at
// path J's shapes: the bf16 rows (q, dsum, k|v, ~180 MB) and the f32 dQ (~90
// MB), 0.081 ms at 3.35 TB/s, against 32.5 GFLOP, 0.033 ms at 989 TFLOP/s:
// bound by bytes.

#include "common.cuh"
#include "edge_attention_bwd_dq_tc_bf16.cuh"

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kPad = 8;  // the ring's row pad, one 16-byte piece of bf16

template <int NKT>
__global__ void __launch_bounds__(NKT <= 3 ? 256 : kMaxThreads, NKT <= 3 ? 2 : 1)
dq_bf16_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ dm, int lddm,
               const bf16* __restrict__ kv, int ldkv, const int* __restrict__ tile_senders,
               const int* __restrict__ tile_valid, const int* __restrict__ recv_ptr,
               const int* __restrict__ recv_slots, float* __restrict__ dq, int num_nodes,
               int s, int sp, int d, int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int ldr = 2 * d + kPad;
  const int stage_values = s * ldr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  const int dh = d / num_heads;
  const int hc = (warp / mtiles) * dh;  // the warp's head, first column
  const int m0 = 16 * (warp % mtiles);  // the warp's first query row
  const float qscale = head_scale<bf16>(dh);          // the scores' q scale, bf16
  const float scale = (float)(1.0 / sqrt((double)dh));  // dQ's, f32
  const bf16 zero = __float2bfloat16_rn(0.0f);

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(recv_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
    if (slot >= 0)
      fill_rows(ring + i * stage_values, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s,
                2 * d);
    cp_async_commit();
  }
  int stage = 0;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
    const int r0 = m0 + g, r1 = r0 + 8;
    // A fragments of (Q * scale) rounded to bf16 and of dMsg, two k-steps of
    // 16 head columns, in registers
    uint32_t qa[2][4], da[2][4];
    {
      const bf16* q0 = q + (own0 + r0) * ldq + hc;
      const bf16* q1 = q + (own0 + r1) * ldq + hc;
      const bf16* d0 = dm + (own0 + r0) * lddm + hc;
      const bf16* d1 = dm + (own0 + r1) * lddm + hc;
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
      const bf16* kr = ring + stage * stage_values + hc;
      const bf16* vr = kr + d;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      // S and dW: 16 queries x 8*NKT keys
      float sc[NKT][4], dw[NKT][4];
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
          if (softmax) {
            const bf16* kp = kr + key * ldr;
            const uint32_t bk[2] = {pair_bf16(kp, 16 * kk + 2 * t, lim),
                                    pair_bf16(kp, 16 * kk + 8 + 2 * t, lim)};
            mma_bf16(sc[j], qa[kk], bk);
          }
        }
      }

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (slot >= 0)
          fill_rows(ring + free_stage * stage_values, ldr, kv, (size_t)tile_senders[slot] * sp,
                    ldkv, s, 2 * d);
        cp_async_commit();
      }

      if (softmax) softmax_backward_bf16<NKT>(sc, dw, s, t);  // else dS = dW
      // dS in bf16, the A operand of dS K over 16 keys a k-step
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

    store_dq_bf16(dq + own0 * d + hc, acc, r0, r1, s, d, dh, t);
    float* pad = dq + own0 * d;
    for (int e = s * d + threadIdx.x; e < sp * d; e += blockDim.x) pad[e] = 0.0f;
  }
  cp_async_wait(0);
}

// 48 < S <= 64: a block of one head (blockIdx.y), 4 warps, one per query
// tile; the registers capped for two blocks per SM
template <int NKT>
__global__ void __launch_bounds__(kWideThreads, 2)
dq_bf16_wide_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ dm,
                    int lddm, const bf16* __restrict__ kv, int ldkv,
                    const int* __restrict__ tile_senders, const int* __restrict__ tile_valid,
                    const int* __restrict__ recv_ptr, const int* __restrict__ recv_slots,
                    float* __restrict__ dq, int num_nodes, int s, int sp, int d,
                    int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // the head's k | v columns
  const int dh = d / num_heads;
  const int ldr = 2 * dh + kPad;
  const int stage_values = s * ldr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hc = blockIdx.y * dh;  // the block's head, first column
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // the warp's query rows
  const float qscale = head_scale<bf16>(dh);          // the scores' q scale, bf16
  const float scale = (float)(1.0 / sqrt((double)dh));  // dQ's, f32

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(recv_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
    if (slot >= 0)
      fill_heads(ring + i * stage_values, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s, d,
                 hc, dh);
    cp_async_commit();
  }
  int stage = 0;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
    uint32_t qa[2][4], da[2][4];
    load_qdm_frags_bf16(qa, da, q + (own0 + r0) * ldq + hc, q + (own0 + r1) * ldq + hc,
                        dm + (own0 + r0) * lddm + hc, dm + (own0 + r1) * lddm + hc, r0, r1, s,
                        dh, t, qscale);
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
      const bf16* kr = ring + stage * stage_values;
      const bf16* vr = kr + dh;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4], dw[NKT][4];
      edge_scores_bf16<NKT>(sc, dw, qa, da, kr, vr, ldr, s, dh, g, t);

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (slot >= 0)
          fill_heads(ring + free_stage * stage_values, ldr, kv, (size_t)tile_senders[slot] * sp,
                     ldkv, s, d, hc, dh);
        cp_async_commit();
      }

      if (softmax) softmax_backward_bf16<NKT>(sc, dw, s, t);  // else dS = dW
      dq_accumulate_bf16<NKT>(acc, dw, kr, ldr, s, dh, g, t, scale);
    }

    store_dq_bf16(dq + own0 * d + hc, acc, r0, r1, s, d, dh, t);
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
int launch(const bf16* q, int ldq, const bf16* dm, int lddm, const bf16* kv, int ldkv,
           const int* tile_senders, const int* tile_valid, const int* recv_ptr,
           const int* recv_slots, float* dq, int num_nodes, int s, int sp, int d,
           int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t stage_bytes = (size_t)s * (2 * d + kPad) * sizeof(bf16);
  const int err = ring_plan_bytes(dq_bf16_kernel<NKT>, threads, s, d, 0, stage_bytes, plan);
  if (err) return err;
  const int grid = num_nodes < plan.blocks_per_sm * plan.sms ? num_nodes
                                                             : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(dq_bf16_kernel<NKT>, plan, grid, info);
  if (grid > 0)
    dq_bf16_kernel<NKT><<<grid, threads, plan.smem, stream>>>(
        q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, dq,
        num_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

// The wide launch: a grid of (receivers, heads), blocks of 4 warps
template <int NKT>
int launch_wide(const bf16* q, int ldq, const bf16* dm, int lddm, const bf16* kv, int ldkv,
                const int* tile_senders, const int* tile_valid, const int* recv_ptr,
                const int* recv_slots, float* dq, int num_nodes, int s, int sp, int d,
                int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int dh = d / num_heads;
  const size_t stage_bytes = (size_t)s * (2 * dh + kPad) * sizeof(bf16);
  const int err =
      ring_plan_bytes(dq_bf16_wide_kernel<NKT>, kWideThreads, s, dh, 0, stage_bytes, plan);
  if (err) return err;
  const dim3 grid = ring_grid(plan, num_nodes, num_heads);
  if (info) return ring_info(dq_bf16_wide_kernel<NKT>, plan, grid.x * grid.y, info);
  if (grid.x > 0)
    dq_bf16_wide_kernel<NKT><<<grid, kWideThreads, plan.smem, stream>>>(
        q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, dq,
        num_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch(const bf16* q, int ldq, const bf16* dm, int lddm, const bf16* kv, int ldkv,
             const int* tile_senders, const int* tile_valid, const int* recv_ptr,
             const int* recv_slots, float* dq, int num_nodes, int s, int sp, int d,
             int num_heads, int softmax, cudaStream_t stream, int* info) {
  if (!wide_shape_ok(s, d, num_heads)) return (int)cudaErrorInvalidValue;
#define AMPNET_K3_BF16_CASE(N, L)                                                            \
  case N:                                                                                    \
    return L<N>(q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots,  \
                dq, num_nodes, s, sp, d, num_heads, softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_K3_BF16_CASE(1, launch) AMPNET_K3_BF16_CASE(2, launch)
    AMPNET_K3_BF16_CASE(3, launch) AMPNET_K3_BF16_CASE(4, launch)
    AMPNET_K3_BF16_CASE(5, launch) AMPNET_K3_BF16_CASE(6, launch)
    AMPNET_K3_BF16_CASE(7, launch_wide) AMPNET_K3_BF16_CASE(8, launch_wide)
  }
#undef AMPNET_K3_BF16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K3, bf16 rows. q, dsum: [num_nodes*sp] rows of d bf16 (row strides ldq,
// lddsum); kv: rows of k|v (2d bf16, row stride ldkv, both in whole 16-byte
// pieces); the index arrays as ampnet_edge_attention_bwd_dq's
// (edge_attention_bwd_dq_tc.cu); dq: [num_nodes*sp, d] f32, contiguous.
int ampnet_edge_attention_bwd_dq_bf16(const bf16* q, int ldq, const bf16* dsum, int lddsum,
                                      const bf16* kv, int ldkv, const int* tile_senders,
                                      const int* tile_valid, const int* recv_ptr,
                                      const int* recv_slots, float* dq, int num_nodes, int s,
                                      int sp, int d, int num_heads, int softmax, void* stream) {
  return dispatch(q, ldq, dsum, lddsum, kv, ldkv, tile_senders, tile_valid, recv_ptr,
                  recv_slots, dq, num_nodes, s, sp, d, num_heads, softmax,
                  (cudaStream_t)stream, nullptr);
}

// What a launch would run with, without launching (info as
// ampnet_edge_attention_sums_info in edge_attention_tc.cu).
int ampnet_edge_attention_bwd_dq_bf16_info(int num_nodes, int s, int d, int num_heads,
                                           int* info) {
  return dispatch(nullptr, 0, nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                  nullptr, num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
