// K4's bf16 body on Hopper's tensor cores: pass S of the scatter-free
// backward over bf16 [Q | dsum] and k|v rows, the per-sender sums dK = dS^T Q
// / sqrt(dh) and dV = W^T dMsg over live out-edges, in bf16 products with f32
// sums (mma.sync m16n8k16, mma_bf16.cuh); dK|dV are f32. Its 3xTF32 body
// for f32 rows is edge_attention_bwd_tc.cu, whose walk, ring, warp layout and
// exchange across a head's warps it keeps.
//
// Replaces, in bf16, the TPU kernels of ampnet_tpu/ops/pallas/
// edge_attention_bwd_scatterfree.py _dkv_kernel_vmem (:280) and
// _dkv_kernel_dma (:319), math _dkv_group_math (:105), rounding where it
// rounds (:128-157): S^T takes k against q times the bf16 1/sqrt(dh),
// rounded to bf16; dW^T = V dMsg^T takes the bf16 rows as they are; the
// softmax over keys and its backward run in f32 (W = e / sum(e), dS = W (dW
// - sum(dW W))); W^T and dS^T round to bf16 as the A operands of W^T dMsg and
// dS^T Q (their C fragments packed pairwise), Q unscaled; each edge's tiles
// are summed in fresh f32 tiles, dK's scaled by 1/sqrt(dh) in f32, and added
// to the sender's f32 sums.
//
// Bound (H100 SXM) at the S=40 Cora shapes: 16.9 GFLOP of products, 17.1 us
// at 989 TFLOP/s, against the bf16 rows (q|dsum, k|v, ~94 MB) and the f32
// dK|dV (~113 MB), ~62 us at 3.35 TB/s: bound by bytes. One warp per (head,
// 16-row key tile of the block's own sender); the warp's K and V fragments
// stay in registers; the softmax over keys spans the head's warps (shuffles
// over the quad's rows, then a small shared scratch and a named barrier per
// head, partials added in warp order); the ring holds bf16 [Q | dMsg] rows
// (row stride 2D + 8); a persistent grid walks senders; no atomics:
// bit-reproducible. Within the tensor cores' range only (S <= 48, dh <= 32,
// at most 12 warps, 8 up to S=24; and 48 < S <= 64 with dh a multiple of
// 8); beyond it the wrapper runs the CUDA-core bf16 body
// (edge_attention_bwd.cu). Trouble spots as in the 3xTF32 body.
//
// 48 < S <= 64 (path J's S=64) takes the 3xTF32 body's grid of (senders,
// heads): a block of one head (4 warps, its 4 key tiles; the softmax over
// keys within the block) gathers that head's columns of [Q | dMsg] (row
// stride 2dh + 8 values), 9 KB a stage at dh = 32. At S=40 the body of every
// head took 168 registers at 12 warps; a warp's S^T and dW^T at S=64 are 64
// registers, so the cap is 255 (2 blocks of 128 threads per SM; at 168 they
// spilled 224 bytes).

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kPad = 8;  // the ring's row pad, one 16-byte piece of bf16

using bf16 = __nv_bfloat16;

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

// elements c, c + 1 of q row p times the scale, rounded to bf16 and packed
__device__ __forceinline__ uint32_t scaled_pair(const bf16* p, int c, int lim, float scale) {
  const bf16 zero = __float2bfloat16_rn(0.0f);
  return pack_bf16(c < lim ? scaled_bf16(p[c], scale) : zero,
                   c + 1 < lim ? scaled_bf16(p[c + 1], scale) : zero);
}

template <int NQT>
__global__ void __launch_bounds__(NQT > 6 ? kWideThreads : NQT <= 3 ? 256 : kMaxThreads,
                                  NQT > 6 || NQT <= 3 ? 2 : 1)
dkv_bf16_kernel(const bf16* __restrict__ qdm, int ldqdm, const bf16* __restrict__ kv, int ldkv,
                const int* __restrict__ snd_receivers, const int* __restrict__ snd_valid,
                const int* __restrict__ snd_ptr, const int* __restrict__ snd_slots,
                float* __restrict__ dkv, int num_nodes, int s, int sp, int d, int num_heads,
                int softmax, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kCols = 8 * NQT;  // query columns of the scratch
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  constexpr bool kWide = NQT > 6;  // a block of one head, blockIdx.y
  const int bh = kWide ? 0 : warp / mtiles, mt = warp % mtiles;  // the warp's head in the block
  const int dh = d / num_heads;
  const int heads = kWide ? 1 : num_heads;
  const int hc = (kWide ? blockIdx.y : bh) * dh;  // the warp's head, first column
  const int gw = kWide ? dh : d;  // the block's columns of Q (and of dMsg)
  const int ldr = 2 * gw + kPad;
  const int stage_values = s * ldr;
  const int k0 = 16 * mt;  // the warp's first key row
  const float qscale = head_scale<bf16>(dh);            // the scores' q scale, bf16
  const float scale = (float)(1.0 / sqrt((double)dh));  // dK's, f32
  // the ring; then the scratch [3][heads][mtiles][kCols]: max, sum(e), sum(dW e)
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int nred = heads * mtiles * kCols;
  float* rmax = reinterpret_cast<float*>(ring + stages * stage_values) + bh * mtiles * kCols;
  float* rsum = rmax + nred;
  float* rdot = rsum + nred;
  const int bar_id = 1 + bh, bar_threads = 32 * mtiles;

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(snd_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(snd_ptr, snd_slots, snd_valid, num_nodes);
    if (slot >= 0)
      fill_heads(ring + i * stage_values, ldr, qdm, (size_t)snd_receivers[slot] * sp, ldqdm, s,
                 d, (kWide ? hc : 0), gw);
    cp_async_commit();
  }
  int stage = 0;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
    const int r0 = k0 + g, r1 = r0 + 8;
    // A fragments of K and of V (bf16 as they are), two k-steps of 16 head
    // columns, in registers
    uint32_t ka[2][4], va[2][4];
    {
      const bf16* p0 = kv + (own0 + r0) * ldkv + hc;
      const bf16* p1 = kv + (own0 + r1) * ldkv + hc;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * kk + 8 * h + 2 * t;
          ka[kk][2 * h] = pair_bf16(p0, c, r0 < s ? dh : 0);
          ka[kk][2 * h + 1] = pair_bf16(p1, c, r1 < s ? dh : 0);
          va[kk][2 * h] = pair_bf16(p0 + d, c, r0 < s ? dh : 0);
          va[kk][2 * h + 1] = pair_bf16(p1 + d, c, r1 < s ? dh : 0);
        }
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
      const bf16* qr = ring + stage * stage_values + (kWide ? 0 : hc);
      const bf16* mr = qr + gw;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      // S^T and dW^T: 16 keys x 8*NQT queries
      float st[NQT][4], dw[NQT][4];
#pragma unroll
      for (int j = 0; j < NQT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dw[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (16 * kk >= dh) break;
#pragma unroll
        for (int j = 0; j < NQT; ++j) {
          const int qi = 8 * j + g;
          const int lim = qi < s ? dh : 0;
          const bf16* qp = qr + qi * ldr;
          const bf16* mp = mr + qi * ldr;
          const uint32_t bq[2] = {scaled_pair(qp, 16 * kk + 2 * t, lim, qscale),
                                  scaled_pair(qp, 16 * kk + 8 + 2 * t, lim, qscale)};
          const uint32_t bm[2] = {pair_bf16(mp, 16 * kk + 2 * t, lim),
                                  pair_bf16(mp, 16 * kk + 8 + 2 * t, lim)};
          mma_bf16(st[j], ka[kk], bq);
          mma_bf16(dw[j], va[kk], bm);
        }
      }

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int slot = prod.next(snd_ptr, snd_slots, snd_valid, num_nodes);
        if (slot >= 0)
          fill_heads(ring + free_stage * stage_values, ldr, qdm, (size_t)snd_receivers[slot] * sp,
                     ldqdm, s, d, (kWide ? hc : 0), gw);
        cp_async_commit();
      }

      if (softmax) {  // per query column (C columns 2t + e), over the head's keys
        if (r0 >= s)
#pragma unroll
          for (int j = 0; j < NQT; ++j) st[j][0] = st[j][1] = -INFINITY;
        if (r1 >= s)
#pragma unroll
          for (int j = 0; j < NQT; ++j) st[j][2] = st[j][3] = -INFINITY;
#pragma unroll
        for (int j = 0; j < NQT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float m = quad_rows_max(fmaxf(st[j][e], st[j][2 + e]));
            if (g == 0) rmax[mt * kCols + 8 * j + 2 * t + e] = m;
          }
        head_barrier(bar_id, bar_threads);
#pragma unroll
        for (int j = 0; j < NQT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            float mx = rmax[col];
            for (int u = 1; u < mtiles; ++u) mx = fmaxf(mx, rmax[u * kCols + col]);
            st[j][e] = expf(st[j][e] - mx);
            st[j][2 + e] = expf(st[j][2 + e] - mx);
            const float sum = quad_rows_sum(st[j][e] + st[j][2 + e]);
            const float dot = quad_rows_sum(fmaf(dw[j][e], st[j][e], dw[j][2 + e] * st[j][2 + e]));
            if (g == 0) {
              rsum[mt * kCols + col] = sum;
              rdot[mt * kCols + col] = dot;
            }
          }
        head_barrier(bar_id, bar_threads);
#pragma unroll
        for (int j = 0; j < NQT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            float sum = rsum[col], dot = rdot[col];
            for (int u = 1; u < mtiles; ++u) {
              sum += rsum[u * kCols + col];
              dot += rdot[u * kCols + col];
            }
            dot = dot / sum;  // sum(dW W) of this query
#pragma unroll
            for (int r = 0; r < 4; r += 2) {
              const float wt = st[j][r + e] / sum;  // W = e / sum(e)
              st[j][r + e] = wt;
              dw[j][r + e] = wt * (dw[j][r + e] - dot);
            }
          }
      }  // else W^T the raw scaled scores and dS^T = dW^T

      // W^T and dS^T in bf16, the A operands over 16 queries a k-step
      constexpr int kPSteps = (NQT + 1) / 2;
      uint32_t pw[kPSteps][4], ps[kPSteps][4];
#pragma unroll
      for (int kk = 0; kk < kPSteps; ++kk) {
        const bool odd = 2 * kk + 1 < NQT;
        pw[kk][0] = pack_f32(st[2 * kk][0], st[2 * kk][1]);
        pw[kk][1] = pack_f32(st[2 * kk][2], st[2 * kk][3]);
        pw[kk][2] = odd ? pack_f32(st[2 * kk + 1][0], st[2 * kk + 1][1]) : 0u;
        pw[kk][3] = odd ? pack_f32(st[2 * kk + 1][2], st[2 * kk + 1][3]) : 0u;
        ps[kk][0] = pack_f32(dw[2 * kk][0], dw[2 * kk][1]);
        ps[kk][1] = pack_f32(dw[2 * kk][2], dw[2 * kk][3]);
        ps[kk][2] = odd ? pack_f32(dw[2 * kk + 1][0], dw[2 * kk + 1][1]) : 0u;
        ps[kk][3] = odd ? pack_f32(dw[2 * kk + 1][2], dw[2 * kk + 1][3]) : 0u;
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        if (8 * nn >= dh) break;
        const int c = 8 * nn + g;
        float mv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, mk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < kPSteps; ++kk) {
          const int qi = 16 * kk + 2 * t;
          const bf16* m0 = mr + qi * ldr;
          const bf16* q0 = qr + qi * ldr;
          const uint32_t bm[2] = {
              column_pair_bf16(m0, ldr, c, dh, qi < s, qi + 1 < s),
              column_pair_bf16(m0 + 8 * ldr, ldr, c, dh, qi + 8 < s, qi + 9 < s)};
          const uint32_t bq[2] = {
              column_pair_bf16(q0, ldr, c, dh, qi < s, qi + 1 < s),
              column_pair_bf16(q0 + 8 * ldr, ldr, c, dh, qi + 8 < s, qi + 9 < s)};
          mma_bf16(mv, pw[kk], bm);
          mma_bf16(mk, ps[kk], bq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[nn][e] = __fadd_rn(dv[nn][e], mv[e]);
          dk[nn][e] = __fadd_rn(dk[nn][e], __fmul_rn(mk[e], scale));
        }
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
          orow[(size_t)r * 2 * d + c] = dk[nn][e];
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
int launch(const bf16* qdm, int ldqdm, const bf16* kv, int ldkv, const int* snd_receivers,
           const int* snd_valid, const int* snd_ptr, const int* snd_slots, float* dkv,
           int num_nodes, int s, int sp, int d, int num_heads, int softmax,
           cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int heads = block_heads(s, num_heads);
  const int gw = heads * (d / num_heads);
  const int threads = 32 * heads * ((s + 15) / 16);
  const size_t fixed = (size_t)3 * (threads / 32) * 8 * NQT * sizeof(float);  // the scratch
  const size_t stage_bytes = (size_t)s * (2 * gw + kPad) * sizeof(bf16);
  const int err = ring_plan_bytes(dkv_bf16_kernel<NQT>, threads, s, gw, fixed, stage_bytes, plan);
  if (err) return err;
  const dim3 grid = ring_grid(plan, num_nodes, num_heads / heads);
  if (info) return ring_info(dkv_bf16_kernel<NQT>, plan, grid.x * grid.y, info);
  if (grid.x > 0)
    dkv_bf16_kernel<NQT><<<grid, threads, plan.smem, stream>>>(
        qdm, ldqdm, kv, ldkv, snd_receivers, snd_valid, snd_ptr, snd_slots, dkv, num_nodes, s,
        sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch(const bf16* qdm, int ldqdm, const bf16* kv, int ldkv, const int* snd_receivers,
             const int* snd_valid, const int* snd_ptr, const int* snd_slots, float* dkv,
             int num_nodes, int s, int sp, int d, int num_heads, int softmax,
             cudaStream_t stream, int* info) {
  if (!wide_shape_ok(s, d, num_heads)) return (int)cudaErrorInvalidValue;
#define AMPNET_K4_BF16_CASE(N)                                                              \
  case N:                                                                                   \
    return launch<N>(qdm, ldqdm, kv, ldkv, snd_receivers, snd_valid, snd_ptr, snd_slots, dkv, \
                     num_nodes, s, sp, d, num_heads, softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_K4_BF16_CASE(1) AMPNET_K4_BF16_CASE(2) AMPNET_K4_BF16_CASE(3)
    AMPNET_K4_BF16_CASE(4) AMPNET_K4_BF16_CASE(5) AMPNET_K4_BF16_CASE(6)
    AMPNET_K4_BF16_CASE(7) AMPNET_K4_BF16_CASE(8)
  }
#undef AMPNET_K4_BF16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K4, bf16 rows. qdm: rows of q|dsum (2d bf16, stride ldqdm, both in whole
// 16-byte pieces); kv: rows of k|v (2d bf16, stride ldkv); the index arrays
// as ampnet_edge_attention_bwd_dkv's (edge_attention_bwd_tc.cu); dkv:
// [num_nodes*sp, 2d] f32 rows of dk|dv, contiguous.
int ampnet_edge_attention_bwd_dkv_bf16(const bf16* qdm, int ldqdm, const bf16* kv, int ldkv,
                                       const int* snd_receivers, const int* snd_valid,
                                       const int* snd_ptr, const int* snd_slots, float* dkv,
                                       int num_nodes, int s, int sp, int d, int num_heads,
                                       int softmax, void* stream) {
  return dispatch(qdm, ldqdm, kv, ldkv, snd_receivers, snd_valid, snd_ptr, snd_slots, dkv,
                  num_nodes, s, sp, d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What a launch would run with, without launching (info as
// ampnet_edge_attention_sums_info in edge_attention_tc.cu).
int ampnet_edge_attention_bwd_dkv_bf16_info(int num_nodes, int s, int d, int num_heads,
                                            int* info) {
  return dispatch(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                  num_nodes, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
