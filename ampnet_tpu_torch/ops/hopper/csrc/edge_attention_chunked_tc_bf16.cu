// K8's bf16 body on Hopper's tensor cores: the per-receiver SUM of per-edge
// multi-head attention over the receiver-chunked layout, over bf16 q and k|v
// rows, in bf16 products with f32 sums (mma.sync m16n8k16, mma_bf16.cuh); the
// sums are f32. Its 3xTF32 body for f32 rows is edge_attention_chunked_tc.cu,
// whose walk over a receiver's chunks (edge_chunks.cuh) it keeps. Beyond the
// tensor cores' range, and on rows the 16-byte copies cannot take, the
// wrapper routes bf16 rows to the CUDA-core body (edge_attention_chunked.cu,
// ampnet_edge_attention_sums_chunked_simt_bf16).
//
// Replaces, in bf16, the TPU kernel _fused_kernel_chunked of
// ampnet_tpu/ops/pallas/edge_attention_fused.py (:1225, launcher
// _fused_edge_sums_chunked :1364), which holds its K|V buffer in the rows'
// type (:1404) and returns f32 sums (:1401). It rounds where that body rounds
// on bf16 rows: q times 1/sqrt(dh) in bf16 (:1319), the scores summed in
// f32, the softmax in f32, the weights rounded to bf16 for the value
// product (:1351), summed in f32. The TPU body shifts each chunk row by one
// shared maximum and divides by each edge's own segment sum; the per-edge
// softmax here is the same function.
//
// Design. As the 3xTF32 body, the chunk is only an index: the per-edge
// steps are K1's bf16 ones (edge_attention_tc_bf16.cuh), one warp per
// (head, 16-row query tile), over the live slots of a receiver's chunks in
// slot order; k|v rows gathered into a ring of 2-3 stages by 16-byte
// cp.async, the producer's cursor skipping a slot of validity 0 (a partial
// chunk's padding, an edge masked at run time), so the ring holds live
// slots only. One block sums each receiver's rows: no atomics,
// bit-reproducible. A chunk masked whole at run time adds exactly 0 and a
// receiver without a live slot writes exact zeros (stricter than the TPU
// body, as the 3xTF32 body is); rows S..SP-1 are written as 0.
//
// Bound (H100 SXM), as K1's bf16 body: 4*S^2*D FLOP per live edge (8.5
// GFLOP at the S=40 Cora shapes, 8.6 us at 989 TFLOP/s) against the bf16 q
// and k|v rows, the chunk index and the f32 sums once: bound by bytes.
// Within the tensor cores' range only (S <= 48, dh <= 32, at most 12 warps,
// 8 up to S=24).

#include "edge_attention_tc_bf16.cuh"
#include "edge_chunks.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Two blocks per SM as K1's bf16 body: one for NKT = 4 and 6.
template <int NKT>
__global__ void __launch_bounds__(kBf16MaxThreads, NKT == 4 || NKT == 6 ? 1 : 2)
chunked_bf16_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ kv, int ldkv,
                    const int* __restrict__ chunk_senders, const int* __restrict__ chunk_valid,
                    const int* __restrict__ chunk_start, const int* __restrict__ chunk_count,
                    float* __restrict__ out, int num_nodes, int chunk, int s, int sp, int d,
                    int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  const int dh = d / num_heads;
  const int hc = (warp / mtiles) * dh;  // the warp's head, first column
  const int r0 = 16 * (warp % mtiles) + g, r1 = r0 + 8;
  const float scale = head_scale<bf16>(dh);
  // [2][threads] uint4: each lane's own Q fragments; then the ring
  uint4* qfrag = reinterpret_cast<uint4*>(smem_raw) + threadIdx.x;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + 2 * sizeof(uint4) * blockDim.x);
  const int ldr = 2 * d + ring_pad<bf16>();
  const int stage_values = s * ldr;

  ChunkWalk prod;  // the gathers run stages - 1 live slots ahead
  prod.start(chunk_start, chunk_count, chunk, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(chunk_start, chunk_count, chunk_valid, chunk, num_nodes);
    if (slot >= 0)
      fill_rows(ring + i * stage_values, ldr, kv, (size_t)chunk_senders[slot] * sp, ldkv, s,
                2 * d);
    cp_async_commit();
  }
  int stage = 0;  // the stage of the next live slot

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t qrow0 = (size_t)n * sp;
    load_q_frags_bf16(qfrag, q, qrow0, ldq, hc, r0, r1, s, dh, t, scale);
    float o[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nn][e] = 0.0f;

    const int k0 = chunk_start[n] * chunk, end = k0 + chunk_count[n] * chunk;
    for (int k = k0; k < end; ++k) {
      if (chunk_valid[k] == 0) continue;  // the same for every thread of the block
      cp_async_wait(stages - 2);
      __syncthreads();  // this slot's stage has landed; the previous one is free
      const bf16* kr = ring + stage * stage_values + hc;
      const bf16* vr = kr + d;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4];  // scores: 16 queries x 8*NKT keys, f32
      score_tile_bf16<NKT>(sc, qfrag, kr, ldr, s, dh, g, t);

      {  // the gather of the slot stages - 1 ahead, while the products run
        const int slot = prod.next(chunk_start, chunk_count, chunk_valid, chunk, num_nodes);
        if (slot >= 0)
          fill_rows(ring + free_stage * stage_values, ldr, kv, (size_t)chunk_senders[slot] * sp,
                    ldkv, s, 2 * d);
        cp_async_commit();
      }

      // else the raw scaled scores; pad keys score 0 (their k read as 0)
      if (softmax) softmax_rows_bf16<NKT>(sc, s, t);
      pv_accumulate_bf16<NKT>(sc, o, vr, ldr, s, dh, g, t, 1.0f);
    }

    float* orow = out + qrow0 * d;
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
    for (int e = s * d + threadIdx.x; e < sp * d; e += blockDim.x) orow[e] = 0.0f;
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per receiver),
// or, with info, what it would run with.
template <int NKT>
int launch_chunked_bf16(const bf16* q, int ldq, const bf16* kv, int ldkv,
                        const int* chunk_senders, const int* chunk_valid,
                        const int* chunk_start, const int* chunk_count, float* out,
                        int num_nodes, int chunk, int s, int sp, int d, int num_heads,
                        int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t fixed = (size_t)threads * 2 * sizeof(uint4);  // the Q fragments
  const size_t stage_bytes = (size_t)s * (2 * d + ring_pad<bf16>()) * sizeof(bf16);
  const int err = ring_plan_bytes(chunked_bf16_kernel<NKT>, threads, s, d, fixed, stage_bytes,
                                  plan);
  if (err) return err;
  const int grid = num_nodes < plan.blocks_per_sm * plan.sms ? num_nodes
                                                             : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(chunked_bf16_kernel<NKT>, plan, grid, info);
  if (grid > 0)
    chunked_bf16_kernel<NKT><<<grid, threads, plan.smem, stream>>>(
        q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start, chunk_count, out, num_nodes,
        chunk, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch_chunked_bf16(const bf16* q, int ldq, const bf16* kv, int ldkv,
                          const int* chunk_senders, const int* chunk_valid,
                          const int* chunk_start, const int* chunk_count, float* out,
                          int num_nodes, int chunk, int s, int sp, int d, int num_heads,
                          int softmax, cudaStream_t stream, int* info) {
  if (s < 1 || num_heads < 1 || d % num_heads || d / num_heads > 32 || chunk < 1 ||
      num_heads * ((s + 15) / 16) > (s <= 24 ? 8 : kBf16MaxWarps))
    return (int)cudaErrorInvalidValue;
#define AMPNET_CHUNKED_BF16_CASE(N)                                                         \
  case N:                                                                                   \
    return launch_chunked_bf16<N>(q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start, \
                                  chunk_count, out, num_nodes, chunk, s, sp, d, num_heads,  \
                                  softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_CHUNKED_BF16_CASE(1) AMPNET_CHUNKED_BF16_CASE(2) AMPNET_CHUNKED_BF16_CASE(3)
    AMPNET_CHUNKED_BF16_CASE(4) AMPNET_CHUNKED_BF16_CASE(5) AMPNET_CHUNKED_BF16_CASE(6)
  }
#undef AMPNET_CHUNKED_BF16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K8, bf16 rows. q: [num_nodes*sp] rows of d bf16 (row stride ldq); kv: rows
// of k|v (2d bf16, row stride ldkv), kv and ldkv in whole 16-byte pieces; the
// chunked layout's arrays as ampnet_edge_attention_sums_chunked's
// (edge_attention_chunked_tc.cu); out: [num_nodes*sp, d] f32, contiguous.
// The shapes K1 takes; any chunk >= 1.
int ampnet_edge_attention_sums_chunked_bf16(const bf16* q, int ldq, const bf16* kv, int ldkv,
                                            const int* chunk_senders, const int* chunk_valid,
                                            const int* chunk_start, const int* chunk_count,
                                            float* out, int num_nodes, int chunk, int s, int sp,
                                            int d, int num_heads, int softmax, void* stream) {
  return dispatch_chunked_bf16(q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start,
                               chunk_count, out, num_nodes, chunk, s, sp, d, num_heads,
                               softmax, (cudaStream_t)stream, nullptr);
}

// What a launch over num_nodes receivers would run with, without launching
// (info as ampnet_edge_attention_sums_info in edge_attention_tc.cu).
int ampnet_edge_attention_sums_chunked_bf16_info(int num_nodes, int s, int d, int num_heads,
                                                 int* info) {
  return dispatch_chunked_bf16(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                               nullptr, num_nodes, 1, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
