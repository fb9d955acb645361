// K8 on Hopper's tensor cores: the per-receiver SUM of per-edge multi-head
// attention over the receiver-chunked layout, f32 in 3xTF32, with the next
// slots' gathers in flight. Beyond the tensor cores' range, and on rows the
// 16-byte copies cannot take, the wrapper routes K8 to its CUDA-core body
// (edge_attention_chunked.cu).
//
// Replaces the TPU kernel _fused_kernel_chunked of ampnet_tpu/ops/pallas/
// edge_attention_fused.py (:1225, launcher _fused_edge_sums_chunked :1364)
// over the chunked layout of format.py::build_chunked_csr: chunks of up to C
// edges that share one receiver, a receiver's chunks consecutive in its
// tile, per receiver the sum over the live slots of its chunks of
// softmax(Q K^T / sqrt(dh)) V (raw scaled scores with softmax=0).
//
// Bound (H100 SXM), as K1's: 4*S^2*D FLOP per live edge in 3xTF32 (3 x 8.5
// GFLOP at the S=40 Cora shapes, 0.05 ms at 495 TFLOP/s) against the q, k|v
// and output rows and the chunk index once (~226 MB, 0.07 ms at 3.35 TB/s):
// bound by bytes.
//
// Design. On the TPU the chunk sets the block: C edges' K|V side by side in
// VMEM, one score product over C*S columns. Here the chunk is only an
// index: the per-edge steps are K1's (edge_attention_tc.cuh), one warp per
// (head, 16-row query tile), the score tile on mma.sync m16n8k8 in 3xTF32
// into registers, the row softmax there, P V into the warp's 16 x dh output
// fragment O, also in registers, the score tile's C fragment reused as P V's
// A fragment; K|V rows gathered into a ring of 2-3 stages with 16-byte
// cp.async. What differs from K1 is the walk:
// * A persistent grid walks receivers n = blockIdx.x, + gridDim.x, ...; for
//   receiver n the slots chunk_start[n] * C .. (chunk_start[n] +
//   chunk_count[n]) * C - 1 in order. A slot of validity 0 (a partial
//   chunk's padding, about half of Cora's slots at C=8, or an edge masked
//   at run time) is never gathered: the producer's cursor (ChunkWalk)
//   skips it while it looks ahead, so the ring holds live slots only and
//   runs across chunk and receiver boundaries without a stall.
// * Each receiver's rows are summed by one block in slot order: no atomics,
//   bit-reproducible. A receiver without a live slot writes exact zeros;
//   rows S..SP-1 are written as 0.
//
// Trouble spots, as K1's: pad query rows (rows S.. of a 16-row tile are the
// next node's rows in q) are read as 0 and never written; pad keys of the
// last 8-key tile are not read. Instantiated for what K1 takes (S <= 48, dh
// <= 32, at most 12 warps, 8 up to S=24).

#include "edge_attention_tc.cuh"
#include "edge_chunks.cuh"

namespace {

// Two blocks per SM as K1 (edge_attention_tc.cuh): one for NKT = 4 and 6.
template <int NKT>
__global__ void __launch_bounds__(kMaxThreads, NKT == 4 || NKT == 6 ? 1 : 2)
chunked_tc_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ kv, int ldkv,
                  const int* __restrict__ chunk_senders, const int* __restrict__ chunk_valid,
                  const int* __restrict__ chunk_start, const int* __restrict__ chunk_count,
                  float* __restrict__ out, int num_nodes, int chunk, int s, int sp, int d,
                  int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  const int dh = d / num_heads;
  const int hc = (warp / mtiles) * dh;  // the warp's head, first column
  const int r0 = 16 * (warp % mtiles) + g, r1 = r0 + 8;
  const float scale = 1.0f / sqrtf((float)dh);
  // [4][threads] float4: each lane's own Q fragments; then the ring
  float4* qfrag = reinterpret_cast<float4*>(smem) + threadIdx.x;
  float* ring = smem + 16 * blockDim.x;
  const int ldr = 2 * d + 4;
  const int stage_floats = s * ldr;

  ChunkWalk prod;  // the gathers run stages - 1 live slots ahead
  prod.start(chunk_start, chunk_count, chunk, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(chunk_start, chunk_count, chunk_valid, chunk, num_nodes);
    if (slot >= 0)
      fill_stage(ring + i * stage_floats, ldr, kv, (size_t)chunk_senders[slot] * sp, ldkv, s,
                 d);
    cp_async_commit();
  }
  int stage = 0;  // the stage of the next live slot

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t qrow0 = (size_t)n * sp;
    load_q_frags(qfrag, q, qrow0, ldq, hc, r0, r1, s, dh, t, scale);
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
      const float* kr = ring + stage * stage_floats + hc;
      const float* vr = kr + d;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4];  // scores: 16 queries x 8*NKT keys
      score_tile<NKT>(sc, qfrag, kr, ldr, s, dh, g, t);

      {  // the gather of the slot stages - 1 ahead, while the products run
        const int slot = prod.next(chunk_start, chunk_count, chunk_valid, chunk, num_nodes);
        if (slot >= 0)
          fill_stage(ring + free_stage * stage_floats, ldr, kv, (size_t)chunk_senders[slot] * sp,
                     ldkv, s, d);
        cp_async_commit();
      }

      softmax_pv<NKT>(sc, o, vr, ldr, s, dh, g, t, 1.0f, softmax);
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
int launch_chunked_tc(const float* q, int ldq, const float* kv, int ldkv,
                      const int* chunk_senders, const int* chunk_valid, const int* chunk_start,
                      const int* chunk_count, float* out, int num_nodes, int chunk, int s,
                      int sp, int d, int num_heads, int softmax, cudaStream_t stream,
                      int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t fixed = (size_t)threads * 16 * sizeof(float);  // the Q fragments
  const int err = ring_plan(chunked_tc_kernel<NKT>, threads, s, d, fixed, plan);
  if (err) return err;
  const int grid = num_nodes < plan.blocks_per_sm * plan.sms ? num_nodes
                                                             : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(chunked_tc_kernel<NKT>, plan, grid, info);
  if (grid > 0)
    chunked_tc_kernel<NKT><<<grid, threads, plan.smem, stream>>>(
        q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start, chunk_count, out, num_nodes,
        chunk, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch_chunked_tc(const float* q, int ldq, const float* kv, int ldkv,
                        const int* chunk_senders, const int* chunk_valid,
                        const int* chunk_start, const int* chunk_count, float* out,
                        int num_nodes, int chunk, int s, int sp, int d, int num_heads,
                        int softmax, cudaStream_t stream, int* info) {
  if (s < 1 || num_heads < 1 || d % num_heads || d / num_heads > 32 || chunk < 1 ||
      num_heads * ((s + 15) / 16) > (s <= 24 ? 8 : kMaxWarps))
    return (int)cudaErrorInvalidValue;
#define AMPNET_CHUNKED_TC_CASE(N)                                                            \
  case N:                                                                                    \
    return launch_chunked_tc<N>(q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start,   \
                                chunk_count, out, num_nodes, chunk, s, sp, d, num_heads,     \
                                softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_CHUNKED_TC_CASE(1) AMPNET_CHUNKED_TC_CASE(2) AMPNET_CHUNKED_TC_CASE(3)
    AMPNET_CHUNKED_TC_CASE(4) AMPNET_CHUNKED_TC_CASE(5) AMPNET_CHUNKED_TC_CASE(6)
  }
#undef AMPNET_CHUNKED_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K8. q: [num_nodes*sp] rows of d floats (row stride ldq); kv: rows of k|v
// (2d floats, stride ldkv), kv and ldkv 16-byte aligned; chunk_senders /
// chunk_valid: the chunked layout's [T, NCMAX*chunk] slots, flat;
// chunk_start / chunk_count: [num_nodes], each receiver's first flat chunk
// (tile*NCMAX + chunk) and the number of its chunks; out: [num_nodes*sp, d]
// contiguous. The shapes K1 takes; any chunk >= 1.
int ampnet_edge_attention_sums_chunked(const float* q, int ldq, const float* kv, int ldkv,
                                       const int* chunk_senders, const int* chunk_valid,
                                       const int* chunk_start, const int* chunk_count,
                                       float* out, int num_nodes, int chunk, int s, int sp,
                                       int d, int num_heads, int softmax, void* stream) {
  return dispatch_chunked_tc(q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start,
                             chunk_count, out, num_nodes, chunk, s, sp, d, num_heads, softmax,
                             (cudaStream_t)stream, nullptr);
}

// What a K8 launch over num_nodes receivers at (s, d, num_heads) would run
// with, without launching: info[0..6] as K1's ampnet_edge_attention_sums_info.
int ampnet_edge_attention_sums_chunked_info(int num_nodes, int s, int d, int num_heads,
                                            int* info) {
  return dispatch_chunked_tc(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                             nullptr, num_nodes, 1, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
