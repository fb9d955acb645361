// K6 and K9 on Hopper's tensor cores: the per-receiver SUM of per-edge
// multi-head attention with the work cut by EDGE GROUPS (runs of G
// consecutive layout slots of one tile), f32 in 3xTF32, with the next
// slots' gathers in flight. K6 and K9 are one kernel; a flag says whether
// the tile's structural trip count is read (K6) or every group is walked
// (K9). Beyond the tensor cores' range, and on rows the 16-byte copies
// cannot take, the wrappers route both to their CUDA-core body
// (edge_attention_groups.cu).
//
// Replaces the non-default TPU forward bodies of ampnet_tpu/ops/pallas/
// edge_attention_fused.py:
//   * K6 ampnet_edge_attention_sums_mm <- _fused_kernel_vmem_v2_mm (:731)
//     and _fused_kernel_dma_v8 (:1126, epilogue _mm_scatter_epilogue :1088):
//     groups below ceil(count / G) of each tile, a tile's messages summed
//     onto their receivers by a {0,1} one-hot product; also K7's attention
//     launch (_fused_kernel_vmem_v6_mm, :865);
//   * K9 ampnet_edge_attention_sums_v1 <- _fused_kernel (:186) and
//     _fused_kernel_vmem (:294): G packed edges per step, G | EMAX, every
//     group walked, each message scaled by its validity.
//
// Bound (H100 SXM), as K1's: 4*S^2*D FLOP per live edge in 3xTF32 (3 x 8.5
// GFLOP at the S=40 Cora shapes, 0.05 ms at 495 TFLOP/s) against the q, k|v
// and output rows once (~226 MB, 0.07 ms at 3.35 TB/s): bound by bytes.
//
// Design. The per-edge steps are K1's (edge_attention_tc.cuh): one warp per
// (head, 16-row query tile), the score tile on mma.sync m16n8k8 in 3xTF32
// into registers, the row softmax there, P V into the warp's 16 x dh output
// fragment O, also in registers, the score tile's C fragment reused as P V's
// A fragment; K|V rows gathered into a ring of 2-3 stages with 16-byte
// cp.async. What differs is the walk and the reduction:
// * A persistent grid walks (tile, group) items i = blockIdx.x, + gridDim.x,
//   ...; the ring runs across slots and items, so a short group does not
//   drain it. A slot of validity 0 is never gathered; K6 skips an item at
//   or beyond ceil(count / G) of its tile.
// * The receiver of slot j is tile * TN + tile_recv[tile, j]. Slots are in
//   the graph's edge order within a tile, so one receiver may recur anywhere
//   in a group. O accumulates while consecutive live slots of an item point
//   at one receiver; when the receiver changes, and at the end of an item,
//   each warp adds its own O fragment to the output rows with f32 atomics
//   (two adjacent columns of the C fragment per float2 atomic) and starts
//   again at 0. That is the one-hot product's "one add per element per
//   receiver of the group", taken in registers: no message buffer in shared
//   memory, so the group is not bounded by shared memory, and no block
//   barrier, since each warp owns its slice. Q's fragments are loaded again
//   only when the receiver changes.
// * K9's sums are the same function; only the order of summation differs
//   (and a slot is scaled by its validity instead of selected by it).
// The output is ZEROED by the caller; the atomics make the last bits of a
// sum change from launch to launch.
//
// Trouble spots: the third 16-row tile at S=40 holds rows 32-47, and rows
// 40-47 are the next node's rows in q and in the output: they are read as 0
// and never added to. Columns past dh of a zero-padded head (D=100, H=4:
// dh=25) are never written. Instantiated for what K1 takes (S <= 48, dh <=
// 32, at most 12 warps, 8 up to S=24).

#include "edge_attention_tc.cuh"
#include "edge_groups.cuh"

namespace {

// Two blocks per SM as K1 (edge_attention_tc.cuh): one for NKT = 4 and 6.
template <int NKT>
__global__ void __launch_bounds__(kMaxThreads, NKT == 4 || NKT == 6 ? 1 : 2)
groups_tc_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ kv, int ldkv,
                 const int* __restrict__ tile_senders, const int* __restrict__ tile_recv,
                 const int* __restrict__ tile_valid, const int* __restrict__ tile_counts,
                 float* __restrict__ out, int num_tiles, int emax, int group, int tile_nodes,
                 int s, int sp, int d, int num_heads, int softmax, int stages) {
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
  const int gpt = (emax + group - 1) / group;
  const int items = num_tiles * gpt;

  GroupWalk prod;  // the gathers run stages - 1 live slots ahead
  prod.start();
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(tile_valid, tile_counts, items, gpt, group, emax);
    if (slot >= 0)
      fill_stage(ring + i * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s, d);
    cp_async_commit();
  }
  int stage = 0;  // the stage of the next live slot

  GroupWalk cons;
  cons.start();
  float o[4][4];
#pragma unroll
  for (int nn = 0; nn < 4; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nn][e] = 0.0f;
  int cur = -1, cur_item = -1;  // the receiver and item O holds sums of
  for (;;) {
    const int slot = cons.next(tile_valid, tile_counts, items, gpt, group, emax);
    const int r = slot < 0 ? -1 : (slot / emax) * tile_nodes + tile_recv[slot];
    // the same for every thread of the block: the end of a receiver's run
    // in an item, or of the walk
    if (cur >= 0 && (r != cur || cons.item != cur_item)) {
      flush_o(o, out + (size_t)cur * sp * d, d, hc, r0, r1, s, dh, t);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nn][e] = 0.0f;
    }
    if (slot < 0) break;
    if (r != cur) load_q_frags(qfrag, q, (size_t)r * sp, ldq, hc, r0, r1, s, dh, t, scale);
    cur = r;
    cur_item = cons.item;
    // K6 selects a live slot; K9 scales it by its validity
    const float w = tile_counts != nullptr ? 1.0f : (float)tile_valid[slot];

    cp_async_wait(stages - 2);
    __syncthreads();  // this slot's stage has landed; the previous one is free
    const float* kr = ring + stage * stage_floats + hc;
    const float* vr = kr + d;
    const int free_stage = stage == 0 ? stages - 1 : stage - 1;
    stage = stage + 1 == stages ? 0 : stage + 1;

    float sc[NKT][4];  // scores: 16 queries x 8*NKT keys
    score_tile<NKT>(sc, qfrag, kr, ldr, s, dh, g, t);

    {  // the gather of the slot stages - 1 ahead, while the products run
      const int next = prod.next(tile_valid, tile_counts, items, gpt, group, emax);
      if (next >= 0)
        fill_stage(ring + free_stage * stage_floats, ldr, kv, (size_t)tile_senders[next] * sp,
                   ldkv, s, d);
      cp_async_commit();
    }

    softmax_pv<NKT>(sc, o, vr, ldr, s, dh, g, t, w, softmax);
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per item), or,
// with info, what it would run with.
template <int NKT>
int launch_groups_tc(const float* q, int ldq, const float* kv, int ldkv, const int* tile_senders,
                     const int* tile_recv, const int* tile_valid, const int* tile_counts,
                     float* out, int num_tiles, int emax, int group, int tile_nodes, int s,
                     int sp, int d, int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t fixed = (size_t)threads * 16 * sizeof(float);  // the Q fragments
  const int err = ring_plan(groups_tc_kernel<NKT>, threads, s, d, fixed, plan);
  if (err) return err;
  const long items = (long)num_tiles * ((emax + group - 1) / group);
  const int grid = items < plan.blocks_per_sm * plan.sms ? (int)items
                                                          : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(groups_tc_kernel<NKT>, plan, grid, info);
  if (grid > 0)
    groups_tc_kernel<NKT><<<grid, threads, plan.smem, stream>>>(
        q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, tile_counts, out, num_tiles,
        emax, group, tile_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch_groups_tc(const float* q, int ldq, const float* kv, int ldkv,
                       const int* tile_senders, const int* tile_recv, const int* tile_valid,
                       const int* tile_counts, float* out, int num_tiles, int emax, int group,
                       int tile_nodes, int s, int sp, int d, int num_heads, int softmax,
                       cudaStream_t stream, int* info) {
  if (s < 1 || num_heads < 1 || d % num_heads || d / num_heads > 32 || group < 1 ||
      num_heads * ((s + 15) / 16) > (s <= 24 ? 8 : kMaxWarps))
    return (int)cudaErrorInvalidValue;
#define AMPNET_GROUPS_TC_CASE(N)                                                           \
  case N:                                                                                  \
    return launch_groups_tc<N>(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid,      \
                               tile_counts, out, num_tiles, emax, group, tile_nodes, s, sp, \
                               d, num_heads, softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_GROUPS_TC_CASE(1) AMPNET_GROUPS_TC_CASE(2) AMPNET_GROUPS_TC_CASE(3)
    AMPNET_GROUPS_TC_CASE(4) AMPNET_GROUPS_TC_CASE(5) AMPNET_GROUPS_TC_CASE(6)
  }
#undef AMPNET_GROUPS_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K6. q: [num_tiles*tile_nodes*sp] rows of d floats (row stride ldq); kv:
// rows of k|v (2d floats, stride ldkv), kv and ldkv 16-byte aligned;
// tile_senders / tile_recv / tile_valid: [num_tiles, emax]; tile_counts:
// [num_tiles] structural live slots; out: [num_tiles*tile_nodes*sp, d]
// contiguous and ZEROED by the caller. Any group >= 1. The shapes K1 takes.
int ampnet_edge_attention_sums_mm(const float* q, int ldq, const float* kv, int ldkv,
                                     const int* tile_senders, const int* tile_recv,
                                     const int* tile_valid, const int* tile_counts, float* out,
                                     int num_tiles, int emax, int group, int tile_nodes, int s,
                                     int sp, int d, int num_heads, int softmax, void* stream) {
  if (tile_counts == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_groups_tc(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, tile_counts,
                            out, num_tiles, emax, group, tile_nodes, s, sp, d, num_heads,
                            softmax, (cudaStream_t)stream, nullptr);
}

// K9. As K6 without tile_counts: every group of every tile is walked (the
// caller checks that group divides emax).
int ampnet_edge_attention_sums_v1(const float* q, int ldq, const float* kv, int ldkv,
                                     const int* tile_senders, const int* tile_recv,
                                     const int* tile_valid, float* out, int num_tiles,
                                     int emax, int group, int tile_nodes, int s, int sp, int d,
                                     int num_heads, int softmax, void* stream) {
  return dispatch_groups_tc(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, nullptr,
                            out, num_tiles, emax, group, tile_nodes, s, sp, d, num_heads,
                            softmax, (cudaStream_t)stream, nullptr);
}

// What a K6 or K9 launch over num_items (tile, group) items at (s, d,
// num_heads) would run with, without launching: info[0..6] as K1's
// ampnet_edge_attention_sums_info.
int ampnet_edge_attention_groups_info(int num_items, int s, int d, int num_heads, int* info) {
  return dispatch_groups_tc(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                            num_items, 1, 1, 1, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
