// K6 and K9's bf16 body on Hopper's tensor cores: the per-receiver SUM of
// per-edge multi-head attention with the work cut by EDGE GROUPS, over bf16
// q and k|v rows, or over f32 rows whose products are rounded to bf16 (K6
// under mxu_bf16), in bf16 products with f32 sums (mma.sync m16n8k16,
// mma_bf16.cuh); the sums are f32. Its 3xTF32 body for f32 rows is
// edge_attention_groups_tc.cu, whose walk, flush and warp layout it keeps
// (edge_groups.cuh); K7's attention launch runs it too.
//
// Replaces, in bf16, the TPU forward bodies of ampnet_tpu/ops/pallas/
// edge_attention_fused.py:
//   * K6 <- _fused_kernel_vmem_v2_mm (:731, with mxu_bf16) and
//     _fused_kernel_dma_v8 (:1126, which ignores mxu_bf16: the wrapper
//     never asks for it there), and the attention of
//     _fused_kernel_vmem_v6_mm (:865);
//   * K9 <- _fused_kernel (:186) and _fused_kernel_vmem (:294), which have
//     no mxu_bf16.
// The per-edge steps are K1's bf16 ones (edge_attention_tc_bf16.cuh) and
// round where the JAX bodies round (:259, :273 for v1; the tile body
// :560-561, 576-580 for v2_mm and v6_mm): q times 1/sqrt(dh) in the rows'
// type, rounded to bf16; the softmax in f32; W rounded to bf16 for P V. The
// messages are f32 and their reduction is f32: JAX sums them by an f32
// one-hot product (_mm_scatter_epilogue, :1088) or f32 adds (v1, :1852);
// here each warp sums a receiver's run of slots in an f32 register tile and
// adds it to the zeroed output with f32 atomics, so a sum's last bits
// change from launch to launch, as in the 3xTF32 body.
//
// Bound (H100 SXM) at the S=40 Cora shapes, as K1's bf16 body: 8.47 GFLOP of
// products, 8.6 us at 989 TFLOP/s, against the bf16 rows (q, k|v once each,
// ~47 MB) and the f32 sums (~56 MB), ~31 us at 3.35 TB/s: bound by bytes.
// Shared memory holds each lane's Q fragments (2 x 16 bytes) and a ring of
// 2-3 stages of gathered k|v rows in the rows' type (row stride 2D + one
// 16-byte piece). Within the tensor cores' range only (S <= 48, dh <= 32, at
// most 12 warps, 8 up to S=24): beyond it the wrappers run the CUDA-core
// bf16 body (edge_attention_groups.cu).

#include "edge_attention_tc_bf16.cuh"
#include "edge_groups.cuh"

namespace {

// Two blocks per SM as K1's bf16 body: one for NKT = 4 and 6.
template <int NKT, typename T>
__global__ void __launch_bounds__(kBf16MaxThreads, NKT == 4 || NKT == 6 ? 1 : 2)
groups_bf16_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ kv, int ldkv,
                   const int* __restrict__ tile_senders, const int* __restrict__ tile_recv,
                   const int* __restrict__ tile_valid, const int* __restrict__ tile_counts,
                   float* __restrict__ out, int num_tiles, int emax, int group, int tile_nodes,
                   int s, int sp, int d, int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = (s + 15) / 16;
  const int dh = d / num_heads;
  const int hc = (warp / mtiles) * dh;  // the warp's head, first column
  const int r0 = 16 * (warp % mtiles) + g, r1 = r0 + 8;
  const float scale = head_scale<T>(dh);
  // [2][threads] uint4: each lane's own Q fragments; then the ring
  uint4* qfrag = reinterpret_cast<uint4*>(smem_raw) + threadIdx.x;
  T* ring = reinterpret_cast<T*>(smem_raw + 2 * sizeof(uint4) * blockDim.x);
  const int ldr = 2 * d + ring_pad<T>();
  const int stage_values = s * ldr;
  const int gpt = (emax + group - 1) / group;
  const int items = num_tiles * gpt;

  GroupWalk prod;  // the gathers run stages - 1 live slots ahead
  prod.start();
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(tile_valid, tile_counts, items, gpt, group, emax);
    if (slot >= 0)
      fill_rows(ring + i * stage_values, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s,
                2 * d);
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
    if (r != cur) load_q_frags_bf16(qfrag, q, (size_t)r * sp, ldq, hc, r0, r1, s, dh, t, scale);
    cur = r;
    cur_item = cons.item;
    // K6 selects a live slot; K9 scales it by its validity
    const float w = tile_counts != nullptr ? 1.0f : (float)tile_valid[slot];

    cp_async_wait(stages - 2);
    __syncthreads();  // this slot's stage has landed; the previous one is free
    const T* kr = ring + stage * stage_values + hc;
    const T* vr = kr + d;
    const int free_stage = stage == 0 ? stages - 1 : stage - 1;
    stage = stage + 1 == stages ? 0 : stage + 1;

    float sc[NKT][4];  // scores: 16 queries x 8*NKT keys, f32
    score_tile_bf16<NKT>(sc, qfrag, kr, ldr, s, dh, g, t);

    {  // the gather of the slot stages - 1 ahead, while the products run
      const int next = prod.next(tile_valid, tile_counts, items, gpt, group, emax);
      if (next >= 0)
        fill_rows(ring + free_stage * stage_values, ldr, kv, (size_t)tile_senders[next] * sp,
                  ldkv, s, 2 * d);
      cp_async_commit();
    }

    // else the raw scaled scores; pad keys score 0 (their k read as 0)
    if (softmax) softmax_rows_bf16<NKT>(sc, s, t);
    pv_accumulate_bf16<NKT>(sc, o, vr, ldr, s, dh, g, t, w);
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per item), or,
// with info, what it would run with.
template <int NKT, typename T>
int launch_groups_bf16(const T* q, int ldq, const T* kv, int ldkv, const int* tile_senders,
                       const int* tile_recv, const int* tile_valid, const int* tile_counts,
                       float* out, int num_tiles, int emax, int group, int tile_nodes, int s,
                       int sp, int d, int num_heads, int softmax, cudaStream_t stream,
                       int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t fixed = (size_t)threads * 2 * sizeof(uint4);  // the Q fragments
  const size_t stage_bytes = (size_t)s * (2 * d + ring_pad<T>()) * sizeof(T);
  const int err = ring_plan_bytes(groups_bf16_kernel<NKT, T>, threads, s, d, fixed,
                                  stage_bytes, plan);
  if (err) return err;
  const long items = (long)num_tiles * ((emax + group - 1) / group);
  const int grid = items < plan.blocks_per_sm * plan.sms ? (int)items
                                                          : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(groups_bf16_kernel<NKT, T>, plan, grid, info);
  if (grid > 0)
    groups_bf16_kernel<NKT, T><<<grid, threads, plan.smem, stream>>>(
        q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, tile_counts, out, num_tiles,
        emax, group, tile_nodes, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_groups_bf16(const T* q, int ldq, const T* kv, int ldkv, const int* tile_senders,
                         const int* tile_recv, const int* tile_valid, const int* tile_counts,
                         float* out, int num_tiles, int emax, int group, int tile_nodes, int s,
                         int sp, int d, int num_heads, int softmax, cudaStream_t stream,
                         int* info) {
  if (s < 1 || num_heads < 1 || d % num_heads || d / num_heads > 32 || group < 1 ||
      num_heads * ((s + 15) / 16) > (s <= 24 ? 8 : kBf16MaxWarps))
    return (int)cudaErrorInvalidValue;
#define AMPNET_GROUPS_BF16_CASE(N)                                                         \
  case N:                                                                                  \
    return launch_groups_bf16<N, T>(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, \
                                    tile_counts, out, num_tiles, emax, group, tile_nodes,  \
                                    s, sp, d, num_heads, softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_GROUPS_BF16_CASE(1) AMPNET_GROUPS_BF16_CASE(2) AMPNET_GROUPS_BF16_CASE(3)
    AMPNET_GROUPS_BF16_CASE(4) AMPNET_GROUPS_BF16_CASE(5) AMPNET_GROUPS_BF16_CASE(6)
  }
#undef AMPNET_GROUPS_BF16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K6, bf16 rows. q: [num_tiles*tile_nodes*sp] rows of d bf16 (row stride
// ldq); kv: rows of k|v (2d bf16, row stride ldkv, kv and ldkv in whole
// 16-byte pieces); the layout arrays as ampnet_edge_attention_sums_mm's
// (edge_attention_groups_tc.cu); out: [num_tiles*tile_nodes*sp, d] f32,
// contiguous and ZEROED by the caller. Any group >= 1. The shapes K1 takes.
int ampnet_edge_attention_sums_mm_bf16(const __nv_bfloat16* q, int ldq,
                                       const __nv_bfloat16* kv, int ldkv,
                                       const int* tile_senders, const int* tile_recv,
                                       const int* tile_valid, const int* tile_counts,
                                       float* out, int num_tiles, int emax, int group,
                                       int tile_nodes, int s, int sp, int d, int num_heads,
                                       int softmax, void* stream) {
  if (tile_counts == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_groups_bf16(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid,
                              tile_counts, out, num_tiles, emax, group, tile_nodes, s, sp, d,
                              num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// K6, f32 rows with the products' operands rounded to bf16 (mxu_bf16); the
// arguments of ampnet_edge_attention_sums_mm.
int ampnet_edge_attention_sums_mm_mxu(const float* q, int ldq, const float* kv, int ldkv,
                                      const int* tile_senders, const int* tile_recv,
                                      const int* tile_valid, const int* tile_counts, float* out,
                                      int num_tiles, int emax, int group, int tile_nodes, int s,
                                      int sp, int d, int num_heads, int softmax, void* stream) {
  if (tile_counts == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_groups_bf16(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid,
                              tile_counts, out, num_tiles, emax, group, tile_nodes, s, sp, d,
                              num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// K9, bf16 rows: as K6 without tile_counts, every group of every tile walked
// (the caller checks that group divides emax).
int ampnet_edge_attention_sums_v1_bf16(const __nv_bfloat16* q, int ldq,
                                       const __nv_bfloat16* kv, int ldkv,
                                       const int* tile_senders, const int* tile_recv,
                                       const int* tile_valid, float* out, int num_tiles,
                                       int emax, int group, int tile_nodes, int s, int sp,
                                       int d, int num_heads, int softmax, void* stream) {
  return dispatch_groups_bf16(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid,
                              (const int*)nullptr, out, num_tiles, emax, group, tile_nodes, s,
                              sp, d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What a launch over num_items (tile, group) items would run with, on bf16
// rows or under mxu_bf16, without launching (info as
// ampnet_edge_attention_groups_info in edge_attention_groups_tc.cu).
int ampnet_edge_attention_groups_bf16_info(int num_items, int s, int d, int num_heads,
                                           int* info) {
  return dispatch_groups_bf16<__nv_bfloat16>(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr,
                                             nullptr, nullptr, num_items, 1, 1, 1, s, s, d,
                                             num_heads, 1, nullptr, info);
}

int ampnet_edge_attention_groups_mxu_info(int num_items, int s, int d, int num_heads,
                                          int* info) {
  return dispatch_groups_bf16<float>(nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, num_items, 1, 1, 1, s, s, d, num_heads,
                                     1, nullptr, info);
}

}  // extern "C"
