// K5's bf16 body on Hopper's tensor cores: pass A of the stream backward
// over bf16 q, k|v and dsum rows, in bf16 products with f32 sums (mma.sync
// m16n8k16, mma_bf16.cuh); dQ and the dK | dV stream are f32. Its 3xTF32
// body for f32 rows is edge_attention_bwd_stream_tc.cu, whose walk, ring,
// warp layout and staging it keeps; its per-edge steps are K3's bf16 ones
// (edge_attention_bwd_dq_tc_bf16.cuh).
//
// Replaces, in bf16, the TPU kernels of ampnet_tpu/ops/pallas/
// edge_attention_bwd.py _bwd_kernel_vmem_v2 (:178), _bwd_kernel_dma_compact
// (:694), _bwd_kernel_dma (:545) and _bwd_kernel_vmem (:32), rounding where
// they round (:109-141): the scores take q times the bf16 1/sqrt(dh),
// rounded to bf16, against k; the softmax and its backward run in f32; W
// rounds to bf16 (wt) for dV_e = W^T dMsg, dS rounds to bf16 for dQ = dS K
// and dK_e = dS^T Q, both summed in f32 and then scaled by the f32
// 1/sqrt(dh). dK_e takes the UNSCALED bf16 q (JAX's dot(ds, qh) * scale),
// not the scores' q * bf16(scale). dQ and the stream come out f32 (:930-932,
// :1065-1067), the stream indexed as the 3xTF32 body's (slot (tile, j) at
// rows ((tile*EMAX + j) - slot0)*SP .., 2D floats).
//
// Bound (H100 SXM) at the S=40 Cora shapes over 10,344 live edges: 10*S^2*D
// FLOP per edge (21.2 GFLOP, 21 us at 989 TFLOP/s) against the bf16 rows
// (~113 MB read) and the f32 dQ and stream (~490 MB written once), 0.18 ms
// at 3.35 TB/s: bound by the stream's bytes. The design is the 3xTF32
// body's:
//
// * One warp per (head, 16-row query tile): per edge S and dW on mma.sync
//   from the sender's K|V rows in the ring, the softmax and its backward in
//   registers, dQ += dS K (K3's bf16 steps; Q's and dMsg's A fragments in
//   registers, loaded once per receiver from its rows in device memory).
// * The transposed products dV_e = W^T dMsg and dK_e = dS^T Q sum over
//   queries, the M dimension of W's and dS's C fragments: each warp stages
//   its 16 x S tiles of W and dS, rounded to bf16, per head [query][key]
//   (32-bit stores of key pairs), and after a named barrier per head the
//   warp that owns query tile mt takes keys 16 mt .. 16 mt + 15 over all
//   the head's queries, k-steps of 16 queries: W^T and dS^T are the A
//   fragments, each register two 16-bit loads of one key's column (queries
//   2t, 2t + 1); dMsg and the unscaled q the B fragments, each register two
//   16-bit loads from the receiver's own rows in shared memory (queries 2t,
//   2t + 1 of one column). Both strides are 4 mod 8 in bf16 values (the
//   staging 16 ceil(S/16) + 4, the own rows roundup(D, 8) + 4), so the t of
//   a quad land on words 0, ldw, 2 ldw, 3 ldw apart by 4 mod 32 or more and
//   the eight g on four neighbouring words: free of bank conflicts. The sum
//   over queries is the mma's own, in a fixed order: bit-reproducible.
// * Shared memory at S=40, D=128, H=4: own q and dMsg rows (48 x 132 bf16
//   each) 25,344 B, staging (W and dS, 4 heads x 48 x 52 bf16) 39,936 B, and
//   a ring of 2-3 stages of k|v rows (40 x 264 bf16, 21,120 B): 107,520 B
//   at 2 stages, 128,640 B at 3. One block of 384 threads per SM at S > 24
//   (K3's bf16 register budget); two of 256 at S <= 24.
// * Per receiver one block barrier before its own rows are loaded (the
//   previous receiver's transposed products read them), per edge K3's
//   barrier and the head's.
//
// Trouble spots as in the 3xTF32 body: pad query rows read 0 for Q and dMsg
// (their W is finite and meets zero B rows, their dS is 0); pad keys are
// scored -inf (W = 0) and read as 0 (dS = 0); keys past the last key tile
// are staged as 0 and their rows are not stored; a slot masked at run time
// is walked and its SP rows are written as 0; rows S..SP-1 of a walked slot
// are written as 0; slots that are not walked are not written; a receiver
// without a live edge writes exact zeros for dQ. Within the tensor cores'
// range only (S <= 48, dh <= 32, at most 12 warps, 8 up to S=24): beyond it
// the wrapper runs the CUDA-core bf16 body (edge_attention_bwd.cu).

#include "common.cuh"
#include "edge_attention_bwd_dq_tc_bf16.cuh"

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kPad = 8;  // the ring's row pad, one 16-byte piece of bf16

__device__ __forceinline__ void head_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Row strides, in bf16 values, of the receiver's own rows and of the W / dS
// staging tiles: 4 mod 8, and at least D (own) or the keys of whole 16-row
// tiles (staging)
__host__ __device__ inline int own_stride_bf16(int d) { return (d + 7) / 8 * 8 + 4; }
__host__ __device__ inline int staging_stride_bf16(int s) { return 16 * ((s + 15) / 16) + 4; }

// Shared memory before the ring, in bf16 values: own q and dMsg rows, then W
// and dS per head, 16 ceil(S/16) query rows each (a multiple of 16 bytes)
__host__ __device__ inline size_t fixed_values_bf16(int s, int d, int num_heads) {
  const size_t qrows = 16 * ((s + 15) / 16);
  return 2 * qrows * own_stride_bf16(d) + 2 * (size_t)num_heads * qrows * staging_stride_bf16(s);
}

template <int NKT>
__global__ void __launch_bounds__(NKT <= 3 ? 256 : kMaxThreads, NKT <= 3 ? 2 : 1)
stream_bf16_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ dm, int lddm,
                   const bf16* __restrict__ kv, int ldkv, const int* __restrict__ tile_senders,
                   const int* __restrict__ tile_valid, const int* __restrict__ recv_ptr,
                   const int* __restrict__ recv_slots, float* __restrict__ dq,
                   float* __restrict__ stream, int num_nodes, int slot0, int s, int sp, int d,
                   int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mtiles = (s + 15) / 16;
  const int qrows = 16 * mtiles;  // query rows staged: k-steps of 16
  const int ldo = own_stride_bf16(d), ldw = staging_stride_bf16(s);
  bf16* qo = reinterpret_cast<bf16*>(smem_raw);  // [qrows][ldo] q, unscaled
  bf16* mo = qo + qrows * ldo;                   // [qrows][ldo] dMsg
  bf16* wst = mo + qrows * ldo;                  // [H][qrows][ldw] W
  bf16* dst = wst + num_heads * qrows * ldw;     // [H][qrows][ldw] dS
  bf16* ring = dst + num_heads * qrows * ldw;
  const int ldr = 2 * d + kPad;
  const int stage_values = s * ldr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int dh = d / num_heads;
  const int head = warp / mtiles, mt = warp % mtiles;
  const int hc = head * dh;  // the warp's head, first column
  const int m0 = 16 * mt;    // the warp's first query row, and first key row of dK_e | dV_e
  const float qscale = head_scale<bf16>(dh);            // the scores' q scale, bf16
  const float scale = (float)(1.0 / sqrt((double)dh));  // dQ's and dK's, f32
  bf16* wh = wst + head * qrows * ldw;
  bf16* dsh = dst + head * qrows * ldw;

  // rows past S of the own rows and keys past the last key tile of the
  // staging stay 0
  uint32_t* fixed = reinterpret_cast<uint32_t*>(smem_raw);
  for (int e = threadIdx.x; e < (int)fixed_values_bf16(s, d, num_heads) / 2; e += blockDim.x)
    fixed[e] = 0u;

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
  const int r0 = m0 + g, r1 = r0 + 8;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
    __syncthreads();  // the previous receiver's products are done with its rows
    for (int e = threadIdx.x; e < s * d; e += blockDim.x) {
      const int r = e / d, c = e - r * d;
      qo[r * ldo + c] = q[(own0 + r) * ldq + c];
      mo[r * ldo + c] = dm[(own0 + r) * lddm + c];
    }
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
      const int slot = recv_slots[k];
      const int valid = tile_valid[slot];
      float* srow = stream + (size_t)(slot - slot0) * sp * 2 * d;
      if (valid == 0) {  // the same for every thread of the block: walked, weighted 0
        for (int e = threadIdx.x; e < sp * 2 * d; e += blockDim.x) srow[e] = 0.0f;
        continue;
      }
      cp_async_wait(stages - 2);
      __syncthreads();  // this edge's stage (and the receiver's rows) landed; the previous
                        // stage and the staging tiles are free
      const bf16* kr = ring + stage * stage_values + hc;
      const bf16* vr = kr + d;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4], dw[NKT][4];  // S (then W) and dW (then dS)
      edge_scores_bf16<NKT>(sc, dw, qa, da, kr, vr, ldr, s, dh, g, t);

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int next = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (next >= 0)
          fill_rows(ring + free_stage * stage_values, ldr, kv, (size_t)tile_senders[next] * sp,
                    ldkv, s, 2 * d);
        cp_async_commit();
      }

      // else W is the raw scaled scores and dS = dW
      if (softmax) softmax_backward_bf16<NKT>(sc, dw, s, t);
      dq_accumulate_bf16<NKT>(acc, dw, kr, ldr, s, dh, g, t, scale);

      // W and dS of the warp's 16 queries, rounded to bf16, into the head's
      // staging tiles
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const int key = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(wh + r0 * ldw + key) = pack_f32(sc[j][0], sc[j][1]);
        *reinterpret_cast<uint32_t*>(wh + r1 * ldw + key) = pack_f32(sc[j][2], sc[j][3]);
        *reinterpret_cast<uint32_t*>(dsh + r0 * ldw + key) = pack_f32(dw[j][0], dw[j][1]);
        *reinterpret_cast<uint32_t*>(dsh + r1 * ldw + key) = pack_f32(dw[j][2], dw[j][3]);
      }
      head_barrier(1 + head, 32 * mtiles);

      // dV_e = W^T dMsg and dK_e = dS^T q for keys m0 .. m0 + 15 (rows r0,
      // r1 of the A fragments), 16 queries a k-step: A[key][k] with k = 2t,
      // 2t + 1 (then + 8) <-> queries q0 + k
      float dv[4][4], dk[4][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[nn][e] = dk[nn][e] = 0.0f;
#pragma unroll 1
      for (int q0 = 0; q0 < qrows; q0 += 16) {
        const int qa0 = q0 + 2 * t;
        const bf16* w0 = wh + qa0 * ldw;
        const bf16* s0 = dsh + qa0 * ldw;
        const uint32_t aw[4] = {
            pack_bf16(w0[r0], w0[ldw + r0]), pack_bf16(w0[r1], w0[ldw + r1]),
            pack_bf16(w0[8 * ldw + r0], w0[9 * ldw + r0]),
            pack_bf16(w0[8 * ldw + r1], w0[9 * ldw + r1])};
        const uint32_t as[4] = {
            pack_bf16(s0[r0], s0[ldw + r0]), pack_bf16(s0[r1], s0[ldw + r1]),
            pack_bf16(s0[8 * ldw + r0], s0[9 * ldw + r0]),
            pack_bf16(s0[8 * ldw + r1], s0[9 * ldw + r1])};
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          if (8 * nn >= dh) break;
          const int c = 8 * nn + g;
          const bool in = c < dh;
          const bf16* mc = mo + qa0 * ldo + hc + c;
          const bf16* qc = qo + qa0 * ldo + hc + c;
          const uint32_t bm[2] = {column_pair_bf16(mc, ldo, 0, 1, in, in),
                                  column_pair_bf16(mc + 8 * ldo, ldo, 0, 1, in, in)};
          const uint32_t bq[2] = {column_pair_bf16(qc, ldo, 0, 1, in, in),
                                  column_pair_bf16(qc + 8 * ldo, ldo, 0, 1, in, in)};
          mma_bf16(dv[nn], aw, bm);
          mma_bf16(dk[nn], as, bq);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        if (8 * nn >= dh) break;
        const int c = 8 * nn + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = h ? r1 : r0;
          if (key >= s) continue;
          float* row = srow + (size_t)key * 2 * d + hc + c;
          if (dh % 2 == 0) {  // c even and dh even: c + 1 < dh, 8-byte aligned
            if (c < dh) {
              *reinterpret_cast<float2*>(row) =
                  make_float2(dk[nn][2 * h] * scale, dk[nn][2 * h + 1] * scale);
              *reinterpret_cast<float2*>(row + d) = make_float2(dv[nn][2 * h], dv[nn][2 * h + 1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (c + e < dh) {
                row[e] = dk[nn][2 * h + e] * scale;
                row[d + e] = dv[nn][2 * h + e];
              }
          }
        }
      }
      for (int e = s * 2 * d + threadIdx.x; e < sp * 2 * d; e += blockDim.x) srow[e] = 0.0f;
    }

    store_dq_bf16(dq + own0 * d + hc, acc, r0, r1, s, d, dh, t);
    float* pad = dq + own0 * d;
    for (int e = s * d + threadIdx.x; e < sp * d; e += blockDim.x) pad[e] = 0.0f;
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per receiver),
// or, with info, what it would run with.
template <int NKT>
int launch(const bf16* q, int ldq, const bf16* dm, int lddm, const bf16* kv, int ldkv,
           const int* tile_senders, const int* tile_valid, const int* recv_ptr,
           const int* recv_slots, float* dq, float* stream_out, int num_nodes, int slot0,
           int s, int sp, int d, int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t fixed = fixed_values_bf16(s, d, num_heads) * sizeof(bf16);
  const size_t stage_bytes = (size_t)s * (2 * d + kPad) * sizeof(bf16);
  const int err = ring_plan_bytes(stream_bf16_kernel<NKT>, threads, s, d, fixed, stage_bytes,
                                  plan);
  if (err) return err;
  const int grid = num_nodes < plan.blocks_per_sm * plan.sms ? num_nodes
                                                             : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(stream_bf16_kernel<NKT>, plan, grid, info);
  if (grid > 0)
    stream_bf16_kernel<NKT><<<grid, threads, plan.smem, stream>>>(
        q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, dq,
        stream_out, num_nodes, slot0, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch(const bf16* q, int ldq, const bf16* dm, int lddm, const bf16* kv, int ldkv,
             const int* tile_senders, const int* tile_valid, const int* recv_ptr,
             const int* recv_slots, float* dq, float* stream_out, int num_nodes, int slot0,
             int s, int sp, int d, int num_heads, int softmax, cudaStream_t stream, int* info) {
  if (s < 1 || num_heads < 1 || d % num_heads || d / num_heads > 32 ||
      num_heads * ((s + 15) / 16) > (s <= 24 ? 8 : kMaxWarps))
    return (int)cudaErrorInvalidValue;
#define AMPNET_K5_BF16_CASE(N)                                                              \
  case N:                                                                                   \
    return launch<N>(q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr,        \
                     recv_slots, dq, stream_out, num_nodes, slot0, s, sp, d, num_heads,     \
                     softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_K5_BF16_CASE(1) AMPNET_K5_BF16_CASE(2) AMPNET_K5_BF16_CASE(3)
    AMPNET_K5_BF16_CASE(4) AMPNET_K5_BF16_CASE(5) AMPNET_K5_BF16_CASE(6)
  }
#undef AMPNET_K5_BF16_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K5, bf16 rows. q, dsum: rows of d bf16 (row strides ldq, lddsum); kv: rows
// of k|v (2d bf16, row stride ldkv, both in whole 16-byte pieces); the
// index arrays, node0, num_nodes, slot0, dq and dkv_stream (f32) as
// ampnet_edge_attention_bwd_stream's (edge_attention_bwd_stream_tc.cu).
int ampnet_edge_attention_bwd_stream_bf16(const bf16* q, int ldq, const bf16* dsum, int lddsum,
                                          const bf16* kv, int ldkv, const int* tile_senders,
                                          const int* tile_valid, const int* recv_ptr,
                                          const int* recv_slots, float* dq, float* dkv_stream,
                                          int node0, int num_nodes, int slot0, int s, int sp,
                                          int d, int num_heads, int softmax, void* stream) {
  const size_t rows0 = (size_t)node0 * sp;
  return dispatch(q + rows0 * ldq, ldq, dsum + rows0 * lddsum, lddsum, kv, ldkv, tile_senders,
                  tile_valid, recv_ptr + node0, recv_slots, dq, dkv_stream, num_nodes, slot0, s,
                  sp, d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What a launch would run with, without launching (info as
// ampnet_edge_attention_sums_info in edge_attention_tc.cu).
int ampnet_edge_attention_bwd_stream_bf16_info(int num_nodes, int s, int d, int num_heads,
                                               int* info) {
  return dispatch(nullptr, 0, nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, num_nodes, 0, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
