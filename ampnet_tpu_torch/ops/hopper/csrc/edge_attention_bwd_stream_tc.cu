// K5 on Hopper's tensor cores: pass A of the stream backward, f32 in 3xTF32
// (mma_tf32.cuh), with the next edges' gathers in flight.
//
// Replaces the TPU kernels of ampnet_tpu/ops/pallas/edge_attention_bwd.py
// _bwd_kernel_vmem_v2 (:178), _bwd_kernel_dma_compact (:694), _bwd_kernel_dma
// (:545) and _bwd_kernel_vmem (:32): per live edge, K3's dQ = dS K /
// sqrt(dh) summed per receiver, and the edge's own rows dK_e = dS^T Q /
// sqrt(dh) | dV_e = W^T dMsg written to a stream in device memory (slot
// (tile, j) at rows ((tile*EMAX + j) - slot0)*SP .., 2D floats), which pass B
// sums by sender. With softmax=0 the weights W are the raw scaled scores and
// dS = dW. Beyond the instantiated range the wrapper routes to K5's
// CUDA-core body, ampnet_edge_attention_bwd_stream_simt in
// edge_attention_bwd.cu.
//
// Bound (H100 SXM), at the S=40 Cora shapes over 10,344 live edges: 10*S^2*D
// FLOP per edge (21.2 GFLOP, 0.13 ms at the tensor cores' 495 TFLOP/s for
// three TF32 products each) against K3's ~282 MB read plus 424 MB of stream
// written once (0.21 ms at 3.35 TB/s): bound by bytes. The CUDA-core body
// reads shared memory for every FMA and holds one block of 512 threads per
// SM. Here K3's receiver design (edge_attention_bwd_dq_tc.cu), whose
// per-edge steps are shared device functions (edge_attention_bwd_dq_tc.cuh):
//
// * One warp per (head, 16-row query tile of the receiver): per edge it
//   takes S and dW (queries x keys) on mma.sync from the sender's K|V rows
//   in the ring, the softmax and its backward in registers, and dQ += dS K,
//   as K3 does.
// * The transposed products. dK_e and dV_e sum over queries, which is the M
//   dimension of W's and dS's C fragments, so no fragment of a product over
//   queries can be read from them. Each warp stages its 16 x S tiles of W
//   and dS (times the slot's validity) in shared memory, per head [query]
//   [key] with row stride 16 ceil(S/16) + 4; after a named barrier per head
//   (bar.sync 1 + head, the head's warps), the warp that owns query tile mt
//   takes keys 16 mt .. 16 mt + 15 of dV_e = W^T dMsg and dK_e = dS^T (Q /
//   sqrt(dh)) over ALL of the head's queries: W^T and dS^T are the A
//   fragments, read from the staging tile in A order, and dMsg and Q the B
//   fragments, read from the receiver's own rows. A k-step pairs its
//   columns t and t + 4 with queries 2t and 2t + 1 (as c_as_a does), so
//   both reads are free of bank conflicts with row strides that are 4 mod
//   8 (staging) and 4 mod 32 (own rows). The sum over queries is the mma's
//   own, in a fixed order: no cross-warp partial sums, bit-reproducible.
//   The other way, shuffles that transpose the C fragments, leaves each
//   warp a 16-query share of every key's dK_e and dV_e (2 x S x dh floats)
//   to sum across the head's warps: more registers than K3's 168 leave.
// * The receiver's Q (scaled by 1/sqrt(dh)) and dMsg rows therefore sit in
//   shared memory row-major (row stride roundup(D, 32) + 4, rows past S 0)
//   instead of K3's per-lane fragments; K3's A fragments are read from them
//   in 4-byte loads, free of bank conflicts.
// * The warp stores its rows of dK_e | dV_e from the C fragments straight to
//   the stream (8-byte stores where dh is even: 32 bytes per row and quad,
//   whole sectors).
// * Shared memory at S=40, D=128, H=4: own rows 50,688 B, staging 66,560 B,
//   a 2-stage ring of gathered K|V rows (S x 2D f32, row stride 2D + 4)
//   83,200 B: 200,448 B, one block of 384 threads per SM (a third stage
//   does not fit). At S=20: two blocks of 256 threads per SM.
// * Per receiver one block barrier before its rows are loaded (the previous
//   receiver's transposed products read them), per edge K3's barrier and
//   the head's.
//
// Trouble spots: pad query rows of a tile (rows S..) read 0 for Q and dMsg:
// their W is finite and meets zero B rows, their dS is 0; pad keys of the
// last 8-key tile are scored -inf (W = 0) and read as 0 (dS = 0); keys past
// the last key tile are staged as 0 and their rows are not stored; a slot
// masked at run time is walked and its SP rows are written as 0; rows
// S..SP-1 of a walked slot are written as 0; slots that are not walked are
// not written; a receiver without a live edge writes exact zeros for dQ.
// Instantiated for K3's range up to S=48: S <= 48 (NKT = ceil(S/8)), dh
// <= 32, at most 12 warps (8 up to S=24).

#include "common.cuh"
#include "edge_attention_bwd_dq_tc.cuh"

namespace {

constexpr int kMaxWarps = 12;
constexpr int kMaxThreads = 32 * kMaxWarps;

__device__ __forceinline__ void head_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Row strides, in floats, of the receiver's own rows (4 mod 32) and of the
// W / dS staging tiles (4 mod 8, at least the keys of whole 16-row tiles)
__host__ __device__ inline int own_stride(int d) { return (d + 31) / 32 * 32 + 4; }
__host__ __device__ inline int staging_stride(int s) { return 16 * ((s + 15) / 16) + 4; }

// Shared memory before the ring, in floats: own Q and dMsg rows (16 per
// query tile), then W and dS per head (8 * NKT query rows each)
__host__ __device__ inline size_t fixed_floats(int s, int d, int num_heads, int nkt) {
  return (size_t)2 * 16 * ((s + 15) / 16) * own_stride(d) +
         (size_t)2 * num_heads * 8 * nkt * staging_stride(s);
}

template <int NKT>
__global__ void __launch_bounds__(NKT <= 3 ? 256 : kMaxThreads, NKT <= 3 ? 2 : 1)
stream_tc_kernel(const float* __restrict__ q, int ldq, const float* __restrict__ dm, int lddm,
                 const float* __restrict__ kv, int ldkv, const int* __restrict__ tile_senders,
                 const int* __restrict__ tile_valid, const int* __restrict__ recv_ptr,
                 const int* __restrict__ recv_slots, float* __restrict__ dq,
                 float* __restrict__ stream, int num_nodes, int slot0, int s, int sp, int d,
                 int num_heads, int softmax, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int mtiles = (s + 15) / 16;
  const int ldo = own_stride(d), ldw = staging_stride(s);
  const int qrows = 8 * NKT;  // query rows staged (the k-steps of the transposed products)
  float* qo = smem;                                 // [16 mtiles][ldo] Q / sqrt(dh)
  float* mo = qo + 16 * mtiles * ldo;               // [16 mtiles][ldo] dMsg
  float* wst = mo + 16 * mtiles * ldo;              // [H][qrows][ldw] W
  float* dst = wst + num_heads * qrows * ldw;       // [H][qrows][ldw] dS
  float* ring = dst + num_heads * qrows * ldw;
  const int ldr = 2 * d + 4;
  const int stage_floats = s * ldr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int dh = d / num_heads;
  const int head = warp / mtiles, mt = warp % mtiles;
  const int hc = head * dh;   // the warp's head, first column
  const int m0 = 16 * mt;     // the warp's first query row, and first key row of dK_e | dV_e
  const float scale = 1.0f / sqrtf((float)dh);
  float* wh = wst + head * qrows * ldw;
  float* dsh = dst + head * qrows * ldw;

  // rows past S of the own rows and keys past the last key tile of the
  // staging stay 0
  for (int e = threadIdx.x; e < (int)fixed_floats(s, d, num_heads, NKT); e += blockDim.x)
    smem[e] = 0.0f;

  LiveWalk prod;  // the gathers run stages - 1 live edges ahead
  prod.start(recv_ptr, blockIdx.x, num_nodes);
  for (int i = 0; i < stages - 1; ++i) {
    const int slot = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
    if (slot >= 0)
      fill_stage(ring + i * stage_floats, ldr, kv, (size_t)tile_senders[slot] * sp, ldkv, s, d);
    cp_async_commit();
  }
  int stage = 0;
  const int r0 = m0 + g, r1 = r0 + 8;
  // the lane's A fragment of Q / sqrt(dh) (i = kk) or dMsg (i = 4 + kk)
  auto load = [&](int i) {
    const float* p = (i < 4 ? qo : mo) + hc;
    const int c0 = 8 * (i & 3) + t, c1 = c0 + 4;
    return make_float4(c0 < dh ? p[r0 * ldo + c0] : 0.0f, c0 < dh ? p[r1 * ldo + c0] : 0.0f,
                       c1 < dh ? p[r0 * ldo + c1] : 0.0f, c1 < dh ? p[r1 * ldo + c1] : 0.0f);
  };

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const size_t own0 = (size_t)n * sp;
    __syncthreads();  // the previous receiver's products are done with its rows
    for (int e = threadIdx.x; e < s * d; e += blockDim.x) {
      const int r = e / d, c = e - r * d;
      qo[r * ldo + c] = q[(own0 + r) * ldq + c] * scale;
      mo[r * ldo + c] = dm[(own0 + r) * lddm + c];
    }
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
      const float* kr = ring + stage * stage_floats + hc;
      const float* vr = kr + d;
      const int free_stage = stage == 0 ? stages - 1 : stage - 1;
      stage = stage + 1 == stages ? 0 : stage + 1;

      float sc[NKT][4], dw[NKT][4];
      edge_scores<NKT>(sc, dw, load, kr, vr, ldr, s, dh, g, t);

      {  // the gather of the edge stages - 1 ahead, while the products run
        const int next = prod.next(recv_ptr, recv_slots, tile_valid, num_nodes);
        if (next >= 0)
          fill_stage(ring + free_stage * stage_floats, ldr, kv, (size_t)tile_senders[next] * sp,
                     ldkv, s, d);
        cp_async_commit();
      }

      softmax_backward<NKT, true>(sc, dw, s, (float)valid, softmax, t);
      dq_accumulate<NKT>(acc, dw, kr, ldr, s, dh, g, t);

      // W and dS of the warp's 16 queries into the head's staging tiles
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const int key = 8 * j + 2 * t;
        if (r0 < qrows) {
          *reinterpret_cast<float2*>(wh + r0 * ldw + key) = make_float2(sc[j][0], sc[j][1]);
          *reinterpret_cast<float2*>(dsh + r0 * ldw + key) = make_float2(dw[j][0], dw[j][1]);
        }
        if (r1 < qrows) {
          *reinterpret_cast<float2*>(wh + r1 * ldw + key) = make_float2(sc[j][2], sc[j][3]);
          *reinterpret_cast<float2*>(dsh + r1 * ldw + key) = make_float2(dw[j][2], dw[j][3]);
        }
      }
      head_barrier(1 + head, 32 * mtiles);

      // dV_e = W^T dMsg and dK_e = dS^T (Q / sqrt(dh)) for keys m0 .. m0 + 15:
      // A[key][k] with k = t <-> query q0 + 2t and k = t + 4 <-> q0 + 2t + 1
      float dv[4][4], dk[4][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[nn][e] = dk[nn][e] = 0.0f;
#pragma unroll 1
      for (int q0 = 0; q0 < qrows; q0 += 8) {
        const int qa = q0 + 2 * t, qb = qa + 1;
        const FragA aw = split_a(wh[qa * ldw + r0], wh[qa * ldw + r1], wh[qb * ldw + r0],
                                 wh[qb * ldw + r1]);
        const FragA as = split_a(dsh[qa * ldw + r0], dsh[qa * ldw + r1], dsh[qb * ldw + r0],
                                 dsh[qb * ldw + r1]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          if (8 * nn >= dh) break;
          const int c = 8 * nn + g;
          const bool in = c < dh;
          mma_3xtf32(dv[nn], aw, split_b(in ? mo[qa * ldo + hc + c] : 0.0f,
                                         in ? mo[qb * ldo + hc + c] : 0.0f));
          mma_3xtf32(dk[nn], as, split_b(in ? qo[qa * ldo + hc + c] : 0.0f,
                                         in ? qo[qb * ldo + hc + c] : 0.0f));
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
              *reinterpret_cast<float2*>(row) = make_float2(dk[nn][2 * h], dk[nn][2 * h + 1]);
              *reinterpret_cast<float2*>(row + d) = make_float2(dv[nn][2 * h], dv[nn][2 * h + 1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (c + e < dh) {
                row[e] = dk[nn][2 * h + e];
                row[d + e] = dv[nn][2 * h + e];
              }
          }
        }
      }
      for (int e = s * 2 * d + threadIdx.x; e < sp * 2 * d; e += blockDim.x) srow[e] = 0.0f;
    }

    store_dq(dq + own0 * d + hc, acc, r0, r1, s, d, dh, scale, t);
    float* pad = dq + own0 * d;
    for (int e = s * d + threadIdx.x; e < sp * d; e += blockDim.x) pad[e] = 0.0f;
  }
  cp_async_wait(0);
}

// A persistent launch (blocks per SM x SMs, at most one block per receiver),
// or, with info, what it would run with.
template <int NKT>
int launch(const float* q, int ldq, const float* dm, int lddm, const float* kv, int ldkv,
           const int* tile_senders, const int* tile_valid, const int* recv_ptr,
           const int* recv_slots, float* dq, float* stream_out, int num_nodes, int slot0,
           int s, int sp, int d, int num_heads, int softmax, cudaStream_t stream, int* info) {
  static RingPlan plan;
  const int threads = 32 * num_heads * ((s + 15) / 16);
  const size_t fixed = fixed_floats(s, d, num_heads, NKT) * sizeof(float);
  const int err = ring_plan(stream_tc_kernel<NKT>, threads, s, d, fixed, plan);
  if (err) return err;
  const int grid = num_nodes < plan.blocks_per_sm * plan.sms ? num_nodes
                                                             : plan.blocks_per_sm * plan.sms;
  if (info) return ring_info(stream_tc_kernel<NKT>, plan, grid, info);
  if (grid > 0)
    stream_tc_kernel<NKT><<<grid, threads, plan.smem, stream>>>(
        q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, dq,
        stream_out, num_nodes, slot0, s, sp, d, num_heads, softmax, plan.stages);
  return (int)cudaGetLastError();
}

int dispatch(const float* q, int ldq, const float* dm, int lddm, const float* kv, int ldkv,
             const int* tile_senders, const int* tile_valid, const int* recv_ptr,
             const int* recv_slots, float* dq, float* stream_out, int num_nodes, int slot0,
             int s, int sp, int d, int num_heads, int softmax, cudaStream_t stream, int* info) {
  if (s < 1 || num_heads < 1 || d % num_heads || d / num_heads > 32 ||
      num_heads * ((s + 15) / 16) > (s <= 24 ? 8 : kMaxWarps))
    return (int)cudaErrorInvalidValue;
#define AMPNET_K5_CASE(N)                                                                   \
  case N:                                                                                   \
    return launch<N>(q, ldq, dm, lddm, kv, ldkv, tile_senders, tile_valid, recv_ptr,        \
                     recv_slots, dq, stream_out, num_nodes, slot0, s, sp, d, num_heads,     \
                     softmax, stream, info);
  switch ((s + 7) / 8) {
    AMPNET_K5_CASE(1) AMPNET_K5_CASE(2) AMPNET_K5_CASE(3)
    AMPNET_K5_CASE(4) AMPNET_K5_CASE(5) AMPNET_K5_CASE(6)
  }
#undef AMPNET_K5_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K5. Inputs as K3 (ampnet_edge_attention_bwd_dq), for the num_nodes
// receivers from node0 on (a range of whole tiles); dq: [num_nodes*sp, d]
// contiguous, the range's rows; dkv_stream: rows of dk|dv (2d floats,
// contiguous), sp rows per slot, slot (tile, j) of the layout at row
// (tile*EMAX + j - slot0)*sp: it must hold every slot the range walks. K3's
// range and alignment.
int ampnet_edge_attention_bwd_stream(const float* q, int ldq, const float* dsum, int lddsum,
                                     const float* kv, int ldkv, const int* tile_senders,
                                     const int* tile_valid, const int* recv_ptr,
                                     const int* recv_slots, float* dq, float* dkv_stream,
                                     int node0, int num_nodes, int slot0, int s, int sp, int d,
                                     int num_heads, int softmax, void* stream) {
  const size_t rows0 = (size_t)node0 * sp;
  return dispatch(q + rows0 * ldq, ldq, dsum + rows0 * lddsum, lddsum, kv, ldkv, tile_senders,
                  tile_valid, recv_ptr + node0, recv_slots, dq, dkv_stream, num_nodes, slot0, s,
                  sp, d, num_heads, softmax, (cudaStream_t)stream, nullptr);
}

// What a K5 launch would run with, without launching (info as
// ampnet_edge_attention_sums_info).
int ampnet_edge_attention_bwd_stream_info(int num_nodes, int s, int d, int num_heads,
                                          int* info) {
  return dispatch(nullptr, 0, nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, num_nodes, 0, s, s, d, num_heads, 1, nullptr, info);
}

}  // extern "C"
