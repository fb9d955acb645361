// Per-receiver edge attention on Hopper (sm_90a), f32.
//
// Replaces the TPU forward kernels of ampnet_tpu/ops/pallas/
// edge_attention_fused.py:
//   * K1's CUDA-core body, ampnet_edge_attention_sums_simt <-
//     _fused_kernel_vmem_v2 (:691, body _tile_attention_accumulate :379)
//     and _fused_kernel_vmem_v4 (:942): the per-receiver SUM over live
//     in-edges of the multi-head message softmax(Q K^T / sqrt(dh)) V (raw
//     scores with softmax=0);
//   * K2's CUDA-core attention launch, ampnet_edge_attention_layer_simt <-
//     _fused_kernel_vmem_v6 (:763): the same walk with each edge pre-scaled
//     by its receiver's 1/degree (the accumulator holds the MEAN), then the
//     out-projection and b_out on live rows only, in the epilogue. Its QKV
//     projection is the separate launch in qkv_projection.cu.
// K1 and K2 run on the tensor cores (edge_attention_tc.cu,
// edge_attention_layer_tc.cu) within their instantiated range; these bodies
// are the route beyond it (S > 48, D/H > 32, more than 12 warps, rows the
// 16-byte copies cannot take), at every shape: where a block's working
// set (smem_floats, mirrored in launch.py) exceeds the 227 KB of shared
// memory a block may have, the same body keeps it in device memory instead,
// one slice per resident block, and the blocks walk the receivers in turn.
//
// bf16 (the *_simt_bf16 and *_simt_mxu entry points, launch.py's body
// 'simt_bf16'): the same walk over bf16 rows, or over f32 rows whose
// products' operands are rounded to bf16 (mxu_bf16), beyond the bf16
// tensor-core bodies' range (edge_attention_tc_bf16.cuh). The working set
// stays f32 (the same smem_floats); each value is converted as it is loaded
// and rounded where the JAX bodies round: q times 1/sqrt(dh) in the rows'
// type, rounded to bf16 (k and v rounded too on f32 rows); the softmax in
// f32, then W (or the raw scaled scores) rounded to bf16; each edge's
// message summed in f32 and added to the f32 sums. A bf16 times a bf16 is
// exact in f32, so an f32 FMA on these values is the tensor cores' bf16
// product up to the order of the f32 sums. K2 on bf16 rows rounds its mean
// to bf16, the out-projection's f32 sum to bf16, and adds b_out in bf16 on
// live rows, as _fused_kernel_vmem_v6 (:851-860) does; under mxu_bf16 its
// epilogue is the f32 one.
//
// Design. A TPU tile of TN receivers carries a TN*SP*D f32 accumulator
// (5.2 MB at S=40) through a sequential grid; that cannot be one thread
// block here (227 KB of shared memory). So ONE BLOCK PER RECEIVER: it
// holds its Q rows and an S x D f32 accumulator on chip, walks its
// in-edges through the receiver-major index (format.py::receiver_index),
// stages each sender's K|V rows in shared memory, and writes its rows
// once. No atomics: the result is deterministic, summed in in-edge order.
// The trip count is the receiver's STRUCTURAL in-degree; a runtime-masked
// edge has validity 0 and is skipped, so nothing is clamped or duplicated.
// Rows are SP apart (the JAX package's sublane-aligned stride); only the
// S real key rows are read, which is the pad-key mask, and pad query rows
// are written as 0.
//
// Bound (H100 SXM): at the S=40 Cora shapes the work is 4*S^2*D FLOP per
// edge (~8.7 GFLOP over 10,556 edges, 0.13 ms at the 67 TFLOP/s f32 rate)
// against ~230 MB of compulsory traffic (0.07 ms at 3.35 TB/s): bound by
// operations. They run on the CUDA cores in f32 from shared memory, with
// register tiles that reuse each operand read (2 queries x 4 keys per
// thread for the scores, 4 query rows x 1 column for the messages); the
// tensor cores (TF32/bf16 wgmma) are later work.

#include <type_traits>

#include "common.cuh"
#include "rows_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowBatch = 8;  // global row loads each thread keeps in flight

// Shared memory per block, in floats (s2 = s rounded up to 2, s4 to 4;
// the pad rows stay 0, so the register tiles below need no guards on reads):
//   qs  [s2][d + 1]  this receiver's query rows, pre-scaled by 1/sqrt(dh)
//   ks  [s4][d + 1]  the sender's key rows
//   vs  [s][d]       the sender's value rows
//   ps  [h][s4][s]   scores, then weights
//   acc [s][d]       f32 sum (K1) or mean (K2)
// (+1 column on qs/ks: the score tiles read down columns without bank
// conflicts.)
__host__ __device__ inline size_t smem_floats(int s, int d, int h) {
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  return (size_t)(s2 + s4) * (d + 1) + (size_t)s * d * 2 + (size_t)h * s4 * s;
}

// K2's output type: the rows' type; K1's: f32
template <bool kLayer, typename T>
using SumsOut = std::conditional_t<kLayer, T, float>;

// One receiver n, its working set at smem (shared or device memory). T: the
// rows' type (and K2's weights'); kBf16: the products' operands rounded to
// bf16 (bf16 rows, or f32 rows under mxu_bf16).
template <bool kLayer, typename T, bool kBf16>
__device__ __forceinline__ void
receiver_sums(int n, float* smem, const T* __restrict__ q, int ldq,
              const T* __restrict__ kv, int ldkv,
              const int* __restrict__ tile_senders,
              const int* __restrict__ tile_valid,
              const int* __restrict__ recv_ptr,
              const int* __restrict__ recv_slots,
              const float* __restrict__ invdeg,
              const T* __restrict__ w_out,
              const T* __restrict__ b_out,
              SumsOut<kLayer, T>* __restrict__ out,
              int s, int sp, int d, int num_heads, int softmax) {
  using O = SumsOut<kLayer, T>;
  const int tid = threadIdx.x;
  const int dh = d / num_heads;
  const int ld = d + 1;
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  float* qs = smem;
  float* ks = qs + s2 * ld;
  float* vs = ks + s4 * ld;
  float* ps = vs + s * d;
  float* acc = ps + num_heads * s4 * s;

  const int beg = recv_ptr[n];
  const int end = recv_ptr[n + 1];
  const float inv_n = kLayer ? invdeg[n] : 1.0f;
  const float scale = kBf16 ? head_scale<T>(dh) : 1.0f / sqrtf((float)dh);
  const size_t qrow0 = (size_t)n * sp;

  // zero everything once (pad rows of qs/ks/ps must read 0), then Q; the
  // block's previous receiver is done with its working set
  const int total = (int)smem_floats(s, d, num_heads);
  __syncthreads();
  for (int e = tid; e < total; e += kThreads) smem[e] = 0.0f;
  __syncthreads();
  if (beg < end) {
    for (int c = tid; c < d; c += kThreads)
      for (int i0 = 0; i0 < s; i0 += kRowBatch) {
        float r[kRowBatch];
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u)
          if (i0 + u < s) r[u] = to_f32(q[(qrow0 + i0 + u) * ldq + c]);
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u)
          if (i0 + u < s)
            qs[(i0 + u) * ld + c] = kBf16 ? round_bf16(r[u] * scale) : r[u] * scale;
      }
  }

  const int n_ip = s2 / 2, n_jq = s4 / 4;       // score tiles: 2 queries x 4 keys
  const int n_score = num_heads * n_ip * n_jq;
  const int n_msg = (s4 / 4) * d;               // message tiles: 4 rows x 1 column

  for (int k = beg; k < end; ++k) {
    const int slot = recv_slots[k];
    const float w = (float)tile_valid[slot] * inv_n;
    if (w == 0.0f) continue;  // the same for every thread of the block
    const size_t krow0 = (size_t)tile_senders[slot] * sp;
    __syncthreads();  // the previous edge is done with ks, vs and ps

    // kRowBatch row loads in flight per thread before any store
    for (int c = tid; c < 2 * d; c += kThreads) {
      float* dst = c < d ? ks + c : vs + c - d;
      const int ldd = c < d ? ld : d;
      for (int i0 = 0; i0 < s; i0 += kRowBatch) {
        float r[kRowBatch];
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u)
          if (i0 + u < s) r[u] = to_f32(kv[(krow0 + i0 + u) * ldkv + c]);
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u)
          if (i0 + u < s) dst[(i0 + u) * ldd] = kBf16 ? round_bf16(r[u]) : r[u];
      }
    }
    __syncthreads();

    for (int t = tid; t < n_score; t += kThreads) {
      const int jq = t % n_jq, r = t / n_jq, ip = r % n_ip, h = r / n_ip;
      const float* q0 = qs + (2 * ip) * ld + h * dh;
      const float* k0 = ks + (4 * jq) * ld + h * dh;
      float a[2][4] = {};
#pragma unroll 4
      for (int c = 0; c < dh; ++c) {
        const float x0 = q0[c], x1 = q0[ld + c];
        const float y0 = k0[c], y1 = k0[ld + c], y2 = k0[2 * ld + c], y3 = k0[3 * ld + c];
        a[0][0] = fmaf(x0, y0, a[0][0]); a[0][1] = fmaf(x0, y1, a[0][1]);
        a[0][2] = fmaf(x0, y2, a[0][2]); a[0][3] = fmaf(x0, y3, a[0][3]);
        a[1][0] = fmaf(x1, y0, a[1][0]); a[1][1] = fmaf(x1, y1, a[1][1]);
        a[1][2] = fmaf(x1, y2, a[1][2]); a[1][3] = fmaf(x1, y3, a[1][3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * ip + u;
        if (i >= s) break;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = 4 * jq + v;
          // (bf16: the raw scaled scores are the value product's operand)
          if (j < s)
            ps[(h * s4 + i) * s + j] = kBf16 && !softmax ? round_bf16(a[u][v]) : a[u][v];
        }
      }
    }
    __syncthreads();

    if (softmax) {  // one warp per (head, query) row
      const int warp = tid / 32, lane = tid % 32;
      for (int row = warp; row < num_heads * s; row += kThreads / 32) {
        float* p = ps + ((row / s) * s4 + row % s) * s;
        float m = -INFINITY;
        for (int j = lane; j < s; j += 32) m = fmaxf(m, p[j]);
        m = warp_max(m);
        float sum = 0.0f;
        for (int j = lane; j < s; j += 32) {
          const float ex = expf(p[j] - m);
          p[j] = ex;
          sum += ex;
        }
        sum = warp_sum(sum);
        for (int j = lane; j < s; j += 32) p[j] = kBf16 ? round_bf16(p[j] / sum) : p[j] / sum;
      }
      __syncthreads();
    }

    // each thread owns the same accumulator elements on every edge
    for (int t = tid; t < n_msg; t += kThreads) {
      const int c = t % d, i0 = 4 * (t / d);
      const float* p = ps + ((c / dh) * s4 + i0) * s;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
      for (int j = 0; j < s; ++j) {
        const float v = vs[j * d + c];
        a0 = fmaf(p[j], v, a0);
        a1 = fmaf(p[s + j], v, a1);
        a2 = fmaf(p[2 * s + j], v, a2);
        a3 = fmaf(p[3 * s + j], v, a3);
      }
      float* ac = acc + i0 * d + c;
      ac[0] += a0 * w;
      if (i0 + 1 < s) ac[d] += a1 * w;
      if (i0 + 2 < s) ac[2 * d] += a2 * w;
      if (i0 + 3 < s) ac[3 * d] += a3 * w;
    }
  }
  __syncthreads();

  O* orow = out + qrow0 * d;
  if constexpr (kLayer && std::is_same_v<T, __nv_bfloat16>) {
    // bf16 rows: the mean rounds to bf16, mean @ w_out sums in f32 and rounds
    // to bf16, b_out is added in bf16 on live rows; degree 0 comes out 0
    for (int e = tid; e < s * d; e += kThreads) acc[e] = round_bf16(acc[e]);
    __syncthreads();
    const bool live = inv_n > 0.0f;
    for (int i = 0; i < s; ++i) {
      const float* ai = acc + i * d;
      for (int c = tid; c < d; c += kThreads) {
        float a = 0.0f;
        for (int k2 = 0; k2 < d; ++k2) a = fmaf(ai[k2], to_f32(w_out[(size_t)k2 * d + c]), a);
        const float y = round_bf16(a);
        orow[i * d + c] = __float2bfloat16_rn(live ? y + to_f32(b_out[c]) : y);
      }
    }
  } else if constexpr (kLayer) {
    // out = mean @ w_out (+ b_out where the receiver has a live in-edge):
    // a receiver of degree 0 has acc == 0 and comes out exactly 0
    const bool live = inv_n > 0.0f;
    for (int i = 0; i < s; ++i) {
      const float* ai = acc + i * d;
      for (int c = tid; c < d; c += kThreads) {
        float a = 0.0f;
        for (int k2 = 0; k2 < d; ++k2) a = fmaf(ai[k2], __ldg(w_out + (size_t)k2 * d + c), a);
        orow[i * d + c] = live ? a + b_out[c] : a;
      }
    }
  } else {
    for (int i = 0; i < s; ++i)
      for (int c = tid; c < d; c += kThreads) orow[i * d + c] = acc[i * d + c];
  }
  for (int e = s * d + tid; e < sp * d; e += kThreads) orow[e] = from_f32<O>(0.0f);
}

// kDeviceMem = false: one block per receiver, its working set in dynamic
// shared memory. kDeviceMem = true: block b works in work[b * smem_floats]
// and takes receivers b, b + gridDim.x, ...
template <bool kLayer, bool kDeviceMem, typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
edge_attention_kernel(const T* __restrict__ q, int ldq,
                      const T* __restrict__ kv, int ldkv,
                      const int* __restrict__ tile_senders,
                      const int* __restrict__ tile_valid,
                      const int* __restrict__ recv_ptr,
                      const int* __restrict__ recv_slots,
                      const float* __restrict__ invdeg,
                      const T* __restrict__ w_out,
                      const T* __restrict__ b_out,
                      SumsOut<kLayer, T>* __restrict__ out, float* __restrict__ work,
                      int num_nodes, int s, int sp, int d, int num_heads,
                      int softmax) {
  extern __shared__ float shared[];
  if (!kDeviceMem) {  // no loop: the loop costs this body registers
    receiver_sums<kLayer, T, kBf16>(blockIdx.x, shared, q, ldq, kv, ldkv, tile_senders,
                                    tile_valid, recv_ptr, recv_slots, invdeg, w_out, b_out,
                                    out, s, sp, d, num_heads, softmax);
    return;
  }
  float* smem = work + blockIdx.x * smem_floats(s, d, num_heads);
  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x)
    receiver_sums<kLayer, T, kBf16>(n, smem, q, ldq, kv, ldkv, tile_senders, tile_valid,
                                    recv_ptr, recv_slots, invdeg, w_out, b_out, out, s, sp,
                                    d, num_heads, softmax);
}

// work == nullptr: the working set in shared memory (the caller checked
// that it fits); else work_blocks slices of smem_floats in device memory.
template <bool kLayer, typename T, bool kBf16>
int launch(const T* q, int ldq, const T* kv, int ldkv,
           const int* tile_senders, const int* tile_valid,
           const int* recv_ptr, const int* recv_slots,
           const float* invdeg, const T* w_out, const T* b_out,
           SumsOut<kLayer, T>* out, float* work, int work_blocks, int num_nodes, int s,
           int sp, int d, int num_heads, int softmax, cudaStream_t stream) {
  if (num_nodes <= 0) return (int)cudaGetLastError();
  if (work != nullptr) {
    edge_attention_kernel<kLayer, true, T, kBf16><<<work_blocks, kThreads, 0, stream>>>(
        q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots,
        invdeg, w_out, b_out, out, work, num_nodes, s, sp, d, num_heads, softmax);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_floats(s, d, num_heads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_attention_kernel<kLayer, false, T, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_attention_kernel<kLayer, false, T, kBf16><<<num_nodes, kThreads, smem, stream>>>(
      q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots,
      invdeg, w_out, b_out, out, nullptr, num_nodes, s, sp, d, num_heads, softmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of working set one block needs (the wrapper puts it in shared
// memory where it fits the card's per-block limit, else in device memory).
size_t ampnet_edge_attention_smem_bytes(int s, int d, int num_heads) {
  return smem_floats(s, d, num_heads) * sizeof(float);
}

// K1's CUDA-core body (the route beyond edge_attention_tc.cu's range). q:
// [num_nodes*sp] rows of d floats, row stride ldq; kv: rows of k|v (2d
// floats), row stride ldkv; out: [num_nodes*sp, d] contiguous; work: null
// (shared memory) or work_blocks * smem_bytes of device memory.
int ampnet_edge_attention_sums_simt(const float* q, int ldq, const float* kv,
                                    int ldkv, const int* tile_senders,
                                    const int* tile_valid, const int* recv_ptr,
                                    const int* recv_slots, float* out,
                                    int num_nodes, int s, int sp, int d,
                                    int num_heads, int softmax, float* work,
                                    int work_blocks, void* stream) {
  return launch<false, float, false>(q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr,
                                     recv_slots, nullptr, nullptr, nullptr, out, work,
                                     work_blocks, num_nodes, s, sp, d, num_heads, softmax,
                                     (cudaStream_t)stream);
}

// K1's CUDA-core body in bf16 (launch.py's 'simt_bf16'): bf16 q and k|v
// rows, the arguments of ampnet_edge_attention_sums_simt; out f32.
int ampnet_edge_attention_sums_simt_bf16(const __nv_bfloat16* q, int ldq,
                                         const __nv_bfloat16* kv, int ldkv,
                                         const int* tile_senders, const int* tile_valid,
                                         const int* recv_ptr, const int* recv_slots,
                                         float* out, int num_nodes, int s, int sp, int d,
                                         int num_heads, int softmax, float* work,
                                         int work_blocks, void* stream) {
  return launch<false, __nv_bfloat16, true>(
      q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots, nullptr, nullptr,
      nullptr, out, work, work_blocks, num_nodes, s, sp, d, num_heads, softmax,
      (cudaStream_t)stream);
}

// K1's CUDA-core body on f32 rows with the products' operands rounded to
// bf16 (mxu_bf16); the arguments of ampnet_edge_attention_sums_simt.
int ampnet_edge_attention_sums_simt_mxu(const float* q, int ldq, const float* kv, int ldkv,
                                        const int* tile_senders, const int* tile_valid,
                                        const int* recv_ptr, const int* recv_slots,
                                        float* out, int num_nodes, int s, int sp, int d,
                                        int num_heads, int softmax, float* work,
                                        int work_blocks, void* stream) {
  return launch<false, float, true>(q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr,
                                    recv_slots, nullptr, nullptr, nullptr, out, work,
                                    work_blocks, num_nodes, s, sp, d, num_heads, softmax,
                                    (cudaStream_t)stream);
}

// K2's CUDA-core attention launch over projected rows (q|k|v packed per
// row, stride ldqkv): invdeg [num_nodes], w_out [d, d] (in, out), b_out [d];
// work as K1's.
int ampnet_edge_attention_layer_simt(const float* qkv, int ldqkv,
                                const int* tile_senders, const int* tile_valid,
                                const int* recv_ptr, const int* recv_slots,
                                const float* invdeg, const float* w_out,
                                const float* b_out, float* out, int num_nodes,
                                int s, int sp, int d, int num_heads,
                                int softmax, float* work, int work_blocks,
                                void* stream) {
  return launch<true, float, false>(qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid,
                                    recv_ptr, recv_slots, invdeg, w_out, b_out, out, work,
                                    work_blocks, num_nodes, s, sp, d, num_heads, softmax,
                                    (cudaStream_t)stream);
}

// K2's CUDA-core attention launch in bf16: bf16 q|k|v rows, w_out and b_out,
// bf16 out; invdeg f32.
int ampnet_edge_attention_layer_simt_bf16(const __nv_bfloat16* qkv, int ldqkv,
                                          const int* tile_senders, const int* tile_valid,
                                          const int* recv_ptr, const int* recv_slots,
                                          const float* invdeg, const __nv_bfloat16* w_out,
                                          const __nv_bfloat16* b_out, __nv_bfloat16* out,
                                          int num_nodes, int s, int sp, int d, int num_heads,
                                          int softmax, float* work, int work_blocks,
                                          void* stream) {
  return launch<true, __nv_bfloat16, true>(
      qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid, recv_ptr, recv_slots, invdeg,
      w_out, b_out, out, work, work_blocks, num_nodes, s, sp, d, num_heads, softmax,
      (cudaStream_t)stream);
}

// K2's CUDA-core attention launch on f32 rows under mxu_bf16 (the
// attention's operands rounded to bf16, the epilogue f32); the arguments of
// ampnet_edge_attention_layer_simt.
int ampnet_edge_attention_layer_simt_mxu(const float* qkv, int ldqkv,
                                         const int* tile_senders, const int* tile_valid,
                                         const int* recv_ptr, const int* recv_slots,
                                         const float* invdeg, const float* w_out,
                                         const float* b_out, float* out, int num_nodes, int s,
                                         int sp, int d, int num_heads, int softmax,
                                         float* work, int work_blocks, void* stream) {
  return launch<true, float, true>(qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid,
                                   recv_ptr, recv_slots, invdeg, w_out, b_out, out, work,
                                   work_blocks, num_nodes, s, sp, d, num_heads, softmax,
                                   (cudaStream_t)stream);
}

}  // extern "C"
