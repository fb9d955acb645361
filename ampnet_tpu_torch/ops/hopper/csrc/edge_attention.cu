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

#include "common.cuh"

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

// One receiver n, its working set at smem (shared or device memory).
template <bool kLayer>
__device__ __forceinline__ void
receiver_sums(int n, float* smem, const float* __restrict__ q, int ldq,
              const float* __restrict__ kv, int ldkv,
              const int* __restrict__ tile_senders,
              const int* __restrict__ tile_valid,
              const int* __restrict__ recv_ptr,
              const int* __restrict__ recv_slots,
              const float* __restrict__ invdeg,
              const float* __restrict__ w_out,
              const float* __restrict__ b_out,
              float* __restrict__ out,
              int s, int sp, int d, int num_heads, int softmax) {
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
  const float scale = 1.0f / sqrtf((float)dh);
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
          if (i0 + u < s) r[u] = q[(qrow0 + i0 + u) * ldq + c];
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u)
          if (i0 + u < s) qs[(i0 + u) * ld + c] = r[u] * scale;
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
          if (i0 + u < s) r[u] = kv[(krow0 + i0 + u) * ldkv + c];
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u)
          if (i0 + u < s) dst[(i0 + u) * ldd] = r[u];
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
          if (j < s) ps[(h * s4 + i) * s + j] = a[u][v];
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
        for (int j = lane; j < s; j += 32) p[j] = p[j] / sum;
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

  float* orow = out + qrow0 * d;
  if (kLayer) {
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
  for (int e = s * d + tid; e < sp * d; e += kThreads) orow[e] = 0.0f;
}

// kDeviceMem = false: one block per receiver, its working set in dynamic
// shared memory. kDeviceMem = true: block b works in work[b * smem_floats]
// and takes receivers b, b + gridDim.x, ...
template <bool kLayer, bool kDeviceMem>
__global__ void __launch_bounds__(kThreads)
edge_attention_kernel(const float* __restrict__ q, int ldq,
                      const float* __restrict__ kv, int ldkv,
                      const int* __restrict__ tile_senders,
                      const int* __restrict__ tile_valid,
                      const int* __restrict__ recv_ptr,
                      const int* __restrict__ recv_slots,
                      const float* __restrict__ invdeg,
                      const float* __restrict__ w_out,
                      const float* __restrict__ b_out,
                      float* __restrict__ out, float* __restrict__ work,
                      int num_nodes, int s, int sp, int d, int num_heads,
                      int softmax) {
  extern __shared__ float shared[];
  if (!kDeviceMem) {  // no loop: the loop costs this body registers
    receiver_sums<kLayer>(blockIdx.x, shared, q, ldq, kv, ldkv, tile_senders, tile_valid,
                          recv_ptr, recv_slots, invdeg, w_out, b_out, out, s, sp, d,
                          num_heads, softmax);
    return;
  }
  float* smem = work + blockIdx.x * smem_floats(s, d, num_heads);
  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x)
    receiver_sums<kLayer>(n, smem, q, ldq, kv, ldkv, tile_senders, tile_valid,
                          recv_ptr, recv_slots, invdeg, w_out, b_out, out, s,
                          sp, d, num_heads, softmax);
}

// work == nullptr: the working set in shared memory (the caller checked
// that it fits); else work_blocks slices of smem_floats in device memory.
template <bool kLayer>
int launch(const float* q, int ldq, const float* kv, int ldkv,
           const int* tile_senders, const int* tile_valid,
           const int* recv_ptr, const int* recv_slots,
           const float* invdeg, const float* w_out, const float* b_out,
           float* out, float* work, int work_blocks, int num_nodes, int s,
           int sp, int d, int num_heads, int softmax, cudaStream_t stream) {
  if (num_nodes <= 0) return (int)cudaGetLastError();
  if (work != nullptr) {
    edge_attention_kernel<kLayer, true><<<work_blocks, kThreads, 0, stream>>>(
        q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr, recv_slots,
        invdeg, w_out, b_out, out, work, num_nodes, s, sp, d, num_heads, softmax);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_floats(s, d, num_heads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_attention_kernel<kLayer, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_attention_kernel<kLayer, false><<<num_nodes, kThreads, smem, stream>>>(
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
  return launch<false>(q, ldq, kv, ldkv, tile_senders, tile_valid, recv_ptr,
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
  return launch<true>(qkv, ldqkv, qkv + d, ldqkv, tile_senders, tile_valid,
                      recv_ptr, recv_slots, invdeg, w_out, b_out, out, work,
                      work_blocks, num_nodes, s, sp, d, num_heads, softmax,
                      (cudaStream_t)stream);
}

}  // extern "C"
