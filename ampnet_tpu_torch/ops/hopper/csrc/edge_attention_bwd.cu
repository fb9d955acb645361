// Backward of the per-edge attention on Hopper (sm_90a), f32: the two
// scatter-free passes and the stream backward, three instantiations of one
// kernel body.
//
// Replaces the TPU backward kernels of ampnet_tpu/ops/pallas/
// edge_attention_bwd_scatterfree.py:
//   * K3's CUDA-core body, ampnet_edge_attention_bwd_dq_simt <- pass R,
//     _dq_kernel_vmem (:167) and _dq_kernel_dma (:211), math _dq_group_math
//     (:61): per edge, recompute the scores and the softmax, dW = dMsg V^T,
//     the softmax backward dS = W (dW - rowsum(dW W)), dQ = dS K / sqrt(dh);
//     summed per RECEIVER;
//   * K4's CUDA-core body, ampnet_edge_attention_bwd_dkv_simt <- pass S,
//     _dkv_kernel_vmem (:280) and _dkv_kernel_dma (:319), math
//     _dkv_group_math (:105): the same recompute, then dV = W^T dMsg and dK
//     = dS^T Q / sqrt(dh); summed per SENDER. K3 and K4 run on the tensor
//     cores (edge_attention_bwd_dq_tc.cu, edge_attention_bwd_tc.cu) within
//     their instantiated range; these two bodies are the route beyond it,
//     at every shape (below);
// and the four stream-backward bodies of ampnet_tpu/ops/pallas/
// edge_attention_bwd.py (pass A):
//   * K5's CUDA-core body, ampnet_edge_attention_bwd_stream_simt <-
//     _bwd_kernel_vmem_v2 (:178),
//     _bwd_kernel_dma_compact (:694), _bwd_kernel_dma (:545) and
//     _bwd_kernel_vmem (:32): K3's dQ per receiver AND, per edge, the rows
//     dK = dS^T Q / sqrt(dh) | dV = W^T dMsg written to a stream in device
//     memory, which a later pass sums by sender. For layouts that have no
//     sender side to walk. K5 runs on the tensor cores
//     (edge_attention_bwd_stream_tc.cu) within K3's range up to S=48; this
//     body is the route beyond it.
// With softmax=0 the weights are the raw scaled scores and dS = dW.
//
// Design. As in the forward (edge_attention.cu), a TPU tile's accumulator
// cannot be one thread block, so ONE BLOCK PER NODE: K3 a receiver, K4 a
// sender. The block holds its own rows (K3: Q and dMsg; K4: K and V) and
// an f32 accumulator in shared memory (K3: S x D; K4: S x 2D), walks its
// edges through a node-major index over the tiled layout's slots
// (format.py::receiver_index, given the receiver or the sender side),
// gathers the peer's rows per edge (K3: the sender's K|V; K4: the
// receiver's [Q | dMsg]) and writes its rows once. K3 and K4 use no
// atomics and no per-edge stream: the sums are taken in slot order, so the
// result is deterministic, like the TPU passes. The trip count is the node's
// STRUCTURAL degree; an edge masked at run time has validity 0 and is
// skipped, so the TPU bodies' clamped duplicate slots have no counterpart.
// Rows are SP apart; only the S real rows are read (the pad-key mask) and
// pad rows are written as 0. Device memory is read either way on Hopper,
// so one kernel per pass serves the 'vmem' and the 'dma' body alike.
// Where a block's working set (smem_floats, mirrored in launch.py) exceeds
// the 227 KB of shared memory a block may have, the same body keeps it in
// device memory instead, one slice per resident block, and the blocks walk
// the nodes in turn.
//
// All three share one kernel body: what differs is which side is the
// block's own and the last products. K5 is K3's block (one per receiver,
// the same shared memory) that also forms K4's last two products from the
// W, dS, Q and dMsg it already holds, and stores them straight from
// registers to the edge's stream rows: row (slot - slot0) * SP + j, 2D
// floats, lanes across columns (coalesced). The TPU bodies' stream strides
// (edge groups) are not carried over; slots that are never walked are never
// written, and the pass that folds the stream reads the walked slots only.
// A slot masked at run time is walked and gets zeros; rows S..SP-1 of a
// walked slot are written as 0. The launch takes a range of receivers
// (node0, slot0) so that a caller can cap the live stream by running tile
// chunks.
//
// Bound (H100 SXM), at the S=40 Cora shapes over 10,344 live edges: K3 does
// 6*S^2*D FLOP per edge (12.7 GFLOP, 0.19 ms at 67 TFLOP/s f32) and moves
// ~282 MB (0.08 ms at 3.35 TB/s); K4 8*S^2*D per edge (16.9 GFLOP, 0.25 ms)
// and ~338 MB (0.10 ms); K5 10*S^2*D per edge (21.2 GFLOP, 0.32 ms) and
// ~282 MB + 424 MB of stream (0.21 ms): all bound by operations. They run
// on the CUDA cores in f32 from shared memory with the forward's register
// tiles (2 x 4 for the two score-shaped products, 4 x 1 column for the
// last); at these sizes one block fills an SM's shared memory, so 512
// threads a block keep 16 warps on it. Within their range K3, K4 and K5 run
// on the tensor cores with cp.async rings instead.
//
// bf16 (the *_simt_bf16 entry points, launch.py's body 'simt_bf16'): the
// same three bodies over bf16 rows beyond the bf16 tensor-core bodies'
// range. The working set stays f32 (the same smem_floats), each value
// converted as it is loaded, and the rounding is the JAX bodies' (as
// edge_attention_bwd_dq_tc_bf16.cu and edge_attention_bwd_tc_bf16.cu take
// it): the scores' q times the bf16 1/sqrt(dh), rounded to bf16 (K3 keeps Q
// so in shared memory; K4 and K5 keep Q unscaled for dK and round q times
// the scale as the score tile reads it); dW from the bf16 rows as they are;
// the softmax and its backward in f32; W and dS rounded to bf16 before
// their products (without the softmax: the raw scores and dW); each edge's
// dQ and dK summed in f32 and scaled by the f32 1/sqrt(dh) after the
// product. dQ, dK|dV and the stream are f32.

#include <type_traits>

#include "common.cuh"
#include "rows_bf16.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadBatch = 4;  // global loads each lane keeps in flight
constexpr int kDq = 0, kDkv = 1, kStream = 2;  // K3, K4, K5

// Shared memory per block, in floats (s2 = s rounded up to 2, s4 to 4, ld =
// d + 1; pad rows and columns stay 0, so the register tiles need no guards
// on reads):
//   qs  [s2][ld]     Q rows, pre-scaled by 1/sqrt(dh)
//   dms [s2][ld]     dMsg rows (gradient of the per-receiver sum)
//   ks  [s4][ld]     K rows
//   vs  [s4][ld]     V rows
//   ps  [h][s4][s4]  scores, then weights W        (query row, key column)
//   gs  [h][s4][s4]  dW, then dS
//   acc [s][d] (K3 and K5, dQ) or [s][2d] (K4, dK | dV)
__host__ __device__ inline size_t smem_floats(int s, int d, int h, int mode) {
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  return (size_t)(2 * s2 + 2 * s4) * (d + 1) + (size_t)2 * h * s4 * s4 +
         (size_t)s * d * (mode == kDkv ? 2 : 1);
}

// Rows [row0, row0 + s) of src (row stride ld_src), columns [0, ncols):
// column c < d goes to dst_a[row][c] * mul_a (kRound: rounded to bf16),
// column c >= d to dst_b[row][c - d]. One warp per row, lanes across
// columns (coalesced), kLoadBatch loads in flight per lane before any store.
template <typename T, bool kRound>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, size_t row0,
                                          int ld_src, int ncols, int s, int d,
                                          float* dst_a, float mul_a, float* dst_b,
                                          int ld_dst) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < s; row += kWarps) {
    const T* r = src + (row0 + row) * (size_t)ld_src;
    for (int c0 = lane; c0 < ncols; c0 += 32 * kLoadBatch) {
      float x[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        if (c0 + 32 * u < ncols) x[u] = to_f32(r[c0 + 32 * u]);
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int c = c0 + 32 * u;
        if (c < ncols) {
          if (c < d) dst_a[row * ld_dst + c] = kRound ? round_bf16(x[u] * mul_a) : x[u] * mul_a;
          else dst_b[row * ld_dst + c - d] = x[u];
        }
      }
    }
  }
}

// out[u][v] = sum_c a0[u * ld + c] * b0[v * ld + c], u < 2, v < 4, c < dh;
// kScaleA: a0's values times a_scale, rounded to bf16, as they are read
template <bool kScaleA = false>
__device__ __forceinline__ void tile_2x4(const float* a0, const float* b0, int ld,
                                         int dh, float out[2][4], float a_scale = 1.0f) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) out[u][v] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < dh; ++c) {
    const float x0 = kScaleA ? round_bf16(a0[c] * a_scale) : a0[c];
    const float x1 = kScaleA ? round_bf16(a0[ld + c] * a_scale) : a0[ld + c];
    const float y0 = b0[c], y1 = b0[ld + c], y2 = b0[2 * ld + c], y3 = b0[3 * ld + c];
    out[0][0] = fmaf(x0, y0, out[0][0]); out[0][1] = fmaf(x0, y1, out[0][1]);
    out[0][2] = fmaf(x0, y2, out[0][2]); out[0][3] = fmaf(x0, y3, out[0][3]);
    out[1][0] = fmaf(x1, y0, out[1][0]); out[1][1] = fmaf(x1, y1, out[1][1]);
    out[1][2] = fmaf(x1, y2, out[1][2]); out[1][3] = fmaf(x1, y3, out[1][3]);
  }
}

// kBf16 without the softmax: the tile is a product's operand, rounded to bf16
template <bool kBf16 = false>
__device__ __forceinline__ void store_2x4(float* dst, int s4, int s, int i0, int j0,
                                          const float a[2][4], int softmax = 1) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (i0 + u >= s) break;
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (j0 + v < s)
        dst[(i0 + u) * s4 + j0 + v] = kBf16 && !softmax ? round_bf16(a[u][v]) : a[u][v];
  }
}

// The block's node n = node0 + local, its working set at smem (shared or
// device memory).
// kMode = kDq:     K3, node n is a receiver, peers are its senders.
// kMode = kDkv:    K4, node n is a sender, peers are its receivers; dm must
//                  be q + d of one packed [Q | dMsg] row array (ldq == lddm).
// kMode = kStream: K5, K3's work for receiver n; out takes the dQ rows of
//                  the launched range, stream the dK | dV rows of each
//                  walked slot, counted from slot0.
// T: the rows' type (bf16: the products' operands are bf16).
template <int kMode, typename T>
__device__ __forceinline__ void
node_backward(int local, float* smem, const T* __restrict__ q, int ldq,
              const T* __restrict__ dm, int lddm,
              const T* __restrict__ kv, int ldkv,
              const int* __restrict__ peer_ids,
              const int* __restrict__ valid,
              const int* __restrict__ ptr,
              const int* __restrict__ slots,
              float* __restrict__ out,
              float* __restrict__ stream, int node0, int slot0,
              int s, int sp, int d, int num_heads, int softmax) {
  const int n = node0 + local;
  const int tid = threadIdx.x;
  const int dh = d / num_heads;
  const int ld = d + 1;
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  const int dacc = kMode == kDkv ? 2 * d : d;
  float* qs = smem;
  float* dms = qs + s2 * ld;
  float* ks = dms + s2 * ld;
  float* vs = ks + s4 * ld;
  float* ps = vs + s4 * ld;
  float* gs = ps + num_heads * s4 * s4;
  float* acc = gs + num_heads * s4 * s4;

  const int beg = ptr[n];
  const int end = ptr[n + 1];
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  // bf16: K3 keeps Q times the bf16 scale, rounded; K4 and K5 keep Q as it
  // is (dK's operand) and the score tile scales and rounds it
  constexpr bool kScaledQ = kBf16 && kMode != kDq;
  // dQ's and dK's scale (f32: also Q's in shared memory); the scores' q scale
  const float scale = kBf16 ? (float)(1.0 / sqrt((double)dh)) : 1.0f / sqrtf((float)dh);
  const float qscale = kBf16 ? head_scale<T>(dh) : scale;
  const float own_q_mul = kScaledQ ? 1.0f : qscale;
  const size_t own0 = (size_t)n * sp;

  // zero everything once (pad rows and columns must read 0), then own rows;
  // the block's previous node is done with its working set
  const int total = (int)smem_floats(s, d, num_heads, kMode);
  __syncthreads();
  for (int e = tid; e < total; e += kThreads) smem[e] = 0.0f;
  __syncthreads();
  if (beg < end) {
    if (kMode == kDkv) {
      load_rows<T, false>(kv, own0, ldkv, 2 * d, s, d, ks, 1.0f, vs, ld);
    } else {
      load_rows<T, kBf16 && !kScaledQ>(q, own0, ldq, d, s, d, qs, own_q_mul, nullptr, ld);
      load_rows<T, false>(dm, own0, lddm, d, s, d, dms, 1.0f, nullptr, ld);
    }
  }

  const int n_ip = s2 / 2, n_jq = s4 / 4;  // score-shaped tiles: 2 rows x 4 columns
  const int n_tile = num_heads * n_ip * n_jq;
  const int n_last = (s4 / 4) * d;         // last product: 4 rows x 1 column
  // K4 and K5 need the weights for dV even without a softmax
  const bool need_scores = softmax || kMode != kDq;

  for (int k = beg; k < end; ++k) {
    const int slot = slots[k];
    float* srow = nullptr;  // K5: this slot's sp rows of dK | dV
    if (kMode == kStream) srow = stream + (size_t)(slot - slot0) * sp * 2 * d;
    if (valid[slot] == 0) {  // the same for every thread of the block
      if (kMode == kStream)
        for (int e = tid; e < sp * 2 * d; e += kThreads) srow[e] = 0.0f;
      continue;
    }
    const size_t peer0 = (size_t)peer_ids[slot] * sp;
    __syncthreads();  // the previous edge is done with the peer rows, ps and gs

    if (kMode == kDkv) load_rows<T, false>(q, peer0, ldq, 2 * d, s, d, qs, own_q_mul, dms, ld);
    else load_rows<T, false>(kv, peer0, ldkv, 2 * d, s, d, ks, 1.0f, vs, ld);
    __syncthreads();

    // scores = (Q / sqrt(dh)) K^T and dW = dMsg V^T, [query, key] per head
    for (int t = tid; t < n_tile; t += kThreads) {
      const int jq = t % n_jq, r = t / n_jq, ip = r % n_ip, h = r / n_ip;
      const int ro = (2 * ip) * ld + h * dh, co = (4 * jq) * ld + h * dh;
      float a[2][4];
      if (need_scores) {
        tile_2x4<kScaledQ>(qs + ro, ks + co, ld, dh, a, qscale);
        store_2x4<kBf16>(ps + h * s4 * s4, s4, s, 2 * ip, 4 * jq, a, softmax);
      }
      tile_2x4(dms + ro, vs + co, ld, dh, a);
      store_2x4<kBf16>(gs + h * s4 * s4, s4, s, 2 * ip, 4 * jq, a, softmax);
    }
    __syncthreads();

    if (softmax) {  // one warp per (head, query) row: W, then dS in place of dW
      const int warp = tid / 32, lane = tid % 32;
      for (int row = warp; row < num_heads * s; row += kWarps) {
        const int o = ((row / s) * s4 + row % s) * s4;
        float* p = ps + o;
        float* g = gs + o;
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
        float dot = 0.0f;
        for (int j = lane; j < s; j += 32) {
          const float w = p[j] / sum;
          p[j] = w;
          dot = fmaf(g[j], w, dot);
        }
        dot = warp_sum(dot);
        if (kBf16) {  // W and dS round to bf16 as their products' operands
          for (int j = lane; j < s; j += 32) {
            const float w = p[j];
            g[j] = round_bf16(w * (g[j] - dot));
            p[j] = round_bf16(w);
          }
        } else {
          for (int j = lane; j < s; j += 32) g[j] = p[j] * (g[j] - dot);
        }
      }
      __syncthreads();
    }

    // each thread owns the same accumulator elements on every edge
    for (int t = tid; t < n_last; t += kThreads) {
      const int c = t % d, r0 = 4 * (t / d), h = c / dh;
      if (kMode != kDkv) {
        // dQ[i][c] = sum_j dS[i][j] K[j][c] / sqrt(dh); i = r0 .. r0 + 3
        const float* g = gs + (h * s4 + r0) * s4;
        float a[4] = {};
#pragma unroll 4
        for (int j = 0; j < s; ++j) {
          const float x = ks[j * ld + c];
#pragma unroll
          for (int v = 0; v < 4; ++v) a[v] = fmaf(g[v * s4 + j], x, a[v]);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (r0 + v < s) acc[(r0 + v) * dacc + c] += a[v] * scale;
      }
      if (kMode != kDq) {
        // dV[j][c] = sum_i W[i][j] dMsg[i][c]; dK[j][c] = sum_i dS[i][j] Qs[i][c]
        // (f32: Qs carries the 1/sqrt(dh); bf16: Q, scaled after); j = r0 .. r0 + 3
        const float* p = ps + h * s4 * s4 + r0;
        const float* g = gs + h * s4 * s4 + r0;
        float dv[4] = {}, dk[4] = {};
#pragma unroll 2
        for (int i = 0; i < s; ++i) {
          const float m = dms[i * ld + c], x = qs[i * ld + c];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            dv[v] = fmaf(p[i * s4 + v], m, dv[v]);
            dk[v] = fmaf(g[i * s4 + v], x, dk[v]);
          }
        }
        if (kBf16) {
#pragma unroll
          for (int v = 0; v < 4; ++v) dk[v] *= scale;
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (r0 + v < s) {
            if (kMode == kDkv) {
              acc[(r0 + v) * dacc + c] += dk[v];
              acc[(r0 + v) * dacc + d + c] += dv[v];
            } else {
              srow[(size_t)(r0 + v) * 2 * d + c] = dk[v];
              srow[(size_t)(r0 + v) * 2 * d + d + c] = dv[v];
            }
          }
      }
    }
    if (kMode == kStream)
      for (int e = s * 2 * d + tid; e < sp * 2 * d; e += kThreads) srow[e] = 0.0f;
  }
  __syncthreads();

  float* orow = out + (size_t)local * sp * dacc;
  for (int e = tid; e < s * dacc; e += kThreads) orow[e] = acc[e];
  for (int e = s * dacc + tid; e < sp * dacc; e += kThreads) orow[e] = 0.0f;
}

// kDeviceMem = false: one block per node, its working set in dynamic shared
// memory. kDeviceMem = true: block b works in work[b * smem_floats] and
// takes the nodes b, b + gridDim.x, ... of the launched range.
template <int kMode, bool kDeviceMem, typename T>
__global__ void __launch_bounds__(kThreads)
edge_attention_bwd_kernel(const T* __restrict__ q, int ldq,
                          const T* __restrict__ dm, int lddm,
                          const T* __restrict__ kv, int ldkv,
                          const int* __restrict__ peer_ids,
                          const int* __restrict__ valid,
                          const int* __restrict__ ptr,
                          const int* __restrict__ slots,
                          float* __restrict__ out,
                          float* __restrict__ stream, float* __restrict__ work,
                          int node0, int num_nodes, int slot0, int s, int sp,
                          int d, int num_heads, int softmax) {
  extern __shared__ float shared[];
  if (!kDeviceMem) {  // no loop: the loop costs this body registers
    node_backward<kMode, T>(blockIdx.x, shared, q, ldq, dm, lddm, kv, ldkv, peer_ids, valid,
                         ptr, slots, out, stream, node0, slot0, s, sp, d, num_heads,
                         softmax);
    return;
  }
  float* smem = work + blockIdx.x * smem_floats(s, d, num_heads, kMode);
  for (int local = blockIdx.x; local < num_nodes; local += gridDim.x)
    node_backward<kMode, T>(local, smem, q, ldq, dm, lddm, kv, ldkv, peer_ids, valid,
                         ptr, slots, out, stream, node0, slot0, s, sp, d,
                         num_heads, softmax);
}

// work == nullptr: the working set in shared memory (the caller checked
// that it fits); else work_blocks slices of smem_floats in device memory.
template <int kMode, typename T>
int launch(const T* q, int ldq, const T* dm, int lddm, const T* kv,
           int ldkv, const int* peer_ids, const int* valid, const int* ptr,
           const int* slots, float* out, float* stream_out, float* work,
           int work_blocks, int node0, int num_nodes, int slot0, int s, int sp,
           int d, int num_heads, int softmax, cudaStream_t stream) {
  if (num_nodes <= 0) return (int)cudaGetLastError();
  if (work != nullptr) {
    edge_attention_bwd_kernel<kMode, true, T><<<work_blocks, kThreads, 0, stream>>>(
        q, ldq, dm, lddm, kv, ldkv, peer_ids, valid, ptr, slots, out, stream_out,
        work, node0, num_nodes, slot0, s, sp, d, num_heads, softmax);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_floats(s, d, num_heads, kMode) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_attention_bwd_kernel<kMode, false, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_attention_bwd_kernel<kMode, false, T><<<num_nodes, kThreads, smem, stream>>>(
      q, ldq, dm, lddm, kv, ldkv, peer_ids, valid, ptr, slots, out, stream_out,
      nullptr, node0, num_nodes, slot0, s, sp, d, num_heads, softmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of working set one block needs (mode 0: K3, 1: K4, 2: K5); the
// wrappers put it in shared memory where it fits the card's per-block limit,
// else in device memory.
size_t ampnet_edge_attention_bwd_smem_bytes(int s, int d, int num_heads, int mode) {
  return smem_floats(s, d, num_heads, mode) * sizeof(float);
}

// K3's CUDA-core body (the route beyond edge_attention_bwd_dq_tc.cu's
// range). q, dsum: [num_nodes*sp] rows of d floats (row strides ldq,
// lddsum); kv: rows of k|v (2d floats, stride ldkv); tile_senders /
// tile_valid over the receiver-tiled slots, recv_ptr / recv_slots the
// receiver-major index; dq: [num_nodes*sp, d] contiguous; work: null
// (shared memory) or work_blocks * smem_bytes of device memory.
int ampnet_edge_attention_bwd_dq_simt(const float* q, int ldq, const float* dsum,
                                 int lddsum, const float* kv, int ldkv,
                                 const int* tile_senders, const int* tile_valid,
                                 const int* recv_ptr, const int* recv_slots,
                                 float* dq, int num_nodes, int s, int sp, int d,
                                 int num_heads, int softmax, float* work,
                                 int work_blocks, void* stream) {
  return launch<kDq, float>(q, ldq, dsum, lddsum, kv, ldkv, tile_senders, tile_valid,
                     recv_ptr, recv_slots, dq, nullptr, work, work_blocks, 0,
                     num_nodes, 0, s, sp, d, num_heads, softmax,
                     (cudaStream_t)stream);
}

// K4's CUDA-core body (the route beyond edge_attention_bwd_tc.cu's range). qdm:
// rows of q|dsum (2d floats, stride ldqdm); kv as above; snd_receivers /
// snd_valid over the sender-tiled slots, snd_ptr / snd_slots the
// sender-major index; dkv: [num_nodes*sp, 2d] contiguous rows of dk|dv.
int ampnet_edge_attention_bwd_dkv_simt(const float* qdm, int ldqdm, const float* kv,
                                       int ldkv, const int* snd_receivers,
                                       const int* snd_valid, const int* snd_ptr,
                                       const int* snd_slots, float* dkv, int num_nodes,
                                       int s, int sp, int d, int num_heads,
                                       int softmax, float* work, int work_blocks,
                                       void* stream) {
  return launch<kDkv, float>(qdm, ldqdm, qdm + d, ldqdm, kv, ldkv, snd_receivers,
                      snd_valid, snd_ptr, snd_slots, dkv, nullptr, work,
                      work_blocks, 0, num_nodes, 0, s, sp, d, num_heads, softmax,
                      (cudaStream_t)stream);
}

// K5's CUDA-core body (the route beyond edge_attention_bwd_stream_tc.cu's
// range). Inputs as K3, for the num_nodes receivers from node0 on (a range
// of whole tiles); dq: [num_nodes*sp, d] contiguous, the range's rows;
// dkv_stream: rows of dk|dv (2d floats, contiguous), sp rows per slot, slot
// (tile, j) of the layout at row (tile*EMAX + j - slot0)*sp: it must hold
// every slot the range walks.
int ampnet_edge_attention_bwd_stream_simt(const float* q, int ldq, const float* dsum,
                                     int lddsum, const float* kv, int ldkv,
                                     const int* tile_senders, const int* tile_valid,
                                     const int* recv_ptr, const int* recv_slots,
                                     float* dq, float* dkv_stream, int node0,
                                     int num_nodes, int slot0, int s, int sp, int d,
                                     int num_heads, int softmax, float* work,
                                     int work_blocks, void* stream) {
  return launch<kStream, float>(q, ldq, dsum, lddsum, kv, ldkv, tile_senders, tile_valid,
                         recv_ptr, recv_slots, dq, dkv_stream, work, work_blocks,
                         node0, num_nodes, slot0, s, sp, d, num_heads, softmax,
                         (cudaStream_t)stream);
}

// The three CUDA-core bodies in bf16 (launch.py's 'simt_bf16'): bf16 rows,
// the arguments of the f32 entry points above; dq, dkv and the stream f32.
using bf16 = __nv_bfloat16;

int ampnet_edge_attention_bwd_dq_simt_bf16(const bf16* q, int ldq, const bf16* dsum,
                                           int lddsum, const bf16* kv, int ldkv,
                                           const int* tile_senders, const int* tile_valid,
                                           const int* recv_ptr, const int* recv_slots,
                                           float* dq, int num_nodes, int s, int sp, int d,
                                           int num_heads, int softmax, float* work,
                                           int work_blocks, void* stream) {
  return launch<kDq, bf16>(q, ldq, dsum, lddsum, kv, ldkv, tile_senders, tile_valid,
                           recv_ptr, recv_slots, dq, nullptr, work, work_blocks, 0,
                           num_nodes, 0, s, sp, d, num_heads, softmax, (cudaStream_t)stream);
}

int ampnet_edge_attention_bwd_dkv_simt_bf16(const bf16* qdm, int ldqdm, const bf16* kv,
                                            int ldkv, const int* snd_receivers,
                                            const int* snd_valid, const int* snd_ptr,
                                            const int* snd_slots, float* dkv, int num_nodes,
                                            int s, int sp, int d, int num_heads, int softmax,
                                            float* work, int work_blocks, void* stream) {
  return launch<kDkv, bf16>(qdm, ldqdm, qdm + d, ldqdm, kv, ldkv, snd_receivers, snd_valid,
                            snd_ptr, snd_slots, dkv, nullptr, work, work_blocks, 0,
                            num_nodes, 0, s, sp, d, num_heads, softmax,
                            (cudaStream_t)stream);
}

int ampnet_edge_attention_bwd_stream_simt_bf16(const bf16* q, int ldq, const bf16* dsum,
                                               int lddsum, const bf16* kv, int ldkv,
                                               const int* tile_senders,
                                               const int* tile_valid, const int* recv_ptr,
                                               const int* recv_slots, float* dq,
                                               float* dkv_stream, int node0, int num_nodes,
                                               int slot0, int s, int sp, int d, int num_heads,
                                               int softmax, float* work, int work_blocks,
                                               void* stream) {
  return launch<kStream, bf16>(q, ldq, dsum, lddsum, kv, ldkv, tile_senders, tile_valid,
                               recv_ptr, recv_slots, dq, dkv_stream, work, work_blocks,
                               node0, num_nodes, slot0, s, sp, d, num_heads, softmax,
                               (cudaStream_t)stream);
}

}  // extern "C"
