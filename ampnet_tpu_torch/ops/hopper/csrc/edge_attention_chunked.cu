// Receiver-chunked forward kernel on Hopper (sm_90a), f32, on the CUDA
// cores.
//
// Replaces the TPU kernel _fused_kernel_chunked of ampnet_tpu/ops/pallas/
// edge_attention_fused.py (:1225, launcher _fused_edge_sums_chunked :1364)
// over the chunked layout of format.py::build_chunked_csr:
//   * K8's CUDA-core body, ampnet_edge_attention_sums_chunked_simt: the
//     per-receiver SUM of per-edge attention messages, taken chunk by chunk:
//     a chunk is up to C edges that share ONE receiver, their K|V rows laid
//     side by side, so that one score product [H*S, C*S], one per-edge
//     softmax over its segments and ONE value product over the C*S
//     contracted rows give the chunk's summed message, accumulated once.
// K8 runs on the tensor cores (edge_attention_chunked_tc.cu) within their
// instantiated range; this body is the route beyond it (S > 48, D/H > 32,
// more than 12 warps, rows the 16-byte copies cannot take), at every shape:
// where a block's working set (smem_floats, mirrored in launch.py) exceeds
// the 227 KB of shared memory a block may have even at a piece of one edge,
// the same body keeps it in device memory instead, one slice per resident
// block, and the blocks walk the receivers in turn.
//
// Design. A receiver's chunks are consecutive in its tile, so ONE BLOCK PER
// RECEIVER walks them (chunk_start / chunk_count): its Q rows are read once
// for all of them and its S x D accumulator stays in its working set,
// written once; no atomics, the sums repeat bit for bit. Per chunk the block
// compacts the live slots (a slot of validity 0, the padding of a partial
// chunk or an edge masked at run time, costs no gather and contributes
// exactly 0). C edges side by side at S=40 would take 328 KB of K|V and
// scores; a block has 227 KB. So the chunk is walked in PIECES of P live
// edges that fit (P is a launch parameter; the sum over pieces is the sum
// over the chunk). Per piece: P gathers, one score pass over P*S key
// columns, the softmax with each edge's own maximum and denominator (the TPU
// body shifts a row by its shared maximum and divides by per-edge segment
// sums; the result is the same function), one value product contracted over
// the piece's P*S rows, one accumulate: four barriers per piece where the
// per-edge kernels pay four per edge.
//
// Bound (H100 SXM), as K1's: 4*S^2*D FLOP per live edge (0.13 ms at the S=40
// Cora shapes) against q, k|v and the output rows once: by operations at
// S=40, by bytes at S=20.
//
// bf16 (ampnet_edge_attention_sums_chunked_simt_bf16, launch.py's body
// 'simt_bf16'): the same body over bf16 rows beyond the bf16 tensor-core
// body's range (edge_attention_chunked_tc_bf16.cu), the working set f32,
// rounding where _fused_kernel_chunked rounds on bf16 rows (q times the
// bf16 1/sqrt(dh), then the weights before the value product;
// attention_tiles.cuh); the sums f32, as its out_shape is.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunk = 32;

// qs [s2][ld], ks [piece][s4][ld], vs [piece*s][d], ps [h][s4][piece*s],
// acc [s][d]
__host__ __device__ inline size_t smem_floats(int s, int d, int h, int piece) {
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  return (size_t)(s2 + piece * s4) * (d + 1) + (size_t)(piece + 1) * s * d +
         (size_t)h * s4 * piece * s;
}

// One receiver n, its working set at smem (shared or device memory); every
// element of it is zeroed first (pad rows of qs / ks / ps must read 0). T:
// the rows' type (bf16: the products' operands are bf16).
template <typename T>
__device__ __forceinline__ void
receiver_chunks(int n, float* smem, int* live_snd, int& n_live, const T* __restrict__ q,
                int ldq, const T* __restrict__ kv, int ldkv,
                const int* __restrict__ chunk_senders, const int* __restrict__ chunk_valid,
                const int* __restrict__ chunk_start, const int* __restrict__ chunk_count,
                float* __restrict__ out, int chunk, int piece, int s, int sp, int d,
                int num_heads, int softmax) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  const int tid = threadIdx.x;
  const int dh = d / num_heads, ld = d + 1;
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  const int ldp = piece * s;
  float* qs = smem;
  float* ks = qs + s2 * ld;
  float* vs = ks + piece * s4 * ld;
  float* ps = vs + piece * s * d;
  float* acc = ps + num_heads * s4 * ldp;

  const int c0 = chunk_start[n];
  const int nchunks = chunk_count[n];
  const size_t qrow0 = (size_t)n * sp;

  // the block's previous receiver is done with its working set; then Q
  __syncthreads();
  const int total = (int)smem_floats(s, d, num_heads, piece);
  for (int e = tid; e < total; e += kThreads) smem[e] = 0.0f;
  __syncthreads();
  if (nchunks > 0)
    load_tile<kBf16>(q, qrow0, ldq, 0, d, s, qs, ld,
                     kBf16 ? head_scale<T>(dh) : 1.0f / sqrtf((float)dh));

  for (int ci = 0; ci < nchunks; ++ci) {
    const size_t base = (size_t)(c0 + ci) * chunk;
    __syncthreads();  // the previous chunk's pieces are done with live_snd
    if (tid == 0) {
      int nv = 0;
      for (int j = 0; j < chunk; ++j)
        if (chunk_valid[base + j] != 0) live_snd[nv++] = chunk_senders[base + j];
      n_live = nv;
    }
    __syncthreads();
    const int nv = n_live;
    for (int p0 = 0; p0 < nv; p0 += piece) {
      const int np = min(piece, nv - p0);
      if (p0 > 0) __syncthreads();  // the previous piece is done with ks, vs, ps
      for (int e = 0; e < np; ++e) {
        const size_t krow0 = (size_t)live_snd[p0 + e] * sp;
        load_tile<kBf16>(kv, krow0, ldkv, 0, d, s, ks + e * s4 * ld, ld, 1.0f);
        load_tile<kBf16>(kv, krow0, ldkv, d, d, s, vs + e * s * d, d, 1.0f);
      }
      __syncthreads();
      score_tiles<kBf16>(qs, ks, ps, ldp, np, s, d, num_heads, softmax);
      __syncthreads();
      if (softmax) {
        softmax_segments<kBf16>(ps, ldp, np, s, num_heads);
        __syncthreads();
      }
      // columns beyond np * s hold an earlier piece's weights: not contracted
      message_tiles(ps, ldp, vs, np * s, s, d, num_heads,
                    [&](int i, int c, float a) { acc[i * d + c] += a; });
    }
  }
  __syncthreads();

  float* orow = out + qrow0 * d;
  for (int e = tid; e < s * d; e += kThreads) orow[e] = acc[e];
  for (int e = s * d + tid; e < sp * d; e += kThreads) orow[e] = 0.0f;
}

// kDeviceMem = false: one block per receiver, its working set in dynamic
// shared memory. kDeviceMem = true: block b works in work[b * smem_floats]
// and takes receivers b, b + gridDim.x, ...
template <bool kDeviceMem, typename T>
__global__ void __launch_bounds__(kThreads)
edge_chunk_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ kv, int ldkv,
                  const int* __restrict__ chunk_senders, const int* __restrict__ chunk_valid,
                  const int* __restrict__ chunk_start, const int* __restrict__ chunk_count,
                  float* __restrict__ out, float* __restrict__ work, int num_nodes, int chunk,
                  int piece, int s, int sp, int d, int num_heads, int softmax) {
  extern __shared__ float shared[];
  __shared__ int live_snd[kMaxChunk];
  __shared__ int n_live;
  if (!kDeviceMem) {  // no loop, as the other CUDA-core bodies
    receiver_chunks(blockIdx.x, shared, live_snd, n_live, q, ldq, kv, ldkv, chunk_senders,
                    chunk_valid, chunk_start, chunk_count, out, chunk, piece, s, sp, d,
                    num_heads, softmax);
    return;
  }
  float* smem = work + blockIdx.x * smem_floats(s, d, num_heads, piece);
  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x)
    receiver_chunks(n, smem, live_snd, n_live, q, ldq, kv, ldkv, chunk_senders, chunk_valid,
                    chunk_start, chunk_count, out, chunk, piece, s, sp, d, num_heads, softmax);
}

// work == nullptr: the working set at `piece` in shared memory (the caller
// checked that it fits); else work_blocks slices of smem_floats.
template <typename T>
int launch(const T* q, int ldq, const T* kv, int ldkv, const int* chunk_senders,
           const int* chunk_valid, const int* chunk_start, const int* chunk_count, float* out,
           int num_nodes, int chunk, int piece, int s, int sp, int d, int num_heads,
           int softmax, float* work, int work_blocks, cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxChunk || piece < 1 || piece > chunk)
    return (int)cudaErrorInvalidValue;
  if (num_nodes <= 0) return (int)cudaGetLastError();
  if (work != nullptr) {
    edge_chunk_kernel<true, T><<<work_blocks, kThreads, 0, stream>>>(
        q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start, chunk_count, out, work,
        num_nodes, chunk, piece, s, sp, d, num_heads, softmax);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_floats(s, d, num_heads, piece) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_chunk_kernel<false, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_chunk_kernel<false, T><<<num_nodes, kThreads, smem, stream>>>(
      q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start, chunk_count, out, nullptr,
      num_nodes, chunk, piece, s, sp, d, num_heads, softmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of working set one block needs at a piece of `piece` edges (the
// wrapper puts it in shared memory where it fits, else in device memory).
size_t ampnet_edge_chunk_smem_bytes(int s, int d, int num_heads, int piece) {
  return smem_floats(s, d, num_heads, piece) * sizeof(float);
}

// K8's CUDA-core body (the route beyond edge_attention_chunked_tc.cu's
// range). q: [num_nodes*sp] rows of d floats (row stride ldq); kv: rows of
// k|v (2d floats, stride ldkv); chunk_senders / chunk_valid: the chunked
// layout's [T, NCMAX*chunk] slots, flat; chunk_start / chunk_count:
// [num_nodes], the flat index (tile*NCMAX + chunk) of each receiver's first
// chunk and the number of its chunks; out: [num_nodes*sp, d] contiguous;
// work: null (the working set at `piece` in shared memory; the caller
// checked that it fits) or work_blocks * smem_bytes of device memory.
int ampnet_edge_attention_sums_chunked_simt(const float* q, int ldq, const float* kv,
                                            int ldkv, const int* chunk_senders,
                                            const int* chunk_valid, const int* chunk_start,
                                            const int* chunk_count, float* out,
                                            int num_nodes, int chunk, int piece, int s,
                                            int sp, int d, int num_heads, int softmax,
                                            float* work, int work_blocks, void* stream) {
  return launch(q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start, chunk_count, out,
                num_nodes, chunk, piece, s, sp, d, num_heads, softmax, work, work_blocks,
                (cudaStream_t)stream);
}

// K8's CUDA-core body in bf16: bf16 q and k|v rows, the arguments of
// ampnet_edge_attention_sums_chunked_simt; out f32.
int ampnet_edge_attention_sums_chunked_simt_bf16(
    const __nv_bfloat16* q, int ldq, const __nv_bfloat16* kv, int ldkv,
    const int* chunk_senders, const int* chunk_valid, const int* chunk_start,
    const int* chunk_count, float* out, int num_nodes, int chunk, int piece, int s, int sp,
    int d, int num_heads, int softmax, float* work, int work_blocks, void* stream) {
  return launch(q, ldq, kv, ldkv, chunk_senders, chunk_valid, chunk_start, chunk_count, out,
                num_nodes, chunk, piece, s, sp, d, num_heads, softmax, work, work_blocks,
                (cudaStream_t)stream);
}

}  // extern "C"
