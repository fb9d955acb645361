// Edge-group forward kernels on Hopper (sm_90a), f32 on the CUDA cores: the
// per-receiver SUM of per-edge attention messages with the work cut by
// EDGES, not by receivers. K6 and K9 run on the tensor cores
// (edge_attention_groups_tc.cu) within their instantiated range; these
// bodies are the route beyond it (S > 48, D/H > 32, more than 12 warps, rows
// the 16-byte copies cannot take), at every shape: where a block's working
// set (smem_floats, mirrored in launch.py) exceeds the 227 KB of shared
// memory a block may have, the same body keeps it in device memory instead,
// one slice per resident block, and the blocks walk the items in turn.
//
// Replaces the non-default TPU forward bodies of ampnet_tpu/ops/pallas/
// edge_attention_fused.py:
//   * K6 ampnet_edge_attention_sums_mm_simt <- _fused_kernel_vmem_v2_mm (:731) and
//     _fused_kernel_dma_v8 (:1126) with _mm_scatter_epilogue (:1088): the
//     messages of a tile are buffered on chip and summed onto their
//     receivers by a {0,1} one-hot product, validity folded in as a select;
//     also the attention launch of K7 (_fused_kernel_vmem_v6_mm, :865), whose
//     projection and mean/out-projection launches are in qkv_projection.cu;
//   * K9 ampnet_edge_attention_sums_v1_simt <- _fused_kernel (:186) and
//     _fused_kernel_vmem (:294): G packed edges per step, G | EMAX, every
//     group walked, each edge's message scaled by its validity and added to
//     its receiver's rows on its own.
//
// Design. One block takes one run of G consecutive layout slots of one
// tile (slots are in edge order, so a receiver may span groups and blocks,
// and a group may hold several receivers). The block computes each live
// slot's message with the shared per-edge steps (attention_tiles.cuh); the
// receiver's Q rows are loaded again only when the receiver changes from one
// slot to the next. A TPU tile reduces its group loop into one VMEM
// accumulator; blocks here run in no order and share nothing, so the
// reduction across blocks is an f32 atomicAdd into a ZEROED output: the
// sums are right to rounding but their order, and so their last bits, may
// change from launch to launch.
//   K6 keeps the group's G messages in shared memory (they never go to
//   device memory, as msgT never leaves VMEM) and then reduces them as the
//   one-hot product does: for every receiver of the group, the select-sum
//   of the slots that are valid and point at it, added to the output with
//   ONE atomic per element, whatever the number of its edges in the group.
//   The trip count is structural (groups below ceil(count / G) of the tile);
//   a slot beyond EMAX in a ragged last group, and a slot masked at run
//   time, are selected out and cost no gather.
//   K9 buffers nothing: each message goes from registers to the output,
//   times the slot's validity, one atomic per element and EDGE. Every
//   group of the tile is launched, padding included; a slot of validity 0
//   contributes exactly 0 and is not gathered. The TPU bodies compute a
//   dense [G*SP, G*SP] score block and mask it to its diagonal blocks, a
//   way to feed the matrix unit one large product; the off-diagonal
//   products are discarded there and are not computed here.
// The TPU's group sizes (19 at S=40, 32 at S=20) would need G x 20 KB of
// messages in K6; this body's default group is the largest up to 4 that
// keeps the working set in shared memory (the group moves the order of
// summation only).
//
// bf16 (the *_simt_bf16 entry points, and K6's *_simt_mxu for f32 rows
// under mxu_bf16; launch.py's body 'simt_bf16'): the same bodies beyond the
// bf16 tensor-core body's range (edge_attention_groups_tc_bf16.cu), the
// working set f32, the rows converted and rounded as they are loaded and
// the weights rounded before the value product (attention_tiles.cuh); the
// messages, their buffer and their reduction stay f32, as JAX's f32
// one-hot product (_mm_scatter_epilogue) and adds are.
//
// Bound (H100 SXM), as K1's: 4*S^2*D FLOP per live edge against the q, k|v
// and output rows once (~230 MB at the S=40 Cora shapes): bound by
// operations at S=40 (0.13 ms), by bytes at S=20.

#include "attention_tiles.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxGroup = 32;

// qs + ks + vs + ps of attention_tiles.cuh, and K6's message buffer
__host__ __device__ inline size_t smem_floats(int s, int d, int h, int buffered) {
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  return (size_t)(s2 + s4) * (d + 1) + (size_t)s * d + (size_t)h * s4 * s +
         (size_t)buffered * s * d;
}

// One item (tile, group) = blockIdx.x or the items of a persistent block,
// its working set at smem (shared or device memory), its slot tables at
// tables ([3][kMaxGroup]). kBuffered: K6 (messages buffered, one-hot
// reduce). Else K9 (per-edge add). T: the rows' type; kBf16: the products'
// operands rounded to bf16.
template <bool kBuffered, typename T, bool kBf16>
__device__ __forceinline__ void
group_sums(int item, float* smem, int* tables, const T* __restrict__ q, int ldq,
           const T* __restrict__ kv, int ldkv,
           const int* __restrict__ tile_senders,
           const int* __restrict__ tile_recv,
           const int* __restrict__ tile_valid,
           const int* __restrict__ tile_counts,
           float* __restrict__ out, int emax, int groups_per_tile,
           int group, int tile_nodes, int s, int sp, int d, int num_heads,
           int softmax) {
  int* recv_s = tables;
  int* live_s = recv_s + kMaxGroup;
  int* lead_s = live_s + kMaxGroup;
  const int tile = item / groups_per_tile;
  const int slot0 = (item % groups_per_tile) * group;
  __syncthreads();  // the block's previous item is done with its working set
  if (kBuffered && slot0 >= tile_counts[tile]) return;  // structural trip count
  const int tid = threadIdx.x;
  const int dh = d / num_heads, ld = d + 1;
  const int s2 = (s + 1) / 2 * 2, s4 = (s + 3) / 4 * 4;
  const int nslots = min(group, emax - slot0);  // ragged last group: fewer slots
  const size_t base = (size_t)tile * emax + slot0;

  if (tid < nslots) {
    recv_s[tid] = tile * tile_nodes + tile_recv[base + tid];
    live_s[tid] = tile_valid[base + tid] != 0;
  }
  __syncthreads();
  if (tid < nslots) {
    // leader: the first live slot of the group that points at its receiver
    int lead = live_s[tid];
    for (int j = 0; j < tid; ++j) lead &= !(live_s[j] && recv_s[j] == recv_s[tid]);
    lead_s[tid] = lead;
  }
  int any = 0;
  for (int j = 0; j < nslots; ++j) any |= live_s[j];
  if (!any) return;  // the same for every thread

  float* qs = smem;
  float* ks = qs + s2 * ld;
  float* vs = ks + s4 * ld;
  float* ps = vs + s * d;
  float* msg = ps + num_heads * s4 * s;  // K6: [group][s][d]
  // pad rows of qs / ks / ps must read 0
  const int zeroed = (s2 + s4) * ld + s * d + num_heads * s4 * s;
  for (int e = tid; e < zeroed; e += kThreads) smem[e] = 0.0f;

  const float scale = kBf16 ? head_scale<T>(dh) : 1.0f / sqrtf((float)dh);
  int cur = -1;  // the receiver whose Q rows are in qs
  for (int j = 0; j < nslots; ++j) {
    if (!live_s[j]) continue;
    const int r = recv_s[j];
    const size_t krow0 = (size_t)tile_senders[base + j] * sp;
    __syncthreads();  // the previous slot is done with qs, ks, vs and ps
    if (r != cur) load_tile<kBf16>(q, (size_t)r * sp, ldq, 0, d, s, qs, ld, scale);
    cur = r;
    load_tile<kBf16>(kv, krow0, ldkv, 0, d, s, ks, ld, 1.0f);
    load_tile<kBf16>(kv, krow0, ldkv, d, d, s, vs, d, 1.0f);
    __syncthreads();
    score_tiles<kBf16>(qs, ks, ps, s, 1, s, d, num_heads, softmax);
    __syncthreads();
    if (softmax) {
      softmax_segments<kBf16>(ps, s, 1, s, num_heads);
      __syncthreads();
    }
    if (kBuffered) {
      float* mj = msg + (size_t)j * s * d;
      message_tiles(ps, s, vs, s, s, d, num_heads,
                    [&](int i, int c, float a) { mj[i * d + c] = a; });
    } else {
      float* orow = out + (size_t)r * sp * d;
      const float w = (float)tile_valid[base + j];
      message_tiles(ps, s, vs, s, s, d, num_heads,
                    [&](int i, int c, float a) { atomicAdd(orow + i * d + c, a * w); });
    }
  }
  if (!kBuffered) return;
  __syncthreads();

  // out[r] += sum_j sel[r][j] * msg[j], sel[r][j] = live[j] && recv[j] == r:
  // one pass per receiver of the group (its leader slot), one atomic per
  // element. Rows i < s of a receiver are contiguous, s * d floats.
  for (int j = 0; j < nslots; ++j) {
    if (!lead_s[j]) continue;
    float* orow = out + (size_t)recv_s[j] * sp * d;
    for (int e = tid; e < s * d; e += kThreads) {
      float a = msg[(size_t)j * s * d + e];
      for (int j2 = j + 1; j2 < nslots; ++j2)
        if (live_s[j2] && recv_s[j2] == recv_s[j]) a += msg[(size_t)j2 * s * d + e];
      atomicAdd(orow + e, a);
    }
  }
}

// kDeviceMem = false: one block per item, its working set in dynamic shared
// memory. kDeviceMem = true: block b works in work[b * smem_floats] and
// takes items b, b + gridDim.x, ...
template <bool kBuffered, bool kDeviceMem, typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
edge_group_kernel(const T* __restrict__ q, int ldq,
                  const T* __restrict__ kv, int ldkv,
                  const int* __restrict__ tile_senders,
                  const int* __restrict__ tile_recv,
                  const int* __restrict__ tile_valid,
                  const int* __restrict__ tile_counts,
                  float* __restrict__ out, float* __restrict__ work, int items,
                  int emax, int groups_per_tile, int group, int tile_nodes, int s,
                  int sp, int d, int num_heads, int softmax) {
  extern __shared__ float shared[];
  __shared__ int tables[3 * kMaxGroup];
  if (!kDeviceMem) {  // no loop: the loop costs this body registers
    group_sums<kBuffered, T, kBf16>(blockIdx.x, shared, tables, q, ldq, kv, ldkv, tile_senders,
                          tile_recv, tile_valid, tile_counts, out, emax, groups_per_tile,
                          group, tile_nodes, s, sp, d, num_heads, softmax);
    return;
  }
  float* smem = work + blockIdx.x * smem_floats(s, d, num_heads, kBuffered ? group : 0);
  for (int item = blockIdx.x; item < items; item += gridDim.x)
    group_sums<kBuffered, T, kBf16>(item, smem, tables, q, ldq, kv, ldkv, tile_senders, tile_recv,
                          tile_valid, tile_counts, out, emax, groups_per_tile, group,
                          tile_nodes, s, sp, d, num_heads, softmax);
}

// work == nullptr: the working set in shared memory (the caller checked
// that it fits); else work_blocks slices of smem_floats in device memory.
template <bool kBuffered, typename T, bool kBf16>
int launch(const T* q, int ldq, const T* kv, int ldkv,
           const int* tile_senders, const int* tile_recv, const int* tile_valid,
           const int* tile_counts, float* out, float* work, int work_blocks,
           int num_tiles, int emax, int group, int tile_nodes, int s, int sp, int d,
           int num_heads, int softmax, cudaStream_t stream) {
  if (group < 1 || group > kMaxGroup) return (int)cudaErrorInvalidValue;
  const int groups_per_tile = (emax + group - 1) / group;
  const int items = num_tiles * groups_per_tile;
  if (items <= 0) return (int)cudaGetLastError();
  if (work != nullptr) {
    edge_group_kernel<kBuffered, true, T, kBf16><<<work_blocks, kThreads, 0, stream>>>(
        q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, tile_counts, out, work,
        items, emax, groups_per_tile, group, tile_nodes, s, sp, d, num_heads, softmax);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      smem_floats(s, d, num_heads, kBuffered ? group : 0) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_group_kernel<kBuffered, false, T, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_group_kernel<kBuffered, false, T, kBf16><<<items, kThreads, smem, stream>>>(
      q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, tile_counts, out, nullptr,
      items, emax, groups_per_tile, group, tile_nodes, s, sp, d, num_heads, softmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of working set one block needs (the wrapper puts it in shared
// memory where it fits the card's per-block limit, else in device memory);
// buffered = the group size for K6 (its message buffer), 0 for K9.
size_t ampnet_edge_group_smem_bytes(int s, int d, int num_heads, int buffered) {
  return smem_floats(s, d, num_heads, buffered) * sizeof(float);
}

// K6's CUDA-core body (the route beyond edge_attention_groups_tc.cu's
// range). q: [num_tiles*tile_nodes*sp] rows of d floats (row stride ldq);
// kv: rows of k|v (2d floats, stride ldkv); tile_senders / tile_recv /
// tile_valid: [num_tiles, emax]; tile_counts: [num_tiles] structural live
// slots; out: [num_tiles*tile_nodes*sp, d] contiguous and ZEROED by the
// caller; work: null (shared memory) or work_blocks * smem_bytes of device
// memory. group 1..32.
int ampnet_edge_attention_sums_mm_simt(const float* q, int ldq, const float* kv, int ldkv,
                                       const int* tile_senders, const int* tile_recv,
                                       const int* tile_valid, const int* tile_counts,
                                       float* out, int num_tiles, int emax, int group,
                                       int tile_nodes, int s, int sp, int d, int num_heads,
                                       int softmax, float* work, int work_blocks,
                                       void* stream) {
  return launch<true, float, false>(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid,
                                    tile_counts, out, work, work_blocks, num_tiles, emax, group,
                                    tile_nodes, s, sp, d, num_heads, softmax,
                                    (cudaStream_t)stream);
}

// K6's CUDA-core body in bf16: bf16 q and k|v rows, the arguments of
// ampnet_edge_attention_sums_mm_simt; out f32.
int ampnet_edge_attention_sums_mm_simt_bf16(const __nv_bfloat16* q, int ldq,
                                            const __nv_bfloat16* kv, int ldkv,
                                            const int* tile_senders, const int* tile_recv,
                                            const int* tile_valid, const int* tile_counts,
                                            float* out, int num_tiles, int emax, int group,
                                            int tile_nodes, int s, int sp, int d,
                                            int num_heads, int softmax, float* work,
                                            int work_blocks, void* stream) {
  return launch<true, __nv_bfloat16, true>(
      q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, tile_counts, out, work,
      work_blocks, num_tiles, emax, group, tile_nodes, s, sp, d, num_heads, softmax,
      (cudaStream_t)stream);
}

// K6's CUDA-core body on f32 rows with the products' operands rounded to
// bf16 (mxu_bf16); the arguments of ampnet_edge_attention_sums_mm_simt.
int ampnet_edge_attention_sums_mm_simt_mxu(const float* q, int ldq, const float* kv, int ldkv,
                                           const int* tile_senders, const int* tile_recv,
                                           const int* tile_valid, const int* tile_counts,
                                           float* out, int num_tiles, int emax, int group,
                                           int tile_nodes, int s, int sp, int d, int num_heads,
                                           int softmax, float* work, int work_blocks,
                                           void* stream) {
  return launch<true, float, true>(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid,
                                   tile_counts, out, work, work_blocks, num_tiles, emax, group,
                                   tile_nodes, s, sp, d, num_heads, softmax,
                                   (cudaStream_t)stream);
}

// K9's CUDA-core body. As K6's without tile_counts: every group of every
// tile is walked (the caller checks that group divides emax).
int ampnet_edge_attention_sums_v1_simt(const float* q, int ldq, const float* kv, int ldkv,
                                       const int* tile_senders, const int* tile_recv,
                                       const int* tile_valid, float* out, int num_tiles,
                                       int emax, int group, int tile_nodes, int s, int sp,
                                       int d, int num_heads, int softmax, float* work,
                                       int work_blocks, void* stream) {
  return launch<false, float, false>(q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid,
                                     nullptr, out, work, work_blocks, num_tiles, emax, group,
                                     tile_nodes, s, sp, d, num_heads, softmax,
                                     (cudaStream_t)stream);
}

// K9's CUDA-core body in bf16: bf16 q and k|v rows, the arguments of
// ampnet_edge_attention_sums_v1_simt; out f32.
int ampnet_edge_attention_sums_v1_simt_bf16(const __nv_bfloat16* q, int ldq,
                                            const __nv_bfloat16* kv, int ldkv,
                                            const int* tile_senders, const int* tile_recv,
                                            const int* tile_valid, float* out, int num_tiles,
                                            int emax, int group, int tile_nodes, int s, int sp,
                                            int d, int num_heads, int softmax, float* work,
                                            int work_blocks, void* stream) {
  return launch<false, __nv_bfloat16, true>(
      q, ldq, kv, ldkv, tile_senders, tile_recv, tile_valid, nullptr, out, work, work_blocks,
      num_tiles, emax, group, tile_nodes, s, sp, d, num_heads, softmax, (cudaStream_t)stream);
}

}  // extern "C"
