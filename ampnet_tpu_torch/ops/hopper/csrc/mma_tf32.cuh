// Tensor-core helpers of the port's f32 kernels on Hopper (sm_90a): f32
// products at f32-level accuracy on the TF32 tensor cores (3xTF32), the
// cp.async copies that fill a ring of gathered rows in shared memory (f32,
// and any row type: fill_rows, fill_heads), the node walk of a persistent
// block, and the plan of its launch.
//
// 3xTF32. TF32 keeps 10 of f32's 23 mantissa bits, so one TF32 product is
// good to ~3 decimal digits: too coarse for the port's checks (1e-4 against
// the plain f32 version). Each f32 operand x is split into a TF32 high part
// hi = rna(x) and a TF32 low part lo = rna(x - hi) (x - hi is exact in f32),
// and a product is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, the small
// terms first, accumulated in f32 by mma.sync. The dropped lo_a*lo_b term
// is ~2^-22 of the product: f32 accuracy at several times the f32 rate of
// the CUDA cores. tests/test_torch_tf32x3.py emulates the scheme in torch.
// The split rounds with integer operations (tf32_rna), bit for bit what
// cvt.rna.tf32.f32 gives on finite values.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for the
// lane with group g = lane / 4 and thread-in-group t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)    a1 (g + 8, t)    a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g)             b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t)   c1 (g, 2t + 1)   c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// A C tile is used as the A operand of the next product with no shuffle:
// A column t is C column 2t and A column t + 4 is C column 2t + 1 (a =
// {c0, c2, c1, c3}), so the next product's B rows t and t + 4 are read at
// the C columns 2t and 2t + 1 (c_as_a below; the callers load B to match).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// round to nearest, ties away from zero, at 10 mantissa bits: what
// cvt.rna.tf32.f32 gives for a finite x, in two integer operations (a
// conversion instruction issues at 16 results per clock and SM, these at
// 64; the split below runs for every operand element of every product)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo), both TF32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

struct FragA {  // one A fragment, split
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA split_a(float4 a) {
  FragA f;
  split_tf32(a.x, f.hi[0], f.lo[0]);
  split_tf32(a.y, f.hi[1], f.lo[1]);
  split_tf32(a.z, f.hi[2], f.lo[2]);
  split_tf32(a.w, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

// a C tile (c0..c3) as the A operand of the next product (see above)
__device__ __forceinline__ FragA c_as_a(const float c[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32. The tensor cores add a product into their
// accumulator with truncation, so a running sum kept there drifts with the
// number of products added to it (kept there across edges, K1's raw-score
// sums at S=40 missed the card tests' atol on an H100). Each 3-product
// is taken into a fresh accumulator, and that is added to c
// with an IEEE f32 add.
__device__ __forceinline__ void mma_3xtf32(float c[4], const FragA& a, const FragB& b) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(p, a.lo, b.hi);
  mma_tf32(p, a.hi, b.lo);
  mma_tf32(p, a.hi, b.hi);
  c[0] += p[0];
  c[1] += p[1];
  c[2] += p[2];
  c[3] += p[3];
}

// ---- cp.async: 16-byte global -> shared copies, cached in L2 only (.cg)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

// the same copy, or 16 zero bytes where !in (gmem must still be a valid
// address: the source size is 0)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool in) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's committed groups are pending (n is
// 0, 1 or 2: the rings below have 2 or 3 stages)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 2) asm volatile("cp.async.wait_group 2;" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;" ::: "memory");
  else asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---- the walk of a persistent block and its ring of gathered peer rows

// The live slots of the nodes first, first + gridDim.x, ... in order: the
// node-major index (ptr, slots) over the layout's slots, a slot with
// validity 0 skipped. Every thread of a block keeps the same cursor; the
// arrays are passed to each call (kernel parameters cost no registers).
struct LiveWalk {
  int node, k, end;

  __device__ void start(const int* ptr, int first, int num_nodes) {
    node = first;
    k = first < num_nodes ? ptr[first] : 0;
    end = first < num_nodes ? ptr[first + 1] : 0;
  }

  // the next live slot, or -1 past the last node
  __device__ int next(const int* ptr, const int* slots, const int* valid, int num_nodes) {
    for (;;) {
      while (k >= end) {
        node += gridDim.x;
        if (node >= num_nodes) return -1;
        k = ptr[node];
        end = ptr[node + 1];
      }
      const int slot = slots[k++];
      if (valid[slot] != 0) return slot;
    }
  }
};

// Rows [row0, row0 + s) of src (row stride ld floats, 2d floats wide) into
// a ring stage (row stride ldr floats), 16 bytes per cp.async, all threads
// of the block. src, ld and 2d are multiples of 16 bytes (the wrappers
// check it).
__device__ __forceinline__ void fill_stage(float* stage, int ldr, const float* __restrict__ src,
                                           size_t row0, int ld, int s, int d) {
  const int chunks = 2 * d / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < s * chunks; e += blockDim.x) {
    const int r = e / chunks, c = 4 * (e - r * chunks);
    cp_async16(stage + r * ldr + c, src + (row0 + r) * (size_t)ld + c);
  }
}

// Rows [row0, row0 + s) of src (row stride ld values, width values wide)
// into a ring stage (row stride ldr values), 16 bytes per cp.async, all
// threads of the block; src, ld, width and ldr in whole 16-byte pieces (the
// wrappers check the rows)
template <typename T>
__device__ __forceinline__ void fill_rows(T* stage, int ldr, const T* __restrict__ src,
                                          size_t row0, int ld, int s, int width) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = width / kPer;
  for (int e = threadIdx.x; e < s * chunks; e += blockDim.x) {
    const int r = e / chunks, c = kPer * (e - r * chunks);
    cp_async16(stage + r * ldr + c, src + (row0 + r) * (size_t)ld + c);
  }
}

// The columns of a block's heads in rows [row0, row0 + s) of src (row
// stride ld values, k|v packed 2d wide): k's [c0, c0 + w) and v's [d + c0,
// d + c0 + w) into a ring stage's [0, w) and [w, 2w) (row stride ldr
// values), 16 bytes per cp.async, all threads of the block. A block of
// every head (w = d) copies each row as one span of 2d values (fill_rows).
// src, ld, c0 and w (or 2d) are whole 16-byte pieces: the wrappers check
// the rows, and the range gives a block of one head dh a multiple of 8.
template <typename T>
__device__ __forceinline__ void fill_heads(T* stage, int ldr, const T* __restrict__ src,
                                           size_t row0, int ld, int s, int d, int c0, int w) {
  if (w == d) return fill_rows(stage, ldr, src, row0, ld, s, 2 * d);
  constexpr int kPer = 16 / (int)sizeof(T);
  const int chunks = w / kPer;  // 16-byte chunks per span
  for (int e = threadIdx.x; e < s * 2 * chunks; e += blockDim.x) {
    const int r = e / (2 * chunks), j = e - r * 2 * chunks;
    const int v = j >= chunks;  // the v span
    const int c = kPer * (j - v * chunks);
    cp_async16(stage + r * ldr + v * w + c, src + (row0 + r) * (size_t)ld + v * d + c0 + c);
  }
}

// ---- the launch of a persistent kernel with a ring

// A launch plan: threads per block, (s, d) it was made for, ring stages,
// blocks per SM, SMs, dynamic shared memory.
struct RingPlan {
  int threads = 0, s = 0, d = 0, stages = 0, blocks_per_sm = 0, sms = 0;
  size_t smem = 0;
};

// The plan of `kernel` at (threads, s, d), with `fixed` bytes of shared
// memory beside a ring of stages of S x (2D + 4) f32: 3 stages unless 2
// keep more blocks on an SM or 3 exceed a block's shared memory. Made once
// per (threads, s, d) and kept in `cache` (the occupancy queries cost more
// than a launch).
template <typename Kernel>
int ring_plan(Kernel kernel, int threads, int s, int d, size_t fixed, RingPlan& cache) {
  if (cache.threads == threads && cache.s == s && cache.d == d) return 0;
  RingPlan p;
  p.threads = threads; p.s = s; p.d = d;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t stage_bytes = (size_t)s * (2 * d + 4) * sizeof(float);
  const size_t top = fixed + 3 * stage_bytes < (size_t)max_smem ? fixed + 3 * stage_bytes
                                                                : (size_t)max_smem;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)top);
  for (int st = 3; st >= 2 && err == cudaSuccess; --st) {
    if (fixed + st * stage_bytes > top) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                        fixed + st * stage_bytes);
    if (blocks > p.blocks_per_sm) {
      p.blocks_per_sm = blocks;
      p.stages = st;
      p.smem = fixed + st * stage_bytes;
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (p.blocks_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  cache = p;
  return 0;
}

// K1, K3 and K4 (edge_attention_tc.cuh, edge_attention_tc_bf16.cuh,
// edge_attention_bwd_dq_tc.cu, edge_attention_bwd_dq_tc_bf16.cu,
// edge_attention_bwd_tc.cu, edge_attention_bwd_tc_bf16.cu) take S <= 48 with
// one block of every head per node, H * ceil(S/16) warps, at most 12 (8 up
// to S=24), and 48 < S <= 64 with one block per (node, head), 4 warps, where
// dh is a multiple of 8 (a head's columns are whole 16-byte pieces); dh <= 32
// throughout. The other tensor-core kernels keep S <= 48.
constexpr int kWideMaxS = 64;
constexpr int kWideThreads = 128;

inline bool wide_shape_ok(int s, int d, int num_heads) {
  if (s < 1 || num_heads < 1 || d % num_heads || d / num_heads > 32 || s > kWideMaxS) return false;
  if (s > 48) return (d / num_heads) % 8 == 0;
  return num_heads * ((s + 15) / 16) <= (s <= 24 ? 8 : 12);
}

// the heads one block of K1, K3 or K4 takes at S
inline int block_heads(int s, int num_heads) { return s > 48 ? 1 : num_heads; }

// The persistent grid of a plan over num_nodes nodes and `groups` head
// groups (blockIdx.y): at most one block per node and group, as many blocks
// in all as the SMs hold
inline dim3 ring_grid(const RingPlan& p, int num_nodes, int groups) {
  const int per_group = (p.blocks_per_sm * p.sms + groups - 1) / groups;
  return dim3(num_nodes < per_group ? num_nodes : per_group, groups);
}

// What a launch runs with, for the *_info entry points: registers per
// thread, local memory bytes per thread (spills), blocks per SM, ring
// stages, grid, threads per block, dynamic shared memory bytes.
template <typename Kernel>
int ring_info(Kernel kernel, const RingPlan& p, int grid, int* info) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const int values[7] = {attr.numRegs, (int)attr.localSizeBytes, p.blocks_per_sm, p.stages,
                         grid, p.threads, (int)p.smem};
  for (int i = 0; i < 7; ++i) info[i] = values[i];
  return 0;
}
