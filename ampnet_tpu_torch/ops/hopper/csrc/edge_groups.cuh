// The walk and the flush that the edge-group kernels share: K6 and K9 on
// the tensor cores in 3xTF32 (edge_attention_groups_tc.cu) and in bf16
// products (edge_attention_groups_tc_bf16.cu). The design is described in
// edge_attention_groups_tc.cu: a persistent grid walks (tile, group) items,
// each warp keeps the sums of a receiver's run of slots in registers and
// adds them to the zeroed output with f32 atomics when the receiver
// changes or the item ends.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The live slots of the (tile, group) items first, first + gridDim.x, ...
// in order. Item i holds slots [slot0, min(slot0 + group, emax)) of tile
// i / gpt, slot0 = (i % gpt) * group; none where counts is given and slot0
// is at or beyond the tile's count. next() returns the flat slot tile * emax
// + j (validity != 0) or -1 past the last item; `item` is then the item of
// the returned slot. Every thread of a block keeps the same cursor.
struct GroupWalk {
  int item, k, end;

  __device__ void start() {
    item = (int)blockIdx.x - (int)gridDim.x;
    k = end = 0;
  }

  __device__ int next(const int* valid, const int* counts, int items, int gpt, int group,
                      int emax) {
    for (;;) {
      while (k >= end) {
        if (item >= items) return -1;
        item += gridDim.x;
        if (item >= items) return -1;
        const int tile = item / gpt, slot0 = (item - tile * gpt) * group;
        const int stop = counts != nullptr ? min(emax, counts[tile]) : emax;
        k = tile * emax + slot0;
        end = slot0 < stop ? tile * emax + min(slot0 + group, emax) : k;
      }
      const int slot = k++;
      if (valid[slot] != 0) return slot;
    }
  }
};

// o added to rows r0, r1 (< s) of the node row block orow (row stride d) at
// the warp's head columns hc + c, c < dh: two adjacent columns per float2
// atomic where both lie in the head and the pair is 8-byte aligned
__device__ __forceinline__ void flush_o(float (&o)[4][4], float* orow, int d, int hc,
                                        int r0, int r1, int s, int dh, int t) {
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    const int c = 8 * nn + 2 * t;
    if (c >= dh) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= s) continue;
      float* p = orow + (size_t)r * d + hc + c;
      const float a = o[nn][2 * half], b = o[nn][2 * half + 1];
      if (c + 1 < dh && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
      } else {
        atomicAdd(p, a);
        if (c + 1 < dh) atomicAdd(p + 1, b);
      }
    }
  }
}

}  // namespace
