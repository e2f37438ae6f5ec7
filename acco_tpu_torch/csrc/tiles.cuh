// Float32 tiles shared by the attention kernels that template on the head
// dim (64 or 128): block_attention.cu (K4) and flash_attention.cu (K5),
// whose bf16 kernels are hopper_attention.cuh's. FMAs on the CUDA cores,
// D / 32 threads per row.

#pragma once

#include "attention_common.cuh"

namespace {
namespace tiles {

constexpr int kT = 64;          // the lengths' unit: L (K4: Lq, Lk) a multiple of it
constexpr int kThreads = 128;   // every float32 kernel's block

// ---------------------------------------------------------------------------
// float32, CUDA cores
// ---------------------------------------------------------------------------
// TPR = D / 32 threads per row (adjacent lanes), each owning 32 of the row's
// elements; shared rows are stored as TPR parts of 32 floats with 4 floats
// between parts, so the lanes of a row read distinct banks.
template <int D>
struct F32 {
  static constexpr int TPR = D / 32;
  static constexpr int RB = kThreads / TPR;  // rows a block (64 at D 64, 32 at D 128)
  static constexpr int KB = 32;              // keys (or queries) a shared tile
};

template <int D>
__device__ __forceinline__ void load_parts(float (*dst)[D / 32][36], const float* src, int rows) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r][c / 32][c % 32] = src[e];
  }
}

// The full dot product of this thread's 32 elements with the matching part
// of a shared row, summed over the row's TPR lanes.
template <int D>
__device__ __forceinline__ float dot_parts(const float (&r)[32], const float* part) {
  float acc = dot_reg<32>(r, part);
#pragma unroll
  for (int off = 1; off < D / 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

}  // namespace tiles
}  // namespace
