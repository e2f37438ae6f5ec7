// Tiles shared by the attention kernels that template on the head dim (64
// or 128): block_attention.cu (K4) and, for its float32 kernels,
// flash_attention.cu (K5, whose bf16 kernels are hopper_attention.cuh's).
// * bfloat16: one warp owns 16 rows of a 64-row block tile and computes its
//   products with mma.sync m16n8k16 (bf16 in, f32 accumulate), both
//   operands read through ldmatrix from shared tiles whose rows are padded
//   by 8 elements; the accumulator layout is attention_common.cuh's.
// * float32: FMAs on the CUDA cores, D / 32 threads per row.

#pragma once

#include "attention_common.cuh"

namespace {
namespace tiles {

constexpr int kT = 64;          // rows of a block tile (q rows, or keys in dK/dV)
constexpr int kThreads = 128;   // four warps of 16 rows (bf16), every kernel

template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }  // padded shared row (bf16 elements)

template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * ld<D>() * 2; }

// ---------------------------------------------------------------------------
// bfloat16 helpers (accumulator layout: attention_common.cuh)
// ---------------------------------------------------------------------------

// cp.async copy of `rows` rows of D bf16 (contiguous in global memory) into
// a padded shared tile; the caller commits and waits.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rows) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < rows * C; e += kThreads) {
    const int r = e / C, c = (e % C) * 8;
    cp_async16(dst + r * ld<D>() + c, src + (size_t)r * D + c);
  }
}

// `n` int32 values (n a multiple of 4) through cp.async, 16 bytes a thread.
__device__ __forceinline__ void load_ints(int* dst, const int* src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += kThreads) cp_async16(dst + 4 * e, src + 4 * e);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc[N/8][4] += A . B^T for the warp's 16 rows: A is 16 x D in shared
// memory (rows at `a`), B is N x D in shared memory (rows at `b`), so the
// product's columns are B's rows (S = Q K^T with b = K).
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* a, const bf16* b) {
  constexpr int LD = ld<D>();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane % 16) * LD + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + ks * 16 +
                          ((lane / 8) % 2) * 8);
      mma_16816(acc[2 * np], af, bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += A . B for the warp's 16 rows: A is 16 x K in registers
// (K / 16 fragments, from acc_to_a), B is K x D in shared memory (P V with
// b = V).
template <int D, int K>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[K / 16][4],
                                       const bf16* b) {
  constexpr int LD = ld<D>();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                                (lane / 16) * 8);
      mma_16816(acc[2 * dp], a[kk], bf[0], bf[1]);
      mma_16816(acc[2 * dp + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// A fragments of a [16, N] accumulator rounded to bf16 (k = its columns).
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&acc)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// Store this lane's share of a [16, D] accumulator, times `mul`, as bf16
// rows starting at `out` (the warp's first row).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], const float (&mul)[2]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(out + (size_t)(g + h * 8) * D + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * h] * mul[h], acc[j][2 * h + 1] * mul[h]);
    }
  }
}

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
