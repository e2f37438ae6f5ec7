// Device code shared by the float32 attention kernels of this package:
// fused_attention.cu (K1, causal + runtime window + key pad, GQA) and
// banded_attention.cu (K2, static sliding window, MHA, no pad), and the
// float32 tiles of tiles.cuh (K5, K4).
//
// * helpers: masks, float32 dot products over half rows;
// * the float32 backward kernels (dK/dV and dQ on the CUDA cores) with
//   their launchers, which both libraries launch: the JAX package's banded
//   backward (`_dq_kernel`, `_dkv_kernel`) has the arithmetic of its full
//   backward restricted to the key band (P from the saved LSE, dS =
//   P * (dP - delta), dQ and dK scaled after the sum), and these kernels
//   walk only the band. The bf16 kernels are hopper_attention.cuh's.
//
// Each .cu file that includes this header is built into its own shared
// library, so everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kMasked = -1e9f;  // the JAX kernels' mask value
constexpr int kBQ = 64;           // query rows per float32 block (two threads each)
constexpr int kBK = 32;           // keys per float32 shared-memory tile (fwd, dQ)
constexpr int kBKV = 64;          // keys per float32 dK/dV block (two threads each)
constexpr int kBQT = 16;          // query rows per shared tile in float32 dK/dV

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool in_band(int i, int j, int window) {
  return j <= i && (window == 0 || i - j < window);
}

// Dot product of a row held in registers with a row in shared memory.
template <int D>
__device__ __forceinline__ float dot_reg(const float (&r)[D], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(r[d], y.x, acc);
    acc = fmaf(r[d + 1], y.y, acc);
    acc = fmaf(r[d + 2], y.z, acc);
    acc = fmaf(r[d + 3], y.w, acc);
  }
  return acc;
}

// First key of the KV band that rows [q0, q0 + tile) can see, tile-aligned.
__device__ __forceinline__ int kv_band_begin(int q0, int window, int tile) {
  if (window <= 0) return 0;
  const int lo = q0 - window + 1;
  return lo <= 0 ? 0 : (lo / tile) * tile;
}

// Copy `rows` rows of D elements to shared memory as float, each row split
// in two halves of D/2 with kHalfPad floats between them: a warp whose
// threads read the same row, half by half, then hits distinct banks.
constexpr int kHalfPad = 4;

template <int D>
__device__ __forceinline__ void load_halves(float (*dst)[2][D / 2 + kHalfPad], const float* src,
                                            int rows, int nthreads) {
  for (int e = threadIdx.x; e < rows * D; e += nthreads) {
    const int r = e / D, c = e % D;
    dst[r][c / (D / 2)][c % (D / 2)] = src[e];
  }
}

// ---------------------------------------------------------------------------
// float32, CUDA cores: dK, dV (summed over the n_rep q heads of each KV head)
// ---------------------------------------------------------------------------
// Two threads per key row, each owning half of the head dim: its halves of
// the K and V rows and of the dK and dV accumulators stay in registers
// (4 * D/2 floats), and the two halves of each dot product are joined with
// one shuffle. One thread per row would need 4 * D registers and spills.
template <int D>
__global__ void __launch_bounds__(2 * kBKV)
    attn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ pad,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int n_rep, int L, int window,
                         float scale) {
  constexpr int DH = D / 2;
  constexpr int kThreads = 2 * kBKV;
  __shared__ __align__(16) float qs[kBQT][2][DH + kHalfPad];
  __shared__ __align__(16) float dos[kBQT][2][DH + kHalfPad];
  __shared__ float lse_s[kBQT];
  __shared__ float delta_s[kBQT];

  const int Hkv = H / n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int k0 = blockIdx.x * kBKV;
  const int half = threadIdx.x & 1;
  const int j = k0 + (threadIdx.x >> 1);
  const size_t row = (size_t)bkv * L + j;

  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kr[d] = k[row * D + half * DH + d];
    vr[d] = v[row * D + half * DH + d];
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }
  const bool key_ok = pad == nullptr || pad[(size_t)b * L + j] != 0;

  // Query rows that can see keys [k0, k0 + kBKV): causal from k0 on, and
  // with a window only up to (last key) + window - 1.
  const int q_begin = (k0 / kBQT) * kBQT;
  int q_end = L;
  if (window > 0) {
    const int hi = k0 + kBKV - 1 + window;  // exclusive
    q_end = hi < L ? ((hi + kBQT - 1) / kBQT) * kBQT : L;
  }

  // With a key pad mask a row may have no allowed key (left padding); JAX
  // normalises it over all L keys, so P = exp(-1e9 - lse) = 1 on every key,
  // these included: the q tiles outside the band that hold such a row
  // (lse -1e9) are walked too.
  const bool scan = pad != nullptr;
  for (int r = 0; r < n_rep; ++r) {
    const size_t bh = (size_t)b * H + (size_t)hk * n_rep + r;
    for (int q0 = scan ? 0 : q_begin; q0 < (scan ? L : q_end); q0 += kBQT) {
      if (scan && (q0 < q_begin || q0 >= q_end) &&
          !__syncthreads_or(threadIdx.x < kBQT &&
                            lse[bh * L + q0 + threadIdx.x] <= 0.5f * kMasked)) {
        continue;
      }
      __syncthreads();
      load_halves<D>(qs, q + (bh * L + q0) * D, kBQT, kThreads);
      load_halves<D>(dos, dout + (bh * L + q0) * D, kBQT, kThreads);
      if (threadIdx.x < kBQT) {
        lse_s[threadIdx.x] = lse[bh * L + q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta[bh * L + q0 + threadIdx.x];
      }
      __syncthreads();
#pragma unroll 1
      for (int ii = 0; ii < kBQT; ++ii) {
        const int i = q0 + ii;
        const float* qh = qs[ii][half];
        const float* dh = dos[ii][half];
        float dot = dot_reg<DH>(kr, qh);
        float dp = dot_reg<DH>(vr, dh);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const float s = (key_ok && in_band(i, j, window)) ? dot * scale : kMasked;
        const float p = expf(s - lse_s[ii]);
        const float ds = p * (dp - delta_s[ii]);
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          const float4 g = *reinterpret_cast<const float4*>(dh + d);
          const float4 x = *reinterpret_cast<const float4*>(qh + d);
          dv_acc[d] = fmaf(p, g.x, dv_acc[d]);
          dv_acc[d + 1] = fmaf(p, g.y, dv_acc[d + 1]);
          dv_acc[d + 2] = fmaf(p, g.z, dv_acc[d + 2]);
          dv_acc[d + 3] = fmaf(p, g.w, dv_acc[d + 3]);
          dk_acc[d] = fmaf(ds, x.x, dk_acc[d]);
          dk_acc[d + 1] = fmaf(ds, x.y, dk_acc[d + 1]);
          dk_acc[d + 2] = fmaf(ds, x.z, dk_acc[d + 2]);
          dk_acc[d + 3] = fmaf(ds, x.w, dk_acc[d + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk[row * D + half * DH + d] = dk_acc[d] * scale;
    dv[row * D + half * DH + d] = dv_acc[d];
  }
}

// ---------------------------------------------------------------------------
// float32, CUDA cores: dQ (two threads per query row, as in the forward)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(2 * kBQ)
    attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ pad,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq, int H,
                       int n_rep, int L, int window, float scale) {
  constexpr int DH = D / 2;
  __shared__ __align__(16) float ks[kBK][2][DH + kHalfPad];
  __shared__ __align__(16) float vs[kBK][2][DH + kHalfPad];
  __shared__ int kok[kBK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const size_t kv_head = (size_t)b * (H / n_rep) + h / n_rep;
  const int q0 = blockIdx.x * kBQ;
  const int half = threadIdx.x & 1;
  const int i = q0 + (threadIdx.x >> 1);
  const size_t row = (size_t)bh * L + i;
  const float* kb = k + kv_head * L * D;
  const float* vb = v + kv_head * L * D;
  const int* pad_row = pad ? pad + (size_t)b * L : nullptr;

  float qr[DH], dor[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = q[row * D + half * DH + d];
    dor[d] = dout[row * D + half * DH + d];
    acc[d] = 0.f;
  }
  const float lse_i = lse[row];
  const float delta_i = delta[row];

  // a row with no allowed key (lse -1e9, key pads only) has P = 1 on all L
  // keys, as in JAX: the block then walks every key
  const bool widen = __syncthreads_or(pad != nullptr && lse_i <= 0.5f * kMasked);
  const int kv_end = widen ? L : q0 + kBQ;
  for (int k0 = widen ? 0 : kv_band_begin(q0, window, kBK); k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_halves<D>(ks, kb + (size_t)k0 * D, kBK, 2 * kBQ);
    load_halves<D>(vs, vb + (size_t)k0 * D, kBK, 2 * kBQ);
    if (threadIdx.x < kBK) kok[threadIdx.x] = pad_row ? pad_row[k0 + threadIdx.x] : 1;
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kBK; ++j) {
      const float* krow = ks[j][half];
      float dot = dot_reg<DH>(qr, krow);
      float dp = dot_reg<DH>(dor, vs[j][half]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float s = (kok[j] != 0 && in_band(i, k0 + j, window)) ? dot * scale : kMasked;
      const float p = expf(s - lse_i);
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + d);
        acc[d] = fmaf(ds, kk.x, acc[d]);
        acc[d + 1] = fmaf(ds, kk.y, acc[d + 1]);
        acc[d + 2] = fmaf(ds, kk.z, acc[d + 2]);
        acc[d + 3] = fmaf(ds, kk.w, acc[d + 3]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[row * D + half * DH + d] = acc[d] * scale;
}

// ---------------------------------------------------------------------------
// float32 backward launchers, for both libraries (K2 passes no pad mask and
// n_rep 1): float32 runs only with mixed precision off, never in a bf16
// training cell, and the band's float32 arithmetic is the full kernels'
// restricted to the band, which these kernels already walk.
// ---------------------------------------------------------------------------
template <int D>
void launch_bwd_dkdv_f32(const void* q, const void* k, const void* v, const void* pad,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int Hkv, int L, int window, float scale,
                         cudaStream_t s) {
  attn_bwd_dkdv_f32_kernel<D><<<dim3(L / kBKV, B * Hkv), 2 * kBKV, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(pad), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, H / Hkv, L, window, scale);
}

template <int D>
void launch_bwd_dq_f32(const void* q, const void* k, const void* v, const void* pad,
                       const void* dout, const void* lse, const void* delta, void* dq, int B,
                       int H, int Hkv, int L, int window, float scale, cudaStream_t s) {
  attn_bwd_dq_f32_kernel<D><<<dim3(L / kBQ, B * H), 2 * kBQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(pad), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq),
      H, H / Hkv, L, window, scale);
}

}  // namespace
