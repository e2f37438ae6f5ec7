// Banded sliding-window attention for Hopper: forward and backward (K2).
//
// Replaces the Pallas TPU kernels of acco_tpu/ops/banded_attention.py:
// `_fwd_kernel` (the `_banded_fwd` call), `_dq_kernel` and `_dkv_kernel`
// (the two calls of `_banded_bwd`). Contract, for q, k, v [B, H, L, D]
// (MHA, no pad mask) and a window W > 0:
//
//   O = softmax(scale * Q K^T + mask) V,  mask: causal and i - j < W,
//
// computed over the key band only, with the forward saving lse [B, H, L]
// f32 for the backward. Masked scores are -1e9, as in the JAX kernel. The
// backward keeps the JAX kernels' arithmetic: P = exp(scale * s - lse) from
// the saved lse, dS = P (dP - delta), P and dS rounded to the activation
// dtype before their products, dQ and dK scaled after the sum. delta =
// rowsum(dO * O) comes from K1's `acco_attn_bwd_delta`.
//
// What bounds it on the H100 (data sheet: 3.35 TB/s, 989 TFLOP/s bf16): at
// the GPT-Neo-125M local layer (B 8, H 12, L 1024, D 64, W 256) the band
// holds 22,032,384 (query, key) pairs; the forward moves 50.7 MB (15.1 us)
// against 5.7 us of operations, dQ 63.7 MB and dK/dV 76.3 MB against 8.6
// and 11.4 us: every kernel is bound by memory, and a band's q tile reads
// each K and V tile of its band (up to three at W 256) from L2. At
// GPT-Neo-2.7B's width (H 20, D 128, L 2048, W 256) the same holds.
//
// Two implementations, chosen by dtype:
// * bfloat16, the training path: the wgmma + TMA attention mainloop of
//   hopper_attention.cuh with the band mask below as its policy, head_dim 64
//   and 128 (forward: 128 query rows a block over the 128-key tiles of
//   their band, at W 256 three; dQ: 64-key tiles; dK/dV: 128 keys over the
//   64-query steps that see them). Only the tiles that cross the diagonal
//   or the band's far edge are masked. The JAX kernel takes the band's row
//   max first and rounds the NORMALISED P; the mainloop rounds P against
//   the running max and divides by the row sum at the end (at W 256 the
//   max moves at most twice), which chip_smoke.py holds to K2's bars.
// * float32: FMAs on the CUDA cores, two threads per row, each owning half
//   of the head dim (the backward: attention_common.cuh's kernels, which
//   K1 shares).
//
// Three launchers with a plain C interface, each returning
// cudaGetLastError(); dtype code 0 = float32, 1 = bfloat16; head_dim 64 or
// 128; L a multiple of 128.
//   acco_banded_fwd       one block per (128-row q tile, b*h)
//   acco_banded_bwd_dq    one block per (128-row q tile, b*h)
//   acco_banded_bwd_dkdv  one block per (128-key tile, b*h), looping over
//                         the q steps that can see it (no atomics)

#include "attention_common.cuh"
#include "hopper_attention.cuh"

namespace {

// The mask policy of hopper_attention.cuh for K2: causal inside the static
// window W; every row sees itself, so none is ever fully masked.
struct BandMask {
  static constexpr bool kScaleInDs = false;  // dS = P (dP - delta); dQ, dK scaled after
  static constexpr bool kFlagRows = false;
  static constexpr bool kStats = false;
  static constexpr bool kExactP = true;  // the normalised P, rounded (two walks)
  static constexpr bool kBounds = false;
  struct Params {
    int window;
  };
  int window, L;

  __device__ BandMask(const Params& p, int, int L_, int) : window(p.window), L(L_) {}
  __device__ bool has_key_mask() const { return false; }
  __device__ int key_begin(int q0) const { return max(0, q0 - window + 1); }
  __device__ int key_end(int q1) const { return min(L, q1); }
  __device__ int query_begin(int k0) const { return k0; }
  __device__ int query_end(int j) const { return min(L, j + window); }
  __device__ bool partial(int i0, int i1, int j0, int j1) const {
    return j1 - 1 > i0 || i1 - 1 - j0 >= window || i1 > L || j1 > L;
  }
  __device__ int query_val(int) const { return 0; }
  __device__ int key_val(int) const { return 0; }
  __device__ bool allowed(int i, int, int j, int) const { return j <= i && i - j < window; }
};

// ---------------------------------------------------------------------------
// float32, CUDA cores: forward
// ---------------------------------------------------------------------------
// Two threads per query row, each owning half of the head dim (its halves
// of the q row and of the output accumulator stay in registers); the two
// halves of each score are joined with one shuffle, so both threads of a
// pair hold the same scores. The JAX kernel's three passes (the row max
// over the whole band, the sum, the normalised P V), with K reloaded tile
// by tile in each (float32 runs only with mixed precision off, never in
// the bf16 training cell).
template <int D>
__global__ void __launch_bounds__(2 * kBQ)
    banded_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int L, int window, float scale) {
  constexpr int DH = D / 2;
  constexpr int kThreads = 2 * kBQ;
  __shared__ __align__(16) float ks[kBK][2][DH + kHalfPad];
  __shared__ __align__(16) float vs[kBK][2][DH + kHalfPad];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int half = threadIdx.x & 1;
  const int i = q0 + (threadIdx.x >> 1);
  const size_t row = (size_t)bh * L + i;
  const float* kb = k + (size_t)bh * L * D;
  const float* vb = v + (size_t)bh * L * D;

  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = q[row * D + half * DH + d];

  // masked scale * q_i . k_j for key j of the shared tile starting at k0
  auto score = [&](int k0, int j) {
    float dot = dot_reg<DH>(qr, ks[j][half]);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    return in_band(i, k0 + j, window) ? dot * scale : kMasked;
  };
  const int k_begin = kv_band_begin(q0, window, kBK);
  const int k_end = q0 + kBQ;

  float m = kMasked;  // pass 1: the row max over the whole band
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_halves<D>(ks, kb + (size_t)k0 * D, kBK, kThreads);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) m = fmaxf(m, score(k0, j));
  }
  float l = 0.f;  // pass 2: l = sum of exp(s - max)
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_halves<D>(ks, kb + (size_t)k0 * D, kBK, kThreads);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) l += expf(score(k0, j) - m);
  }
  float acc[DH];  // pass 3: O = sum of (exp(s - max) / l) V
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
    load_halves<D>(ks, kb + (size_t)k0 * D, kBK, kThreads);
    load_halves<D>(vs, vb + (size_t)k0 * D, kBK, kThreads);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(score(k0, j) - m) / l;
      const float* vrow = vs[j][half];
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) o[row * D + half * DH + d] = acc[d];
  if (half == 0) lse[row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// launchers, templated on the head dim
// ---------------------------------------------------------------------------
template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse, int B,
                int H, int L, int window, float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_fwd<D, BandMask>(q, k, v, o, static_cast<float*>(lse), nullptr,
                                                  nullptr, {B, H, H, L, L, scale}, {window}, s);
  }
  if (!hopper::bind_device_of(o)) return cudaErrorInvalidValue;
  banded_fwd_f32_kernel<D><<<dim3(L / kBQ, B * H), 2 * kBQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), L, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int H, int L, int window,
                   float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_bwd_dq<D, BandMask>(
        q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), nullptr,
        dq, {B, H, H, L, L, scale}, {window}, s);
  }
  if (!hopper::bind_device_of(dq)) return cudaErrorInvalidValue;
  launch_bwd_dq_f32<D>(q, k, v, nullptr, dout, lse, delta, dq, B, H, H, L, window, scale, s);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int H, int L,
                     int window, float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_bwd_dkdv<D, BandMask>(
        q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), nullptr,
        dk, dv, {B, H, H, L, L, scale}, {window}, s);
  }
  if (!hopper::bind_device_of(dk)) return cudaErrorInvalidValue;
  launch_bwd_dkdv_f32<D>(q, k, v, nullptr, dout, lse, delta, dk, dv, B, H, H, L, window, scale,
                         s);
  return cudaGetLastError();
}

// The JAX envelope's shapes (L a multiple of its 128-row q block; the
// band's width is checked by the wrapper) at the head dims built here.
bool banded_ok(int dtype, int B, int H, int L, int D, int window) {
  return (dtype == 0 || dtype == 1) && (D == 64 || D == 128) && B > 0 && H > 0 && L > 0 &&
         L % 128 == 0 && window > 0;
}

}  // namespace

extern "C" {

int acco_banded_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                    int B, int H, int L, int D, int window, float scale, void* stream) {
  if (!banded_ok(dtype, B, H, L, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? fwd<64>(dtype, q, k, v, o, lse, B, H, L, window, scale, s)
                       : fwd<128>(dtype, q, k, v, o, lse, B, H, L, window, scale, s));
}

int acco_banded_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta, void* dq, int B,
                       int H, int L, int D, int window, float scale, void* stream) {
  if (!banded_ok(dtype, B, H, L, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? bwd_dq<64>(dtype, q, k, v, dout, lse, delta, dq, B, H, L, window, scale, s)
                       : bwd_dq<128>(dtype, q, k, v, dout, lse, delta, dq, B, H, L, window, scale,
                                     s));
}

int acco_banded_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int L, int D, int window, float scale,
                         void* stream) {
  if (!banded_ok(dtype, B, H, L, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? bwd_dkdv<64>(dtype, q, k, v, dout, lse, delta, dk, dv, B, H, L, window,
                                      scale, s)
                       : bwd_dkdv<128>(dtype, q, k, v, dout, lse, delta, dk, dv, B, H, L, window,
                                       scale, s));
}

}  // extern "C"
