// Causal (+window, +key padding) attention for Hopper: forward and backward (K1).
//
// Replaces the Pallas TPU kernels of acco_tpu/ops/fused_attention.py
// (`_attn_fwd` and `_attn_bwd`, each one `pl.pallas_call`). Those kernels
// keep one head's whole [L, L] f32 score tile in VMEM (4 MB at L = 1024);
// an H100 block has at most 227 KB of shared memory, so this version is a
// tiled online-softmax kernel with the same contract instead:
//
//   softmax(scale * Q K^T + mask) V   for q [B, H, L, D], k/v [B, Hkv, L, D]
//
// * mask: causal, plus a runtime sliding window (0 = global), plus an
//   optional [B, L] int32 key pad mask (0 = padding). Masked scores are
//   -1e9, as in the JAX kernel. A row with no allowed key (left padding:
//   its keys are all pads) is normalised over all L keys, as the JAX
//   kernel's whole-row softmax does: O is the mean of V, lse = -1e9, and
//   the backward's P = exp(s - lse) is 1 on every key.
// * GQA reads KV head h / n_rep; K and V are never repeated.
// * the forward saves lse [B, H, L] f32; the backward recomputes P from
//   it, uses delta = rowsum(dO * O), and sums dK / dV over the n_rep
//   query heads of each KV head inside one block: no atomics, so the
//   gradients are deterministic.
//
// What bounds it on the H100: at the flagship shape (B 8, H 12, L 1024,
// D 64, bf16) the forward moves ~51 MB and does ~13 GFLOP, so an ideal
// kernel is memory-bound at ~15 us; the dK/dV and dQ kernels are
// compute-bound (~26 and ~19 GFLOP). The design keeps every [L, L]
// intermediate out of device memory: each block walks KV tiles (or q
// steps) only inside the causal and window band, with the running max /
// sum and the output (or gradient) rows in registers.
//
// Two implementations, chosen by dtype:
// * bfloat16, the training path: the wgmma + TMA attention mainloop of
//   hopper_attention.cuh with the mask policy below (forward: 128 query
//   rows a block, 128-key K/V tiles; dQ: 128 query rows, 64-key tiles;
//   dK/dV: 128 keys, 64-query steps over the n_rep q heads). P and dS are
//   rounded to bf16 before their products, as the JAX kernel does.
// * float32: FMAs on the CUDA cores, two threads per row, each owning half
//   the head dim, so that the row's halves stay in registers (at D 128
//   dK/dV's four half rows exceed the registers and spill: float32 is the
//   end-to-end check's dtype, never a training cell's).
//
// Four launchers, each with a plain C interface that returns
// cudaGetLastError():
//   acco_attn_fwd        one block per (128-row q tile, b*h)
//   acco_attn_bwd_delta  one warp per (b, h, row)
//   acco_attn_bwd_dkdv   one block per (128-key tile, b*hkv), looping over
//                        the q steps and the n_rep q heads
//   acco_attn_bwd_dq     one block per (128-row q tile, b*h)
// dtype code: 0 = float32, 1 = bfloat16; head_dim 64 or 128 (the JAX
// kernel's head_dim % 64 == 0 on the model presets); L a multiple of 64.

// The float32 backward kernels live in attention_common.cuh, which
// banded_attention.cu shares.

#include "attention_common.cuh"
#include "hopper_attention.cuh"

namespace {

// The mask policy of hopper_attention.cuh for K1: causal, the window, the
// key pads.
struct WindowPadMask {
  static constexpr bool kScaleInDs = false;  // dS = P (dP - delta); dQ, dK scaled after
  static constexpr bool kFlagRows = true;    // all of a row's keys may be pads
  static constexpr bool kStats = false;
  static constexpr bool kExactP = false;
  static constexpr bool kBounds = false;
  struct Params {
    const int* pad;
    int window;
  };
  const int* pad;
  int window, L;

  __device__ WindowPadMask(const Params& p, int b, int L_, int)
      : pad(p.pad ? p.pad + (size_t)b * L_ : nullptr), window(p.window), L(L_) {}
  __device__ bool has_key_mask() const { return pad != nullptr; }
  __device__ int key_begin(int q0) const { return window > 0 ? max(0, q0 - window + 1) : 0; }
  __device__ int key_end(int q1) const { return min(L, q1); }
  __device__ int query_begin(int k0) const { return k0; }
  __device__ int query_end(int j) const { return window > 0 ? min(L, j + window) : L; }
  __device__ bool partial(int i0, int i1, int j0, int j1) const {
    return pad != nullptr || j1 - 1 > i0 || (window > 0 && i1 - 1 - j0 >= window) || i1 > L ||
           j1 > L;
  }
  __device__ int query_val(int) const { return 0; }
  __device__ int key_val(int j) const { return pad == nullptr ? 1 : (j < L ? pad[j] : 0); }
  __device__ bool allowed(int i, int, int j, int kv) const {
    return j <= i && (window == 0 || i - j < window) && kv != 0;
  }
};

// ---------------------------------------------------------------------------
// float32, CUDA cores: forward
// ---------------------------------------------------------------------------
// Two threads per query row, each owning half of the head dim (its halves
// of the q row and of the output accumulator stay in registers); the two
// halves of each score are joined with one shuffle. Both threads of a pair
// then hold the same scores and run the same online softmax.
template <int D>
__global__ void __launch_bounds__(2 * kBQ)
    attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ pad,
                        float* __restrict__ o, float* __restrict__ lse, int H, int n_rep,
                        int L, int window, float scale) {
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

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = q[row * D + half * DH + d];
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const int kv_end = q0 + kBQ;  // causal: no key past this tile's last row
  for (int k0 = kv_band_begin(q0, window, kBK); k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_halves<D>(ks, kb + (size_t)k0 * D, kBK, 2 * kBQ);
    load_halves<D>(vs, vb + (size_t)k0 * D, kBK, 2 * kBQ);
    if (threadIdx.x < kBK) kok[threadIdx.x] = pad_row ? pad_row[k0 + threadIdx.x] : 1;
    __syncthreads();

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = dot_reg<DH>(qr, ks[j][half]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      s[j] = (kok[j] != 0 && in_band(i, k0 + j, window)) ? dot * scale : kMasked;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* vrow = vs[j][half];
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
        acc[d] = fmaf(s[j], vv.x, acc[d]);
        acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }
  if (pad_row != nullptr && m == kMasked) {
    // every key this row may see is a pad: P = 1 on all L keys, as the JAX
    // kernel's whole-row softmax, so O is the mean of V
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = 0.f;
    for (int j = 0; j < L; ++j) {
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] += vb[(size_t)j * D + half * DH + d];
    }
    l = (float)L;
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < DH; ++d) o[row * D + half * DH + d] = acc[d] * inv;
  if (half == 0) lse[row] = m + logf(l);
}

// ---------------------------------------------------------------------------
// backward pre-pass, both dtypes: delta = rowsum(dO * O)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                      float* __restrict__ delta, long rows) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    acc = fmaf(to_f(o[row * D + d]), to_f(dout[row * D + d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// launchers, templated on the head dim
// ---------------------------------------------------------------------------
template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, const int* pad, void* o,
                void* lse, int B, int H, int Hkv, int L, int window, float scale,
                cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_fwd<D, WindowPadMask>(q, k, v, o, static_cast<float*>(lse),
                                                       nullptr, nullptr, {B, H, Hkv, L, L, scale},
                                                       {pad, window}, s);
  }
  if (!hopper::bind_device_of(o)) return cudaErrorInvalidValue;
  attn_fwd_f32_kernel<D><<<dim3(L / kBQ, B * H), 2 * kBQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pad, static_cast<float*>(o), static_cast<float*>(lse), H, H / Hkv, L, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const int* pad,
                     const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                     int B, int H, int Hkv, int L, int window, float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_bwd_dkdv<D, WindowPadMask>(
        q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), nullptr,
        dk, dv, {B, H, Hkv, L, L, scale}, {pad, window}, s);
  }
  if (!hopper::bind_device_of(dk)) return cudaErrorInvalidValue;
  attn_bwd_dkdv_f32_kernel<D><<<dim3(L / kBKV, B * Hkv), 2 * kBKV, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pad, static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), H,
      H / Hkv, L, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const int* pad,
                   const void* dout, const void* lse, const void* delta, void* dq, int B, int H,
                   int Hkv, int L, int window, float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_bwd_dq<D, WindowPadMask>(
        q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), nullptr,
        dq, {B, H, Hkv, L, L, scale}, {pad, window}, s);
  }
  if (!hopper::bind_device_of(dq)) return cudaErrorInvalidValue;
  attn_bwd_dq_f32_kernel<D><<<dim3(L / kBQ, B * H), 2 * kBQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      pad, static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, H / Hkv, L, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_delta(int dtype, const void* o, const void* dout, void* delta, long rows,
                      cudaStream_t s) {
  if (!hopper::bind_device_of(delta)) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long warps_per_block = kThreads / 32;
  const dim3 grid((unsigned)((rows + warps_per_block - 1) / warps_per_block));
  if (dtype == 1) {
    attn_bwd_delta_kernel<bf16, D><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
        rows);
  } else {
    attn_bwd_delta_kernel<float, D><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows);
  }
  return cudaGetLastError();
}

bool dtype_ok(int dtype) { return dtype == 0 || dtype == 1; }

bool shape_ok(int B, int H, int Hkv, int L, int D) {
  return (D == 64 || D == 128) && B > 0 && Hkv > 0 && H % Hkv == 0 && L > 0 && L % kBKV == 0;
}

}  // namespace

extern "C" {

int acco_attn_fwd(int dtype, const void* q, const void* k, const void* v, const void* pad,
                  void* o, void* lse, int B, int H, int Hkv, int L, int D, int window,
                  float scale, void* stream) {
  if (!dtype_ok(dtype) || !shape_ok(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? fwd<64>(dtype, q, k, v, p, o, lse, B, H, Hkv, L, window, scale, s)
                       : fwd<128>(dtype, q, k, v, p, o, lse, B, H, Hkv, L, window, scale, s));
}

int acco_attn_bwd_delta(int dtype, const void* o, const void* dout, void* delta, long rows,
                        int D, void* stream) {
  if (!dtype_ok(dtype) || (D != 64 && D != 128) || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? bwd_delta<64>(dtype, o, dout, delta, rows, s)
                       : bwd_delta<128>(dtype, o, dout, delta, rows, s));
}

int acco_attn_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                       const void* pad, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H, int Hkv, int L,
                       int D, int window, float scale, void* stream) {
  if (!dtype_ok(dtype) || !shape_ok(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? bwd_dkdv<64>(dtype, q, k, v, p, dout, lse, delta, dk, dv, B, H, Hkv, L,
                                      window, scale, s)
                       : bwd_dkdv<128>(dtype, q, k, v, p, dout, lse, delta, dk, dv, B, H, Hkv,
                                       L, window, scale, s));
}

int acco_attn_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* pad,
                     const void* dout, const void* lse, const void* delta, void* dq, int B,
                     int H, int Hkv, int L, int D, int window, float scale, void* stream) {
  if (!dtype_ok(dtype) || !shape_ok(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? bwd_dq<64>(dtype, q, k, v, p, dout, lse, delta, dq, B, H, Hkv, L,
                                    window, scale, s)
                       : bwd_dq<128>(dtype, q, k, v, p, dout, lse, delta, dq, B, H, Hkv, L,
                                     window, scale, s));
}

}  // extern "C"
