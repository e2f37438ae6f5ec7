// Causal flash attention with segment ids for Hopper: forward and backward (K5).
//
// Replaces JAX's bundled Pallas TPU flash kernel, which the JAX package
// reaches through acco_tpu/ops/attention.py:193 `flash_dot_product_attention`
// (jax.experimental.pallas.ops.tpu.flash_attention: the forward
// `_flash_attention_impl`, and the backward's `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq`, one `pallas_call` each). Contract, for q
// [B, H, L, D], k/v [B, Hkv, L, D] (GQA through h / n_rep; K and V are never
// repeated) and optional int32 segment ids seg [B, L]:
//
//   O = softmax(scale * Q K^T + mask) V,  mask: j <= i and seg[i] == seg[j].
//
// This is the flash kernel's mask, not K1's: K1 (fused_attention.cu) masks
// pad KEYS for every query, while here a pad query (segment 0) attends to
// the pad keys at or before it. The two agree on real rows. The causal
// diagonal always shares its segment, so no row is ever fully masked and the
// finite mask value (-1e9 here, -0.7 * FLT_MAX in JAX) gives exact zeros.
// The forward saves lse [B, H, L] f32 (JAX saves l and m; lse = m + log l);
// the backward recomputes P = exp(s - lse), takes delta = rowsum(dO * O)
// from a pre-pass, and forms dS = P * (dP - delta) * scale, rounded to the
// activation dtype before its products, as the JAX kernel does. dK and dV
// are summed over the n_rep q heads of each KV head inside one block: no
// atomics, so the gradients are deterministic.
//
// What bounds it on the H100 (data sheet: 989 TFLOP/s bf16, 3.35 TB/s): at
// Llama-3-8B's long-context shape (B 1, H 32, Hkv 8, L 8192, D 128) there
// are 1.07e9 attended pairs; the forward's 4 D operations a pair take 0.56
// ms and the backward's dK/dV (8 D) and dQ (6 D) 1.95 ms, against 0.1 ms of
// bytes: compute-bound. The design keeps
// everything [L, L] out of device memory and runs every product on wgmma.
//
// Two implementations, chosen by dtype:
// * bfloat16: the wgmma + TMA attention mainloop of hopper_attention.cuh
//   with the segment mask below as its policy (forward: 128 query rows a
//   block, 128-key K/V tiles; dQ: 128 query rows, 64-key tiles; dK/dV: 128
//   keys, 64-query steps over the n_rep q heads), head_dim 64 and 128.
// * float32: FMAs on the CUDA cores, D / 32 threads per row, each owning 32
//   of its elements; the parts of a dot product are joined with shuffles.
//
// Four launchers, each with a plain C interface returning
// cudaGetLastError(); dtype code 0 = float32, 1 = bfloat16:
//   acco_flash_fwd        one block per (128-row q tile, b*h), heaviest first
//   acco_flash_bwd_delta  one warp per (b, h, row)
//   acco_flash_bwd_dkdv   one block per (128-key tile, b*hkv), looping over
//                         the n_rep q heads and the q steps at or after it
//   acco_flash_bwd_dq     one block per (128-row q tile, b*h), heaviest first

#include "hopper_attention.cuh"
#include "tiles.cuh"

namespace {

// The mask policy of hopper_attention.cuh for K5: causal AND equal segment
// ids; every row keeps its diagonal, so none is ever fully masked.
struct SegmentMask {
  static constexpr bool kScaleInDs = true;  // dS = P (dP - delta) scale, rounded
  static constexpr bool kFlagRows = false;
  static constexpr bool kStats = false;
  static constexpr bool kExactP = false;
  static constexpr bool kBounds = false;
  struct Params {
    const int* seg;
  };
  const int* seg;
  int L;

  __device__ SegmentMask(const Params& p, int b, int L_, int)
      : seg(p.seg ? p.seg + (size_t)b * L_ : nullptr), L(L_) {}
  __device__ bool has_key_mask() const { return seg != nullptr; }
  __device__ int key_begin(int) const { return 0; }
  __device__ int key_end(int q1) const { return min(L, q1); }
  __device__ int query_begin(int k0) const { return k0; }
  __device__ int query_end(int) const { return L; }
  __device__ bool partial(int i0, int i1, int j0, int j1) const {
    return seg != nullptr || j1 - 1 > i0 || i1 > L || j1 > L;
  }
  __device__ int query_val(int i) const { return seg != nullptr && i < L ? seg[i] : 0; }
  __device__ int key_val(int j) const { return seg != nullptr && j < L ? seg[j] : 0; }
  __device__ bool allowed(int i, int qv, int j, int kv) const { return j <= i && qv == kv; }
};

namespace k5 {

using namespace tiles;

// ---------------------------------------------------------------------------
// backward pre-pass, both dtypes: delta = rowsum(dO * O), one warp a row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                       float* __restrict__ delta, long rows) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(o[row * D + d]), to_f(dout[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// float32, CUDA cores (F32, load_parts, dot_parts: tiles.cuh)
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool allowed(const int* seg_b, int i, int j) {
  return j <= i && (seg_b == nullptr || seg_b[i] == seg_b[j]);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         float* __restrict__ o, float* __restrict__ lse, int H, int n_rep, int L,
                         float scale) {
  using C = F32<D>;
  __shared__ __align__(16) float ks[C::KB][D / 32][36];
  __shared__ __align__(16) float vs[C::KB][D / 32][36];
  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::RB;
  const int part = threadIdx.x % C::TPR;
  const int i = q0 + threadIdx.x / C::TPR;
  const size_t row = (size_t)bh * L + i;
  const int* seg_b = seg ? seg + (size_t)b * L : nullptr;

  float qr[32], acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    qr[d] = q[row * D + part * 32 + d];
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < q0 + C::RB; k0 += C::KB) {
    __syncthreads();
    load_parts<D>(ks, k + (kv_head * L + k0) * D, C::KB);
    load_parts<D>(vs, v + (kv_head * L + k0) * D, C::KB);
    __syncthreads();
    float s[C::KB];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < C::KB; ++j) {
      const float dot = dot_parts<D>(qr, ks[j][part]);
      s[j] = allowed(seg_b, i, k0 + j) ? dot * scale : kMasked;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < C::KB; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < 32; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < C::KB; ++j) {
#pragma unroll
      for (int d = 0; d < 32; ++d) acc[d] = fmaf(s[j], vs[j][part][d], acc[d]);
    }
    m = m_new;
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < 32; ++d) o[row * D + part * 32 + d] = acc[d] * inv;
  if (part == 0) lse[row] = m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ seg,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ dq, int H,
                            int n_rep, int L, float scale) {
  using C = F32<D>;
  __shared__ __align__(16) float ks[C::KB][D / 32][36];
  __shared__ __align__(16) float vs[C::KB][D / 32][36];
  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::RB;
  const int part = threadIdx.x % C::TPR;
  const int i = q0 + threadIdx.x / C::TPR;
  const size_t row = (size_t)bh * L + i;
  const int* seg_b = seg ? seg + (size_t)b * L : nullptr;

  float qr[32], dor[32], acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    qr[d] = q[row * D + part * 32 + d];
    dor[d] = dout[row * D + part * 32 + d];
    acc[d] = 0.f;
  }
  const float lse_i = lse[row], delta_i = delta[row];
  for (int k0 = 0; k0 < q0 + C::RB; k0 += C::KB) {
    __syncthreads();
    load_parts<D>(ks, k + (kv_head * L + k0) * D, C::KB);
    load_parts<D>(vs, v + (kv_head * L + k0) * D, C::KB);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < C::KB; ++j) {
      const float dot = dot_parts<D>(qr, ks[j][part]);
      const float dp = dot_parts<D>(dor, vs[j][part]);
      const float s = allowed(seg_b, i, k0 + j) ? dot * scale : kMasked;
      const float ds = expf(s - lse_i) * (dp - delta_i) * scale;
#pragma unroll
      for (int d = 0; d < 32; ++d) acc[d] = fmaf(ds, ks[j][part][d], acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < 32; ++d) dq[row * D + part * 32 + d] = acc[d];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ seg,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dk,
                              float* __restrict__ dv, int H, int n_rep, int L, float scale) {
  using C = F32<D>;
  constexpr int QT = 16;  // query rows a shared tile
  __shared__ __align__(16) float qs[QT][D / 32][36];
  __shared__ __align__(16) float dos[QT][D / 32][36];
  __shared__ float lse_s[QT], delta_s[QT];
  const int Hkv = H / n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int k0 = blockIdx.x * C::RB;
  const int part = threadIdx.x % C::TPR;
  const int j = k0 + threadIdx.x / C::TPR;
  const size_t row = (size_t)bkv * L + j;
  const int* seg_b = seg ? seg + (size_t)b * L : nullptr;

  float kr[32], vr[32], dk_acc[32], dv_acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    kr[d] = k[row * D + part * 32 + d];
    vr[d] = v[row * D + part * 32 + d];
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }
  for (int r = 0; r < n_rep; ++r) {
    const size_t bh = (size_t)b * H + (size_t)hk * n_rep + r;
    for (int q0 = (k0 / QT) * QT; q0 < L; q0 += QT) {
      __syncthreads();
      load_parts<D>(qs, q + (bh * L + q0) * D, QT);
      load_parts<D>(dos, dout + (bh * L + q0) * D, QT);
      if (threadIdx.x < QT) {
        lse_s[threadIdx.x] = lse[bh * L + q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta[bh * L + q0 + threadIdx.x];
      }
      __syncthreads();
#pragma unroll 1
      for (int ii = 0; ii < QT; ++ii) {
        const float dot = dot_parts<D>(kr, qs[ii][part]);
        const float dp = dot_parts<D>(vr, dos[ii][part]);
        const float s = allowed(seg_b, q0 + ii, j) ? dot * scale : kMasked;
        const float p = expf(s - lse_s[ii]);
        const float ds = p * (dp - delta_s[ii]) * scale;
#pragma unroll
        for (int d = 0; d < 32; ++d) {
          dv_acc[d] = fmaf(p, dos[ii][part][d], dv_acc[d]);
          dk_acc[d] = fmaf(ds, qs[ii][part][d], dk_acc[d]);
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    dk[row * D + part * 32 + d] = dk_acc[d];
    dv[row * D + part * 32 + d] = dv_acc[d];
  }
}

// ---------------------------------------------------------------------------
// launchers, templated on the head dim
// ---------------------------------------------------------------------------
template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, const int* seg, void* o,
                void* lse, int B, int H, int Hkv, int L, float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_fwd<D, SegmentMask>(q, k, v, o, static_cast<float*>(lse), nullptr,
                                                     nullptr, {B, H, Hkv, L, L, scale}, {seg}, s);
  }
  if (!hopper::bind_device_of(o)) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<D><<<dim3(L / F32<D>::RB, B * H), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, static_cast<float*>(o), static_cast<float*>(lse), H, H / Hkv, L, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const int* seg,
                   const void* dout, const float* lse, const float* delta, void* dq, int B,
                   int H, int Hkv, int L, float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_bwd_dq<D, SegmentMask>(q, k, v, dout, lse, delta, nullptr, dq,
                                                        {B, H, Hkv, L, L, scale}, {seg}, s);
  }
  if (!hopper::bind_device_of(dq)) return cudaErrorInvalidValue;
  flash_bwd_dq_f32_kernel<D><<<dim3(L / F32<D>::RB, B * H), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), H, H / Hkv, L,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const int* seg,
                     const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                     int B, int H, int Hkv, int L, float scale, cudaStream_t s) {
  if (dtype == 1) {
    return hopper::attn::launch_bwd_dkdv<D, SegmentMask>(q, k, v, dout, lse, delta, nullptr, dk,
                                                          dv, {B, H, Hkv, L, L, scale}, {seg}, s);
  }
  if (!hopper::bind_device_of(dk)) return cudaErrorInvalidValue;
  flash_bwd_dkdv_f32_kernel<D><<<dim3(L / F32<D>::RB, B * Hkv), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, H / Hkv, L, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_delta(int dtype, const void* o, const void* dout, float* delta, long rows,
                      cudaStream_t s) {
  if (!hopper::bind_device_of(delta)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)));
  if (dtype == 1) {
    flash_bwd_delta_kernel<bf16, D><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, rows);
  } else {
    flash_bwd_delta_kernel<float, D><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta, rows);
  }
  return cudaGetLastError();
}

bool shape_ok(int dtype, int B, int H, int Hkv, int L, int D) {
  return (dtype == 0 || dtype == 1) && (D == 64 || D == 128) && B > 0 && Hkv > 0 &&
         H % Hkv == 0 && L >= kT && L % kT == 0;
}

}  // namespace k5
}  // namespace

extern "C" {

int acco_flash_fwd(int dtype, const void* q, const void* k, const void* v, const void* seg,
                   void* o, void* lse, int B, int H, int Hkv, int L, int D, float scale,
                   void* stream) {
  if (!k5::shape_ok(dtype, B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? k5::fwd<64>(dtype, q, k, v, sg, o, lse, B, H, Hkv, L, scale, s)
                       : k5::fwd<128>(dtype, q, k, v, sg, o, lse, B, H, Hkv, L, scale, s));
}

int acco_flash_bwd_delta(int dtype, const void* o, const void* dout, void* delta, long rows,
                         int D, void* stream) {
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128) || rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? k5::bwd_delta<64>(dtype, o, dout, dl, rows, s)
                       : k5::bwd_delta<128>(dtype, o, dout, dl, rows, s));
}

int acco_flash_bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const void* seg,
                        const void* dout, const void* lse, const void* delta, void* dk,
                        void* dv, int B, int H, int Hkv, int L, int D, float scale,
                        void* stream) {
  if (!k5::shape_ok(dtype, B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64
                   ? k5::bwd_dkdv<64>(dtype, q, k, v, sg, dout, ls, dl, dk, dv, B, H, Hkv, L,
                                      scale, s)
                   : k5::bwd_dkdv<128>(dtype, q, k, v, sg, dout, ls, dl, dk, dv, B, H, Hkv, L,
                                       scale, s));
}

int acco_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* seg,
                      const void* dout, const void* lse, const void* delta, void* dq, int B,
                      int H, int Hkv, int L, int D, float scale, void* stream) {
  if (!k5::shape_ok(dtype, B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? k5::bwd_dq<64>(dtype, q, k, v, sg, dout, ls, dl, dq, B, H, Hkv, L,
                                        scale, s)
                       : k5::bwd_dq<128>(dtype, q, k, v, sg, dout, ls, dl, dq, B, H, Hkv, L,
                                         scale, s));
}

}  // extern "C"
