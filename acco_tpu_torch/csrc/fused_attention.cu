// Causal (+window, +key padding) attention for Hopper: forward and backward.
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
//   -1e9, as in the JAX kernel, so a row with at least one allowed key
//   gets exactly the JAX probabilities.
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
// intermediate out of device memory: each block walks KV (or Q) tiles
// only inside the causal and window band, with the running max / sum and
// the output (or gradient) rows in registers.
//
// Two implementations, chosen by dtype:
// * bfloat16, the training path: tensor cores through mma.sync m16n8k16
//   (bf16 in, f32 accumulate), one warp per 16 rows, operands loaded with
//   ldmatrix. P and dS are rounded to bf16 before their products, as the
//   JAX kernel does. Without wgmma, TMA or pipelined loads it is still
//   several times its bound.
// * float32: FMAs on the CUDA cores, two threads per row, each owning half
//   the head dim, so that the row's halves stay in registers.
//
// Four launchers, each with a plain C interface that returns
// cudaGetLastError():
//   acco_attn_fwd        one block per (64-row q tile, b*h)
//   acco_attn_bwd_delta  one warp per (b, h, row)
//   acco_attn_bwd_dkdv   one block per (64-key tile, b*hkv), looping over
//                        the q tiles and the n_rep q heads
//   acco_attn_bwd_dq     one block per (64-row q tile, b*h)
// dtype code: 0 = float32, 1 = bfloat16. Only head_dim 64 is built; the
// Python wrapper refuses anything else before launching.

// The helpers and the float32 backward kernels live in attention_common.cuh,
// which banded_attention.cu shares.

#include "attention_common.cuh"

namespace {

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

__global__ void __launch_bounds__(32 * kWarps)
    attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ pad,
                        bf16* __restrict__ o, float* __restrict__ lse, int H, int n_rep, int L,
                        int window, float scale) {
  __shared__ __align__(16) bf16 qs[kTile][kRow];
  __shared__ __align__(16) bf16 ks[kTile][kRow];
  __shared__ __align__(16) bf16 vs[kTile][kRow];
  __shared__ int kok[kTile];
  constexpr int D = kHeadDim;
  constexpr int kThreads = 32 * kWarps;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + warp * 16 + g;  // this lane's rows: row_lo, row_lo + 8
  const bf16* kb = k + kv_head * L * D;
  const bf16* vb = v + kv_head * L * D;
  const int* pad_row = pad ? pad + (size_t)b * L : nullptr;

  copy_tile(qs, q + ((size_t)bh * L + q0) * D, kThreads);
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, qs, warp * 16);

  float oacc[8][4];
  zero(oacc);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int kv_end = q0 + kTile;
  for (int k0 = kv_band_begin(q0, window, kTile); k0 < kv_end; k0 += kTile) {
    __syncthreads();
    copy_tile(ks, kb + (size_t)k0 * D, kThreads);
    copy_tile(vs, vb + (size_t)k0 * D, kThreads);
    if (threadIdx.x < kTile) kok[threadIdx.x] = pad_row ? pad_row[k0 + threadIdx.x] : 1;
    __syncthreads();

    float s[8][4];
    zero(s);
    mma_rows(s, qa, ks);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row_lo + (e / 2) * 8;
        const int jj = j * 8 + 2 * t + (e % 2);
        s[j][e] = (kok[jj] != 0 && in_band(i, k0 + jj, window)) ? s[j][e] * scale : kMasked;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);  // 0 on the first tile (m = -inf)
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);
        l[e / 2] += s[j][e];  // this lane's share; the quad is summed at the end
        oacc[j][e] *= corr[e / 2];
      }
    }
    uint32_t pa[4][4];
    acc_to_a(pa, s);
    mma_cols(oacc, pa, vs);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bh * L + row_lo + h * 8;
      const float inv = 1.f / l[h];
      *reinterpret_cast<uint32_t*>(o + row * D + j * 8 + 2 * t) =
          pack_bf16(oacc[j][2 * h] * inv, oacc[j][2 * h + 1] * inv);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[(size_t)bh * L + row_lo + h * 8] = m[h] + logf(l[h]);
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ pad,
                           const bf16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dq, int H,
                           int n_rep, int L, int window, float scale) {
  __shared__ __align__(16) bf16 qs[kTile][kRow];  // then reused for dO
  __shared__ __align__(16) bf16 ks[kTile][kRow];
  __shared__ __align__(16) bf16 vs[kTile][kRow];
  __shared__ int kok[kTile];
  constexpr int D = kHeadDim;
  constexpr int kThreads = 32 * kWarps;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + warp * 16 + g;
  const bf16* kb = k + kv_head * L * D;
  const bf16* vb = v + kv_head * L * D;
  const int* pad_row = pad ? pad + (size_t)b * L : nullptr;

  uint32_t qa[4][4], da[4][4];
  copy_tile(qs, q + ((size_t)bh * L + q0) * D, kThreads);
  __syncthreads();
  load_a(qa, qs, warp * 16);
  __syncthreads();
  copy_tile(qs, dout + ((size_t)bh * L + q0) * D, kThreads);
  __syncthreads();
  load_a(da, qs, warp * 16);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = lse[(size_t)bh * L + row_lo + h * 8];
    delta_r[h] = delta[(size_t)bh * L + row_lo + h * 8];
  }

  float dqacc[8][4];
  zero(dqacc);
  const int kv_end = q0 + kTile;
  for (int k0 = kv_band_begin(q0, window, kTile); k0 < kv_end; k0 += kTile) {
    __syncthreads();
    copy_tile(ks, kb + (size_t)k0 * D, kThreads);
    copy_tile(vs, vb + (size_t)k0 * D, kThreads);
    if (threadIdx.x < kTile) kok[threadIdx.x] = pad_row ? pad_row[k0 + threadIdx.x] : 1;
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows(s, qa, ks);
    mma_rows(dp, da, vs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int i = row_lo + h * 8;
        const int jj = j * 8 + 2 * t + (e % 2);
        const float sv = (kok[jj] != 0 && in_band(i, k0 + jj, window)) ? s[j][e] * scale : kMasked;
        const float p = expf(sv - lse_r[h]);
        s[j][e] = p * (dp[j][e] - delta_r[h]);  // dS, rounded to bf16 by acc_to_a
      }
    }
    uint32_t dsa[4][4];
    acc_to_a(dsa, s);
    mma_cols(dqacc, dsa, ks);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bh * L + row_lo + h * 8;
      *reinterpret_cast<uint32_t*>(dq + row * D + j * 8 + 2 * t) =
          pack_bf16(dqacc[j][2 * h] * scale, dqacc[j][2 * h + 1] * scale);
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ pad,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int H, int n_rep, int L, int window,
                             float scale) {
  __shared__ __align__(16) bf16 qs[kTile][kRow];  // K, then each Q tile
  __shared__ __align__(16) bf16 ds_[kTile][kRow];  // V, then each dO tile
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  constexpr int D = kHeadDim;
  constexpr int kThreads = 32 * kWarps;

  const int Hkv = H / n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g;  // this lane's key rows: key_lo, key_lo + 8

  // This warp's 16 K and V rows as A fragments (S^T = K Q^T, dP^T = V dO^T).
  uint32_t ka[4][4], va[4][4];
  copy_tile(qs, k + ((size_t)bkv * L + k0) * D, kThreads);
  copy_tile(ds_, v + ((size_t)bkv * L + k0) * D, kThreads);
  __syncthreads();
  load_a(ka, qs, warp * 16);
  load_a(va, ds_, warp * 16);
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_ok[h] = pad == nullptr || pad[(size_t)b * L + key_lo + h * 8] != 0;

  float dkacc[8][4], dvacc[8][4];
  zero(dkacc);
  zero(dvacc);
  int q_end = L;
  if (window > 0) {
    const int hi = k0 + kTile - 1 + window;  // exclusive
    q_end = hi < L ? ((hi + kTile - 1) / kTile) * kTile : L;
  }
  for (int r = 0; r < n_rep; ++r) {
    const size_t bh = (size_t)b * H + (size_t)hk * n_rep + r;
    for (int q0 = k0; q0 < q_end; q0 += kTile) {
      __syncthreads();
      copy_tile(qs, q + (bh * L + q0) * D, kThreads);
      copy_tile(ds_, dout + (bh * L + q0) * D, kThreads);
      if (threadIdx.x < kTile) {
        lse_s[threadIdx.x] = lse[bh * L + q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta[bh * L + q0 + threadIdx.x];
      }
      __syncthreads();
      float st[8][4], dpt[8][4];
      zero(st);
      zero(dpt);
      mma_rows(st, ka, qs);
      mma_rows(dpt, va, ds_);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int ii = j * 8 + 2 * t + (e % 2);
          const float sv = (key_ok[h] && in_band(q0 + ii, key_lo + h * 8, window))
                               ? st[j][e] * scale : kMasked;
          const float p = expf(sv - lse_s[ii]);
          st[j][e] = p;  // P^T, rounded to bf16 by acc_to_a
          dpt[j][e] = p * (dpt[j][e] - delta_s[ii]);  // dS^T
        }
      }
      uint32_t a[4][4];
      acc_to_a(a, st);
      mma_cols(dvacc, a, ds_);
      acc_to_a(a, dpt);
      mma_cols(dkacc, a, qs);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bkv * L + key_lo + h * 8;
      *reinterpret_cast<uint32_t*>(dk + row * D + j * 8 + 2 * t) =
          pack_bf16(dkacc[j][2 * h] * scale, dkacc[j][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row * D + j * 8 + 2 * t) =
          pack_bf16(dvacc[j][2 * h], dvacc[j][2 * h + 1]);
    }
  }
}

bool shape_ok(int B, int H, int Hkv, int L, int D) {
  return D == kHeadDim && B > 0 && Hkv > 0 && H % Hkv == 0 && L > 0 && L % kBKV == 0;
}

}  // namespace

extern "C" {

int acco_attn_fwd(int dtype, const void* q, const void* k, const void* v, const void* pad,
                  void* o, void* lse, int B, int H, int Hkv, int L, int D, int window,
                  float scale, void* stream) {
  if (!shape_ok(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  const dim3 grid(L / kBQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pad);
  if (dtype == 1) {
    attn_fwd_bf16_kernel<<<dim3(L / kTile, B * H), 32 * kWarps, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        p, static_cast<bf16*>(o), static_cast<float*>(lse), H, H / Hkv, L, window, scale);
  } else if (dtype == 0) {
    attn_fwd_f32_kernel<kHeadDim><<<grid, 2 * kBQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), p, static_cast<float*>(o), static_cast<float*>(lse),
        H, H / Hkv, L, window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int acco_attn_bwd_delta(int dtype, const void* o, const void* dout, void* delta, long rows,
                        int D, void* stream) {
  if (D != kHeadDim || rows <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long warps_per_block = kThreads / 32;
  const dim3 grid((unsigned)((rows + warps_per_block - 1) / warps_per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    attn_bwd_delta_kernel<T, kHeadDim><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta),
        rows);
  } else if (dtype == 0) {
    attn_bwd_delta_kernel<float, kHeadDim><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int acco_attn_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                       const void* pad, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int H, int Hkv, int L,
                       int D, int window, float scale, void* stream) {
  if (!shape_ok(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    attn_bwd_dkdv_bf16_kernel<<<dim3(L / kTile, B * Hkv), 32 * kWarps, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int*>(pad), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, H / Hkv, L, window, scale);
  } else if (dtype == 0) {
    launch_bwd_dkdv_f32(q, k, v, pad, dout, lse, delta, dk, dv, B, H, Hkv, L, window, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int acco_attn_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* pad,
                     const void* dout, const void* lse, const void* delta, void* dq, int B,
                     int H, int Hkv, int L, int D, int window, float scale, void* stream) {
  if (!shape_ok(B, H, Hkv, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    attn_bwd_dq_bf16_kernel<<<dim3(L / kTile, B * H), 32 * kWarps, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int*>(pad), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), H, H / Hkv, L, window, scale);
  } else if (dtype == 0) {
    launch_bwd_dq_f32(q, k, v, pad, dout, lse, delta, dq, B, H, Hkv, L, window, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
