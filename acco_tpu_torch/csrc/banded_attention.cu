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
// f32 for the backward. Masked scores are -1e9, as in the JAX kernel.
//
// The forward keeps the JAX kernel's arithmetic: the row max over the whole
// band first, then the sum of exp(s - max), then the NORMALISED P rounded to
// the activation dtype before the PV product, with no online rescaling. The
// TPU kernel holds the band's [128, (nprev + 1) * 128] f32 scores in VMEM;
// a Hopper block has 227 KB of shared memory, and the widest band of the
// envelope (W 897: 64 rows x 960 keys x 4 B = 245 KB) does not fit. So
// each block recomputes its scores in every pass instead (three Q K^T
// products over the band: max, sum, PV). They are exact repeats of the same
// mma sequence, so every pass sees the same scores. What the bf16 kernel
// keeps resident is the band's K tiles (bf16, at most 15 tiles of 64 keys,
// 138 KB at W 897): K is read from device memory once per block, and the
// first two passes run with no loads and no barriers. V is streamed in the
// third pass, each tile's load under the previous tile's products. The
// whole envelope runs on this one kernel.
//
// The backward keeps the JAX kernels' arithmetic (P from the saved LSE, P
// and dS rounded before their products) in two bf16 kernels of its own,
// dQ over each q tile's key band and dK/dV over each key tile's q band,
// which mask only the tiles that cross an edge of the band and load the
// next tile while this one is multiplied (cp.async, two stages). delta =
// rowsum(dO * O) comes from K1's `acco_attn_bwd_delta`. The float32
// backward is the one both libraries share (attention_common.cuh).
//
// What bounds it on the H100, at the GPT-Neo-125M local layer (B 8, H 12,
// L 1024, D 64, W 256, bf16; from the data sheet's 3.35 TB/s and 989
// TFLOP/s, not measured): 22,032,384 (query, key) pairs;
//   forward  50.7 MB moved -> 15.1 us, memory-bound (operations 5.7 us);
//   dQ       63.7 MB       -> 19.0 us, memory-bound (operations 8.6 us);
//   dK/dV    76.3 MB       -> 22.8 us, memory-bound (operations 11.4 us).
// Unlike K1's causal backward, this backward is bound by memory. The design
// keeps everything [L, L] out of device memory; each K and V tile is still
// read by the up to five q tiles whose band holds it (from L2), and the
// two-stage loads of the backward keep those reads under the products.
//
// Two implementations, chosen by dtype: bfloat16 on the tensor cores
// (mma.sync m16n8k16, one warp per 16 rows, as in K1) and float32 on the
// CUDA cores (two threads per row, each owning half of the head dim).
//
// Three launchers with a plain C interface, each returning
// cudaGetLastError(); dtype code 0 = float32, 1 = bfloat16; head_dim 64.
//   acco_banded_fwd       one block per (64-row q tile, b*h)
//   acco_banded_bwd_dq    one block per (64-row q tile, b*h)
//   acco_banded_bwd_dkdv  one block per (64-key tile, b*h), looping over
//                         the q tiles that can see it (no atomics)

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16, tensor cores: forward
// ---------------------------------------------------------------------------

// Masked scale * Q K^T of this lane's two rows (row_lo, row_lo + 8) against
// the key tile in `ks`, whose first key is k0 (accumulator layout, see
// attention_common.cuh).
__device__ __forceinline__ void band_scores(float (&s)[8][4], const uint32_t (&qa)[4][4],
                                            bf16 (*ks)[kRow], int row_lo, int k0, int window,
                                            float scale) {
  const int t = threadIdx.x % 4;
  zero(s);
  mma_rows(s, qa, ks);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row_lo + (e / 2) * 8;
      const int jj = k0 + j * 8 + 2 * t + (e % 2);
      s[j][e] = in_band(i, jj, window) ? s[j][e] * scale : kMasked;
    }
  }
}

// Key tiles of 64 in the band of a 64-row q tile: ceil((W - 1) / 64) + 1.
// The envelope's widest band (W 897) has 15: with the Q tile and two V
// tiles, 18 tiles of 9 KB, 165,888 bytes of shared memory.
__host__ __device__ constexpr int band_tiles(int window) {
  return (window - 1 + kTile - 1) / kTile + 1;
}
constexpr int kMaxBandTiles = 15;

// Dynamic shared memory: the Q tile, two stages of V tiles and the band's
// K tiles, which stay resident for the three passes (loaded from device
// memory once, as the TPU kernel keeps its band's KV blocks in VMEM).
__global__ void __launch_bounds__(32 * kWarps)
    banded_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int L, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*qs)[kRow] = reinterpret_cast<bf16 (*)[kRow]>(smem);
  bf16 (*vs)[kRow] = qs + kTile;         // stage s: vs + s * kTile
  bf16 (*kband)[kRow] = vs + 2 * kTile;  // band_tiles(window) tiles of kTile rows
  constexpr int D = kHeadDim;
  constexpr int kThreads = 32 * kWarps;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: row_lo, row_lo + 8
  const size_t base = (size_t)bh * L * D;

  const int k_begin = kv_band_begin(q0, window, kTile);
  const int n_tiles = (q0 + kTile - k_begin) / kTile;  // causal: no key past q0 + 63
  auto load_v = [&](int i) {
    copy_tile_async(vs + (i & 1) * kTile, v + base + (size_t)(k_begin + i * kTile) * D, kThreads);
  };
  // Q, the band's K tiles and V tile 0 in one group; V tile 0 is in place
  // long before pass 3 needs it.
  copy_tile_async(qs, q + base + (size_t)q0 * D, kThreads);
  for (int i = 0; i < n_tiles; ++i) {
    copy_tile_async(kband + i * kTile, k + base + (size_t)(k_begin + i * kTile) * D, kThreads);
  }
  load_v(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4];
  load_a(qa, qs, warp * 16);
  float s[8][4];

  // pass 1: the row max over the whole band
  float m[2] = {kMasked, kMasked};
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * kTile;
    band_scores(s, qa, kband + i * kTile, row_lo, k0, window, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e / 2] = fmaxf(m[e / 2], s[j][e]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }

  // pass 2: l = sum of exp(s - max)
  float l[2] = {0.f, 0.f};
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * kTile;
    band_scores(s, qa, kband + i * kTile, row_lo, k0, window, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e / 2] += expf(s[j][e] - m[e / 2]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // pass 3: O = sum of bf16(exp(s - max) / l) V, V tile i + 1 loading
  // (cp.async) under tile i's products
  float oacc[8][4];
  zero(oacc);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_v(i + 1);  // stage (i + 1) & 1 was last read in i - 1
    cp_async_commit();
    const int k0 = k_begin + i * kTile;
    band_scores(s, qa, kband + i * kTile, row_lo, k0, window, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e / 2]) / l[e / 2];
    uint32_t pa[4][4];
    acc_to_a(pa, s);  // the normalised P, rounded to bf16
    mma_cols(oacc, pa, vs + (i & 1) * kTile);
    cp_async_wait<0>();  // V tile i + 1 has landed
    __syncthreads();     // and every warp is done with V tile i
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bh * L + row_lo + h * 8;
      *reinterpret_cast<uint32_t*>(o + row * D + j * 8 + 2 * t) =
          pack_bf16(oacc[j][2 * h], oacc[j][2 * h + 1]);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[(size_t)bh * L + row_lo + h * 8] = m[h] + logf(l[h]);
  }
}

// ---------------------------------------------------------------------------
// float32, CUDA cores: forward
// ---------------------------------------------------------------------------
// Two threads per query row, each owning half of the head dim (its halves
// of the q row and of the output accumulator stay in registers); the two
// halves of each score are joined with one shuffle, so both threads of a
// pair hold the same scores. The same three passes as the bf16 kernel,
// with K reloaded tile by tile in each (float32 runs only with mixed
// precision off, never in the bf16 training cell).
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
// bfloat16, tensor cores: backward
// ---------------------------------------------------------------------------
// The JAX kernels' arithmetic: P = exp(scale * s - lse) from the saved LSE,
// dS = P * (dP - delta), P and dS rounded to bf16 before their products,
// dQ and dK scaled after the sum. What is the band's own:
// * the mask is applied only on the tiles that cross an edge of the band
//   (the diagonal tile and the window's far edge): at W 256, 2 of the 5
//   tiles of a q tile's band; the 3 inside it skip the index tests;
// * the next tile's loads (cp.async) run under this tile's products, and
//   the block's own two tiles arrive with the first band tile;
// * MHA with no pad mask: no key-validity loads, no loop over q heads.

// Whether every (query, key) pair of a 64-row q tile at q0 and a 64-key
// tile at k0 is inside the causal window (no mask needed).
__device__ __forceinline__ bool tile_in_band(int q0, int k0, int window) {
  return k0 + kTile - 1 <= q0 && q0 + kTile - 1 - k0 < window;
}

// dQ: one block per 64-row q tile, walking its band's key tiles, two
// stages of K and V tiles in shared memory.
__global__ void __launch_bounds__(32 * kWarps)
    banded_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int L, int window, float scale) {
  __shared__ __align__(16) bf16 ks[2][kTile][kRow];
  __shared__ __align__(16) bf16 vs[2][kTile][kRow];
  constexpr int D = kHeadDim;
  constexpr int kThreads = 32 * kWarps;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row_lo = q0 + warp * 16 + lane / 4;  // this lane's rows: row_lo, row_lo + 8
  const size_t base = (size_t)bh * L * D;
  const int k_begin = kv_band_begin(q0, window, kTile);
  const int n_tiles = (q0 - k_begin) / kTile + 1;
  auto prefetch = [&](int i) {
    const size_t off = base + (size_t)(k_begin + i * kTile) * D;
    copy_tile_async(ks[i & 1], k + off, kThreads);
    copy_tile_async(vs[i & 1], v + off, kThreads);
  };

  // Q and dO through the stage-1 buffers, with band tile 0 into stage 0.
  copy_tile_async(ks[1], q + base + (size_t)q0 * D, kThreads);
  copy_tile_async(vs[1], dout + base + (size_t)q0 * D, kThreads);
  prefetch(0);
  cp_async_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = lse[(size_t)bh * L + row_lo + h * 8];
    delta_r[h] = delta[(size_t)bh * L + row_lo + h * 8];
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a(qa, ks[1], warp * 16);
  load_a(da, vs[1], warp * 16);
  __syncthreads();

  float dqacc[8][4];
  zero(dqacc);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) prefetch(i + 1);  // stage (i + 1) & 1 was last read in i - 1
    cp_async_commit();
    const int k0 = k_begin + i * kTile;
    const bool edge = !tile_in_band(q0, k0, window);
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows(s, qa, ks[i & 1]);
    mma_rows(dp, da, vs[i & 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float sv = s[j][e] * scale;
        if (edge && !in_band(row_lo + h * 8, k0 + j * 8 + 2 * t + (e % 2), window)) {
          sv = kMasked;
        }
        const float p = expf(sv - lse_r[h]);
        s[j][e] = p * (dp[j][e] - delta_r[h]);  // dS, rounded to bf16 by acc_to_a
      }
    }
    uint32_t dsa[4][4];
    acc_to_a(dsa, s);
    mma_cols(dqacc, dsa, ks[i & 1]);
    cp_async_wait<0>();  // tile i + 1 has landed
    __syncthreads();     // and every warp is done with tile i
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

// dK, dV: one block per 64-key tile, walking the q tiles whose band holds
// it (k0 up to k0 + 63 + W - 1), two stages of Q, dO, LSE and delta tiles.
// Each key's gradient is summed inside its block: no atomics.
__global__ void __launch_bounds__(32 * kWarps)
    banded_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int window,
                                float scale) {
  __shared__ __align__(16) bf16 qs[2][kTile][kRow];
  __shared__ __align__(16) bf16 dos[2][kTile][kRow];
  __shared__ __align__(16) float lse_s[2][kTile];
  __shared__ __align__(16) float delta_s[2][kTile];
  constexpr int D = kHeadDim;
  constexpr int kThreads = 32 * kWarps;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int key_lo = k0 + warp * 16 + lane / 4;  // this lane's keys: key_lo, key_lo + 8
  const size_t base = (size_t)bh * L * D;
  const int hi = k0 + kTile - 1 + window;  // the first query row that sees no key here
  const int q_end = hi < L ? ((hi + kTile - 1) / kTile) * kTile : L;
  const int n_tiles = (q_end - k0) / kTile;
  auto prefetch = [&](int i) {
    const int q0 = k0 + i * kTile;
    copy_tile_async(qs[i & 1], q + base + (size_t)q0 * D, kThreads);
    copy_tile_async(dos[i & 1], dout + base + (size_t)q0 * D, kThreads);
    const int c = threadIdx.x % 16;  // 16 copies of 4 floats per row vector
    if (threadIdx.x < 16) {
      cp_async16(&lse_s[i & 1][4 * c], lse + (size_t)bh * L + q0 + 4 * c);
    } else if (threadIdx.x < 32) {
      cp_async16(&delta_s[i & 1][4 * c], delta + (size_t)bh * L + q0 + 4 * c);
    }
  };

  // K and V through the stage-1 buffers, with q tile 0 into stage 0.
  copy_tile_async(qs[1], k + base + (size_t)k0 * D, kThreads);
  copy_tile_async(dos[1], v + base + (size_t)k0 * D, kThreads);
  prefetch(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[4][4], va[4][4];  // S^T = K Q^T, dP^T = V dO^T
  load_a(ka, qs[1], warp * 16);
  load_a(va, dos[1], warp * 16);
  __syncthreads();

  float dkacc[8][4], dvacc[8][4];
  zero(dkacc);
  zero(dvacc);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) prefetch(i + 1);
    cp_async_commit();
    const int q0 = k0 + i * kTile;
    const bool edge = !tile_in_band(q0, k0, window);
    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    mma_rows(st, ka, qs[i & 1]);
    mma_rows(dpt, va, dos[i & 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int ii = j * 8 + 2 * t + (e % 2);
        float sv = st[j][e] * scale;
        if (edge && !in_band(q0 + ii, key_lo + h * 8, window)) sv = kMasked;
        const float p = expf(sv - lse_s[i & 1][ii]);
        st[j][e] = p;                                       // P^T, rounded by acc_to_a
        dpt[j][e] = p * (dpt[j][e] - delta_s[i & 1][ii]);  // dS^T
      }
    }
    uint32_t a[4][4];
    acc_to_a(a, st);
    mma_cols(dvacc, a, dos[i & 1]);
    acc_to_a(a, dpt);
    mma_cols(dkacc, a, qs[i & 1]);
    cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t row = (size_t)bh * L + key_lo + h * 8;
      *reinterpret_cast<uint32_t*>(dk + row * D + j * 8 + 2 * t) =
          pack_bf16(dkacc[j][2 * h] * scale, dkacc[j][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row * D + j * 8 + 2 * t) =
          pack_bf16(dvacc[j][2 * h], dvacc[j][2 * h + 1]);
    }
  }
}

bool banded_ok(int B, int H, int L, int D, int window) {
  return D == kHeadDim && B > 0 && H > 0 && L > 0 && L % kTile == 0 && window > 0 &&
         band_tiles(window) <= kMaxBandTiles;
}

}  // namespace

extern "C" {

int acco_banded_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                    int B, int H, int L, int D, int window, float scale, void* stream) {
  if (!banded_ok(B, H, L, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int smem = (3 + band_tiles(window)) * kTile * kRow * (int)sizeof(bf16);
    const cudaError_t err = cudaFuncSetAttribute(
        banded_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    banded_fwd_bf16_kernel<<<dim3(L / kTile, B * H), 32 * kWarps, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), L, window, scale);
  } else if (dtype == 0) {
    banded_fwd_f32_kernel<kHeadDim><<<dim3(L / kBQ, B * H), 2 * kBQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), L,
        window, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int acco_banded_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta, void* dq, int B,
                       int H, int L, int D, int window, float scale, void* stream) {
  if (!banded_ok(B, H, L, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    banded_bwd_dq_bf16_kernel<<<dim3(L / kTile, B * H), 32 * kWarps, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), L, window, scale);
  } else if (dtype == 0) {
    launch_bwd_dq_f32(q, k, v, nullptr, dout, lse, delta, dq, B, H, H, L, window, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int acco_banded_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int L, int D, int window, float scale,
                         void* stream) {
  if (!banded_ok(B, H, L, D, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    banded_bwd_dkdv_bf16_kernel<<<dim3(L / kTile, B * H), 32 * kWarps, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L,
        window, scale);
  } else if (dtype == 0) {
    launch_bwd_dkdv_f32(q, k, v, nullptr, dout, lse, delta, dk, dv, B, H, H, L, window, scale,
                        s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
