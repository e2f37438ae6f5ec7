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
// What bounds it on the H100 (data sheet: 989 TFLOP/s bf16, 3.35 TB/s; not
// measured): at Llama-3-8B's long-context shape (B 1, H 32, Hkv 8, L 8192,
// D 128) there are 1.07e9 attended pairs; the forward's 4 D operations a
// pair take 0.56 ms and the whole backward's 10 D 1.39 ms, against 0.1 ms
// of bytes: compute-bound. The design keeps everything [L, L] out of device
// memory: blocks walk KV (or Q) tiles only up to the causal diagonal, with
// the running max, sum and output (or gradient) rows in registers, and load
// the next tile with cp.async while the current one is multiplied.
//
// Two implementations, chosen by dtype:
// * bfloat16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//   accumulate), four warps of 16 rows each, operands through ldmatrix from
//   padded shared tiles (the A operand too, which keeps D 128's tiles out of
//   the registers). head_dim 64 and 128 are template instances: at D 128
//   the forward holds 64 f32 output values a thread, dQ 64, dK/dV 128 (so
//   dK/dV steps over 32 queries at a time there, 64 at D 64). Shared memory:
//   forward 5 tiles (Q, two stages of K and V), dQ 6, dK/dV 2 + 4 half
//   tiles; at most 104 KB a block at D 128.
// * float32: FMAs on the CUDA cores, D / 32 threads per row, each owning 32
//   of its elements; the parts of a dot product are joined with shuffles.
//
// Four launchers, each with a plain C interface returning
// cudaGetLastError(); dtype code 0 = float32, 1 = bfloat16:
//   acco_flash_fwd        one block per (64-row q tile, b*h), heaviest first
//   acco_flash_bwd_delta  one warp per (b, h, row)
//   acco_flash_bwd_dkdv   one block per (64-key tile, b*hkv), looping over
//                         the n_rep q heads and the q tiles at or after it
//   acco_flash_bwd_dq     one block per (64-row q tile, b*h), heaviest first

#include "tiles.cuh"

namespace {
namespace k5 {

using namespace tiles;

// ---------------------------------------------------------------------------
// bfloat16: forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ seg,
                          bf16* __restrict__ o, float* __restrict__ lse, int H, int n_rep, int L,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld<D>();
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kb = qs + kT * LD;       // two stages
  bf16* vb = kb + 2 * kT * LD;   // two stages
  int* segk = reinterpret_cast<int*>(vb + 2 * kT * LD);  // [2][kT]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;  // the longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + warp * 16 + g;  // this lane's rows: row_lo, row_lo + 8
  const bf16* kh = k + kv_head * L * D;
  const bf16* vh = v + kv_head * L * D;
  const int* seg_b = seg ? seg + (size_t)b * L : nullptr;
  int sq[2] = {0, 0};
  if (seg_b) {
    sq[0] = seg_b[row_lo];
    sq[1] = seg_b[row_lo + 8];
  }

  const int n_tiles = q0 / kT + 1;  // causal: key tiles 0 .. q0 / kT
  load_rows<D>(qs, q + ((size_t)bh * L + q0) * D, kT);
  load_rows<D>(kb, kh, kT);
  load_rows<D>(vb, vh, kT);
  if (seg_b) load_ints(segk, seg_b, kT);
  cp_async_commit();

  float oacc[D / 8][4];
  zero(oacc);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const int k0 = it * kT;
    if (it + 1 < n_tiles) {  // the next tile's loads run under this tile's products
      const int nxt = cur ^ 1;
      load_rows<D>(kb + nxt * kT * LD, kh + (size_t)(k0 + kT) * D, kT);
      load_rows<D>(vb + nxt * kT * LD, vh + (size_t)(k0 + kT) * D, kT);
      if (seg_b) load_ints(segk + nxt * kT, seg_b + k0 + kT, kT);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = kb + cur * kT * LD;
    const int* sk = segk + cur * kT;

    float s[kT / 8][4];
    zero(s);
    mma_abt<D, kT>(s, qs + warp * 16 * LD, ks);
    const bool diag = it == n_tiles - 1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int jj = j * 8 + 2 * t + (e % 2);
        const bool ok = (!diag || k0 + jj <= row_lo + h * 8) && (!seg_b || sk[jj] == sq[h]);
        s[j][e] = ok ? s[j][e] * scale : kMasked;
        mx[h] = fmaxf(mx[h], s[j][e]);
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
    for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);
        l[e / 2] += s[j][e];  // this lane's share; the quad is summed at the end
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] *= corr[e / 2];
    }
    uint32_t pa[kT / 16][4];
    acc_to_a<kT>(pa, s);  // P rounded to bf16 before P V, as the JAX kernel
    mma_ab<D, kT>(oacc, pa, vb + cur * kT * LD);
    __syncthreads();  // this stage is reloaded by the next iteration but one
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  store_rows<D>(o + ((size_t)bh * L + q0 + warp * 16) * D, oacc, inv);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) lse[(size_t)bh * L + row_lo + h * 8] = m[h] + logf(l[h]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: dQ
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ seg,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dq, int H,
                             int n_rep, int L, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld<D>();
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kT * LD;
  bf16* kb = dos + kT * LD;      // two stages
  bf16* vb = kb + 2 * kT * LD;   // two stages
  int* segk = reinterpret_cast<int*>(vb + 2 * kT * LD);  // [2][kT]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + warp * 16 + g;
  const bf16* kh = k + kv_head * L * D;
  const bf16* vh = v + kv_head * L * D;
  const int* seg_b = seg ? seg + (size_t)b * L : nullptr;
  int sq[2] = {0, 0};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * L + row_lo + h * 8;
    lse_r[h] = lse[row];
    delta_r[h] = delta[row];
    if (seg_b) sq[h] = seg_b[row_lo + h * 8];
  }

  const int n_tiles = q0 / kT + 1;
  load_rows<D>(qs, q + ((size_t)bh * L + q0) * D, kT);
  load_rows<D>(dos, dout + ((size_t)bh * L + q0) * D, kT);
  load_rows<D>(kb, kh, kT);
  load_rows<D>(vb, vh, kT);
  if (seg_b) load_ints(segk, seg_b, kT);
  cp_async_commit();

  float dqacc[D / 8][4];
  zero(dqacc);
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const int k0 = it * kT;
    if (it + 1 < n_tiles) {
      const int nxt = cur ^ 1;
      load_rows<D>(kb + nxt * kT * LD, kh + (size_t)(k0 + kT) * D, kT);
      load_rows<D>(vb + nxt * kT * LD, vh + (size_t)(k0 + kT) * D, kT);
      if (seg_b) load_ints(segk + nxt * kT, seg_b + k0 + kT, kT);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = kb + cur * kT * LD;
    const int* sk = segk + cur * kT;

    float s[kT / 8][4], dp[kT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D, kT>(s, qs + warp * 16 * LD, ks);
    mma_abt<D, kT>(dp, dos + warp * 16 * LD, vb + cur * kT * LD);
    const bool diag = it == n_tiles - 1;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int jj = j * 8 + 2 * t + (e % 2);
        const bool ok = (!diag || k0 + jj <= row_lo + h * 8) && (!seg_b || sk[jj] == sq[h]);
        const float p = expf((ok ? s[j][e] * scale : kMasked) - lse_r[h]);
        s[j][e] = p * (dp[j][e] - delta_r[h]) * scale;  // dS, rounded by acc_to_a
      }
    }
    uint32_t dsa[kT / 16][4];
    acc_to_a<kT>(dsa, s);
    mma_ab<D, kT>(dqacc, dsa, ks);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + ((size_t)bh * L + q0 + warp * 16) * D, dqacc, one);
}

// ---------------------------------------------------------------------------
// bfloat16: dK, dV (summed over the n_rep q heads of each KV head)
// ---------------------------------------------------------------------------
// Each warp owns 16 keys; S^T = K Q^T and dP^T = V dO^T come out in the
// accumulator layout with keys as rows, so P^T and dS^T feed the next
// products as A fragments straight from the registers.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const int* __restrict__ seg,
                               const bf16* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int H, int n_rep, int L, float scale) {
  constexpr int QS = D == 128 ? 32 : 64;  // queries a step (registers: see the top)
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld<D>();
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kT * LD;
  bf16* qb = vs + kT * LD;        // two stages of QS rows
  bf16* db = qb + 2 * QS * LD;    // two stages of QS rows of dO
  float* lse_s = reinterpret_cast<float*>(db + 2 * QS * LD);  // [2][QS]
  float* delta_s = lse_s + 2 * QS;                             // [2][QS]
  int* segq = reinterpret_cast<int*>(delta_s + 2 * QS);       // [2][QS]

  const int Hkv = H / n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int k0 = blockIdx.x * kT;  // the longest columns first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g;  // this lane's keys: key_lo, key_lo + 8
  const int* seg_b = seg ? seg + (size_t)b * L : nullptr;
  int skey[2] = {0, 0};
  if (seg_b) {
    skey[0] = seg_b[key_lo];
    skey[1] = seg_b[key_lo + 8];
  }

  const int n_q = (L - k0) / QS;  // q steps at or after this key tile
  const int n_steps = n_rep * n_q;
  auto stage = [&](int step, int buf) {
    const int r = step / n_q;
    const int qq = k0 + (step % n_q) * QS;
    const size_t bh = (size_t)b * H + (size_t)hk * n_rep + r;
    load_rows<D>(qb + buf * QS * LD, q + (bh * L + qq) * D, QS);
    load_rows<D>(db + buf * QS * LD, dout + (bh * L + qq) * D, QS);
    load_ints(reinterpret_cast<int*>(lse_s + buf * QS),
              reinterpret_cast<const int*>(lse + bh * L + qq), QS);
    load_ints(reinterpret_cast<int*>(delta_s + buf * QS),
              reinterpret_cast<const int*>(delta + bh * L + qq), QS);
    if (seg_b) load_ints(segq + buf * QS, seg_b + qq, QS);
  };
  load_rows<D>(ks, k + ((size_t)bkv * L + k0) * D, kT);
  load_rows<D>(vs, v + ((size_t)bkv * L + k0) * D, kT);
  stage(0, 0);
  cp_async_commit();

  float dkacc[D / 8][4], dvacc[D / 8][4];
  zero(dkacc);
  zero(dvacc);
  for (int step = 0; step < n_steps; ++step) {
    const int cur = step & 1;
    const int qq = k0 + (step % n_q) * QS;
    if (step + 1 < n_steps) stage(step + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qb + cur * QS * LD;
    const bf16* dt = db + cur * QS * LD;
    const float* ls = lse_s + cur * QS;
    const float* dl = delta_s + cur * QS;
    const int* sg = segq + cur * QS;

    float st[QS / 8][4], dpt[QS / 8][4];
    zero(st);
    zero(dpt);
    mma_abt<D, QS>(st, ks + warp * 16 * LD, qt);
    mma_abt<D, QS>(dpt, vs + warp * 16 * LD, dt);
    const bool diag = qq < k0 + kT;  // some query of this step precedes some key
#pragma unroll
    for (int j = 0; j < QS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int ii = j * 8 + 2 * t + (e % 2);
        const bool ok = (!diag || key_lo + h * 8 <= qq + ii) && (!seg_b || sg[ii] == skey[h]);
        const float p = expf((ok ? st[j][e] * scale : kMasked) - ls[ii]);
        st[j][e] = p;                                      // P^T, rounded by acc_to_a
        dpt[j][e] = p * (dpt[j][e] - dl[ii]) * scale;      // dS^T
      }
    }
    uint32_t a[QS / 16][4];
    acc_to_a<QS>(a, st);
    mma_ab<D, QS>(dvacc, a, dt);
    acc_to_a<QS>(a, dpt);
    mma_ab<D, QS>(dkacc, a, qt);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + ((size_t)bkv * L + k0 + warp * 16) * D, dkacc, one);
  store_rows<D>(dv + ((size_t)bkv * L + k0 + warp * 16) * D, dvacc, one);
}

template <int D>
constexpr int fwd_smem() { return 5 * tile_bytes<D>(kT) + 2 * kT * 4; }
template <int D>
constexpr int dq_smem() { return 6 * tile_bytes<D>(kT) + 2 * kT * 4; }
template <int D>
constexpr int dkdv_smem() {
  constexpr int QS = D == 128 ? 32 : 64;
  return 2 * tile_bytes<D>(kT) + 4 * tile_bytes<D>(QS) + 3 * 2 * QS * 4;
}

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
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, const int* seg, void* o,
                void* lse, int B, int H, int Hkv, int L, float scale, cudaStream_t s) {
  if (dtype == 1) {
    auto kernel = flash_fwd_bf16_kernel<D>;
    const cudaError_t err = allow_smem(kernel, fwd_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<dim3(L / kT, B * H), kThreads, fwd_smem<D>(), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        seg, static_cast<bf16*>(o), static_cast<float*>(lse), H, H / Hkv, L, scale);
  } else {
    flash_fwd_f32_kernel<D><<<dim3(L / F32<D>::RB, B * H), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<float*>(o), static_cast<float*>(lse), H,
        H / Hkv, L, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const int* seg,
                   const void* dout, const float* lse, const float* delta, void* dq, int B,
                   int H, int Hkv, int L, float scale, cudaStream_t s) {
  if (dtype == 1) {
    auto kernel = flash_bwd_dq_bf16_kernel<D>;
    const cudaError_t err = allow_smem(kernel, dq_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<dim3(L / kT, B * H), kThreads, dq_smem<D>(), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        seg, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, H / Hkv, L,
        scale);
  } else {
    flash_bwd_dq_f32_kernel<D><<<dim3(L / F32<D>::RB, B * H), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), H, H / Hkv, L, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const int* seg,
                     const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                     int B, int H, int Hkv, int L, float scale, cudaStream_t s) {
  if (dtype == 1) {
    auto kernel = flash_bwd_dkdv_bf16_kernel<D>;
    const cudaError_t err = allow_smem(kernel, dkdv_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<dim3(L / kT, B * Hkv), kThreads, dkdv_smem<D>(), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        seg, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, H / Hkv, L, scale);
  } else {
    flash_bwd_dkdv_f32_kernel<D><<<dim3(L / F32<D>::RB, B * Hkv), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), seg, static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), H, H / Hkv, L, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_delta(int dtype, const void* o, const void* dout, float* delta, long rows,
                      cudaStream_t s) {
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
