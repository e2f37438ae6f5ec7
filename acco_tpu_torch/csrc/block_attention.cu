// One ring hop's attention block for Hopper: forward and backward (K4).
//
// Replaces the JAX package's ring block kernel,
// acco_tpu/ops/block_attention.py `_blk_fwd` (pallas_call :200) and `_blk_bwd`
// (pallas_call :250), which the ring attention of context parallelism calls
// once per (q chunk, kv chunk) block. Contract, for q [B, H, Lq, D] and k/v
// [B, Hkv, Lk, D] (GQA through h / n_rep; K and V are never repeated):
//
//   s = scale * Q K^T, masked entries set to -1e9
//   m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) V   (f32, o unnormalised)
//
// with one of three masks (`mode`): 0 none (a past chunk), 1 diag (j <= i, the
// self hop, Lq == Lk), 2 positional (kv_pos[j] <= q_pos[i] and, when window
// != 0, kv_pos[j] > q_pos[i] - window). A positional row may be fully masked:
// it then has m = -1e9, p = 1 on every key, l = Lk and o = sum of V, as in
// JAX, so the positional mask is evaluated per element and no tile is
// skipped; the diag mask skips the tiles above the diagonal, whose p is 0.
//
// The backward takes the cotangents (dO, dm, dl) of all three outputs:
//   dp = dO V^T + dl,  eq = (s == m),  c = (dm - sum_j p dp) / max(#eq, 1),
// (dO rounded to the activation dtype, as the JAX kernel's dp),
//   dS = p dp + eq c  (zero where masked, rounded to the activation dtype),
//   dQ = dS K scale,  dK = dS^T Q scale,  dV = P^T dO
// which is the JAX VJP's ds = p dp - w sum(p dp) + dm w with w = eq / #eq,
// the cotangent on m split evenly over tied maxima. #eq (`cnt`) is counted
// by the forward against its running max (the count restarts when the max
// rises); sum_j p dp comes from a pre-pass as rowsum(dO * o) + dl * l (o =
// sum_j p V). The backward kernels recompute s with the forward's products
// (the same tiles, the same k order, scale applied after), so `s == m` finds
// the forward's maxima bit for bit.
//
// What bounds it on the H100 (data sheet: 989 TFLOP/s bf16, 3.35 TB/s): the
// ring's block at Llama-3-8B's shape on the card path (B 1, H 32, Hkv 8,
// Lq = Lk 4096, D 128) is 5.4e8 pairs (full) or 2.7e8 (diag); the forward's
// 4 D operations a pair take 0.28 ms (full) against 0.04 ms of bytes:
// compute-bound, like K5. The design is K5's: blocks walk KV (or Q) tiles
// with the running max, sum, count and output (or gradient) rows in
// registers, through mma.sync from ldmatrix (tiles.cuh), and load the
// next tile with cp.async under the current one's products. Nothing [Lq, Lk]
// reaches device memory.
//
// Two implementations, chosen by dtype:
// * bfloat16: tensor cores (tiles.cuh), four warps of 16 rows. P is
//   rounded to bf16 against the running max before P V (as K5); dV is
//   bf16(P)^T bf16(dO) with float32 accumulation (JAX: float32 p and dO).
// * float32: FMAs on the CUDA cores, D / 32 threads per row, as K5's.
//
// Four launchers, each with a plain C interface returning cudaGetLastError();
// dtype code 0 = float32, 1 = bfloat16:
//   acco_blk_fwd       one block per (64-row q tile, b*h)
//   acco_blk_bwd_rowc  one warp per (b, h, row): c
//   acco_blk_bwd_dkdv  one block per (64-key tile, b*hkv), looping over the
//                      n_rep q heads and the q tiles (at or after it: diag)
//   acco_blk_bwd_dq    one block per (64-row q tile, b*h)

#include "tiles.cuh"

namespace {
namespace k4 {

using namespace tiles;

constexpr int kFull = 0, kDiag = 1, kPos = 2;

// May query i attend key j? (local indices i, j; absolute positions qp, kp)
__device__ __forceinline__ bool blk_allowed(int mode, int i, int j, int qp, int kp, int window) {
  if (mode == kFull) return true;
  if (mode == kDiag) return j <= i;
  return kp <= qp && (window == 0 || kp > qp - window);
}

// dS of one (query, key) pair, before its rounding to the activation dtype.
__device__ __forceinline__ float blk_ds(bool ok, float p, float dp_dot, float dl, bool eq,
                                        float c) {
  return ok ? p * (dp_dot + dl) + (eq ? c : 0.f) : 0.f;
}

// ---------------------------------------------------------------------------
// bfloat16: forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    blk_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ qpos,
                        const int* __restrict__ kpos, float* __restrict__ o,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ cnt_out, int H, int n_rep, int Lq, int Lk, int mode,
                        int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld<D>();
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kb = qs + kT * LD;       // two stages
  bf16* vb = kb + 2 * kT * LD;   // two stages
  int* kps = reinterpret_cast<int*>(vb + 2 * kT * LD);  // [2][kT]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const bool diag = mode == kDiag;
  const bool pos = mode == kPos;
  const int q0 = (diag ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kT;  // diag: longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + warp * 16 + g;  // this lane's rows: row_lo, row_lo + 8
  const bf16* kh = k + kv_head * Lk * D;
  const bf16* vh = v + kv_head * Lk * D;
  int qp[2] = {0, 0};
  if (pos) {
    qp[0] = qpos[row_lo];
    qp[1] = qpos[row_lo + 8];
  }

  const int n_tiles = diag ? q0 / kT + 1 : Lk / kT;
  load_rows<D>(qs, q + ((size_t)bh * Lq + q0) * D, kT);
  load_rows<D>(kb, kh, kT);
  load_rows<D>(vb, vh, kT);
  if (pos) load_ints(kps, kpos, kT);
  cp_async_commit();

  float oacc[D / 8][4];
  zero(oacc);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float cnt[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const int k0 = it * kT;
    if (it + 1 < n_tiles) {  // the next tile's loads run under this tile's products
      const int nxt = cur ^ 1;
      load_rows<D>(kb + nxt * kT * LD, kh + (size_t)(k0 + kT) * D, kT);
      load_rows<D>(vb + nxt * kT * LD, vh + (size_t)(k0 + kT) * D, kT);
      if (pos) load_ints(kps + nxt * kT, kpos + k0 + kT, kT);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int* kp = kps + cur * kT;

    float s[kT / 8][4];
    zero(s);
    mma_abt<D, kT>(s, qs + warp * 16 * LD, kb + cur * kT * LD);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int jj = j * 8 + 2 * t + (e % 2);
        const bool ok = blk_allowed(mode, row_lo + h * 8, k0 + jj, qp[h], pos ? kp[jj] : 0,
                                    window);
        s[j][e] = ok ? s[j][e] * scale : kMasked;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    }
    float corr[2], tie[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);  // 0 on the first tile (m = -inf)
      if (m_new != m[h]) cnt[h] = 0.f;  // the running max rose: its ties are gone
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tie[e / 2] += s[j][e] == m[e / 2] ? 1.f : 0.f;
        s[j][e] = expf(s[j][e] - m[e / 2]);
        l[e / 2] += s[j][e];  // this lane's share; the quad is summed at the end
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tie[h] += __shfl_xor_sync(0xffffffffu, tie[h], 1);
      tie[h] += __shfl_xor_sync(0xffffffffu, tie[h], 2);
      cnt[h] += tie[h];
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const size_t row = (size_t)bh * Lq + row_lo + h * 8;
    float* orow = o + row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(orow + j * 8 + 2 * t) =
          make_float2(oacc[j][2 * h], oacc[j][2 * h + 1]);
    }
    if (t == 0) {
      m_out[row] = m[h];
      l_out[row] = l[h];
      cnt_out[row] = cnt[h];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: dQ
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    blk_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ qpos,
                           const int* __restrict__ kpos, const bf16* __restrict__ dout,
                           const float* __restrict__ m, const float* __restrict__ dl,
                           const float* __restrict__ c, bf16* __restrict__ dq, int H, int n_rep,
                           int Lq, int Lk, int mode, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld<D>();
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kT * LD;
  bf16* kb = dos + kT * LD;      // two stages
  bf16* vb = kb + 2 * kT * LD;   // two stages
  int* kps = reinterpret_cast<int*>(vb + 2 * kT * LD);  // [2][kT]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const bool diag = mode == kDiag;
  const bool pos = mode == kPos;
  const int q0 = (diag ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + warp * 16 + g;
  const bf16* kh = k + kv_head * Lk * D;
  const bf16* vh = v + kv_head * Lk * D;
  int qp[2] = {0, 0};
  float m_r[2], dl_r[2], c_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * Lq + row_lo + h * 8;
    m_r[h] = m[row];
    dl_r[h] = dl[row];
    c_r[h] = c[row];
    if (pos) qp[h] = qpos[row_lo + h * 8];
  }

  const int n_tiles = diag ? q0 / kT + 1 : Lk / kT;
  load_rows<D>(qs, q + ((size_t)bh * Lq + q0) * D, kT);
  load_rows<D>(dos, dout + ((size_t)bh * Lq + q0) * D, kT);
  load_rows<D>(kb, kh, kT);
  load_rows<D>(vb, vh, kT);
  if (pos) load_ints(kps, kpos, kT);
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
      if (pos) load_ints(kps + nxt * kT, kpos + k0 + kT, kT);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = kb + cur * kT * LD;
    const int* kp = kps + cur * kT;

    float s[kT / 8][4], dp[kT / 8][4];
    zero(s);
    zero(dp);
    mma_abt<D, kT>(s, qs + warp * 16 * LD, ks);
    mma_abt<D, kT>(dp, dos + warp * 16 * LD, vb + cur * kT * LD);
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int jj = j * 8 + 2 * t + (e % 2);
        const bool ok = blk_allowed(mode, row_lo + h * 8, k0 + jj, qp[h], pos ? kp[jj] : 0,
                                    window);
        const float sv = ok ? s[j][e] * scale : kMasked;
        const float p = expf(sv - m_r[h]);
        s[j][e] = blk_ds(ok, p, dp[j][e], dl_r[h], sv == m_r[h], c_r[h]);  // rounded by acc_to_a
      }
    }
    uint32_t dsa[kT / 16][4];
    acc_to_a<kT>(dsa, s);
    mma_ab<D, kT>(dqacc, dsa, ks);
    __syncthreads();
  }
  const float mul[2] = {scale, scale};  // scale after the product, as the JAX kernel
  store_rows<D>(dq + ((size_t)bh * Lq + q0 + warp * 16) * D, dqacc, mul);
}

// ---------------------------------------------------------------------------
// bfloat16: dK, dV (summed over the n_rep q heads of each KV head)
// ---------------------------------------------------------------------------
// Each warp owns 16 keys; S^T = K Q^T and dP^T = V dO^T come out with keys
// as rows, so P^T and dS^T feed the next products as A fragments straight
// from the registers. Each element of S^T is the same sum of the same
// bf16 products, in the same k order, as the forward's S.
template <int D>
__global__ void __launch_bounds__(kThreads)
    blk_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ qpos,
                             const int* __restrict__ kpos, const bf16* __restrict__ dout,
                             const float* __restrict__ m, const float* __restrict__ dl,
                             const float* __restrict__ c, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int H, int n_rep, int Lq, int Lk, int mode,
                             int window, float scale) {
  constexpr int QS = D == 128 ? 32 : 64;  // queries a step (registers, as K5)
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = ld<D>();
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kT * LD;
  bf16* qb = vs + kT * LD;        // two stages of QS rows
  bf16* db = qb + 2 * QS * LD;    // two stages of QS rows of dO
  float* m_s = reinterpret_cast<float*>(db + 2 * QS * LD);  // [2][QS]
  float* dl_s = m_s + 2 * QS;                               // [2][QS]
  float* c_s = dl_s + 2 * QS;                               // [2][QS]
  int* qp_s = reinterpret_cast<int*>(c_s + 2 * QS);         // [2][QS]

  const int Hkv = H / n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int k0 = blockIdx.x * kT;
  const bool diag = mode == kDiag;
  const bool pos = mode == kPos;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g;  // this lane's keys: key_lo, key_lo + 8
  int kp[2] = {0, 0};
  if (pos) {
    kp[0] = kpos[key_lo];
    kp[1] = kpos[key_lo + 8];
  }

  const int q_begin = diag ? k0 : 0;  // diag: no query before the key tile sees it
  const int n_q = (Lq - q_begin) / QS;
  const int n_steps = n_rep * n_q;
  auto stage = [&](int step, int buf) {
    const int r = step / n_q;
    const int qq = q_begin + (step % n_q) * QS;
    const size_t bh = (size_t)b * H + (size_t)hk * n_rep + r;
    load_rows<D>(qb + buf * QS * LD, q + (bh * Lq + qq) * D, QS);
    load_rows<D>(db + buf * QS * LD, dout + (bh * Lq + qq) * D, QS);
    load_ints(reinterpret_cast<int*>(m_s + buf * QS), reinterpret_cast<const int*>(m + bh * Lq + qq),
              QS);
    load_ints(reinterpret_cast<int*>(dl_s + buf * QS),
              reinterpret_cast<const int*>(dl + bh * Lq + qq), QS);
    load_ints(reinterpret_cast<int*>(c_s + buf * QS), reinterpret_cast<const int*>(c + bh * Lq + qq),
              QS);
    if (pos) load_ints(qp_s + buf * QS, qpos + qq, QS);
  };
  load_rows<D>(ks, k + ((size_t)bkv * Lk + k0) * D, kT);
  load_rows<D>(vs, v + ((size_t)bkv * Lk + k0) * D, kT);
  stage(0, 0);
  cp_async_commit();

  float dkacc[D / 8][4], dvacc[D / 8][4];
  zero(dkacc);
  zero(dvacc);
  for (int step = 0; step < n_steps; ++step) {
    const int cur = step & 1;
    const int qq = q_begin + (step % n_q) * QS;
    if (step + 1 < n_steps) stage(step + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qb + cur * QS * LD;
    const bf16* dt = db + cur * QS * LD;
    const float* ms = m_s + cur * QS;
    const float* dls = dl_s + cur * QS;
    const float* cs = c_s + cur * QS;
    const int* qps = qp_s + cur * QS;

    float st[QS / 8][4], dpt[QS / 8][4];
    zero(st);
    zero(dpt);
    mma_abt<D, QS>(st, ks + warp * 16 * LD, qt);
    mma_abt<D, QS>(dpt, vs + warp * 16 * LD, dt);
#pragma unroll
    for (int j = 0; j < QS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int ii = j * 8 + 2 * t + (e % 2);
        const bool ok = blk_allowed(mode, qq + ii, key_lo + h * 8, pos ? qps[ii] : 0, kp[h],
                                    window);
        const float sv = ok ? st[j][e] * scale : kMasked;
        const float p = expf(sv - ms[ii]);
        st[j][e] = p;  // P^T, rounded by acc_to_a
        dpt[j][e] = blk_ds(ok, p, dpt[j][e], dls[ii], sv == ms[ii], cs[ii]);  // dS^T
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
  const float mul[2] = {scale, scale};
  store_rows<D>(dk + ((size_t)bkv * Lk + k0 + warp * 16) * D, dkacc, mul);
  store_rows<D>(dv + ((size_t)bkv * Lk + k0 + warp * 16) * D, dvacc, one);
}

template <int D>
constexpr int fwd_smem() { return 5 * tile_bytes<D>(kT) + 2 * kT * 4; }
template <int D>
constexpr int dq_smem() { return 6 * tile_bytes<D>(kT) + 2 * kT * 4; }
template <int D>
constexpr int dkdv_smem() {
  constexpr int QS = D == 128 ? 32 : 64;
  return 2 * tile_bytes<D>(kT) + 4 * tile_bytes<D>(QS) + 4 * 2 * QS * 4;
}

// ---------------------------------------------------------------------------
// backward pre-pass: c = (dm - rowsum(dO * o) - dl * l) / max(cnt, 1), one
// warp a row; o float32, dO in the activation dtype (the dO of dp = dO V^T)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void blk_bwd_rowc_kernel(const float* __restrict__ o, const T* __restrict__ dout,
                                    const float* __restrict__ dm, const float* __restrict__ dl,
                                    const float* __restrict__ l, const float* __restrict__ cnt,
                                    float* __restrict__ c, long rows) {
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(o[row * D + d], to_f(dout[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const float common = acc + dl[row] * l[row];
    c[row] = (dm[row] - common) / fmaxf(cnt[row], 1.f);
  }
}

// ---------------------------------------------------------------------------
// float32, CUDA cores (F32, load_parts, dot_parts: tiles.cuh). dot(q, k) and
// dot(k, q) take the same steps, so the forward's and the backward's s agree.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    blk_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, float* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ cnt_out, int H, int n_rep, int Lq, int Lk, int mode,
                       int window, float scale) {
  using C = F32<D>;
  __shared__ __align__(16) float ks[C::KB][D / 32][36];
  __shared__ __align__(16) float vs[C::KB][D / 32][36];
  __shared__ int kps[C::KB];
  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const bool diag = mode == kDiag;
  const bool pos = mode == kPos;
  const int q0 = blockIdx.x * C::RB;
  const int part = threadIdx.x % C::TPR;
  const int i = q0 + threadIdx.x / C::TPR;
  const size_t row = (size_t)bh * Lq + i;
  const int qp = pos ? qpos[i] : 0;

  float qr[32], acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    qr[d] = q[row * D + part * 32 + d];
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f, cnt = 0.f;
  const int k_end = diag ? q0 + C::RB : Lk;
  for (int k0 = 0; k0 < k_end; k0 += C::KB) {
    __syncthreads();
    load_parts<D>(ks, k + (kv_head * Lk + k0) * D, C::KB);
    load_parts<D>(vs, v + (kv_head * Lk + k0) * D, C::KB);
    if (pos && threadIdx.x < C::KB) kps[threadIdx.x] = kpos[k0 + threadIdx.x];
    __syncthreads();
    float s[C::KB];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < C::KB; ++j) {
      const float dot = dot_parts<D>(qr, ks[j][part]);
      const bool ok = blk_allowed(mode, i, k0 + j, qp, pos ? kps[j] : 0, window);
      s[j] = ok ? dot * scale : kMasked;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    if (m_new != m) cnt = 0.f;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < C::KB; ++j) {
      cnt += s[j] == m_new ? 1.f : 0.f;
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
#pragma unroll
  for (int d = 0; d < 32; ++d) o[row * D + part * 32 + d] = acc[d];
  if (part == 0) {
    m_out[row] = m;
    l_out[row] = l;
    cnt_out[row] = cnt;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    blk_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ qpos,
                          const int* __restrict__ kpos, const float* __restrict__ dout,
                          const float* __restrict__ m, const float* __restrict__ dl,
                          const float* __restrict__ c, float* __restrict__ dq, int H, int n_rep,
                          int Lq, int Lk, int mode, int window, float scale) {
  using C = F32<D>;
  __shared__ __align__(16) float ks[C::KB][D / 32][36];
  __shared__ __align__(16) float vs[C::KB][D / 32][36];
  __shared__ int kps[C::KB];
  const int bh = blockIdx.y;
  const int b = bh / H;
  const size_t kv_head = (size_t)b * (H / n_rep) + (bh % H) / n_rep;
  const bool diag = mode == kDiag;
  const bool pos = mode == kPos;
  const int q0 = blockIdx.x * C::RB;
  const int part = threadIdx.x % C::TPR;
  const int i = q0 + threadIdx.x / C::TPR;
  const size_t row = (size_t)bh * Lq + i;
  const int qp = pos ? qpos[i] : 0;

  float qr[32], dor[32], acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) {
    qr[d] = q[row * D + part * 32 + d];
    dor[d] = dout[row * D + part * 32 + d];
    acc[d] = 0.f;
  }
  const float m_i = m[row], dl_i = dl[row], c_i = c[row];
  const int k_end = diag ? q0 + C::RB : Lk;
  for (int k0 = 0; k0 < k_end; k0 += C::KB) {
    __syncthreads();
    load_parts<D>(ks, k + (kv_head * Lk + k0) * D, C::KB);
    load_parts<D>(vs, v + (kv_head * Lk + k0) * D, C::KB);
    if (pos && threadIdx.x < C::KB) kps[threadIdx.x] = kpos[k0 + threadIdx.x];
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < C::KB; ++j) {
      const float dot = dot_parts<D>(qr, ks[j][part]);
      const float dp = dot_parts<D>(dor, vs[j][part]);
      const bool ok = blk_allowed(mode, i, k0 + j, qp, pos ? kps[j] : 0, window);
      const float sv = ok ? dot * scale : kMasked;
      const float ds = blk_ds(ok, expf(sv - m_i), dp, dl_i, sv == m_i, c_i);
#pragma unroll
      for (int d = 0; d < 32; ++d) acc[d] = fmaf(ds, ks[j][part][d], acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < 32; ++d) dq[row * D + part * 32 + d] = acc[d] * scale;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    blk_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ qpos,
                            const int* __restrict__ kpos, const float* __restrict__ dout,
                            const float* __restrict__ m, const float* __restrict__ dl,
                            const float* __restrict__ c, float* __restrict__ dk,
                            float* __restrict__ dv, int H, int n_rep, int Lq, int Lk, int mode,
                            int window, float scale) {
  using C = F32<D>;
  constexpr int QT = 16;  // query rows a shared tile
  __shared__ __align__(16) float qs[QT][D / 32][36];
  __shared__ __align__(16) float dos[QT][D / 32][36];
  __shared__ float m_s[QT], dl_s[QT], c_s[QT];
  __shared__ int qp_s[QT];
  const int Hkv = H / n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const bool diag = mode == kDiag;
  const bool pos = mode == kPos;
  const int k0 = blockIdx.x * C::RB;
  const int part = threadIdx.x % C::TPR;
  const int j = k0 + threadIdx.x / C::TPR;
  const size_t row = (size_t)bkv * Lk + j;
  const int kp = pos ? kpos[j] : 0;

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
    for (int q0 = diag ? (k0 / QT) * QT : 0; q0 < Lq; q0 += QT) {
      __syncthreads();
      load_parts<D>(qs, q + (bh * Lq + q0) * D, QT);
      load_parts<D>(dos, dout + (bh * Lq + q0) * D, QT);
      if (threadIdx.x < QT) {
        m_s[threadIdx.x] = m[bh * Lq + q0 + threadIdx.x];
        dl_s[threadIdx.x] = dl[bh * Lq + q0 + threadIdx.x];
        c_s[threadIdx.x] = c[bh * Lq + q0 + threadIdx.x];
        qp_s[threadIdx.x] = pos ? qpos[q0 + threadIdx.x] : 0;
      }
      __syncthreads();
#pragma unroll 1
      for (int ii = 0; ii < QT; ++ii) {
        const float dot = dot_parts<D>(kr, qs[ii][part]);
        const float dp = dot_parts<D>(vr, dos[ii][part]);
        const bool ok = blk_allowed(mode, q0 + ii, j, qp_s[ii], kp, window);
        const float sv = ok ? dot * scale : kMasked;
        const float p = expf(sv - m_s[ii]);
        const float ds = blk_ds(ok, p, dp, dl_s[ii], sv == m_s[ii], c_s[ii]);
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
    dk[row * D + part * 32 + d] = dk_acc[d] * scale;
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

struct Shape {
  int B, H, Hkv, Lq, Lk, mode, window;
  float scale;
};

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, float* o, float* m, float* l, float* cnt, Shape sh,
                cudaStream_t s) {
  const int n_rep = sh.H / sh.Hkv;
  if (dtype == 1) {
    auto kernel = blk_fwd_bf16_kernel<D>;
    const cudaError_t err = allow_smem(kernel, fwd_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<dim3(sh.Lq / kT, sh.B * sh.H), kThreads, fwd_smem<D>(), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        qpos, kpos, o, m, l, cnt, sh.H, n_rep, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  } else {
    blk_fwd_f32_kernel<D><<<dim3(sh.Lq / F32<D>::RB, sh.B * sh.H), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        qpos, kpos, o, m, l, cnt, sh.H, n_rep, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, const void* dout, const float* m, const float* dl,
                   const float* c, void* dq, Shape sh, cudaStream_t s) {
  const int n_rep = sh.H / sh.Hkv;
  if (dtype == 1) {
    auto kernel = blk_bwd_dq_bf16_kernel<D>;
    const cudaError_t err = allow_smem(kernel, dq_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<dim3(sh.Lq / kT, sh.B * sh.H), kThreads, dq_smem<D>(), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        qpos, kpos, static_cast<const bf16*>(dout), m, dl, c, static_cast<bf16*>(dq), sh.H,
        n_rep, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  } else {
    blk_bwd_dq_f32_kernel<D><<<dim3(sh.Lq / F32<D>::RB, sh.B * sh.H), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        qpos, kpos, static_cast<const float*>(dout), m, dl, c, static_cast<float*>(dq), sh.H,
        n_rep, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const int* qpos,
                     const int* kpos, const void* dout, const float* m, const float* dl,
                     const float* c, void* dk, void* dv, Shape sh, cudaStream_t s) {
  const int n_rep = sh.H / sh.Hkv;
  if (dtype == 1) {
    auto kernel = blk_bwd_dkdv_bf16_kernel<D>;
    const cudaError_t err = allow_smem(kernel, dkdv_smem<D>());
    if (err != cudaSuccess) return err;
    kernel<<<dim3(sh.Lk / kT, sh.B * sh.Hkv), kThreads, dkdv_smem<D>(), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        qpos, kpos, static_cast<const bf16*>(dout), m, dl, c, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), sh.H, n_rep, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  } else {
    blk_bwd_dkdv_f32_kernel<D><<<dim3(sh.Lk / F32<D>::RB, sh.B * sh.Hkv), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        qpos, kpos, static_cast<const float*>(dout), m, dl, c, static_cast<float*>(dk),
        static_cast<float*>(dv), sh.H, n_rep, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  }
  return cudaGetLastError();
}

bool shape_ok(int dtype, int B, int H, int Hkv, int Lq, int Lk, int D, int mode) {
  return (dtype == 0 || dtype == 1) && (D == 64 || D == 128) && B > 0 && Hkv > 0 &&
         H % Hkv == 0 && Lq >= kT && Lq % kT == 0 && Lk >= kT && Lk % kT == 0 && mode >= kFull &&
         mode <= kPos && (mode != kDiag || Lq == Lk);
}

}  // namespace k4
}  // namespace

extern "C" {

int acco_blk_fwd(int dtype, const void* q, const void* k, const void* v, const void* qpos,
                 const void* kpos, void* o, void* m, void* l, void* cnt, int B, int H, int Hkv,
                 int Lq, int Lk, int D, int mode, int window, float scale, void* stream) {
  if (!k4::shape_ok(dtype, B, H, Hkv, Lq, Lk, D, mode)) return (int)cudaErrorInvalidValue;
  if (mode == k4::kPos && (qpos == nullptr || kpos == nullptr)) return (int)cudaErrorInvalidValue;
  const k4::Shape sh{B, H, Hkv, Lq, Lk, mode, window, scale};
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float *o_ = static_cast<float*>(o), *m_ = static_cast<float*>(m), *l_ = static_cast<float*>(l),
        *c_ = static_cast<float*>(cnt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? k4::fwd<64>(dtype, q, k, v, qp, kp, o_, m_, l_, c_, sh, s)
                       : k4::fwd<128>(dtype, q, k, v, qp, kp, o_, m_, l_, c_, sh, s));
}

int acco_blk_bwd_rowc(int dtype, const void* o, const void* dout, const void* dm,
                      const void* dl, const void* l, const void* cnt, void* c, long rows, int D,
                      void* stream) {
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128) || rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((rows + k4::kThreads / 32 - 1) / (k4::kThreads / 32)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *o_ = static_cast<const float*>(o), *dm_ = static_cast<const float*>(dm),
              *dl_ = static_cast<const float*>(dl), *l_ = static_cast<const float*>(l),
              *cnt_ = static_cast<const float*>(cnt);
  float* c_ = static_cast<float*>(c);
  if (dtype == 1) {
    auto kernel = D == 64 ? &k4::blk_bwd_rowc_kernel<bf16, 64> : &k4::blk_bwd_rowc_kernel<bf16, 128>;
    kernel<<<grid, k4::kThreads, 0, s>>>(o_, static_cast<const bf16*>(dout), dm_, dl_, l_, cnt_,
                                         c_, rows);
  } else {
    auto kernel =
        D == 64 ? &k4::blk_bwd_rowc_kernel<float, 64> : &k4::blk_bwd_rowc_kernel<float, 128>;
    kernel<<<grid, k4::kThreads, 0, s>>>(o_, static_cast<const float*>(dout), dm_, dl_, l_, cnt_,
                                         c_, rows);
  }
  return (int)cudaGetLastError();
}

int acco_blk_bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const void* qpos,
                      const void* kpos, const void* dout, const void* m, const void* dl,
                      const void* c, void* dk, void* dv, int B, int H, int Hkv, int Lq, int Lk,
                      int D, int mode, int window, float scale, void* stream) {
  if (!k4::shape_ok(dtype, B, H, Hkv, Lq, Lk, D, mode)) return (int)cudaErrorInvalidValue;
  if (mode == k4::kPos && (qpos == nullptr || kpos == nullptr)) return (int)cudaErrorInvalidValue;
  const k4::Shape sh{B, H, Hkv, Lq, Lk, mode, window, scale};
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  const float *m_ = static_cast<const float*>(m), *dl_ = static_cast<const float*>(dl),
              *c_ = static_cast<const float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64
                   ? k4::bwd_dkdv<64>(dtype, q, k, v, qp, kp, dout, m_, dl_, c_, dk, dv, sh, s)
                   : k4::bwd_dkdv<128>(dtype, q, k, v, qp, kp, dout, m_, dl_, c_, dk, dv, sh, s));
}

int acco_blk_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* qpos,
                    const void* kpos, const void* dout, const void* m, const void* dl,
                    const void* c, void* dq, int B, int H, int Hkv, int Lq, int Lk, int D,
                    int mode, int window, float scale, void* stream) {
  if (!k4::shape_ok(dtype, B, H, Hkv, Lq, Lk, D, mode)) return (int)cudaErrorInvalidValue;
  if (mode == k4::kPos && (qpos == nullptr || kpos == nullptr)) return (int)cudaErrorInvalidValue;
  const k4::Shape sh{B, H, Hkv, Lq, Lk, mode, window, scale};
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  const float *m_ = static_cast<const float*>(m), *dl_ = static_cast<const float*>(dl),
              *c_ = static_cast<const float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 64 ? k4::bwd_dq<64>(dtype, q, k, v, qp, kp, dout, m_, dl_, c_, dq, sh, s)
                       : k4::bwd_dq<128>(dtype, q, k, v, qp, kp, dout, m_, dl_, c_, dq, sh, s));
}

}  // extern "C"
