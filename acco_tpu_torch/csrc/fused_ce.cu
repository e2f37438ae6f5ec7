// Fused lm-head + cross-entropy for Hopper: forward and backward (K3).
//
// Replaces the Pallas TPU kernels of acco_tpu/ops/fused_ce.py: `_fwd_kernel`
// (the `_lm_head_ce_fwd` call) and the three calls of `_lm_head_ce_bwd`
// (`_bwd_kernel`, the fused form; `_bwd_dh_kernel` and `_bwd_dw_kernel`,
// the split form). Contract, for hidden rows h [N, D], the head as the
// row-major [V, D] matrix w (the tied embedding table as it is stored),
// int32 targets [N] and a runtime v_real <= V:
//
//   logits = h w^T, float32 sums of activation-dtype products, with the
//            columns >= v_real set to -1e30 (the JAX constant);
//   forward  per row: lse, the true logit (the column equal to the target;
//            a target outside [0, V) never matches) and the sum of the
//            real logits (for label smoothing), all float32;
//   backward dp = d_lse * exp(logit - lse) + d_tl * onehot + d_sl * valid,
//            rounded to the activation dtype as `_dp_tile` does, then
//            dH = dp w and dW = dp^T h, summed in float32 and written once
//            in the activation dtype.
//
// No [N, V] tensor is ever written to device memory. What bounds it on the
// H100, at the Llama-125M head (N 8192, D 768, V 50257, bf16; the data
// sheet's 989 TFLOP/s and 3.35 TB/s, not measured): the forward's 2 N D V =
// 632 GFLOP take 0.64 ms and its bytes (h, w, three [N] rows) 0.01 ms, so
// it is bound by operations; the backward's dH, dW and one logits
// recompute, 6 N D V, take 1.92 ms, also bound by operations.
//
// The TPU kernels keep an [RB, D] f32 dH or a [D, VT] f32 dW accumulator in
// 128 MB of VMEM. A Hopper block has 227 KB of shared memory and its
// registers hold about as much; a 64-row accumulator over D 768 is 192 KB
// of f32, and over D 4096 1 MB. So each backward block owns a 64-row tile
// and a DC-column chunk of D (the widest of 384, 256, 128 that divides D),
// keeps that [64, DC] accumulator in the registers of eight warps, and
// recomputes the logits tile over the whole D for each chunk: D / DC
// recomputes (2 at D 768) buy a single kernel for every D of the envelope,
// with no partial buffers and no atomics, so dH and dW are deterministic.
// The forward splits the vocab
// across blocks for occupancy (64 rows give 128 row tiles at N 8192, on 132
// SMs) and a second small kernel merges each row's per-split (max, sumexp,
// true logit, sum) in a fixed order.
//
// Two implementations, chosen by dtype:
// * bfloat16, the training path: tensor cores through mma.sync m16n8k16
//   (attention_common.cuh's ldmatrix / mma pieces); the forward's four
//   warps own 16 rows each, the backward's eight 16 rows and half the
//   columns each. The logits tile's D chunks stream through two cp.async
//   stages, and the next inner tile's DC-column operand arrives with the
//   first chunk. In the backward dp passes through shared memory, rounded
//   to bf16, into the A operand of the second product.
// * float32: FMAs on the CUDA cores (no TF32), 16 x 16 threads over a
//   64 x 64 tile, 4 x 4 elements each.
//
// Three launchers with a plain C interface, each returning
// cudaGetLastError(); dtype code 0 = float32, 1 = bfloat16:
//   acco_ce_fwd     grid (row tiles, vocab splits), then the merge, one
//                   thread per row: two kernels from one call
//   acco_ce_bwd_dh  grid (row tiles, D / DC), looping over vocab tiles
//   acco_ce_bwd_dw  grid (vocab tiles, D / DC), looping over row tiles
// D must be a multiple of 128 (the envelope); N, V and v_real are free.

#include "attention_common.cuh"

namespace {

constexpr float kCeMask = -1e30f;  // the JAX kernel's column mask (`_NEG`)
constexpr int kCeT = 64;           // rows of every tile: hidden rows or vocab rows
constexpr int kCeK = kHeadDim;     // D chunk of the logits product (64: kRow fits)
constexpr int kCeThreads = 32 * kWarps;  // forward: four warps, 16 rows each
constexpr int kCeBwdThreads = 64 * kWarps;  // backward: eight warps, 16 rows x half the columns

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

// Rows [row0, row0 + 64) x columns [c0, c0 + W) of a row-major [nrows, ld]
// bf16 matrix into a padded shared tile through cp.async; rows at or past
// nrows are zero.
template <int W>
__device__ __forceinline__ void load_rows(bf16 (*dst)[W + 8], const bf16* src, int row0,
                                          int nrows, int ld, int c0) {
  for (int e = threadIdx.x; e < kCeT * W / 8; e += blockDim.x) {
    const int r = e / (W / 8), c = (e % (W / 8)) * 8;
    if (row0 + r < nrows) {
      cp_async16(&dst[r][c], src + (size_t)(row0 + r) * ld + c0 + c);
    } else {
      *reinterpret_cast<uint4*>(&dst[r][c]) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc[j] += A . B for the NT 8-column tiles j of a [16, 8 NT] product
// whose B operand is B(k, n) = s[c0 + n][k] (attention_common.cuh's
// mma_rows, from column c0 and NT wide).
template <int NT>
__device__ __forceinline__ void mma_rows_at(float (&acc)[NT][4], const uint32_t (&a)[4][4],
                                            bf16 (*s)[kRow], int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, &s[c0 + np * 16 + (lane % 8) + (lane / 16) * 8][ks * 16 + ((lane / 8) % 2) * 8]);
      mma_16816(acc[2 * np], a[ks], b[0], b[1]);
      mma_16816(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// s = A[a0 .. a0 + 64) . B[b0 .. b0 + 64)^T over the whole D, for this
// warp's share: rows 16 (warp % 4) + [0, 16), columns 8 NT (warp / 4) +
// [0, 8 NT) (accumulator layout: lane 4g + t holds rows g, g + 8 and
// columns 2t, 2t + 1 of each 8-column tile). The D chunks stream through
// two cp.async stages (sa, sb: two [64][kRow] tiles each). `first` issues
// more copies (or stores) into the first group; it runs after the barrier
// that ends every earlier use of the shared tiles.
template <int NT, typename First>
__device__ __forceinline__ void tile_logits(float (&s)[NT][4], bf16 (*sa)[kRow], bf16 (*sb)[kRow],
                                            const bf16* A, int a0, int na, const bf16* B,
                                            int b0, int nb, int D, First first) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  __syncthreads();
  load_rows<kCeK>(sa, A, a0, na, D, 0);
  load_rows<kCeK>(sb, B, b0, nb, D, 0);
  first();
  cp_async_commit();
  const int nk = D / kCeK;
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < nk) {
      load_rows<kCeK>(sa + (st ^ 1) * kCeT, A, a0, na, D, (kc + 1) * kCeK);
      load_rows<kCeK>(sb + (st ^ 1) * kCeT, B, b0, nb, D, (kc + 1) * kCeK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t a[4][4];
    load_a(a, sa + st * kCeT, (warp % 4) * 16);
    mma_rows_at<NT>(s, a, sb + st * kCeT, (warp / 4) * 8 * NT);
    __syncthreads();
  }
}

// One (row tile, vocab split): per row, this split's running max, sumexp,
// true logit and sum of real logits, into part[4][S][N].
__global__ void __launch_bounds__(kCeThreads)
    ce_fwd_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                       const int* __restrict__ tgt, float* __restrict__ part, int N, int D,
                       int V, int v_real, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*sa)[kRow] = reinterpret_cast<bf16 (*)[kRow]>(smem);
  bf16 (*sb)[kRow] = sa + 2 * kCeT;
  const int S = gridDim.y, split = blockIdx.y;
  const int r0 = blockIdx.x * kCeT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int row[2], tg[2];
  float m[2], l[2], tl[2], sl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = r0 + warp * 16 + g + hh * 8;
    tg[hh] = row[hh] < N ? tgt[row[hh]] : -1;
    m[hh] = kCeMask;
    l[hh] = tl[hh] = sl[hh] = 0.f;
  }
  const int T = (V + kCeT - 1) / kCeT;
  const int t_end = min(T, (split + 1) * tiles_per_split);
  for (int vt = split * tiles_per_split; vt < t_end; ++vt) {
    const int v0 = vt * kCeT;
    float s[8][4];
    tile_logits(s, sa, sb, h, r0, N, w, v0, V, D, [] {});
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2, col = v0 + j * 8 + 2 * t + (e % 2);
        if (col < V) {
          const float x = col < v_real ? s[j][e] : kCeMask;
          s[j][e] = x;
          mx[hh] = fmaxf(mx[hh], x);
          if (col == tg[hh]) tl[hh] += x;
          if (col < v_real) sl[hh] += x;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], mx[hh]);
      l[hh] *= expf(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v0 + j * 8 + 2 * t + (e % 2) < V) l[e / 2] += expf(s[j][e] - m[e / 2]);
      }
    }
  }
  // join the quad's four column shares; a + b == b + a, so both lanes of
  // each exchange hold the same value
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[hh], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[hh], off);
      const float m_new = fmaxf(m[hh], mo);
      l[hh] = l[hh] * expf(m[hh] - m_new) + lo * expf(mo - m_new);
      m[hh] = m_new;
      tl[hh] += __shfl_xor_sync(0xffffffffu, tl[hh], off);
      sl[hh] += __shfl_xor_sync(0xffffffffu, sl[hh], off);
    }
    if (t == 0 && row[hh] < N) {
      const size_t at = (size_t)split * N + row[hh];
      part[at] = m[hh];
      part[(size_t)S * N + at] = l[hh];
      part[(size_t)2 * S * N + at] = tl[hh];
      part[(size_t)3 * S * N + at] = sl[hh];
    }
  }
}

// dH (DW false: own rows are hidden rows, the inner tiles vocab rows) or dW
// (DW true: own rows are vocab rows, the inner tiles hidden rows) for one
// 64-row tile and the D columns [blockIdx.y * DC, + DC). Eight warps: warp
// w owns rows 16 (w % 4) + [0, 16) and, of the logits tile, columns
// 32 (w / 4) + [0, 32); of the accumulator, columns DC / 2 (w / 4) +
// [0, DC / 2). dp passes through shared memory (bf16, the rounding of
// `_dp_tile`) between the two products.
template <int DC, bool DW>
__global__ void __launch_bounds__(kCeBwdThreads)
    ce_bwd_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                       const int* __restrict__ tgt, const float* __restrict__ lse,
                       const float* __restrict__ dl, const float* __restrict__ dt,
                       const float* __restrict__ ds, bf16* __restrict__ out, int N, int D, int V,
                       int v_real) {
  constexpr int HC = DC / 2;  // accumulator columns of one warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*sa)[kRow] = reinterpret_cast<bf16 (*)[kRow]>(smem);
  bf16 (*sb)[kRow] = sa + 2 * kCeT;
  bf16 (*dps)[kRow] = sb + 2 * kCeT;  // dp, [own row][inner row]
  bf16 (*bd)[DC + 8] = reinterpret_cast<bf16 (*)[DC + 8]>(dps + kCeT);
  float (*rs)[kCeT] = reinterpret_cast<float (*)[kCeT]>(bd + kCeT);  // dW: inner rows' stats
  int* rt = reinterpret_cast<int*>(rs + 4);

  const int a0 = blockIdx.x * kCeT, dc0 = blockIdx.y * DC;
  const bf16* A = DW ? w : h;
  const bf16* B = DW ? h : w;
  const int na = DW ? V : N, nb = DW ? N : V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r16 = (warp % 4) * 16, half = warp / 4;

  // dH: the stats of this lane's two hidden rows, for the whole loop; rows
  // past N get zero cotangents, so their dp is 0
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f}, dt_r[2] = {0.f, 0.f}, ds_r[2] = {0.f, 0.f};
  int tg_r[2] = {-1, -1};
  if (!DW) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = a0 + r16 + g + hh * 8;
      if (r < N) {
        lse_r[hh] = lse[r];
        dl_r[hh] = dl[r];
        dt_r[hh] = dt[r];
        ds_r[hh] = ds[r];
        tg_r[hh] = tgt[r];
      }
    }
  }

  float acc[HC / 8][4];
#pragma unroll
  for (int j = 0; j < HC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_inner = (nb + kCeT - 1) / kCeT;
  for (int it = 0; it < n_inner; ++it) {
    const int b0 = it * kCeT;
    float s[4][4];
    tile_logits(s, sa, sb, A, a0, na, B, b0, nb, D, [&] {
      load_rows<DC>(bd, B, b0, nb, D, dc0);
      if (DW && threadIdx.x < kCeT) {
        const int r = b0 + threadIdx.x;
        const bool in = r < N;
        rs[0][threadIdx.x] = in ? lse[r] : 0.f;
        rs[1][threadIdx.x] = in ? dl[r] : 0.f;
        rs[2][threadIdx.x] = in ? dt[r] : 0.f;
        rs[3][threadIdx.x] = in ? ds[r] : 0.f;
        rt[threadIdx.x] = in ? tgt[r] : -1;
      }
    });
    // dp over this warp's [16, 32] share of the tile, rounded into dps
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float dp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2, bl = half * 32 + j * 8 + 2 * t + (e % 2);
        const int v = DW ? a0 + r16 + g + hh * 8 : b0 + bl;
        float x_lse, x_dl, x_dt, x_ds;
        int x_tg;
        if (DW) {
          x_lse = rs[0][bl], x_dl = rs[1][bl], x_dt = rs[2][bl], x_ds = rs[3][bl], x_tg = rt[bl];
        } else {
          x_lse = lse_r[hh], x_dl = dl_r[hh], x_dt = dt_r[hh], x_ds = ds_r[hh], x_tg = tg_r[hh];
        }
        dp[e] = 0.f;
        if (v < V) {
          const bool valid = v < v_real;
          dp[e] = x_dl * expf((valid ? s[j][e] : kCeMask) - x_lse) + (v == x_tg ? x_dt : 0.f) +
                  (valid ? x_ds : 0.f);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<uint32_t*>(&dps[r16 + g + hh * 8][half * 32 + j * 8 + 2 * t]) =
            pack_bf16(dp[2 * hh], dp[2 * hh + 1]);
      }
    }
    __syncthreads();
    // acc += dp . bd over this warp's rows and half of the D chunk, bd's
    // rows being the contraction
    uint32_t a[4][4];
    load_a(a, dps, r16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int cp = 0; cp < HC / 16; ++cp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, &bd[kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8][half * HC + cp * 16 + (lane / 16) * 8]);
        mma_16816(acc[2 * cp], a[kk], b[0], b[1]);
        mma_16816(acc[2 * cp + 1], a[kk], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = a0 + r16 + g + hh * 8;
    if (r >= na) continue;
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + (size_t)r * D + dc0 + half * HC + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;  // 16 x 16, each a 4 x 4 share of a 64 x 64 tile
constexpr int kF32K = 16;         // D chunk of the logits product
constexpr int kF32DC = 64;        // D columns per backward block

// s[i][j] = A[a0 + ty + 16 i] . B[b0 + tx + 16 j] over the whole D; rows at
// or past na / nb read as 0.
__device__ __forceinline__ void tile_logits_f32(float (&s)[4][4], float (*as)[kF32K + 1],
                                                float (*bs)[kF32K + 1], const float* A, int a0,
                                                int na, const float* B, int b0, int nb, int D) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kF32K) {
    __syncthreads();
    for (int e = threadIdx.x; e < kCeT * kF32K; e += kF32Threads) {
      const int r = e / kF32K, c = e % kF32K;
      as[r][c] = a0 + r < na ? A[(size_t)(a0 + r) * D + k0 + c] : 0.f;
      bs[r][c] = b0 + r < nb ? B[(size_t)(b0 + r) * D + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ar[i] = as[ty + 16 * i][k];
        br[i] = bs[tx + 16 * i][k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ar[i], br[j], s[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kF32Threads)
    ce_fwd_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                      const int* __restrict__ tgt, float* __restrict__ part, int N, int D, int V,
                      int v_real, int tiles_per_split) {
  __shared__ float as[kCeT][kF32K + 1];
  __shared__ float bs[kCeT][kF32K + 1];
  const int S = gridDim.y, split = blockIdx.y;
  const int r0 = blockIdx.x * kCeT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int tg[4];
  float m[4], l[4], tl[4], sl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    tg[i] = r < N ? tgt[r] : -1;
    m[i] = kCeMask;
    l[i] = tl[i] = sl[i] = 0.f;
  }
  const int T = (V + kCeT - 1) / kCeT;
  const int t_end = min(T, (split + 1) * tiles_per_split);
  for (int vt = split * tiles_per_split; vt < t_end; ++vt) {
    const int v0 = vt * kCeT;
    float s[4][4];
    tile_logits_f32(s, as, bs, h, r0, N, w, v0, V, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        if (col < V) {
          const float x = col < v_real ? s[i][j] : kCeMask;
          s[i][j] = x;
          mx = fmaxf(mx, x);
          if (col == tg[i]) tl[i] += x;
          if (col < v_real) sl[i] += x;
        }
      }
      const float m_new = fmaxf(m[i], mx);
      l[i] *= expf(m[i] - m_new);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (v0 + tx + 16 * j < V) l[i] += expf(s[i][j] - m[i]);
      }
    }
  }
  // join the 16 column shares of each row (lanes that differ in tx only)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float m_new = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - m_new) + lo * expf(mo - m_new);
      m[i] = m_new;
      tl[i] += __shfl_xor_sync(0xffffffffu, tl[i], off);
      sl[i] += __shfl_xor_sync(0xffffffffu, sl[i], off);
    }
    const int r = r0 + ty + 16 * i;
    if (tx == 0 && r < N) {
      const size_t at = (size_t)split * N + r;
      part[at] = m[i];
      part[(size_t)S * N + at] = l[i];
      part[(size_t)2 * S * N + at] = tl[i];
      part[(size_t)3 * S * N + at] = sl[i];
    }
  }
}

// dH or dW, as ce_bwd_bf16_kernel, for one 64-row tile and the D columns
// [blockIdx.y * 64, + 64); dp stays float32.
template <bool DW>
__global__ void __launch_bounds__(kF32Threads)
    ce_bwd_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                      const int* __restrict__ tgt, const float* __restrict__ lse,
                      const float* __restrict__ dl, const float* __restrict__ dt,
                      const float* __restrict__ ds, float* __restrict__ out, int N, int D, int V,
                      int v_real) {
  __shared__ float as[kCeT][kF32K + 1];
  __shared__ float bs[kCeT][kF32K + 1];
  __shared__ float ps[kCeT][kCeT + 1];    // dp, [own row][inner row]
  __shared__ float bd[kCeT][kF32DC + 1];  // the inner rows' D columns
  __shared__ float st[4][kCeT];           // lse, dl, dt, ds of the hidden rows in play
  __shared__ int stt[kCeT];               // their targets

  const int a0 = blockIdx.x * kCeT, dc0 = blockIdx.y * kF32DC;
  const float* A = DW ? w : h;
  const float* B = DW ? h : w;
  const int na = DW ? V : N, nb = DW ? N : V;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  auto load_stats = [&](int r0) {
    if (threadIdx.x < kCeT) {
      const int r = r0 + threadIdx.x;
      const bool in = r < N;
      st[0][threadIdx.x] = in ? lse[r] : 0.f;
      st[1][threadIdx.x] = in ? dl[r] : 0.f;
      st[2][threadIdx.x] = in ? dt[r] : 0.f;
      st[3][threadIdx.x] = in ? ds[r] : 0.f;
      stt[threadIdx.x] = in ? tgt[r] : -1;
    }
  };
  if (!DW) load_stats(a0);  // visible after tile_logits_f32's barriers

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_inner = (nb + kCeT - 1) / kCeT;
  for (int it = 0; it < n_inner; ++it) {
    const int b0 = it * kCeT;
    float s[4][4];
    tile_logits_f32(s, as, bs, A, a0, na, B, b0, nb, D);
    if (DW) load_stats(b0);
    for (int e = threadIdx.x; e < kCeT * kF32DC; e += kF32Threads) {
      const int r = e / kF32DC, c = e % kF32DC;
      bd[r][c] = b0 + r < nb ? B[(size_t)(b0 + r) * D + dc0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int al = ty + 16 * i, bl = tx + 16 * j;
        const int v = DW ? a0 + al : b0 + bl;
        const int x = DW ? bl : al;  // the hidden row's slot in st
        float dp = 0.f;
        if (v < V) {
          const bool valid = v < v_real;
          dp = st[1][x] * expf((valid ? s[i][j] : kCeMask) - st[0][x]) +
               (v == stt[x] ? st[2][x] : 0.f) + (valid ? st[3][x] : 0.f);
        }
        ps[al][bl] = dp;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int b = 0; b < kCeT; ++b) {
      float pa[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[ty + 16 * i][b];
        bb[i] = bd[b][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], bb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = a0 + ty + 16 * i;
    if (r >= na) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(size_t)r * D + dc0 + tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// both dtypes: the forward's merge of the vocab splits, in split order
// ---------------------------------------------------------------------------
__global__ void ce_fwd_merge_kernel(const float* __restrict__ part, float* __restrict__ lse,
                                    float* __restrict__ tl, float* __restrict__ sl, int N,
                                    int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const float* pm = part;
  const float* pl = part + (size_t)S * N;
  const float* pt = part + (size_t)2 * S * N;
  const float* ps = part + (size_t)3 * S * N;
  float m = kCeMask;
  for (int s = 0; s < S; ++s) m = fmaxf(m, pm[(size_t)s * N + r]);
  float l = 0.f, t = 0.f, u = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t at = (size_t)s * N + r;
    l += pl[at] * expf(pm[at] - m);
    t += pt[at];
    u += ps[at];
  }
  lse[r] = m + logf(l);
  tl[r] = t;
  sl[r] = u;
}

bool ce_shape_ok(int N, int D, int V, int v_real) {
  return N > 0 && D >= 128 && D % 128 == 0 && V > 0 && v_real >= 0 && v_real <= V;
}

template <int DC, bool DW>
cudaError_t launch_bwd_bf16(const void* h, const void* w, const void* tgt, const void* lse,
                            const void* dl, const void* dt, const void* ds, void* out, int N,
                            int D, int V, int v_real, cudaStream_t s) {
  const size_t bytes = 5 * kCeT * kRow * sizeof(bf16) + kCeT * (DC + 8) * sizeof(bf16) +
                       4 * kCeT * sizeof(float) + kCeT * sizeof(int);
  auto kernel = ce_bwd_bf16_kernel<DC, DW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int rows = DW ? V : N;
  kernel<<<dim3((rows + kCeT - 1) / kCeT, D / DC), kCeBwdThreads, bytes, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(dl),
      static_cast<const float*>(dt), static_cast<const float*>(ds), static_cast<bf16*>(out), N,
      D, V, v_real);
  return cudaGetLastError();
}

template <bool DW>
int launch_bwd(int dtype, const void* h, const void* w, const void* tgt, const void* lse,
               const void* dl, const void* dt, const void* ds, void* out, int N, int D, int V,
               int v_real, void* stream) {
  if (!ce_shape_ok(N, D, V, v_real)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // the widest D chunk that divides D: fewer logits recomputes
    if (D % 384 == 0) return (int)launch_bwd_bf16<384, DW>(h, w, tgt, lse, dl, dt, ds, out, N, D, V, v_real, s);
    if (D % 256 == 0) return (int)launch_bwd_bf16<256, DW>(h, w, tgt, lse, dl, dt, ds, out, N, D, V, v_real, s);
    return (int)launch_bwd_bf16<128, DW>(h, w, tgt, lse, dl, dt, ds, out, N, D, V, v_real, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int rows = DW ? V : N;
  ce_bwd_f32_kernel<DW><<<dim3((rows + kCeT - 1) / kCeT, D / kF32DC), kF32Threads, 0, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(dl),
      static_cast<const float*>(dt), static_cast<const float*>(ds), static_cast<float*>(out), N,
      D, V, v_real);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part: float32 scratch [4, splits, N]; the vocab tiles of 64 are cut into
// `splits` runs of `tiles_per_split`, none empty.
int acco_ce_fwd(int dtype, const void* h, const void* w, const void* tgt, void* part, void* lse,
                void* tl, void* sl, int N, int D, int V, int v_real, int splits,
                int tiles_per_split, void* stream) {
  const int T = (V + kCeT - 1) / kCeT;
  if (!ce_shape_ok(N, D, V, v_real) || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long)(splits - 1) * tiles_per_split >= T || (long)splits * tiles_per_split < T) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kCeT - 1) / kCeT, splits);
  if (dtype == 1) {
    ce_fwd_bf16_kernel<<<grid, kCeThreads, 4 * kCeT * kRow * sizeof(bf16), s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), static_cast<const int*>(tgt),
        static_cast<float*>(part), N, D, V, v_real, tiles_per_split);
  } else if (dtype == 0) {
    ce_fwd_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const int*>(tgt),
        static_cast<float*>(part), N, D, V, v_real, tiles_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lse), static_cast<float*>(tl),
      static_cast<float*>(sl), N, splits);
  return (int)cudaGetLastError();
}

int acco_ce_bwd_dh(int dtype, const void* h, const void* w, const void* tgt, const void* lse,
                   const void* dl, const void* dt, const void* ds, void* dh, int N, int D, int V,
                   int v_real, void* stream) {
  return launch_bwd<false>(dtype, h, w, tgt, lse, dl, dt, ds, dh, N, D, V, v_real, stream);
}

int acco_ce_bwd_dw(int dtype, const void* h, const void* w, const void* tgt, const void* lse,
                   const void* dl, const void* dt, const void* ds, void* dw, int N, int D, int V,
                   int v_real, void* stream) {
  return launch_bwd<true>(dtype, h, w, tgt, lse, dl, dt, ds, dw, N, D, V, v_real, stream);
}

}  // extern "C"
