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
// What bounds it on the H100 (the data sheet's 989 TFLOP/s and 3.35 TB/s):
// each of the four bf16 passes below is one product of 2 N D V operations
// (8.70 ms at N 8192, D 4096, V 128256; 0.64 ms at the Llama-125M head, N
// 8192, D 768, V 50257) against bytes worth a few ms at most, so every pass
// is bound by operations, and the design's job is to run each product once
// at the tensor cores' rate.
//
// bfloat16, the training path: four launches of one GEMM mainloop
// (hopper_gemm.cuh: TMA into a 4-stage ring of 128B-swizzled tiles, one
// producer warp, two consumer warpgroups on wgmma m64n256k16 or m64n128k16,
// float32 accumulators in registers), each with its own epilogue:
//   ce_fwd     logits tile = h w^T per (128-row tile, vocab split of
//              256-column tiles); the epilogue keeps each row's running
//              max, sumexp, true logit and sum of real logits across the
//              split's tiles; a second small kernel merges the splits in a
//              fixed order;
//   ce_bwd_dp  the same logits product, once; the epilogue forms dp in
//              float32, rounds it to bf16 and writes it to dp [Nc, Vp]
//              (Vp = V rounded up to 128, so that TMA's row stride is a
//              multiple of 16 bytes; columns >= V written as 0);
//   ce_bwd_dh  dH = dp w: A = dp (K-major), B = w [V, D] read MN-major
//              (wgmma's transpose bit), K = Vp; TMA fills w's rows >= V
//              with zeros; 256-column tiles of D, or 128 where 256 would
//              leave the last wave of blocks mostly idle (D 768);
//   ce_bwd_dw  dW = dp^T h: A = dp read MN-major, B = h MN-major, K = Nc;
//              written in bf16, or, when the rows come in several chunks,
//              summed chunk after chunk in a float32 [V, D] buffer (a fixed
//              order) and rounded once by the last chunk's launch.
// The TPU kernels keep an [RB, D] f32 dH or [D, VT] f32 dW accumulator in
// VMEM and recompute the logits in each backward kernel; the port instead
// writes the bf16 dlogits once (the values `_dp_tile` multiplies) and
// reads them twice: 2 N Vp bytes of device memory (1.96 GiB at N 8192, V
// 128256; the wrapper chunks the rows to keep it under a cap) for one
// logits product in place of two, and no partial buffers. Every output
// element is summed by one thread in a fixed order, with no atomics, so
// dH and dW are bit-identical from run to run.
//
// float32 (the end-to-end float32 check): FMAs on the CUDA cores (no
// TF32), 16 x 16 threads over a 64 x 64 tile, 4 x 4 elements each; each
// backward block owns a 64-row tile and a 64-column chunk of D and
// recomputes the logits tile over the whole D.
//
// Launchers with a plain C interface, each returning cudaGetLastError():
//   acco_ce_fwd        dtype 0 = float32, 1 = bfloat16: the split pass and
//                      the merge, two kernels from one call
//   acco_ce_bwd_dp     bf16
//   acco_ce_bwd_dh     bf16, from dp
//   acco_ce_bwd_dw     bf16, from dp
//   acco_ce_bwd_dh_f32 / acco_ce_bwd_dw_f32   float32, recomputing dp
// D must be a multiple of 128 (the envelope); N, V and v_real are free.

#include <math.h>

#include "hopper_gemm.cuh"

namespace {

using hopper::bf16;

constexpr float kCeMask = -1e30f;  // the JAX kernel's column mask (`_NEG`)
constexpr int kCeT = 64;           // the float32 kernels' tile: hidden rows or vocab rows
constexpr int kVocabTile = 256;    // bf16 forward and dp: vocab columns per tile
constexpr int kGroup = 16;         // row tiles per group of blocks (hopper_gemm.cuh)

// ---------------------------------------------------------------------------
// bfloat16: epilogues of the Hopper GEMM
// ---------------------------------------------------------------------------

// This thread's rows (r, r + 8) of the block's 128-row tile and the first
// column of its pair in each 8-column group (hopper_gemm.cuh's layout).
__device__ __forceinline__ void frag_coords(int wg, int& r, int& c) {
  const int t = threadIdx.x % 128;
  r = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  c = 2 * (t % 4);
}

// Per row of the block, over the vocab split's tiles: running max, sumexp,
// true logit and sum of real logits, into part[4][splits][N].
struct ce_fwd_epilogue {
  struct Params {
    const int* tgt;
    float* part;
    int N, V, v_real, splits;
  };
  float* part;
  int N, V, v_real, splits, split, c;
  int row[2], tg[2];
  float m[2], l[2], tl[2], sl[2];

  __device__ ce_fwd_epilogue(const Params& p, int m0, int bn, int wg)
      : part(p.part), N(p.N), V(p.V), v_real(p.v_real), splits(p.splits), split(bn) {
    int r;
    frag_coords(wg, r, c);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      row[hh] = m0 + r + 8 * hh;
      tg[hh] = row[hh] < N ? p.tgt[row[hh]] : -1;
      m[hh] = kCeMask;
      l[hh] = tl[hh] = sl[hh] = 0.f;
    }
  }

  template <int NA>
  __device__ __forceinline__ void tile(const float (&acc)[NA], int n0) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e / 2, col = n0 + 8 * j + c + (e % 2);
        if (col < V) {
          const float x = col < v_real ? acc[4 * j + e] : kCeMask;
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
    for (int j = 0; j < NA / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * j + c + (e % 2);
        if (col < V) {
          const float x = col < v_real ? acc[4 * j + e] : kCeMask;
          l[e / 2] += expf(x - m[e / 2]);
        }
      }
    }
  }

  // join the quad's four column shares; a + b == b + a, so both lanes of
  // each exchange hold the same value
  __device__ __forceinline__ void finish() {
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
      if (c == 0 && row[hh] < N) {
        const size_t at = (size_t)split * N + row[hh];
        part[at] = m[hh];
        part[(size_t)splits * N + at] = l[hh];
        part[(size_t)2 * splits * N + at] = tl[hh];
        part[(size_t)3 * splits * N + at] = sl[hh];
      }
    }
  }
};

// dp = d_lse * exp(logit - lse) + d_tl * onehot + d_sl * valid, rounded to
// bf16, into dp [N, Vp]; 0 at the columns >= V.
struct ce_bwd_dp_epilogue {
  struct Params {
    const int* tgt;
    const float *lse, *dl, *dt, *ds;
    bf16* dp;
    int N, V, Vp, v_real;
  };
  bf16* dp;
  int N, V, Vp, v_real, c;
  int row[2], tg_r[2];
  float lse_r[2], dl_r[2], dt_r[2], ds_r[2];

  __device__ ce_bwd_dp_epilogue(const Params& p, int m0, int, int wg)
      : dp(p.dp), N(p.N), V(p.V), Vp(p.Vp), v_real(p.v_real) {
    int r;
    frag_coords(wg, r, c);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      row[hh] = m0 + r + 8 * hh;
      const bool in = row[hh] < N;
      lse_r[hh] = in ? p.lse[row[hh]] : 0.f;
      dl_r[hh] = in ? p.dl[row[hh]] : 0.f;
      dt_r[hh] = in ? p.dt[row[hh]] : 0.f;
      ds_r[hh] = in ? p.ds[row[hh]] : 0.f;
      tg_r[hh] = in ? p.tgt[row[hh]] : -1;
    }
  }

  __device__ __forceinline__ float dlogit(float s, int col, int hh) const {
    if (col >= V) return 0.f;
    const bool valid = col < v_real;
    return dl_r[hh] * expf((valid ? s : kCeMask) - lse_r[hh]) + (col == tg_r[hh] ? dt_r[hh] : 0.f) +
           (valid ? ds_r[hh] : 0.f);
  }

  template <int NA>
  __device__ __forceinline__ void tile(const float (&acc)[NA], int n0) {
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      const int col = n0 + 8 * j + c;
      if (col >= Vp) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (row[hh] < N) {
          *reinterpret_cast<__nv_bfloat162*>(dp + (size_t)row[hh] * Vp + col) =
              __floats2bfloat162_rn(dlogit(acc[4 * j + 2 * hh], col, hh),
                                    dlogit(acc[4 * j + 2 * hh + 1], col + 1, hh));
        }
      }
    }
  }

  __device__ __forceinline__ void finish() {}
};

// dH rows [0, rows), columns [0, ld), of a row-major [rows, ld] bf16 output.
struct ce_bwd_dh_epilogue {
  struct Params {
    bf16* out;
    int rows, ld;
  };
  bf16* out;
  int rows, ld, r0, c;

  __device__ ce_bwd_dh_epilogue(const Params& p, int m0, int, int wg)
      : out(p.out), rows(p.rows), ld(p.ld) {
    int r;
    frag_coords(wg, r, c);
    r0 = m0 + r;
  }

  template <int NA>
  __device__ __forceinline__ void tile(const float (&acc)[NA], int n0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        if (n0 + 8 * j + c >= ld) break;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ld + n0 + 8 * j + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }
  }

  __device__ __forceinline__ void finish() {}
};

// dW rows [0, rows) (the vocab rows < V of a Vp-row product), columns
// [0, ld), by mode:
// 0 write bf16 (one chunk of rows); 1 write the float32 sum buffer (the
// first of several chunks); 2 add to it; 3 add to it and write the sum
// in bf16 (the last chunk).
struct ce_bwd_dw_epilogue {
  struct Params {
    bf16* out;
    float* sum;
    int rows, ld, mode;
  };
  bf16* out;
  float* sum;
  int rows, ld, mode, r0, c;

  __device__ ce_bwd_dw_epilogue(const Params& p, int m0, int, int wg)
      : out(p.out), sum(p.sum), rows(p.rows), ld(p.ld), mode(p.mode) {
    int r;
    frag_coords(wg, r, c);
    r0 = m0 + r;
  }

  template <int NA>
  __device__ __forceinline__ void tile(const float (&acc)[NA], int n0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        if (n0 + 8 * j + c >= ld) break;
        const size_t at = (size_t)row * ld + n0 + 8 * j + c;
        float2 v = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        if (mode >= 2) {
          const float2 s = *reinterpret_cast<const float2*>(sum + at);
          v = make_float2(s.x + v.x, s.y + v.y);
        }
        if (mode == 1 || mode == 2) {
          *reinterpret_cast<float2*>(sum + at) = v;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v.x, v.y);
        }
      }
    }
  }

  __device__ __forceinline__ void finish() {}
};

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

// dH (DW false: own rows are hidden rows, the inner tiles vocab rows) or dW
// (DW true: own rows are vocab rows, the inner tiles hidden rows) for one
// 64-row tile and the D columns [blockIdx.y * 64, + 64), recomputing the
// logits tile over the whole D; dp stays float32.
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

bool vp_ok(int V, int Vp) { return Vp >= V && Vp % 128 == 0; }

template <bool DW>
int launch_bwd_f32(const void* h, const void* w, const void* tgt, const void* lse, const void* dl,
                   const void* dt, const void* ds, void* out, int N, int D, int V, int v_real,
                   void* stream) {
  if (!ce_shape_ok(N, D, V, v_real) || !hopper::bind_device_of(out)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = DW ? V : N;
  ce_bwd_f32_kernel<DW><<<dim3((rows + kCeT - 1) / kCeT, D / kF32DC), kF32Threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(dl),
      static_cast<const float*>(dt), static_cast<const float*>(ds), static_cast<float*>(out), N,
      D, V, v_real);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part: float32 scratch [4, splits, N]; the vocab tiles (256 columns in
// bf16, 64 in float32) are cut into `splits` runs of `tiles_per_split`,
// none empty.
int acco_ce_fwd(int dtype, const void* h, const void* w, const void* tgt, void* part, void* lse,
                void* tl, void* sl, int N, int D, int V, int v_real, int splits,
                int tiles_per_split, void* stream) {
  const int tile = dtype == 1 ? kVocabTile : kCeT;
  const int T = (V + tile - 1) / tile;
  if (!ce_shape_ok(N, D, V, v_real) || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long)(splits - 1) * tiles_per_split >= T || (long)splits * tiles_per_split < T) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    CUtensorMap ma, mb;
    if (!hopper::make_map(&ma, h, N, D, false) ||
        !hopper::make_map(&mb, w, V, D, false, kVocabTile)) {
      return (int)cudaErrorInvalidValue;
    }
    const hopper::GemmArgs g{(N + hopper::kBM - 1) / hopper::kBM, T, D / hopper::kBK,
                             tiles_per_split, kGroup};
    err = hopper::launch_gemm<kVocabTile, false, false, ce_fwd_epilogue>(
        ma, mb, g, {static_cast<const int*>(tgt), static_cast<float*>(part), N, V, v_real, splits},
        s);
  } else if (dtype == 0) {
    if (!hopper::bind_device_of(part)) return (int)cudaErrorInvalidValue;
    ce_fwd_f32_kernel<<<dim3((N + kCeT - 1) / kCeT, splits), kF32Threads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), static_cast<const int*>(tgt),
        static_cast<float*>(part), N, D, V, v_real, tiles_per_split);
    err = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  ce_fwd_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lse), static_cast<float*>(tl),
      static_cast<float*>(sl), N, splits);
  return (int)cudaGetLastError();
}

// bf16 dp [N, Vp] of N hidden rows (a chunk of them: every row pointer
// starts at the chunk); blocks (128-row tiles, vocab splits of
// `tiles_per_split` 256-column tiles of Vp).
int acco_ce_bwd_dp(const void* h, const void* w, const void* tgt, const void* lse, const void* dl,
                   const void* dt, const void* ds, void* dp, int N, int D, int V, int Vp,
                   int v_real, int splits, int tiles_per_split, void* stream) {
  const int T = (Vp + kVocabTile - 1) / kVocabTile;
  if (!ce_shape_ok(N, D, V, v_real) || !vp_ok(V, Vp) || splits < 1 || tiles_per_split < 1 ||
      (long)(splits - 1) * tiles_per_split >= T || (long)splits * tiles_per_split < T) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap ma, mb;
  if (!hopper::make_map(&ma, h, N, D, false) ||
      !hopper::make_map(&mb, w, V, D, false, kVocabTile)) {
    return (int)cudaErrorInvalidValue;
  }
  const hopper::GemmArgs g{(N + hopper::kBM - 1) / hopper::kBM, T, D / hopper::kBK,
                           tiles_per_split, kGroup};
  const ce_bwd_dp_epilogue::Params p{static_cast<const int*>(tgt), static_cast<const float*>(lse),
                                     static_cast<const float*>(dl), static_cast<const float*>(dt),
                                     static_cast<const float*>(ds), static_cast<bf16*>(dp),
                                     N, V, Vp, v_real};
  return (int)hopper::launch_gemm<kVocabTile, false, false, ce_bwd_dp_epilogue>(
      ma, mb, g, p, static_cast<cudaStream_t>(stream));
}

// bf16 dH [N, D] = dp [N, Vp] . w [V, D] (w's rows >= V read as zeros).
int acco_ce_bwd_dh(const void* dp, const void* w, void* dh, int N, int D, int V, int Vp,
                   void* stream) {
  if (!ce_shape_ok(N, D, V, V) || !vp_ok(V, Vp)) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!hopper::make_map(&ma, dp, N, Vp, false) || !hopper::make_map(&mb, w, V, D, true)) {
    return (int)cudaErrorInvalidValue;
  }
  const int m_tiles = (N + hopper::kBM - 1) / hopper::kBM;
  const int k_steps_dh = Vp / hopper::kBK;
  const ce_bwd_dh_epilogue::Params p{static_cast<bf16*>(dh), N, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper::pick_bn(m_tiles, D) == 256) {
    const hopper::GemmArgs g{m_tiles, (D + 255) / 256, k_steps_dh, 1, kGroup};
    return (int)hopper::launch_gemm<256, false, true, ce_bwd_dh_epilogue>(ma, mb, g, p, s);
  }
  const hopper::GemmArgs g{m_tiles, D / 128, k_steps_dh, 1, kGroup};
  return (int)hopper::launch_gemm<128, false, true, ce_bwd_dh_epilogue>(ma, mb, g, p, s);
}

// bf16 dW [V, D] = dp [N, Vp]^T . h [N, D] over N rows (a chunk), by
// `mode` (ce_bwd_dw_epilogue) with `sum` a float32 [V, D] buffer.
int acco_ce_bwd_dw(const void* dp, const void* h, void* dw, void* sum, int N, int D, int V,
                   int Vp, int mode, void* stream) {
  if (!ce_shape_ok(N, D, V, V) || !vp_ok(V, Vp) || mode < 0 || mode > 3 ||
      (mode > 0 && sum == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap ma, mb;
  if (!hopper::make_map(&ma, dp, N, Vp, true) || !hopper::make_map(&mb, h, N, D, true)) {
    return (int)cudaErrorInvalidValue;
  }
  const int m_tiles = Vp / hopper::kBM;
  const int k_steps = (N + hopper::kBK - 1) / hopper::kBK;
  const ce_bwd_dw_epilogue::Params p{static_cast<bf16*>(dw), static_cast<float*>(sum), V, D,
                                     mode};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper::pick_bn(m_tiles, D) == 256) {
    const hopper::GemmArgs g{m_tiles, (D + 255) / 256, k_steps, 1, kGroup};
    return (int)hopper::launch_gemm<256, true, true, ce_bwd_dw_epilogue>(ma, mb, g, p, s);
  }
  const hopper::GemmArgs g{m_tiles, D / 128, k_steps, 1, kGroup};
  return (int)hopper::launch_gemm<128, true, true, ce_bwd_dw_epilogue>(ma, mb, g, p, s);
}

int acco_ce_bwd_dh_f32(const void* h, const void* w, const void* tgt, const void* lse,
                       const void* dl, const void* dt, const void* ds, void* dh, int N, int D,
                       int V, int v_real, void* stream) {
  return launch_bwd_f32<false>(h, w, tgt, lse, dl, dt, ds, dh, N, D, V, v_real, stream);
}

int acco_ce_bwd_dw_f32(const void* h, const void* w, const void* tgt, const void* lse,
                       const void* dl, const void* dt, const void* ds, void* dw, int N, int D,
                       int V, int v_real, void* stream) {
  return launch_bwd_f32<true>(h, w, tgt, lse, dl, dt, ds, dw, N, D, V, v_real, stream);
}

}  // extern "C"
