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
// JAX.
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
// sum_j p V).
//
// What bounds it on the H100 (data sheet: 989 TFLOP/s bf16, 3.35 TB/s): the
// ring's block at Llama-3-8B's shape on the card path (B 1, H 32, Hkv 8,
// Lq = Lk 4096, D 128) is 5.4e8 pairs (full) or 2.7e8 (diag); the forward's
// 4 D operations a pair take 0.28 ms (full) against 0.04 ms of bytes:
// compute-bound, like K5. GPT-Neo's positional block (B 8, H 12, L 1024, D
// 64, a zig-zag hop at window 256) attends few pairs and is bound by its
// bytes.
//
// Two implementations, chosen by dtype:
// * bfloat16: the wgmma + TMA attention mainloop of hopper_attention.cuh,
//   one instance a mask (BlockMask below; forward: 128 query rows a block,
//   128-key tiles; dQ: 128 query rows, 64-key tiles; dK/dV: 128 keys, the
//   64-query steps of the n_rep q heads, no atomics). The mainloop's kStats
//   path keeps the forward's scores as the raw accumulator, so that the
//   emitted m = scale * max is bit for bit the backward's s at the maximum
//   (the backward's products run in the same k order), writes o float32
//   and unnormalised from registers, and m, l and the tie count. The diag
//   mask walks K5's causal band (no tile above the diagonal, in dK/dV
//   too); the positional mask walks only the tiles whose spans of positions
//   can meet, masks only the tiles whose spans it does not cover (a span:
//   a 64-position tile's min and max, which the wrapper appends to the
//   positions), and gives a row with no allowed key the sum of V over all
//   Lk keys after its walk; dK/dV walks the q steps that hold one as well,
//   as P^T dO alone where no pair of the step is allowed (their p = 1
//   gives dV, their dS is 0). P is rounded to bf16 against the running
//   max before P V (as K5); dV is bf16(P)^T bf16(dO) with float32
//   accumulation (JAX: float32 p and dO).
// * float32: FMAs on the CUDA cores, D / 32 threads per row, as K5's.
//
// Four launchers, each with a plain C interface returning cudaGetLastError();
// dtype code 0 = float32, 1 = bfloat16; Lq and Lk multiples of 64:
//   acco_blk_fwd       one block per (128-row q tile, b*h)
//   acco_blk_bwd_rowc  one warp per (b, h, row): c
//   acco_blk_bwd_dkdv  one block per (128-key tile, b*hkv), looping over the
//                      n_rep q heads and the q steps (at or after it: diag)
//   acco_blk_bwd_dq    one block per (128-row q tile, b*h)

#include "hopper_attention.cuh"
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

// The mask policy of hopper_attention.cuh for K4, one a mode: none (a past
// chunk), diag (the self hop) or positional (windowed or not).
template <int kMode>
struct BlockMask {
  static constexpr bool kScaleInDs = false;         // dQ, dK scaled after the sum
  static constexpr bool kFlagRows = kMode == kPos;  // a positional row may see no key
  static constexpr bool kStats = true;
  static constexpr bool kExactP = false;
  static constexpr bool kBounds = kMode == kPos;
  struct Params {
    const int* qpos;
    const int* kpos;
    int window;
  };
  const int *qpos, *kpos;
  int window, Lq, Lk;

  __device__ BlockMask(const Params& p, int, int Lq_, int Lk_)
      : qpos(p.qpos), kpos(p.kpos), window(p.window), Lq(Lq_), Lk(Lk_) {}
  __device__ bool has_key_mask() const { return kMode == kPos; }
  __device__ int key_begin(int) const { return 0; }
  __device__ int key_end(int q1) const { return kMode == kDiag ? min(Lk, q1) : Lk; }
  __device__ int query_begin(int k0) const { return kMode == kDiag ? k0 : 0; }
  __device__ int query_end(int) const { return Lq; }
  __device__ bool partial(int i0, int i1, int j0, int j1) const {
    if (i1 > Lq || j1 > Lk) return true;
    if (kMode == kPos) return !covers(q_span(i0, i1), k_span(j0, j1));
    return kMode == kDiag && j1 - 1 > i0;
  }
  __device__ int query_val(int i) const { return kMode == kPos && i < Lq ? qpos[i] : 0; }
  __device__ int key_val(int j) const { return kMode == kPos && j < Lk ? kpos[j] : 0; }
  __device__ bool allowed(int i, int qp, int j, int kp) const {
    return blk_allowed(kMode, i, j, qp, kp, window);
  }
  // The positions' (min, max) over rows [i0, i1) of pos, n long (i0 < n),
  // from the (min, max) of each 64-position tile that follow the n
  // positions (ops/block_attention.py `positions_with_spans`).
  __device__ int2 span(const int* pos, int n, int i0, int i1) const {
    const int2* tiles = reinterpret_cast<const int2*>(pos + n);
    int2 r = tiles[i0 / 64];
    for (int x = i0 / 64 + 1; x < (min(i1, n) + 63) / 64; ++x) {
      r.x = min(r.x, tiles[x].x);
      r.y = max(r.y, tiles[x].y);
    }
    return r;
  }
  __device__ int2 q_span(int i0, int i1) const { return span(qpos, Lq, i0, i1); }
  __device__ int2 k_span(int j0, int j1) const { return span(kpos, Lk, j0, j1); }
  // queries with positions in qs, keys in ks: may some pair be allowed?
  __device__ bool meets(int2 qs, int2 ks) const {
    return ks.x <= qs.y && (window == 0 || ks.y > qs.x - window);
  }
  // ... is every pair allowed?
  __device__ bool covers(int2 qs, int2 ks) const {
    return ks.y <= qs.x && (window == 0 || ks.x > qs.y - window);
  }
};

// dS of one (query, key) pair, before its rounding to the activation dtype.
__device__ __forceinline__ float blk_ds(bool ok, float p, float dp_dot, float dl, bool eq,
                                        float c) {
  return ok ? p * (dp_dot + dl) + (eq ? c : 0.f) : 0.f;
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
struct Shape {
  int B, H, Hkv, Lq, Lk, mode, window;
  float scale;
};

template <int kMode>
struct ModeTag {
  using Mask = BlockMask<kMode>;
};

// The bf16 launch of `mode`: fn(ModeTag<mode>, dims, the mask's params).
template <class Fn>
cudaError_t by_mode(const Shape& sh, const int* qpos, const int* kpos, Fn fn) {
  const hopper::attn::Dims d{sh.B, sh.H, sh.Hkv, sh.Lq, sh.Lk, sh.scale};
  if (sh.mode == kFull) {
    return fn(ModeTag<kFull>{}, d, BlockMask<kFull>::Params{qpos, kpos, sh.window});
  }
  if (sh.mode == kDiag) {
    return fn(ModeTag<kDiag>{}, d, BlockMask<kDiag>::Params{qpos, kpos, sh.window});
  }
  return fn(ModeTag<kPos>{}, d, BlockMask<kPos>::Params{qpos, kpos, sh.window});
}

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v, const int* qpos,
                const int* kpos, float* o, float* m, float* l, float* cnt, Shape sh,
                cudaStream_t s) {
  if (dtype == 1) {
    return by_mode(sh, qpos, kpos, [&](auto tag, const hopper::attn::Dims& d, const auto& p) {
      using Mask = typename decltype(tag)::Mask;
      return hopper::attn::launch_fwd<D, Mask>(q, k, v, o, m, l, cnt, d, p, s);
    });
  }
  blk_fwd_f32_kernel<D><<<dim3(sh.Lq / F32<D>::RB, sh.B * sh.H), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qpos, kpos, o, m, l, cnt, sh.H, sh.H / sh.Hkv, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, const void* dout, const float* m, const float* dl,
                   const float* c, void* dq, Shape sh, cudaStream_t s) {
  if (dtype == 1) {
    return by_mode(sh, qpos, kpos, [&](auto tag, const hopper::attn::Dims& d, const auto& p) {
      using Mask = typename decltype(tag)::Mask;
      return hopper::attn::launch_bwd_dq<D, Mask>(q, k, v, dout, m, dl, c, dq, d, p, s);
    });
  }
  blk_bwd_dq_f32_kernel<D><<<dim3(sh.Lq / F32<D>::RB, sh.B * sh.H), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qpos, kpos, static_cast<const float*>(dout), m, dl, c, static_cast<float*>(dq), sh.H,
      sh.H / sh.Hkv, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkdv(int dtype, const void* q, const void* k, const void* v, const int* qpos,
                     const int* kpos, const void* dout, const float* m, const float* dl,
                     const float* c, void* dk, void* dv, Shape sh, cudaStream_t s) {
  if (dtype == 1) {
    return by_mode(sh, qpos, kpos, [&](auto tag, const hopper::attn::Dims& d, const auto& p) {
      using Mask = typename decltype(tag)::Mask;
      return hopper::attn::launch_bwd_dkdv<D, Mask>(q, k, v, dout, m, dl, c, dk, dv, d, p, s);
    });
  }
  blk_bwd_dkdv_f32_kernel<D><<<dim3(sh.Lk / F32<D>::RB, sh.B * sh.Hkv), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qpos, kpos, static_cast<const float*>(dout), m, dl, c, static_cast<float*>(dk),
      static_cast<float*>(dv), sh.H, sh.H / sh.Hkv, sh.Lq, sh.Lk, sh.mode, sh.window, sh.scale);
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
