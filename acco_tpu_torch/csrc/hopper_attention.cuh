// One Hopper attention mainloop for the bf16 kernels of K5 (flash_attention.cu:
// causal + segment ids) and K1 (fused_attention.cu: causal + window + key
// pads), which differ only in the mask policy given as a template parameter.
// Built on hopper_gemm.cuh's mbarrier, TMA, descriptor and wgmma helpers.
//
// Every kernel here is one block of 384 threads:
//   warpgroup 0: warp 0 decides the block's walk (which K/V tiles, or which
//                q steps and heads, and in what order), and its lane 0
//                issues the TMA loads of each onto the `full` mbarrier of a
//                stage of a ring, with the walk's position (`meta`) written
//                beside it; a sentinel stage (meta -1) ends the walk. The
//                warpgroup gives its registers away (setmaxnreg.dec).
//   warpgroups 1, 2: 64 rows each of the block's 128 (query rows in the
//                forward and dQ, key rows in dK/dV). They follow the walk
//                stage by stage: the score product S = A B^T from shared
//                memory (SS wgmma, both operands K-major), the mask policy
//                on tiles that need it, the softmax arithmetic in
//                registers, the probabilities (or dS) rounded to bf16 in
//                registers and fed to the second product as its A operand
//                (RS wgmma), with the second operand read MN-major through
//                wgmma's transpose bit; then the stage goes back on its
//                `empty` mbarrier.
// The gradients of dK/dV and dQ are each written by one thread in a fixed
// order: no atomics, bit-identical reruns.
//
// Shared tiles. An operand tile of R rows (queries or keys) x D (64 or 128)
// is D / 64 TMA boxes of R x 64 bf16 at the 128-byte swizzle, R * 128
// bytes each, every box on a 1024-byte boundary. It is read two ways:
//   K-major, contraction over D (S = Q K^T: A = Q rows, B = K rows): k16
//     step j starts (j / 4) boxes in and (j % 4) * 32 bytes into the
//     swizzled row; rows are 128 bytes apart, 8-row groups 1024 (SBO);
//     a warpgroup's 64 rows start 64 * 128 bytes into each box;
//   MN-major, contraction over the rows and N = D (O += P V: B = V): k16
//     step j is rows [16 j, 16 j + 16), 2048 bytes further; 8-row groups
//     1024 bytes apart (SBO); the second 64 columns of D are the next box,
//     R * 128 bytes on (LBO).
// These are hopper_gemm.cuh's two layouts with a box R rows high.
//
// Tensor maps are rank 3, (D, L, B * heads), so TMA zero-fills the rows
// past L of a 128-row tile when L is a multiple of 64 but not of 128; rows
// past L are never stored, and keys past L are masked to -inf in the
// forward (they must not count even for a row with no allowed key).
//
// Accumulator layout (wgmma m64nN, f32): thread t = 32 w + l of a
// warpgroup holds rows 16 w + l / 4 (acc[4 j + 0, 1]) and + 8 (acc[4 j +
// 2, 3]), columns 8 j + 2 (l % 4) + {0, 1}. The A fragment of an RS wgmma
// (m64k16, bf16) has the same rows: register 0 holds (row, columns 2 (l %
// 4) + {0, 1}), 1 the row + 8, 2 and 3 the same at columns + 8 (see
// acc_to_frag).
//
// Mask policy contract (Mask):
//   struct Params;                    kernel argument, by value
//   kScaleInDs                        dS is rounded with the softmax scale
//                                     in it (K5), or dQ, dK are scaled
//                                     after the sum (K1)
//   kFlagRows                         a row may have no allowed key (K1's
//                                     pads): its scores are all -1e9, and
//                                     the reference normalises it over all
//                                     L keys (P = 1 in the backward)
//   Mask(const Params&, int b, int L)
//   has_key_mask()                    per-key data (segment ids, pads)
//   key_begin(q0), query_end(k)       the band: the first key rows >= q0
//                                     may see; one past the last query
//                                     that key k may be seen by
//   partial(i0, i1, j0, j1)           some pair of rows [i0, i1) x keys
//                                     [j0, j1) is masked (or past L)
//   query_val(i), key_val(j)          per-row data for allowed()
//   allowed(i, qv, j, kv)
// Masked scores are -1e9 (the JAX kernels' value), so P = exp(s - lse)
// keeps JAX's arithmetic for a row with no allowed key: lse = -1e9 and
// P = 1 on every key. The forward gives such a row the mean of V over all
// L keys (a pass over V, only in a warpgroup that holds one); dQ walks all
// key tiles, and dK/dV the q steps that hold one, only where one is
// (found from lse).

#pragma once

#include <math.h>

#include "hopper_gemm.cuh"

namespace hopper {
namespace attn {

constexpr float kMasked = -1e9f;   // the JAX kernels' mask value
constexpr float kFlagLse = -5e8f;  // lse at or below this: a row with no allowed key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the forward keeps its scores in log2 units (exp(s - m) = 2^(s2 - m2)):
// the mask value there
constexpr float kMasked2 = kMasked * kLog2e;
constexpr int kRows = 128;         // the block's rows: two consumer warpgroups of 64
constexpr int kFwdKeys = 128;      // forward: keys of a K/V tile
constexpr int kStep = 64;          // dQ: keys of a K/V tile; dK/dV: queries of a step

// -- PTX ----------------------------------------------------------------------

// A 3-D box at element coordinates (c0 inner, c1, c2) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map, void* dst, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory, completing
// on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 2^x on the special function unit (relative error 2^-22; 2^0 = 1 and
// 2^-inf = 0 exactly).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A barrier for the 128 threads of one consumer warpgroup (ids 1 and 2; 0
// is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Ping-pong of the two consumer warpgroups (ids 3 and 4): a warpgroup
// waits for its turn before it issues its products and then hands the turn
// to the other, so that one's softmax runs under the other's wgmmas.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
}

template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d += A (64 x 16) . B (16 x N), both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  wgmma<0, 0>(d, desc_a, desc_b, scale_d);  // m64n128k16
}

// d += A (64 x 16, bf16 in registers) . B (16 x N, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// -- shared tiles -------------------------------------------------------------

// Descriptor of k16 step j (D columns [16 j, 16 j + 16)) of rows [r0, r0 +
// 64 or N) of an R-row tile, K-major.
template <int R>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int r0, int j) {
  return make_desc(tile + (j >> 2) * (R * 128) + r0 * 128 + (j & 3) * 32, 16, 1024);
}

// Descriptor of k16 step j (rows [16 j, 16 j + 16)) of an R-row tile,
// MN-major with N = D.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int j) {
  return make_desc(tile + j * 2048, R * 128, 1024);
}

// The R x D tile from row `row` of slice `slice` of a (D, L, slices) map.
template <int R, int D>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, unsigned char* dst,
                                          uint64_t* bar, int row, int slice) {
#pragma unroll
  for (int b = 0; b < D / 64; ++b) tma_load_3d(map, dst + b * R * 128, bar, 64 * b, row, slice);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The RS A fragments (bf16) of a [64 x N] float32 accumulator, for a
// product whose contraction runs over the accumulator's columns: k16 step
// kk takes columns [16 kk, 16 kk + 16).
template <int N>
__device__ __forceinline__ void acc_to_frag(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16x2(acc[8 * kk + 0], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// The largest of a row's values over the four threads that hold it.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- the ring -----------------------------------------------------------------

// The block's barriers: a ring of S stages (`full` completes when a
// stage's loads have landed, `empty` when both consumer warpgroups are done
// with it; `meta` is the walk's position held in the stage, -1 ends the
// walk), and one barrier for the block's resident tiles.
template <int S>
struct Ring {
  uint64_t full[S], empty[S], resident;
  int meta[S];
  int flags[8];  // forward: a consumer warp holds a row with no allowed key
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

template <int S>
__device__ __forceinline__ void init_ring(Ring<S>* ring) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&ring->full[s], 1);
      mbar_init(&ring->empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(&ring->resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Producer: waits until stage it % S is free, records `meta` in it and arms
// its `full` barrier for `bytes`; the caller then issues the loads.
template <int S>
__device__ __forceinline__ int begin_stage(Ring<S>* ring, int it, int meta, int bytes) {
  const int s = it % S;
  mbar_wait(&ring->empty[s], ((it / S) & 1) ^ 1);
  ring->meta[s] = meta;
  mbar_expect_tx(&ring->full[s], bytes);
  return s;
}

// Producer: the sentinel stage that ends the walk.
template <int S>
__device__ __forceinline__ void end_walk(Ring<S>* ring, int it) {
  const int s = it % S;
  mbar_wait(&ring->empty[s], ((it / S) & 1) ^ 1);
  ring->meta[s] = -1;
  mbar_arrive(&ring->full[s]);
}

// Consumer: waits for stage it % S; returns its meta (-1: the walk is over).
template <int S>
__device__ __forceinline__ int wait_stage(Ring<S>* ring, int it) {
  const int s = it % S;
  mbar_wait(&ring->full[s], (it / S) & 1);
  return ring->meta[s];
}

constexpr int kBwdProducerRegs = 24;   // dK/dV: its consumers hold dK and dV
constexpr int kBwdConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65536

// -- forward ------------------------------------------------------------------

template <int D>
struct FwdCfg {
  // a stage is held from its S product to its P V, across a softmax: at
  // least 3 stages keep one load in flight (231.5 KB a block at D 128)
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kFwdKeys * D * 2;  // each of K and V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kSmem =
      1024 + kQBytes + kStages * kStageBytes + (int)sizeof(Ring<kStages>) + 2 * 128 * 4;
  static_assert(kSmem <= 232448, "a block has at most 227 KB of shared memory");
};

struct FwdArgs {
  const bf16* v;  // read again for the rows with no allowed key
  bf16* o;
  float* lse;
  int H, n_rep, L;
  float scale;
};

// One block: 128 query rows of head bh against the K/V tiles of their
// band, 128 keys a tile; O and lse.
template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const FwdArgs a,
                    const typename Mask::Params mp) {
  using C = FwdCfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* skv = sq + C::kQBytes;
  Ring<S>* ring = reinterpret_cast<Ring<S>*>(skv + S * C::kStageBytes);
  float* colsum = reinterpret_cast<float*>(ring + 1);  // [2][128]

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int kvh = b * (a.H / a.n_rep) + (bh % a.H) / a.n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest rows first
  const Mask mask(mp, b, a.L);
  init_ring(ring);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(&ring->resident, C::kQBytes);
      load_tile<kRows, D>(&map_q, sq, &ring->resident, q0, bh);
      const int k_end = min(a.L, q0 + kRows);
      int it = 0;
      for (int k0 = mask.key_begin(q0) / kFwdKeys * kFwdKeys; k0 < k_end; k0 += kFwdKeys, ++it) {
        const int s = begin_stage(ring, it, k0, C::kStageBytes);
        unsigned char* st = skv + s * C::kStageBytes;
        load_tile<kFwdKeys, D>(&map_k, st, &ring->full[s], k0, kvh);
        load_tile<kFwdKeys, D>(&map_v, st + C::kKVBytes, &ring->full[s], k0, kvh);
      }
      end_walk(ring, it);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, tq = lane % 4;
    const int i0 = q0 + 64 * cw;
    const int r_lo = i0 + 16 * w + lane / 4;  // this thread's rows: r_lo, r_lo + 8
    const int qv[2] = {mask.query_val(r_lo), mask.query_val(r_lo + 8)};
    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float sc[kFwdKeys / 2];
    uint32_t pa[kFwdKeys / 16][4];
    // S = Q K^T of the tile in stage s, issued (the caller commits)
    auto issue_s = [&](int s) {
      const unsigned char* ks = skv + s * C::kStageBytes;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wgmma_ss(sc, kmajor<kRows>(sq, 64 * cw, j), kmajor<kFwdKeys>(ks, 0, j), j);
      }
    };
    // the mask and the online softmax of the scores in sc (keys k0 ...):
    // sc becomes the unnormalised P, m and l move on, corr rescales O
    const float scale2 = a.scale * kLog2e;
    auto softmax = [&](int k0, float (&corr)[2]) {
      if (mask.partial(i0, i0 + 64, k0, k0 + kFwdKeys)) {
#pragma unroll
        for (int x = 0; x < kFwdKeys / 2; ++x) {
          const int hh = (x / 2) % 2;
          const int j = k0 + 8 * (x / 4) + 2 * tq + (x & 1);
          sc[x] = j >= a.L ? -INFINITY
                           : (mask.allowed(r_lo + 8 * hh, qv[hh], j, mask.key_val(j))
                                  ? sc[x] * scale2
                                  : kMasked2);
        }
      } else {
#pragma unroll
        for (int x = 0; x < kFwdKeys / 2; ++x) sc[x] *= scale2;
      }
      // each row's max and sum in four partial chains: a single chain of
      // 32 dependent operations a thread leaves the two warps of each
      // scheduler waiting on latency
      float mx[2][4];
#pragma unroll
      for (int u = 0; u < 8; ++u) mx[u / 4][u % 4] = -INFINITY;
#pragma unroll
      for (int x = 0; x < kFwdKeys / 2; ++x) {
        mx[(x / 2) % 2][(x / 4) % 4] = fmaxf(mx[(x / 2) % 2][(x / 4) % 4], sc[x]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float tile_max = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
        const float m_new = fmaxf(m[hh], quad_max(tile_max));
        corr[hh] = exp2_approx(m[hh] - m_new);  // 0 on the first tile (m = -inf)
        m[hh] = m_new;
      }
      float ls[2][4] = {};
#pragma unroll
      for (int x = 0; x < kFwdKeys / 2; ++x) {
        const int hh = (x / 2) % 2;
        const float p = exp2_approx(sc[x] - m[hh]);
        sc[x] = p;
        ls[hh][(x / 4) % 4] += p;  // this thread's share; the quad's are summed at the end
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = l[hh] * corr[hh] + ((ls[hh][0] + ls[hh][1]) + (ls[hh][2] + ls[hh][3]));
      }
    };
    mbar_wait(&ring->resident, 0);
    float corr[2];
    int k0 = wait_stage(ring, 0);  // the walk holds at least one tile
    if (cw == 1) turn_pass(1);     // the first consumer warpgroup issues first
    turn_wait(cw);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_acc(sc);
    softmax(k0, corr);
    acc_to_frag<kFwdKeys>(pa, sc);  // P rounded to bf16 before P V, as the JAX kernels
    // Tile it's S product and tile it - 1's P V run on the tensor cores
    // while tile it's softmax runs; O is rescaled once P V is done.
    int it = 1;
    for (;; ++it) {
      const int prev = (it - 1) % S;
      k0 = wait_stage(ring, it);
      if (k0 < 0) break;
      turn_wait(cw);
      wgmma_fence();
      issue_s(it % S);
      wgmma_commit();
      const unsigned char* vs = skv + prev * C::kStageBytes + C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) wgmma_rs(o, pa[kk], mnmajor<kFwdKeys>(vs, kk), 1);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<1>();  // S is done; P V may still run
      fence_acc(sc);
      softmax(k0, corr);
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(pa);
      if (t == 0) mbar_arrive(&ring->empty[prev]);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] *= corr[(x / 2) % 2];
      acc_to_frag<kFwdKeys>(pa, sc);
    }
    {  // the last tile's P V
      const int prev = (it - 1) % S;
      const unsigned char* vs = skv + prev * C::kStageBytes + C::kKVBytes;
      turn_wait(cw);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk) wgmma_rs(o, pa[kk], mnmajor<kFwdKeys>(vs, kk), 1);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(pa);
      if (t == 0) mbar_arrive(&ring->empty[prev]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
    if (Mask::kFlagRows && mask.has_key_mask()) {
      // a row whose every score is masked: P = 1 on all L keys, O = mean of V
      const bool f = __any_sync(0xffffffffu, m[0] == kMasked2 || m[1] == kMasked2);
      if (lane == 0) ring->flags[4 * cw + w] = f;
      warpgroup_sync(1 + cw);
      const int* fl = ring->flags + 4 * cw;
      if (fl[0] | fl[1] | fl[2] | fl[3]) {
        constexpr int kParts = 128 / D;
        float* cs = colsum + 128 * cw;
        const bf16* vh = a.v + (size_t)kvh * a.L * D;
        float acc = 0.f;
        for (int j = t / D; j < a.L; j += kParts) {
          acc += __bfloat162float(vh[(size_t)j * D + t % D]);
        }
        cs[t] = acc;
        warpgroup_sync(1 + cw);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (m[hh] != kMasked2) continue;
#pragma unroll
          for (int x = 0; x < D / 2; ++x) {
            if ((x / 2) % 2 != hh) continue;
            const int col = 8 * (x / 4) + 2 * tq + (x & 1);
            float sum = 0.f;
#pragma unroll
            for (int part_ = 0; part_ < kParts; ++part_) sum += cs[part_ * D + col];
            o[x] = sum;
          }
          l[hh] = (float)a.L;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= a.L) continue;
      const float inv = 1.f / l[hh];
      bf16* out = a.o + ((size_t)bh * a.L + row) * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(out + 8 * jj) =
            pack_bf16x2(o[4 * jj + 2 * hh] * inv, o[4 * jj + 2 * hh + 1] * inv);
      }
      // a row with no allowed key: lse = -1e9 + log L, as JAX's (-1e9 in float32)
      const float m_nat = m[hh] == kMasked2 ? kMasked : m[hh] * kLn2;
      if (tq == 0) a.lse[(size_t)bh * a.L + row] = m_nat + logf(l[hh]);
    }
  }
}

// -- backward: dQ --------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kQBytes = kRows * D * 2;  // each of Q and dO
  static constexpr int kKVBytes = kStep * D * 2;  // each of K and V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kSmem =
      1024 + 2 * kQBytes + kStages * kStageBytes + (int)sizeof(Ring<kStages>);
  static_assert(kSmem <= 232448, "a block has at most 227 KB of shared memory");
};

struct BwdArgs {
  const float* lse;
  const float* delta;
  bf16* out0;  // dQ, or dK
  bf16* out1;  // dV
  int H, n_rep, L;
  float scale;
};

// One block: dQ of 128 query rows of head bh over the K/V tiles of their
// band, 64 keys a tile (all of them where a row has no allowed key).
template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do, const BwdArgs a,
                       const typename Mask::Params mp) {
  using C = DqCfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* sdo = sq + C::kQBytes;
  unsigned char* skv = sdo + C::kQBytes;
  Ring<S>* ring = reinterpret_cast<Ring<S>*>(skv + S * C::kStageBytes);

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int kvh = b * (a.H / a.n_rep) + (bh % a.H) / a.n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const Mask mask(mp, b, a.L);
  init_ring(ring);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      bool widen = false;
      if (Mask::kFlagRows && mask.has_key_mask()) {
        bool f = false;
        for (int r = q0 + threadIdx.x; r < min(a.L, q0 + kRows); r += 32) {
          f |= a.lse[(size_t)bh * a.L + r] <= kFlagLse;
        }
        widen = __any_sync(0xffffffffu, f);
      }
      if (threadIdx.x == 0) {
        mbar_expect_tx(&ring->resident, 2 * C::kQBytes);
        load_tile<kRows, D>(&map_q, sq, &ring->resident, q0, bh);
        load_tile<kRows, D>(&map_do, sdo, &ring->resident, q0, bh);
        const int k_end = widen ? a.L : min(a.L, q0 + kRows);
        int it = 0;
        for (int k0 = widen ? 0 : mask.key_begin(q0) / kStep * kStep; k0 < k_end;
             k0 += kStep, ++it) {
          const int s = begin_stage(ring, it, k0, C::kStageBytes);
          unsigned char* st = skv + s * C::kStageBytes;
          load_tile<kStep, D>(&map_k, st, &ring->full[s], k0, kvh);
          load_tile<kStep, D>(&map_v, st + C::kKVBytes, &ring->full[s], k0, kvh);
        }
        end_walk(ring, it);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, tq = lane % 4;
    const int i0 = q0 + 64 * cw;
    const int r_lo = i0 + 16 * w + lane / 4;
    int qv[2];
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      const bool in = row < a.L;  // rows past L: zeros from TMA, dS = 0
      qv[hh] = mask.query_val(row);
      lse_r[hh] = in ? a.lse[(size_t)bh * a.L + row] : 0.f;
      delta_r[hh] = in ? a.delta[(size_t)bh * a.L + row] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
    mbar_wait(&ring->resident, 0);
    for (int it = 0;; ++it) {
      const int k0 = wait_stage(ring, it);
      if (k0 < 0) break;
      const int s = it % S;
      const unsigned char* ks = skv + s * C::kStageBytes;
      const unsigned char* vs = ks + C::kKVBytes;
      float sc[kStep / 2], dp[kStep / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wgmma_ss(sc, kmajor<kRows>(sq, 64 * cw, j), kmajor<kStep>(ks, 0, j), j);
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wgmma_ss(dp, kmajor<kRows>(sdo, 64 * cw, j), kmajor<kStep>(vs, 0, j), j);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      if (mask.partial(i0, i0 + 64, k0, k0 + kStep)) {
#pragma unroll
        for (int x = 0; x < kStep / 2; ++x) {
          const int hh = (x / 2) % 2;
          const int j = k0 + 8 * (x / 4) + 2 * tq + (x & 1);
          sc[x] = mask.allowed(r_lo + 8 * hh, qv[hh], j, mask.key_val(j)) ? sc[x] * a.scale
                                                                          : kMasked;
        }
      } else {
#pragma unroll
        for (int x = 0; x < kStep / 2; ++x) sc[x] *= a.scale;
      }
#pragma unroll
      for (int x = 0; x < kStep / 2; ++x) {
        const int hh = (x / 2) % 2;
        const float p = exp2_approx((sc[x] - lse_r[hh]) * kLog2e);
        float ds = p * (dp[x] - delta_r[hh]);
        if (Mask::kScaleInDs) ds *= a.scale;
        sc[x] = ds;  // rounded to bf16 by acc_to_frag
      }
      uint32_t da[kStep / 16][4];
      acc_to_frag<kStep>(da, sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) wgmma_rs(dq, da[kk], mnmajor<kStep>(ks, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
      fence_frag(da);
      if (t == 0) mbar_arrive(&ring->empty[s]);
    }
    const float mul = Mask::kScaleInDs ? 1.f : a.scale;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= a.L) continue;
      bf16* out = a.out0 + ((size_t)bh * a.L + row) * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(out + 8 * jj) =
            pack_bf16x2(dq[4 * jj + 2 * hh] * mul, dq[4 * jj + 2 * hh + 1] * mul);
      }
    }
  }
}

// -- backward: dK, dV (summed over the n_rep q heads of each KV head) ----------

template <int D>
struct DkvCfg {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kKBytes = kRows * D * 2;  // each of K and V, resident
  static constexpr int kQBytes = kStep * D * 2;  // each of Q and dO, a step
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kRowBytes = kStep * 4;  // each of lse and delta, a step
  static constexpr int kSmem = 1024 + 2 * kKBytes + kStages * (kStageBytes + 2 * kRowBytes) +
                               (int)sizeof(Ring<kStages>);
  static_assert(kSmem <= 232448, "a block has at most 227 KB of shared memory");
};

// One block: dK and dV of 128 keys of KV head bkv over the q steps (64
// queries) of the n_rep q heads that see them, and over the steps that
// hold a row with no allowed key.
template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, const BwdArgs a,
                         const typename Mask::Params mp) {
  using C = DkvCfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1024(smem_raw);
  unsigned char* sv = sk + C::kKBytes;
  unsigned char* sst = sv + C::kKBytes;  // stages: Q, dO
  float* srow = reinterpret_cast<float*>(sst + S * C::kStageBytes);  // [S][2][kStep]: lse, delta
  Ring<S>* ring = reinterpret_cast<Ring<S>*>(srow + S * 2 * kStep);

  const int Hkv = a.H / a.n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int k0 = blockIdx.x * kRows;  // the keys seen by the most rows first
  const Mask mask(mp, b, a.L);
  init_ring(ring);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(&ring->resident, 2 * C::kKBytes);
        load_tile<kRows, D>(&map_k, sk, &ring->resident, k0, bkv);
        load_tile<kRows, D>(&map_v, sv, &ring->resident, k0, bkv);
      }
      const int n_steps = a.L / kStep;
      const int s_begin = k0 / kStep;
      const int s_end = (min(a.L, mask.query_end(k0 + kRows - 1)) + kStep - 1) / kStep;
      const bool scan = Mask::kFlagRows && mask.has_key_mask();
      int it = 0;
      for (int r = 0; r < a.n_rep; ++r) {
        const int bh = b * a.H + hk * a.n_rep + r;
        for (int c0 = scan ? 0 : s_begin; c0 < (scan ? n_steps : s_end); c0 += 32) {
          unsigned flagged = 0;
          if (scan) {  // steps outside the band that hold a row with no allowed key
            const int st = c0 + lane;
            bool f = false;
            if (st < n_steps && (st < s_begin || st >= s_end)) {
              const float4* p =
                  reinterpret_cast<const float4*>(a.lse + (size_t)bh * a.L + st * kStep);
              for (int x = 0; x < kStep / 4; ++x) {
                const float4 v = p[x];
                f |= fminf(fminf(v.x, v.y), fminf(v.z, v.w)) <= kFlagLse;
              }
            }
            flagged = __ballot_sync(0xffffffffu, f);
          }
          if (lane == 0) {
            const int c1 = min(c0 + 32, scan ? n_steps : s_end);
            for (int st = c0; st < c1; ++st) {
              if ((st < s_begin || st >= s_end) && !((flagged >> (st - c0)) & 1u)) continue;
              const int q0 = st * kStep;
              const int s = begin_stage(ring, it++, q0, C::kStageBytes + 2 * C::kRowBytes);
              unsigned char* stq = sst + s * C::kStageBytes;
              float* rows = srow + s * 2 * kStep;
              load_tile<kStep, D>(&map_q, stq, &ring->full[s], q0, bh);
              load_tile<kStep, D>(&map_do, stq + C::kQBytes, &ring->full[s], q0, bh);
              const size_t at = (size_t)bh * a.L + q0;
              bulk_load(rows, a.lse + at, C::kRowBytes, &ring->full[s]);
              bulk_load(rows + kStep, a.delta + at, C::kRowBytes, &ring->full[s]);
            }
          }
          __syncwarp();
        }
      }
      if (lane == 0) end_walk(ring, it);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, tq = lane % 4;
    const int j0 = k0 + 64 * cw;
    const int j_lo = j0 + 16 * w + lane / 4;  // this thread's keys: j_lo, j_lo + 8
    const int kv[2] = {mask.key_val(j_lo), mask.key_val(j_lo + 8)};
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
    mbar_wait(&ring->resident, 0);
    for (int it = 0;; ++it) {
      const int q0 = wait_stage(ring, it);
      if (q0 < 0) break;
      const int s = it % S;
      const unsigned char* qs = sst + s * C::kStageBytes;
      const unsigned char* dos = qs + C::kQBytes;
      const float* ls = srow + s * 2 * kStep;
      const float* dl = ls + kStep;
      float st[kStep / 2], dpt[kStep / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wgmma_ss(st, kmajor<kRows>(sk, 64 * cw, j), kmajor<kStep>(qs, 0, j), j);
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wgmma_ss(dpt, kmajor<kRows>(sv, 64 * cw, j), kmajor<kStep>(dos, 0, j), j);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      if (mask.partial(q0, q0 + kStep, j0, j0 + 64)) {
#pragma unroll
        for (int x = 0; x < kStep / 2; ++x) {
          const int hh = (x / 2) % 2;
          const int i = q0 + 8 * (x / 4) + 2 * tq + (x & 1);
          st[x] = mask.allowed(i, mask.query_val(i), j_lo + 8 * hh, kv[hh]) ? st[x] * a.scale
                                                                          : kMasked;
        }
      } else {
#pragma unroll
        for (int x = 0; x < kStep / 2; ++x) st[x] *= a.scale;
      }
#pragma unroll
      for (int x = 0; x < kStep / 2; ++x) {
        const int col = 8 * (x / 4) + 2 * tq + (x & 1);  // the query q0 + col
        const float p = exp2_approx((st[x] - ls[col]) * kLog2e);
        float ds = p * (dpt[x] - dl[col]);
        if (Mask::kScaleInDs) ds *= a.scale;
        st[x] = p;    // P^T, rounded to bf16 by acc_to_frag
        dpt[x] = ds;  // dS^T
      }
      uint32_t pa[kStep / 16][4], da[kStep / 16][4];
      acc_to_frag<kStep>(pa, st);
      acc_to_frag<kStep>(da, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) wgmma_rs(dv, pa[kk], mnmajor<kStep>(dos, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) wgmma_rs(dk, da[kk], mnmajor<kStep>(qs, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      fence_frag(pa);
      fence_frag(da);
      if (t == 0) mbar_arrive(&ring->empty[s]);
    }
    const float mul = Mask::kScaleInDs ? 1.f : a.scale;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j_lo + 8 * hh;
      if (j >= a.L) continue;
      const size_t at = ((size_t)bkv * a.L + j) * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(a.out0 + at + 8 * jj) =
            pack_bf16x2(dk[4 * jj + 2 * hh] * mul, dk[4 * jj + 2 * hh + 1] * mul);
        *reinterpret_cast<uint32_t*>(a.out1 + at + 8 * jj) =
            pack_bf16x2(dv[4 * jj + 2 * hh], dv[4 * jj + 2 * hh + 1]);
      }
    }
  }
}

// -- host side ----------------------------------------------------------------

// The tensor map of a contiguous bf16 [slices, L, D] tensor, boxes of
// box_rows x 64 at the 128-byte swizzle; rows past L read as zeros. The
// tensor's device must be bound in this thread (bind_device_of).
inline bool make_map_3d(CUtensorMap* map, const void* ptr, int D, int L, int slices,
                        int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || L < 1 || slices < 1) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline unsigned row_tiles(int L) { return (unsigned)((L + kRows - 1) / kRows); }

// The launchers: bf16 q [B, H, L, D], k, v [B, Hkv, L, D] (and dO like q,
// lse and delta float32 [B, H, L]), every pointer on q's device, whose
// context they bind first (autograd's worker thread may have none). Each
// returns the launch's error.
template <int D, class Mask>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int H, int Hkv, int L, float scale, const typename Mask::Params& mp,
                       cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  if (!bind_device_of(q) || !make_map_3d(&mq, q, D, L, B * H, kRows) ||
      !make_map_3d(&mk, k, D, L, B * Hkv, kFwdKeys) ||
      !make_map_3d(&mv, v, D, L, B * Hkv, kFwdKeys)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attn_fwd_kernel<D, Mask>;
  const cudaError_t err = allow_smem(kernel, FwdCfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const FwdArgs a{static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
                  H, H / Hkv, L, scale};
  kernel<<<dim3(row_tiles(L), B * H), kThreads, FwdCfg<D>::kSmem, s>>>(mq, mk, mv, a, mp);
  return cudaGetLastError();
}

template <int D, class Mask>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                          int L, float scale, const typename Mask::Params& mp, cudaStream_t s) {
  CUtensorMap mq, mk, mv, md;
  if (!bind_device_of(q) || !make_map_3d(&mq, q, D, L, B * H, kRows) ||
      !make_map_3d(&mk, k, D, L, B * Hkv, kStep) || !make_map_3d(&mv, v, D, L, B * Hkv, kStep) ||
      !make_map_3d(&md, dout, D, L, B * H, kRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attn_bwd_dq_kernel<D, Mask>;
  const cudaError_t err = allow_smem(kernel, DqCfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const BwdArgs a{static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<bf16*>(dq), nullptr, H, H / Hkv, L, scale};
  kernel<<<dim3(row_tiles(L), B * H), kThreads, DqCfg<D>::kSmem, s>>>(mq, mk, mv, md, a, mp);
  return cudaGetLastError();
}

template <int D, class Mask>
cudaError_t launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                            int Hkv, int L, float scale, const typename Mask::Params& mp,
                            cudaStream_t s) {
  CUtensorMap mq, mk, mv, md;
  if (!bind_device_of(q) || !make_map_3d(&mq, q, D, L, B * H, kStep) ||
      !make_map_3d(&mk, k, D, L, B * Hkv, kRows) || !make_map_3d(&mv, v, D, L, B * Hkv, kRows) ||
      !make_map_3d(&md, dout, D, L, B * H, kStep)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attn_bwd_dkdv_kernel<D, Mask>;
  const cudaError_t err = allow_smem(kernel, DkvCfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const BwdArgs a{static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, H / Hkv, L, scale};
  kernel<<<dim3(row_tiles(L), B * Hkv), kThreads, DkvCfg<D>::kSmem, s>>>(mq, mk, mv, md, a, mp);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace hopper
