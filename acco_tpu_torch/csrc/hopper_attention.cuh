// One Hopper attention mainloop for the bf16 kernels of K5 (flash_attention.cu:
// causal + segment ids), K1 (fused_attention.cu: causal + window + key
// pads), K2 (banded_attention.cu: a static band) and K4 (block_attention.cu:
// one ring hop's block, unmasked, causal or by positions, with its row
// statistics), which differ only in the mask policy given as a template
// parameter. Built on hopper_gemm.cuh's mbarrier, TMA, descriptor and wgmma
// helpers.
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
// Tensor maps are rank 3, (D, Lq or Lk, B * heads), so TMA zero-fills the
// rows past the end of a 128-row tile when a length is a multiple of 64 but
// not of 128; rows past Lq are never stored, and keys past Lk are masked to
// -inf in the forward (they must not count even for a row with no allowed
// key).
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
//                                     after the sum (K1, K2, K4)
//   kFlagRows                         a row may have no allowed key (K1's
//                                     pads, K4's positions): its scores
//                                     are all -1e9, and the reference takes
//                                     P = 1 on all Lk keys
//   kStats                            K4's block statistics: the forward
//                                     writes o float32 and unnormalised, m
//                                     (in lse's place), l and the count of
//                                     ties at m; the backward takes m for
//                                     lse and dl for delta, dS = P (dP + dl)
//                                     + [s == m] c, 0 where masked
//   kExactP                           the forward walks the band twice: S
//                                     alone for the row max and sum, then
//                                     the normalised P rounded to bf16
//                                     before P V (K2, as the JAX kernel)
//   kBounds                           the walks skip the tiles whose spans
//                                     of positions (qpos, kpos) allow no
//                                     pair (K4's positional mask)
//   Mask(const Params&, int b, int Lq, int Lk)
//   has_key_mask()                    per-key data (segment ids, pads,
//                                     positions)
//   key_begin(q0), key_end(q1)        the band of rows [q0, q1): the first
//                                     key rows >= q0 may see, one past the
//                                     last key rows < q1 may see
//   query_begin(k0), query_end(k)     the first query that may see a key
//                                     >= k0; one past the last query that
//                                     key k may be seen by
//   partial(i0, i1, j0, j1)           some pair of rows [i0, i1) x keys
//                                     [j0, j1) is masked (or past Lq, Lk)
//   query_val(i), key_val(j)          per-row data for allowed(), 0 past
//                                     the end
//   allowed(i, qv, j, kv)
//   q_span(i0, i1), k_span(j0, j1)    kBounds: the (min, max) of the
//                                     positions of rows [i0, i1) (keys [j0,
//                                     j1)), i0 (j0) below the length
//   meets(qspan, kspan)               kBounds: a query whose position lies
//                                     in qspan may see a key in kspan
// Masked scores are -1e9 (the JAX kernels' value), so P = exp(s - lse)
// keeps JAX's arithmetic for a row with no allowed key: lse = -1e9 and
// P = 1 on every key. The forward gives such a row the sum of V over all
// Lk keys (a pass over V, only in a warpgroup that holds one; K1 then
// divides by l = Lk: the mean); K1's dQ walks all key tiles in a block that
// holds one, and dK/dV the q steps that hold one, only where one is (found
// from lse, or m).
//
// K4's forward keeps its scores as the raw accumulator Q K^T (the others
// scale them into log2 units): with scale > 0 the raw max and its ties are
// those of s = scale * raw, and m = scale * max is, bit for bit, the s that
// the backward's products give at the maximum, so that [s == m] finds the
// forward's ties. A masked raw score is -1e9 there.

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
// meta + kMetaFlag: a stage of the forward's first walk (kExactP), or a q
// step that dK/dV walks only for its rows with no allowed key (kStats)
constexpr int kMetaFlag = 1 << 30;

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

// -- walks ---------------------------------------------------------------------

// Producer warp, all lanes: a walk over the key tiles of Tile keys from
// k_first up to k_end (both multiples of Tile, or k_end the length) for
// the rows [q0, q1), from ring position `it`: K and V of each tile go into
// the ring (lane 0), in order, with meta k0 + `flag`, but a tile whose
// keys' positions no row's may meet (kBounds: the lanes test 32 tiles at
// a time) is skipped; the walk holds at least one tile. Without kBounds
// lane 0 walks alone, the other lanes leave at once. Returns the ring
// position after the walk (lane 0).
template <int D, int Tile, int S, class Mask>
__device__ __forceinline__ int walk_keys(Ring<S>* ring, unsigned char* skv, const CUtensorMap* mk,
                                         const CUtensorMap* mv, const Mask& mask, int q0, int q1,
                                         int k_first, int k_end, int kvh, int it, int flag) {
  constexpr int kKVBytes = Tile * D * 2;
  const int lane = threadIdx.x % 32;
  int2 qs = make_int2(0, 0);
  if constexpr (Mask::kBounds) qs = mask.q_span(q0, q1);
  const int it0 = it;
  auto issue = [&](int k0) {  // the forward's first walk (kMetaFlag) reads no V
    const bool with_v = flag != kMetaFlag;
    const int s = begin_stage(ring, it++, k0 + flag, (with_v ? 2 : 1) * kKVBytes);
    unsigned char* st = skv + s * 2 * kKVBytes;
    load_tile<Tile, D>(mk, st, &ring->full[s], k0, kvh);
    if (with_v) load_tile<Tile, D>(mv, st + kKVBytes, &ring->full[s], k0, kvh);
  };
  if constexpr (Mask::kBounds) {
    for (int c0 = k_first; c0 < k_end; c0 += 32 * Tile) {
      const int t0 = c0 + lane * Tile;
      const unsigned bits = __ballot_sync(
          0xffffffffu, t0 < k_end && mask.meets(qs, mask.k_span(t0, t0 + Tile)));
      if (lane == 0) {
        for (int b = 0; b < 32 && c0 + b * Tile < k_end; ++b) {
          if ((bits >> b) & 1u) issue(c0 + b * Tile);
        }
      }
      __syncwarp();
    }
  } else if (lane == 0) {
    for (int k0 = k_first; k0 < k_end; k0 += Tile) issue(k0);
  }
  if (lane == 0 && it == it0) issue(k_first);
  return it;
}

// The sum over the n rows of vh (bf16 [n, D]) of each column, by the 128
// threads t of a consumer warpgroup (barrier `bar`), in the float scratch
// cs ((128 / (D / 8) + 1) * D floats): returns cs + the partial sums'
// size, where the D sums lie.
template <int D>
__device__ __forceinline__ const float* col_sums(const bf16* vh, int n, float* cs, int t, int bar) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kParts = 128 / kChunks;
  const int chunk = t % kChunks, part = t / kChunks;
  const uint4* src = reinterpret_cast<const uint4*>(vh) + chunk;
  float acc[8] = {};
#pragma unroll 8
  for (int j = part; j < n; j += kParts) {
    const uint4 x = __ldg(src + (size_t)j * kChunks);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      acc[2 * e] += f.x;
      acc[2 * e + 1] += f.y;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[part * D + 8 * chunk + e] = acc[e];
  warpgroup_sync(bar);
  float* sums = cs + kParts * D;
  if (t < D) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) s += cs[p * D + t];
    sums[t] = s;
  }
  warpgroup_sync(bar);
  return sums;
}

// -- forward ------------------------------------------------------------------

template <int D>
struct FwdCfg {
  // a stage is held from its S product to its P V, across a softmax: at
  // least 3 stages keep one load in flight (231.5 KB a block at D 128)
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kFwdKeys * D * 2;  // each of K and V
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + (int)sizeof(Ring<kStages>);
  static_assert(kSmem <= 232448, "a block has at most 227 KB of shared memory");
};

struct FwdArgs {
  const bf16* v;  // read again for the rows with no allowed key
  void* o;        // bf16 O; kStats: float32 o, unnormalised
  float* lse;     // lse; kStats: m
  float* l;       // kStats: the row sum
  float* cnt;     // kStats: the ties at the row max
  int H, n_rep, Lq, Lk;
  float scale;
};

// One block: 128 query rows of head bh against the K/V tiles of their
// band, 128 keys a tile; O and lse (K4: o, m, l and the ties).
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

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int kvh = b * (a.H / a.n_rep) + (bh % a.H) / a.n_rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest rows first
  const Mask mask(mp, b, a.Lq, a.Lk);
  init_ring(ring);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&ring->resident, C::kQBytes);
        load_tile<kRows, D>(&map_q, sq, &ring->resident, q0, bh);
      }
      const int k_first = mask.key_begin(q0) / kFwdKeys * kFwdKeys;
      const int k_end = mask.key_end(q0 + kRows);
      int it = 0;
      if constexpr (Mask::kExactP) {  // the first walk: S alone, for the row max and sum
        it = walk_keys<D, kFwdKeys>(ring, skv, &map_k, &map_v, mask, q0, q0 + kRows, k_first,
                                    k_end, kvh, it, kMetaFlag);
      }
      it = walk_keys<D, kFwdKeys>(ring, skv, &map_k, &map_v, mask, q0, q0 + kRows, k_first, k_end,
                                  kvh, it, 0);
      if (threadIdx.x == 0) end_walk(ring, it);
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
    float cnt[2] = {0.f, 0.f};  // K4: this thread's ties at the running max
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
    const float scale2 = a.scale * kLog2e;
    constexpr float kMaskedS = Mask::kStats ? kMasked : kMasked2;  // a masked score
    // the mask on the scores in sc (keys k0 ...), and their scale
    auto scores = [&](int k0) {
      if (mask.partial(i0, i0 + 64, k0, k0 + kFwdKeys)) {
#pragma unroll
        for (int x = 0; x < kFwdKeys / 2; ++x) {
          const int hh = (x / 2) % 2;
          const int j = k0 + 8 * (x / 4) + 2 * tq + (x & 1);
          sc[x] = j >= a.Lk ? -INFINITY
                            : (mask.allowed(r_lo + 8 * hh, qv[hh], j, mask.key_val(j))
                                   ? (Mask::kStats ? sc[x] : sc[x] * scale2)
                                   : kMaskedS);
        }
      } else if constexpr (!Mask::kStats) {
#pragma unroll
        for (int x = 0; x < kFwdKeys / 2; ++x) sc[x] *= scale2;
      }
    };
    // the mask and the online softmax of the scores in sc: sc becomes the
    // unnormalised P, m and l move on, corr rescales O
    auto online = [&](int k0, float (&corr)[2]) {
      scores(k0);
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
        if constexpr (Mask::kStats) {
          corr[hh] = exp2_approx((m[hh] - m_new) * scale2);
          if (m_new != m[hh]) cnt[hh] = 0.f;  // the running max rose: its ties are gone
        } else {
          corr[hh] = exp2_approx(m[hh] - m_new);  // 0 on the first tile (m = -inf)
        }
        m[hh] = m_new;
      }
      float ls[2][4] = {}, ties[2][4] = {};
#pragma unroll
      for (int x = 0; x < kFwdKeys / 2; ++x) {
        const int hh = (x / 2) % 2;
        float p;
        if constexpr (Mask::kStats) {
          p = exp2_approx((sc[x] - m[hh]) * scale2);
          ties[hh][(x / 4) % 4] += sc[x] == m[hh] ? 1.f : 0.f;
        } else {
          p = exp2_approx(sc[x] - m[hh]);
        }
        sc[x] = p;
        ls[hh][(x / 4) % 4] += p;  // this thread's share; the quad's are summed at the end
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = l[hh] * corr[hh] + ((ls[hh][0] + ls[hh][1]) + (ls[hh][2] + ls[hh][3]));
        if constexpr (Mask::kStats) {
          cnt[hh] += (ties[hh][0] + ties[hh][1]) + (ties[hh][2] + ties[hh][3]);
        }
      }
    };
    // kExactP: the second walk's P = exp(s - m) / l with the band's final m
    // and l, O's rescale 1
    float inv_l[2] = {1.f, 1.f};
    auto softmax = [&](int k0, float (&corr)[2]) {
      if constexpr (Mask::kExactP) {
        scores(k0);
#pragma unroll
        for (int x = 0; x < kFwdKeys / 2; ++x) {
          sc[x] = exp2_approx(sc[x] - m[(x / 2) % 2]) * inv_l[(x / 2) % 2];
        }
        corr[0] = corr[1] = 1.f;
      } else {
        online(k0, corr);
      }
    };
    mbar_wait(&ring->resident, 0);
    float corr[2];
    int it = 0;
    int k0 = wait_stage(ring, 0);  // the walk holds at least one tile
    if constexpr (Mask::kExactP) {
      // the first walk: the band's row max and sum from S alone, as the JAX
      // kernel's first passes, so that the second rounds the normalised P
      for (; k0 >= kMetaFlag; k0 = wait_stage(ring, ++it)) {
        wgmma_fence();
        issue_s(it % S);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sc);
        if (t == 0) mbar_arrive(&ring->empty[it % S]);
        online(k0 - kMetaFlag, corr);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = quad_sum(l[hh]);
        inv_l[hh] = 1.f / l[hh];
      }
    }
    if (cw == 1) turn_pass(1);  // the first consumer warpgroup issues first
    turn_wait(cw);
    wgmma_fence();
    issue_s(it % S);
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_acc(sc);
    softmax(k0, corr);
    acc_to_frag<kFwdKeys>(pa, sc);  // P rounded to bf16 before P V, as the JAX kernels
    // Tile it's S product and tile it - 1's P V run on the tensor cores
    // while tile it's softmax runs; O is rescaled once P V is done.
    for (++it;; ++it) {
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
    for (int hh = 0; hh < 2; ++hh) {
      if constexpr (!Mask::kExactP) l[hh] = quad_sum(l[hh]);
      if constexpr (Mask::kStats) cnt[hh] = quad_sum(cnt[hh]);
    }
    if (Mask::kFlagRows && mask.has_key_mask()) {
      // a row whose every score is masked: P = 1 on all Lk keys, o = the
      // sum of V (K1 then divides by l = Lk: the mean)
      const bool f = __any_sync(0xffffffffu, m[0] == kMaskedS || m[1] == kMaskedS);
      if (lane == 0) ring->flags[4 * cw + w] = f;
      warpgroup_sync(1 + cw);
      const int* fl = ring->flags + 4 * cw;
      if (fl[0] | fl[1] | fl[2] | fl[3]) {
        // the sums go through this warpgroup's own Q rows, which its
        // finished products no longer read
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const float* cs = col_sums<D>(a.v + (size_t)kvh * a.Lk * D, a.Lk,
                                      reinterpret_cast<float*>(sq + 64 * cw * 128), t, 1 + cw);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (m[hh] != kMaskedS) continue;
#pragma unroll
          for (int x = 0; x < D / 2; ++x) {
            if ((x / 2) % 2 == hh) o[x] = cs[8 * (x / 4) + 2 * tq + (x & 1)];
          }
          l[hh] = (float)a.Lk;
          cnt[hh] = (float)a.Lk;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      if (row >= a.Lq) continue;
      const size_t at = (size_t)bh * a.Lq + row;
      if constexpr (Mask::kStats) {
        float* out = static_cast<float*>(a.o) + at * D + 2 * tq;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<float2*>(out + 8 * jj) = make_float2(o[4 * jj + 2 * hh],
                                                                 o[4 * jj + 2 * hh + 1]);
        }
        if (tq == 0) {  // m = scale * the raw max, as the backward's s
          a.lse[at] = m[hh] == kMasked ? kMasked : m[hh] * a.scale;
          a.l[at] = l[hh];
          a.cnt[at] = cnt[hh];
        }
      } else {
        const float inv = Mask::kExactP ? 1.f : 1.f / l[hh];  // kExactP: P normalised
        bf16* out = static_cast<bf16*>(a.o) + at * D + 2 * tq;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(out + 8 * jj) =
              pack_bf16x2(o[4 * jj + 2 * hh] * inv, o[4 * jj + 2 * hh + 1] * inv);
        }
        // a row with no allowed key: lse = -1e9 + log L, as JAX's (-1e9 in float32)
        const float m_nat = m[hh] == kMasked2 ? kMasked : m[hh] * kLn2;
        if (tq == 0) a.lse[at] = m_nat + logf(l[hh]);
      }
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
  const float* lse;    // lse; kStats: m
  const float* delta;  // delta; kStats: dl
  const float* c;      // kStats: the tie term's row coefficient
  bf16* out0;          // dQ, or dK
  bf16* out1;          // dV
  int H, n_rep, Lq, Lk;
  float scale;
};

// dS of one pair from P, dP and its row's (or query's) values: K1, K2, K5:
// P (dP - delta); K4: P (dP + dl) + [s == m] c, 0 where masked (s the
// masked score, -1e9 there). Rounded to bf16 by the caller.
template <class Mask>
__device__ __forceinline__ float pair_ds(float p, float dp, float s, float lse, float delta,
                                         float c, float scale) {
  if constexpr (Mask::kStats) {
    return s == kMasked ? 0.f : p * (dp + delta) + (s == lse ? c : 0.f);
  } else {
    const float ds = p * (dp - delta);
    return Mask::kScaleInDs ? ds * scale : ds;
  }
}

// One block: dQ of 128 query rows of head bh over the K/V tiles of their
// band, 64 keys a tile (K1: all of them where a row has no allowed key).
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
  const Mask mask(mp, b, a.Lq, a.Lk);
  init_ring(ring);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      bool widen = false;  // K1: P = 1 on every key of a row with none allowed
      if (Mask::kFlagRows && !Mask::kStats && mask.has_key_mask()) {
        bool f = false;
        for (int r = q0 + threadIdx.x; r < min(a.Lq, q0 + kRows); r += 32) {
          f |= a.lse[(size_t)bh * a.Lq + r] <= kFlagLse;
        }
        widen = __any_sync(0xffffffffu, f);
      }
      if (threadIdx.x == 0) {
        mbar_expect_tx(&ring->resident, 2 * C::kQBytes);
        load_tile<kRows, D>(&map_q, sq, &ring->resident, q0, bh);
        load_tile<kRows, D>(&map_do, sdo, &ring->resident, q0, bh);
      }
      const int it = walk_keys<D, kStep>(ring, skv, &map_k, &map_v, mask, q0, q0 + kRows,
                                         widen ? 0 : mask.key_begin(q0) / kStep * kStep,
                                         widen ? a.Lk : mask.key_end(q0 + kRows), kvh, 0, 0);
      if (threadIdx.x == 0) end_walk(ring, it);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, w = t / 32, lane = t % 32, tq = lane % 4;
    const int i0 = q0 + 64 * cw;
    const int r_lo = i0 + 16 * w + lane / 4;
    int qv[2];
    float lse_r[2], delta_r[2], c_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r_lo + 8 * hh;
      const bool in = row < a.Lq;  // rows past Lq: zeros from TMA, dS = 0
      qv[hh] = mask.query_val(row);
      lse_r[hh] = in ? a.lse[(size_t)bh * a.Lq + row] : 0.f;
      delta_r[hh] = in ? a.delta[(size_t)bh * a.Lq + row] : 0.f;
      c_r[hh] = Mask::kStats && in ? a.c[(size_t)bh * a.Lq + row] : 0.f;
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
        // rounded to bf16 by acc_to_frag
        sc[x] = pair_ds<Mask>(p, dp[x], sc[x], lse_r[hh], delta_r[hh], c_r[hh], a.scale);
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
      if (row >= a.Lq) continue;
      bf16* out = a.out0 + ((size_t)bh * a.Lq + row) * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<uint32_t*>(out + 8 * jj) =
            pack_bf16x2(dq[4 * jj + 2 * hh] * mul, dq[4 * jj + 2 * hh + 1] * mul);
      }
    }
  }
}

// -- backward: dK, dV (summed over the n_rep q heads of each KV head) ----------

// R row vectors a q step: lse and delta (K4: m, dl and c).
template <int D, int R>
struct DkvCfg {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kKBytes = kRows * D * 2;  // each of K and V, resident
  static constexpr int kQBytes = kStep * D * 2;  // each of Q and dO, a step
  static constexpr int kStageBytes = 2 * kQBytes;
  static constexpr int kRowBytes = kStep * 4;  // each row vector, a step
  static constexpr int kSmem = 1024 + 2 * kKBytes + kStages * (kStageBytes + R * kRowBytes) +
                               (int)sizeof(Ring<kStages>);
  static_assert(kSmem <= 232448, "a block has at most 227 KB of shared memory");
};

// One block: dK and dV of 128 keys of KV head bkv over the q steps (64
// queries) of the n_rep q heads that see them, and over the steps that
// hold a row with no allowed key (P = 1 on every key).
template <int D, class Mask>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, const BwdArgs a,
                         const typename Mask::Params mp) {
  constexpr int R = Mask::kStats ? 3 : 2;
  using C = DkvCfg<D, R>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1024(smem_raw);
  unsigned char* sv = sk + C::kKBytes;
  unsigned char* sst = sv + C::kKBytes;  // stages: Q, dO
  float* srow = reinterpret_cast<float*>(sst + S * C::kStageBytes);  // [S][R][kStep]
  Ring<S>* ring = reinterpret_cast<Ring<S>*>(srow + S * R * kStep);

  const int Hkv = a.H / a.n_rep;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int k0 = blockIdx.x * kRows;  // the keys seen by the most rows first
  const Mask mask(mp, b, a.Lq, a.Lk);
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
      const int n_steps = a.Lq / kStep;
      const int s_begin = mask.query_begin(k0) / kStep;
      const int s_end = (min(a.Lq, mask.query_end(k0 + kRows - 1)) + kStep - 1) / kStep;
      const bool scan = Mask::kFlagRows && mask.has_key_mask();
      int2 ks = make_int2(0, 0);
      if constexpr (Mask::kBounds) ks = mask.k_span(k0, k0 + kRows);
      int it = 0;
      for (int r = 0; r < a.n_rep; ++r) {
        const int bh = b * a.H + hk * a.n_rep + r;
        for (int c0 = scan ? 0 : s_begin; c0 < (scan ? n_steps : s_end); c0 += 32) {
          const int st = c0 + lane;
          bool walk = st >= s_begin && st < s_end && st < n_steps;
          if constexpr (Mask::kBounds) {
            walk = walk && mask.meets(mask.q_span(st * kStep, st * kStep + kStep), ks);
          }
          bool flagged = false;
          if (scan && !walk && st < n_steps) {
            // a step outside the band that holds a row with no allowed key
            const float4* p =
                reinterpret_cast<const float4*>(a.lse + (size_t)bh * a.Lq + st * kStep);
            for (int x = 0; x < kStep / 4; ++x) {
              const float4 v = p[x];
              flagged |= fminf(fminf(v.x, v.y), fminf(v.z, v.w)) <= kFlagLse;
            }
          }
          const unsigned bits = __ballot_sync(0xffffffffu, walk || flagged);
          // K4: such a step's dS is 0 and its P the rows' flags (K1: a full step)
          const unsigned rows_only =
              Mask::kStats && Mask::kFlagRows ? __ballot_sync(0xffffffffu, flagged) : 0u;
          if (lane == 0) {
            for (int x = 0; x < 32; ++x) {
              if (!((bits >> x) & 1u)) continue;
              const int q0 = (c0 + x) * kStep;
              const int meta = q0 + ((rows_only >> x) & 1u ? kMetaFlag : 0);
              const int s = begin_stage(ring, it++, meta, C::kStageBytes + R * C::kRowBytes);
              unsigned char* stq = sst + s * C::kStageBytes;
              float* rows = srow + s * R * kStep;
              load_tile<kStep, D>(&map_q, stq, &ring->full[s], q0, bh);
              load_tile<kStep, D>(&map_do, stq + C::kQBytes, &ring->full[s], q0, bh);
              const size_t at = (size_t)bh * a.Lq + q0;
              bulk_load(rows, a.lse + at, C::kRowBytes, &ring->full[s]);
              bulk_load(rows + kStep, a.delta + at, C::kRowBytes, &ring->full[s]);
              if constexpr (Mask::kStats) {
                bulk_load(rows + 2 * kStep, a.c + at, C::kRowBytes, &ring->full[s]);
              }
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
      const int meta = wait_stage(ring, it);
      if (meta < 0) break;
      const int q0 = meta % kMetaFlag;
      const int s = it % S;
      const unsigned char* qs = sst + s * C::kStageBytes;
      const unsigned char* dos = qs + C::kQBytes;
      const float* ls = srow + s * R * kStep;
      const float* dl = ls + kStep;
      const float* cs = ls + 2 * kStep;  // kStats
      float st[kStep / 2], dpt[kStep / 2];
      if constexpr (Mask::kStats && Mask::kFlagRows) {
        if (meta >= kMetaFlag) {
          // a step whose pairs with these keys are all masked, walked for its
          // rows with no allowed key: P = 1 on their every key (0 on the
          // others' masked pairs), dS = 0, so only dV += P^T dO
#pragma unroll
          for (int x = 0; x < kStep / 2; ++x) {
            st[x] = ls[8 * (x / 4) + 2 * tq + (x & 1)] <= kFlagLse ? 1.f : 0.f;
          }
          uint32_t pa[kStep / 16][4];
          acc_to_frag<kStep>(pa, st);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kStep / 16; ++kk) {
            wgmma_rs(dv, pa[kk], mnmajor<kStep>(dos, kk), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dv);
          fence_frag(pa);
          if (t == 0) mbar_arrive(&ring->empty[s]);
          continue;
        }
      }
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
        if constexpr (Mask::kStats) {
          dpt[x] = pair_ds<Mask>(p, dpt[x], st[x], ls[col], dl[col], cs[col], a.scale);
        } else {
          float ds = p * (dpt[x] - dl[col]);
          if (Mask::kScaleInDs) ds *= a.scale;
          dpt[x] = ds;  // dS^T
        }
        st[x] = p;  // P^T, rounded to bf16 by acc_to_frag
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
      if (j >= a.Lk) continue;
      const size_t at = ((size_t)bkv * a.Lk + j) * D + 2 * tq;
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

// Sizes of a launch: q [B, H, Lq, D], k, v [B, Hkv, Lk, D].
struct Dims {
  int B, H, Hkv, Lq, Lk;
  float scale;
};

// The launchers: bf16 q, k, v (and dO like q; lse, delta and c float32
// [B, H, Lq]), every pointer on q's device, whose context they bind first
// (autograd's worker thread may have none). The forward writes o (bf16
// like q; kStats: float32) and lse (kStats: m, l and cnt). Each returns the
// launch's error.
template <int D, class Mask>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       float* l, float* cnt, const Dims& d, const typename Mask::Params& mp,
                       cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  if (!bind_device_of(q) || !make_map_3d(&mq, q, D, d.Lq, d.B * d.H, kRows) ||
      !make_map_3d(&mk, k, D, d.Lk, d.B * d.Hkv, kFwdKeys) ||
      !make_map_3d(&mv, v, D, d.Lk, d.B * d.Hkv, kFwdKeys)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attn_fwd_kernel<D, Mask>;
  const cudaError_t err = allow_smem(kernel, FwdCfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const FwdArgs a{static_cast<const bf16*>(v), o, lse, l, cnt, d.H, d.H / d.Hkv, d.Lq, d.Lk,
                  d.scale};
  kernel<<<dim3(row_tiles(d.Lq), d.B * d.H), kThreads, FwdCfg<D>::kSmem, s>>>(mq, mk, mv, a, mp);
  return cudaGetLastError();
}

template <int D, class Mask>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, const float* c, void* dq,
                          const Dims& d, const typename Mask::Params& mp, cudaStream_t s) {
  CUtensorMap mq, mk, mv, md;
  if (!bind_device_of(q) || !make_map_3d(&mq, q, D, d.Lq, d.B * d.H, kRows) ||
      !make_map_3d(&mk, k, D, d.Lk, d.B * d.Hkv, kStep) ||
      !make_map_3d(&mv, v, D, d.Lk, d.B * d.Hkv, kStep) ||
      !make_map_3d(&md, dout, D, d.Lq, d.B * d.H, kRows)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attn_bwd_dq_kernel<D, Mask>;
  const cudaError_t err = allow_smem(kernel, DqCfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const BwdArgs a{lse, delta, c, static_cast<bf16*>(dq), nullptr, d.H, d.H / d.Hkv, d.Lq, d.Lk,
                  d.scale};
  kernel<<<dim3(row_tiles(d.Lq), d.B * d.H), kThreads, DqCfg<D>::kSmem, s>>>(mq, mk, mv, md, a,
                                                                            mp);
  return cudaGetLastError();
}

template <int D, class Mask>
cudaError_t launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const float* c, void* dk,
                            void* dv, const Dims& d, const typename Mask::Params& mp,
                            cudaStream_t s) {
  using C = DkvCfg<D, Mask::kStats ? 3 : 2>;
  CUtensorMap mq, mk, mv, md;
  if (!bind_device_of(q) || !make_map_3d(&mq, q, D, d.Lq, d.B * d.H, kStep) ||
      !make_map_3d(&mk, k, D, d.Lk, d.B * d.Hkv, kRows) ||
      !make_map_3d(&mv, v, D, d.Lk, d.B * d.Hkv, kRows) ||
      !make_map_3d(&md, dout, D, d.Lq, d.B * d.H, kStep)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attn_bwd_dkdv_kernel<D, Mask>;
  const cudaError_t err = allow_smem(kernel, C::kSmem);
  if (err != cudaSuccess) return err;
  const BwdArgs a{lse, delta, c, static_cast<bf16*>(dk), static_cast<bf16*>(dv), d.H,
                  d.H / d.Hkv, d.Lq, d.Lk, d.scale};
  kernel<<<dim3(row_tiles(d.Lk), d.B * d.Hkv), kThreads, C::kSmem, s>>>(mq, mk, mv, md, a, mp);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace hopper
