// A Hopper GEMM mainloop: TMA into a ring of 128B-swizzled shared tiles,
// one producer warp, two consumer warpgroups on wgmma, and an epilogue
// given as a template parameter.
//
// One block computes a 128-row tile of C = A B over the whole K, for a run
// of consecutive BN-column tiles (BN 128 or 256: a vocab split of the
// fused CE, or one tile), and hands each finished [128, BN] float32 tile
// to the epilogue in the registers that wgmma left it in. Roles, 384
// threads:
//   warpgroup 0: one thread issues the TMA loads of stage after stage
//                (A's and B's 64-deep K slices) onto the `full` mbarrier
//                of their stage; the warpgroup gives its registers away
//                (setmaxnreg.dec);
//   warpgroups 1, 2: rows [0, 64) and [64, 128) of the tile: wait for a
//                stage, issue four m64nBNk16 wgmmas from shared memory into
//                BN / 2 float32 accumulators a thread, and hand the stage
//                back on its `empty` mbarrier once those wgmmas are done
//                (one wgmma group stays in flight).
// A stage holds A's [128 x 64] and B's [64 x BN] bf16 tiles, each written
// by TMA with the 128-byte swizzle that wgmma reads:
//   K-major operand (rows contiguous in K, as h [N, D] for h w^T): one box
//     of 128 (BN) rows x 64 K (128 bytes a row), rows 128 bytes apart, so
//     the descriptor's stride byte offset (between 8-row groups) is 1024
//     bytes; the k16 steps inside the 64-wide swizzle atom advance the
//     start address by 32 bytes;
//   MN-major operand (contiguous in M or N, as w [V, D] read as B of
//     dp w): boxes of 64 K rows x 64 MN (128 bytes a row), 8 KB apart (the
//     leading byte offset between 64-wide MN atoms), 8-row K groups 1024
//     bytes apart (the stride byte offset); a k16 step is 16 rows, 2048
//     bytes; wgmma's transpose bit reads it.
// TMA fills every element past the tensor's extent with zeros, so ragged
// M, N and K need no masking in the mainloop, and each stage's barrier
// expects the full box bytes.
//
// BN 256 makes a stage 48 KB and halves the shared-memory traffic per
// operation against BN 128 (the 128 x 128 tile needs more bytes a cycle
// from L2 than the card gives at the tensor cores' rate); BN 128 gives
// twice the tiles where BN 256 leaves the card's last wave half empty.
// Blocks are numbered in groups of `group` row tiles (the column runs
// inside a group vary slowest), so that the blocks resident together
// share both A's and B's tiles in L2.
//
// The tensor maps are made on the host with cuTensorMapEncodeTiled, taken
// from the driver through cudaGetDriverEntryPoint (nothing links libcuda),
// and passed by value as __grid_constant__ kernel parameters.
//
// Epilogue contract (Epi):
//   struct Params;                      kernel argument, by value
//   Epi(const Params&, int m0, int bn, int wg)
//                                       m0 the block's first row, bn its
//                                       column-run index, wg 0 or 1
//   template <int NA> void tile(const float (&acc)[NA], int n0)
//                                       the tile at columns [n0, n0 + BN),
//                                       NA = BN / 2: thread t = 32 w + l
//                                       of the warpgroup holds rows
//                                       16 w + l / 4 (acc[4 j + 0, 1]) and
//                                       + 8 (acc[4 j + 2, 3]) of its 64,
//                                       columns n0 + 8 j + 2 (l % 4) + {0, 1}
//   void finish()                       after the last tile

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows of a block's tile: two consumer warpgroups of 64
constexpr int kBK = 64;   // K of a stage: one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kATileBytes = kBM * kBK * 2;  // 16 KB: A's part of a stage
constexpr int kBoxBytes = 64 * kBK * 2;     // 8 KB: one 64 x 64 MN-major box
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int BN>
struct Tile {
  static_assert(BN == 128 || BN == 256, "BN 128 or 256");
  static constexpr int kBTileBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;  // each stage's barrier expects it
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

// Which blocks a launch runs: m_tiles x ceil(n_tiles / tiles_per_block),
// each walking `tiles_per_block` consecutive BN-column tiles over k_steps
// slices of K, numbered in groups of `group` row tiles.
struct GemmArgs {
  int m_tiles, n_tiles, k_steps, tiles_per_block, group;
};

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A 2-D box at element coordinates (c0 inner, c1 outer) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmmas that own them.
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units; base offset 0 (every
// stage tile starts on a 1024-byte boundary).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // SWIZZLE_128B
  return d;
}

// d += A (64 x 16) . B (16 x BN); kTransA / kTransB: the operand is
// MN-major in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// Descriptor of an operand's k16 step j of a stage tile, for the 64 rows
// (A) or BN columns (B) starting at `tile`: see the layouts above.
template <bool kMN>
__device__ __forceinline__ uint64_t step_desc(const bf16* tile, int j) {
  return kMN ? make_desc(reinterpret_cast<const char*>(tile) + j * 2048, kBoxBytes, 1024)
             : make_desc(reinterpret_cast<const char*>(tile) + j * 32, 16, 1024);
}

// Loads one operand's part of a stage: R rows (M or N) from `r0`, K from
// `k0`.
template <bool kMN, int R>
__device__ __forceinline__ void load_operand(const CUtensorMap* map, bf16* dst, uint64_t* bar,
                                             int r0, int k0) {
  if (kMN) {  // [K, MN] row-major: R / 64 boxes 64 wide
#pragma unroll
    for (int b = 0; b < R / 64; ++b) {
      tma_load(map, reinterpret_cast<char*>(dst) + b * kBoxBytes, bar, r0 + 64 * b, k0);
    }
  } else {  // [MN, K] row-major: one box of R rows
    tma_load(map, dst, bar, k0, r0);
  }
}

template <int BN, bool kAmn, bool kBmn, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    hopper_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, const GemmArgs g,
                       const typename Epi::Params p) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sa = base;                              // [kStages][128 x 64]
  unsigned char* sb = base + kStages * kATileBytes;      // [kStages][64 x BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;

  // block -> (row tile, column run), in groups of g.group row tiles
  const int runs = (g.n_tiles + g.tiles_per_block - 1) / g.tiles_per_block;
  const int per_group = g.group * runs;
  const int first_m = (blockIdx.x / per_group) * g.group;
  const int in_group = min(g.group, g.m_tiles - first_m);
  const int r = blockIdx.x % per_group;
  const int bm = first_m + r % in_group, bn = r / in_group;
  const int m0 = bm * kBM;
  const int t0 = bn * g.tiles_per_block;
  const int t1 = min(g.n_tiles, t0 + g.tiles_per_block);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = t0; t < t1; ++t) {
        for (int k = 0; k < g.k_steps; ++k, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kStageBytes);
          load_operand<kAmn, kBM>(&map_a, reinterpret_cast<bf16*>(sa + s * kATileBytes),
                                  &full[s], m0, k * kBK);
          load_operand<kBmn, BN>(&map_b, reinterpret_cast<bf16*>(sb + s * T::kBTileBytes),
                                 &full[s], t * BN, k * kBK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;  // rows [64 cw, 64 cw + 64) of the tile
    const bool leader = threadIdx.x % 128 == 0;
    Epi epi(p, m0, bn, cw);
    int it = 0;
    for (int t = t0; t < t1; ++t) {
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_acc(acc);
      for (int k = 0; k < g.k_steps; ++k, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        // A's rows of this warpgroup: 64 rows of a K-major box, or the
        // second 64-wide M box of an MN-major one; both 8 KB in
        const bf16* a = reinterpret_cast<const bf16*>(sa + s * kATileBytes + cw * kBoxBytes);
        const bf16* b = reinterpret_cast<const bf16*>(sb + s * T::kBTileBytes);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          wgmma<kAmn, kBmn>(acc, step_desc<kAmn>(a, j), step_desc<kBmn>(b, j), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's wgmmas are done: hand it back
        if (k > 0 && leader) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (g.k_steps > 0 && leader) mbar_arrive(&empty[(it - 1) % kStages]);
      epi.tile(acc, t * BN);
    }
    epi.finish();
  }
}

// -- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
  }
  return fn;
}

// Makes the context of the device that holds `ptr` current in this thread
// (and that device the runtime's current one, where the launch goes).
// cuTensorMapEncodeTiled needs a current context, and a thread whose first
// CUDA work is this call has none: autograd's worker thread, when this
// kernel is the first node of the backward.
inline bool bind_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess ||
      attr.type != cudaMemoryTypeDevice) {
    return false;
  }
  return cudaSetDevice(attr.device) == cudaSuccess;
}

// The tensor map of a row-major bf16 matrix [rows, cols] for one operand:
// K-major (K = cols): boxes of `box_rows` rows (128 for A, BN for B) x 64
// columns; MN-major (MN = cols): boxes of 64 rows (K) x 64 columns. False
// if the driver refused it (a row stride that is not a multiple of 16
// bytes, a misaligned base).
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, bool mn_major,
                     int box_rows = kBM) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || rows < 1 || cols < 1 || !bind_device_of(ptr)) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, mn_major ? 64u : static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device (0 if the runtime cannot say).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return n;
}

// The column tile for a launch of m_tiles row tiles over n columns, one
// tile a block: BN 256 unless its last wave leaves more of the card idle
// than BN 128's lower rate costs (taken as 15%).
inline int pick_bn(int m_tiles, int n) {
  const int sms = sm_count();
  if (sms <= 0) return 256;
  auto used = [&](int bn) {
    const long tiles = (long)m_tiles * ((n + bn - 1) / bn);
    const long waves = (tiles + sms - 1) / sms;
    return (double)tiles / (double)(waves * sms);
  };
  return used(256) >= 0.85 * used(128) ? 256 : 128;
}

// Launches C = A B on `s` with BN-column tiles: A [M, K] (K-major: a
// row-major [M, K] map) or [K, M] (MN-major), B [N, K] or [K, N] likewise.
// Returns the launch's error.
template <int BN, bool kAmn, bool kBmn, class Epi>
cudaError_t launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b, const GemmArgs& g,
                        const typename Epi::Params& p, cudaStream_t s) {
  auto kernel = hopper_gemm_kernel<BN, kAmn, kBmn, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<BN>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const long runs = (g.n_tiles + g.tiles_per_block - 1) / g.tiles_per_block;
  const long blocks = runs * g.m_tiles;
  if (g.m_tiles < 1 || runs < 1 || g.k_steps < 1 || g.group < 1 || blocks > 0x7fffffffL) {
    return cudaErrorInvalidValue;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, Tile<BN>::kSmemBytes, s>>>(map_a, map_b, g,
                                                                                p);
  return cudaGetLastError();
}

}  // namespace hopper
