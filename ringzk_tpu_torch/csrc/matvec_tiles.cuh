// The int8 digit GEMM shared by K3 (matvec_digits.cu), K6 (matvec_colblock.cu)
// and K10 (ntt_dense.cu): the counterpart of _digits_matmul_fold in
// ringzk_tpu/ops/pallas/matvec_kernel.py and of _dense_kernel in
// archive/ntt_dense_kernel.py.
//
//   G_s[b, c] = sum_{dv + dw = s} sum_k digit_dv(A[b, k]) * W_dw[k, c]
//
// A int32 [rows, K] (K3/K6: v), the four int8 operator planes W_dw [K, R]
// taken from the packed operator, and VD + 3 shift groups G_s per output,
// each an exact int32 sum (at most 4 * K * 128^2 = 8.05e8 < 2^31 at
// K = 12288). K10 (kDense) runs the same loop with x [rows, N] as A, its
// four digits u against sixteen planes W_(u,w) [N, N], and the four output
// planes H_w = sum_u sum_j digit_u(x[b, j]) * W_(u,w)[j, c] as its groups.
// The caller's epilogue folds the groups (K3/K6 mod q, K10 plane by plane
// mod p).
//
// Design, for Hopper:
// - The operator is packed once by the wrapper (ops/kernels/matvec.py
//   pack_planes): for each 64-column tile t and 32-deep k step s one block
//   [plane][k half][64 columns][16 k bytes] (8 KB; 32 KB for K10's sixteen
//   planes), zero past K and R. That is the K-major, unswizzled
//   core-matrix layout a wgmma B descriptor names (8 rows of 16 bytes per
//   core matrix: 128 bytes to the next 8 columns, 1 KB to the next 16 k),
//   so a stage's B tile is one cp.async.bulk and no block transposes bytes.
// - A ring of kStages shared-memory stages. One producer thread keeps them
//   full: per stage one TMA load of A (a [kBM, 32] int32 box of A's tensor
//   map; rows and k past A's edge arrive as zeros) and one cp.async.bulk of
//   the B block, both completing on the stage's `full` mbarrier; the
//   consumer warps release a stage on its `empty` mbarrier. No
//   __syncthreads() after the barriers' set-up, and no masks: k past K
//   meets zeros on both sides, and rows past the batch are not stored.
//   (One cp.async.bulk per row of A instead, 128 a stage, is bound by the
//   number of copies at every VD on an H100.)
// - Two consumer warpgroups (setmaxnreg: 232 registers each, 40 for the
//   producer) read their A fragments from the staged int32 (odd rows read
//   their two 16-byte chunks in the other order, so a quarter warp's reads
//   hit all 32 banks), split each value into VD int8 digits in registers by
//   the bias trick of conv_mxu.balanced_digits (digit byte = byte d of
//   v + bias, ^ 0x80), and run wgmma.m64nNk32.s32.s8.s8 with A from
//   registers and B from the descriptor, one per (digit, plane) pair into
//   its shift group's accumulator. A CTA covers 128 batch rows x 64 columns
//   (each warpgroup 64 x 64; at VD = 4, whose seven groups would not fit,
//   64 x 64 with each warpgroup 64 x 32).
// - Raster: the column tiles of one batch slab are adjacent in the launch
//   order, so the CTAs in flight share their A rows in L2 and A is read
//   from device memory about once; the operator (3 MB at N=512, 12.6 MB at
//   N=1024) stays in L2.
// - The epilogue folds each output's groups in registers and stores two
//   adjacent columns as one 8-byte word.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace rz {
namespace mv {

constexpr int kKeyDigits = 4;
constexpr int kBK = 32;                              // contraction per stage
constexpr int kBN = 64;                              // operator columns per tile
constexpr int kStages = 4;
constexpr int kARowBytes = kBK * 4;                 // one staged row of A: 32 int32
constexpr int kPlaneBytes = 2 * kBN * 16;          // one plane of a packed block: 2 KB
constexpr int kLBO = kBN * 16;                       // next 16 k: the second k half
constexpr int kSBO = 128;                            // next 8 columns
constexpr int kThreads = 384;                        // 2 consumer + 1 producer warpgroup

// K3/K6 (kDense false): VD digits of v against 4 key planes, accumulated
// by shift s = d + dw (VD + 3 groups). K10 (kDense true): the 4 digits u of
// x against 16 planes (u, w), accumulated by output plane w (4 groups).
template <int VD, bool kDense>
struct Shape {
  static constexpr int kGroups = kDense ? kKeyDigits : VD + kKeyDigits - 1;
  static constexpr int kPlanes = kDense ? VD * kKeyDigits : kKeyDigits;
  static constexpr int kNW = kGroups > 6 ? 32 : 64;  // wgmma N of one consumer warpgroup
  static constexpr int kBM = kNW == kBN ? 128 : 64;  // batch rows of a CTA
  static constexpr int kAStage = kBM * kARowBytes;
  static constexpr int kBTile = kPlanes * kPlaneBytes;
  static constexpr int kStageBytes = kAStage + kBTile;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8;
};

// One launch: A (as a TMA tensor map), the packed operator, the output and
// the fold constants.
struct Args {
  CUtensorMap amap;  // A int32 [rows, kn], box [kBM rows, 32]
  const int8_t* w;   // packed operator [n_tiles, k_steps, planes, 2, 64, 16]
  void* out;         // [rows, rows_n]
  const uint32_t* c;
  int rows, kn, rows_n;
  int n_tiles, k_steps;
};

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

// Waits for the phase of bar with the given parity to complete. A wait that
// lasts past ~2^34 clocks (seconds) can only be a fault: it traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to shared
// memory, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A box [rows m0.., k k0..] of A's tensor map, completing on bar's
// transaction count; rows and k past A's edge arrive as zeros
__device__ __forceinline__ void tma_load_a(void* dst, const CUtensorMap* map, int k0, int m0,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(m0)
      : "memory");
}

// wgmma descriptor of a K-major, unswizzled operand tile at shared address addr
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLBO >> 4) << 16) | (static_cast<uint64_t>(kSBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A (64 x 32 s8, registers) * B (32 x N s8, descriptor), s32
template <int N>
__device__ __forceinline__ void wgmma(int32_t (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma<64>(int32_t (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(int32_t (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keeps the compiler from reading an accumulator before wgmma_wait_all.
template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One 32-bit A fragment word: byte `sel` (as a __byte_perm selector pair)
// of each of four consecutive k values, biased; the ^ 0x80 recentres each
// byte to a balanced digit.
__device__ __forceinline__ uint32_t digit_word(const int4& x, uint32_t bias, uint32_t sel) {
  const uint32_t lo = __byte_perm(static_cast<uint32_t>(x.x) + bias,
                                  static_cast<uint32_t>(x.y) + bias, sel);
  const uint32_t hi = __byte_perm(static_cast<uint32_t>(x.z) + bias,
                                  static_cast<uint32_t>(x.w) + bias, sel);
  return __byte_perm(lo, hi, 0x5410) ^ 0x80808080u;
}

// The GEMM of one CTA, then epi(out index, groups of column c, of c + 1) for
// each pair of adjacent columns (c even) inside [rows, rows_n).
template <int VD, bool kDense, class Epi>
__device__ __forceinline__ void digit_gemm(const Args& p, const Epi& epi) {
  using S = Shape<VD, kDense>;
  constexpr int G = S::kGroups, NW = S::kNW;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * S::kStageBytes);
  uint64_t* empty = full + kStages;

  const int tile_n = blockIdx.x % p.n_tiles;
  const int m0 = (blockIdx.x / p.n_tiles) * S::kBM;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if ((threadIdx.x & 127) != 0) return;
    const int8_t* wtile = p.w + static_cast<size_t>(tile_n) * p.k_steps * S::kBTile;
    for (int s = 0; s < p.k_steps; ++s) {
      const int st = s % kStages;
      mbar_wait(&empty[st], ((s / kStages) & 1) ^ 1);
      uint8_t* stage = smem + st * S::kStageBytes;
      mbar_expect_tx(&full[st], S::kAStage + S::kBTile);
      tma_load_a(stage, &p.amap, s * kBK, m0, &full[st]);
      bulk_load(stage + S::kAStage, wtile + static_cast<size_t>(s) * S::kBTile, S::kBTile,
                &full[st]);
    }
  } else {
    // consumers: digits in registers, wgmma on the staged operator
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int row_off = NW == kBN ? wg * 64 : 0;   // this warpgroup's rows in the tile
    const int col_off = NW == kBN ? 0 : wg * NW;   // and its columns
    const int r0 = row_off + warp * 16 + g, odd = g & 1;
    constexpr uint32_t kBias = VD == 1 ? 0x80u
                               : VD == 2 ? 0x8080u
                               : VD == 3 ? 0x808080u
                                         : 0x80808080u;
    int32_t acc[G][NW / 2];
#pragma unroll
    for (int s = 0; s < G; ++s)
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[s][i] = 0;

    for (int s = 0; s < p.k_steps; ++s) {
      const int st = s % kStages;
      mbar_wait(&full[st], (s / kStages) & 1);
      const uint8_t* stage = smem + st * S::kStageBytes;
      // rows r0 and r0 + 8, k 4tg..4tg+3 (x?0) and 16+4tg..16+4tg+3 (x?1).
      // Odd rows read their second 16-byte chunk first, so that each
      // quarter warp's reads (rows g, g + 1) cover all 32 banks.
      const int4* row0 = reinterpret_cast<const int4*>(stage + r0 * kARowBytes);
      const int4* row1 = reinterpret_cast<const int4*>(stage + (r0 + 8) * kARowBytes);
      const int c0 = tg + 4 * odd, c1 = tg + 4 - 4 * odd;
      const int4 y00 = row0[c0], y10 = row1[c0], y01 = row0[c1], y11 = row1[c1];
      const int4 x00 = odd ? y01 : y00, x01 = odd ? y00 : y01;
      const int4 x10 = odd ? y11 : y10, x11 = odd ? y10 : y11;
      uint32_t a[VD][4];
#pragma unroll
      for (int d = 0; d < VD; ++d) {
        const uint32_t sel = d | ((d + 4) << 4);
        a[d][0] = digit_word(x00, kBias, sel);
        a[d][1] = digit_word(x10, kBias, sel);
        a[d][2] = digit_word(x01, kBias, sel);
        a[d][3] = digit_word(x11, kBias, sel);
      }
      const uint64_t desc = smem_desc(smem_u32(stage + S::kAStage + col_off * 16));
      wgmma_fence();
#pragma unroll
      for (int dw = 0; dw < kKeyDigits; ++dw)
#pragma unroll
        for (int d = 0; d < VD; ++d) {
          constexpr int kPlaneDesc = kPlaneBytes >> 4;
          if constexpr (kDense)
            wgmma<NW>(acc[dw], a[d], desc + (d * kKeyDigits + dw) * kPlaneDesc);
          else
            wgmma<NW>(acc[d + dw], a[d], desc + dw * kPlaneDesc);
        }
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int s = 0; s < G; ++s) fence_acc(acc[s]);

    // fragment (j, h, e): row r0 + 8h, column 8j + 2tg + e
    const int n0 = tile_n * kBN + col_off;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 8 * h, col = n0 + 8 * j + 2 * tg;
        if (row < p.rows && col < p.rows_n) {
          int32_t g0[G], g1[G];
#pragma unroll
          for (int s = 0; s < G; ++s) {
            g0[s] = acc[s][4 * j + 2 * h];
            g1[s] = acc[s][4 * j + 2 * h + 1];
          }
          epi(static_cast<size_t>(row) * p.rows_n + col, g0, g1);
        }
      }
    }
  }
}

// K3's and K6's epilogue: the shift groups folded mod q with one Montgomery
// product each (the group sum's two's-complement bits times 256^s * R mod
// q, minus (2^32 * 256^s) mod q for a negative sum), written centered.
// Fold constants `c` (uint32): q, -q^-1 mod 2^32, 256^s * R mod q for s < 8,
// (2^32 * 256^s) mod q for s < 8.
struct FoldCentered {
  int32_t* out;
  const uint32_t* c;

  template <int G>
  __device__ __forceinline__ int32_t fold(const int32_t (&gs)[G]) const {
    const uint32_t q = __ldg(c), qinv = __ldg(c + 1);
    uint32_t accq = 0;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      uint32_t term = rz::mont_mul(static_cast<uint32_t>(gs[s]), __ldg(c + 2 + s), q, qinv);
      if (gs[s] < 0) term = rz::sub_mod(term, __ldg(c + 10 + s), q);
      accq = rz::add_mod(accq, term, q);
    }
    return rz::to_centered(accq, q);
  }

  template <int G>
  __device__ __forceinline__ void operator()(size_t idx, const int32_t (&g0)[G],
                                             const int32_t (&g1)[G]) const {
    *reinterpret_cast<int2*>(out + idx) = make_int2(fold(g0), fold(g1));
  }
};

// cuTensorMapEncodeTiled, a libcuda function, through the CUDA runtime's
// entry-point query (the library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
        cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The tensor map of A int32 [rows, kn] (kn % 4 == 0, 16-byte aligned) in
// boxes of bm rows x 32, unswizzled, zero past the edges.
inline bool make_a_map(CUtensorMap* map, const int32_t* a, int rows, int kn, int bm) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kn), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kn) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(bm)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int32_t*>(a), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch one CTA per (batch slab, column tile), column tiles fastest.
template <int VD, bool kDense>
inline int launch(void (*kernel)(Args), const int32_t* a_ptr, Args a, cudaStream_t stream) {
  using S = Shape<VD, kDense>;
  if (a.rows == 0) return 0;
  if (!make_a_map(&a.amap, a_ptr, a.rows, a.kn, S::kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(a.n_tiles) * ((a.rows + S::kBM - 1) / S::kBM);
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(grid)),
                         dim3(kThreads), args, S::kSmem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K3's and K6's launch: v [B, kn], packed operator, out [B, rows_n].
template <void (*K1)(Args), void (*K2)(Args), void (*K3)(Args), void (*K4)(Args)>
inline int launch_matvec(const int32_t* v, const int8_t* w, int32_t* out, const uint32_t* c,
                         int B, int kn, int rows_n, int v_digits, void* stream) {
  if (kn % 4 || rows_n % 2) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{{}, w, out, c, B, kn, rows_n, (rows_n + kBN - 1) / kBN, (kn + kBK - 1) / kBK};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v_digits) {
    case 1: return launch<1, false>(K1, v, a, s);
    case 2: return launch<2, false>(K2, v, a, s);
    case 3: return launch<3, false>(K3, v, a, s);
    case 4: return launch<4, false>(K4, v, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mv
}  // namespace rz
