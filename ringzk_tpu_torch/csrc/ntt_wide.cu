// K7 and K8: the wide-ring (2^32 <= q < 2^63) negacyclic NTT over up to
// eight CRT primes, forward and inverse, on the register-resident
// transform of ntt_regs.cuh.
//
// Replaces ringzk_tpu/ops/pallas/ntt_kernel.py: fwd_wide_all_pallas (K7,
// _fwd_wide_kernel) and inv_wide_all_pallas (K8, _inv_wide_kernel plus the
// Garner limb-pair fold of ringzk_tpu/ops/ntt.py RingContext._crt_to_pair).
//
// What bounds it on this card: per row of N coefficients K7 must read 8N
// bytes (int64) and write 4N per prime, K8 read 4N per prime and write 8N;
// the butterflies cost N/2 * log2(N) Shoup products per prime and the
// Garner epilogue ~num^2/2 products per coefficient. As for K5, what sets
// the time in practice is the transforms' integer instructions and the
// latency between them, so the design keeps the planes in registers and
// the bytes at their least. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py [7]): K7 2.406 ms at num=3 over 393,216 rows (2.0x its
// bound), K8 1.096 ms at num=3 over 131,072 rows (2.2x its calibrated
// bound), against 7.262 and 2.281 ms for the first form of these kernels
// (a block per row, a butterfly per thread, a __syncthreads() per stage).
//
// K7: one group of threads (ntt_regs.cuh: a warp at N <= 512, N/512 warps
// above) per row, four groups a block at N <= 512. The group loads its
// int64 row once, in pass 0's layout (two 16-byte vectors per four
// coefficients), and keeps it in registers while it takes the planes in
// turn: for each prime it forms the residues, for x = lo + hi * 2^32 (hi
// signed) (lo mod p) + (hi mod p) * 2^32 mod p (a Shoup reduction of lo,
// rz::reduce_i32 of hi and a Montgomery product by 2^64 mod p), runs the
// forward transform in registers in the prime's butterfly form, reduces to
// [0, p) and stores the plane straight from the last pass's layout (E
// consecutive words a thread, 16-byte stores).
//
// K8: a block is one group and takes one row, filling a [num][N] tile in
// shared memory with the row's planes in turn: it loads each image in the
// last pass's layout, runs the inverse in registers with the plane's tile
// slot as its transpose buffer, scales by N^-1 (Shoup, [0, p)) and writes
// the plane to the slot in natural order. After one barrier every thread
// takes coefficient pairs of the row: Garner's digits v_i
// (x = sum_i v_i * prod_{j<i} p_j) by Shoup products, the digit compare
// gt = [x > M/2], and
//   x mod q = sum_i v_i * K_i - gt * (M mod q),  K_i = prod_{j<i} p_j mod q,
// with each v_i * K_i a 64-bit Shoup product (q < 2^63, so r < 2q fits a
// word), then the centered int64, two to a 16-byte store. Every step yields
// the unique residue, so the results equal the JAX package's bit for bit,
// whose fold is a REDC with R = 2^64 on 32-bit limbs. The epilogue is
// instantiated per prime count so the digits stay in registers; the
// transforms only per N and butterfly form, the prime a run-time value.
//
// Butterfly forms (ntt_regs.cuh): lazy for 4p < 2^32, strict for the
// extension primes at or above 2^30, as the Pallas kernels choose; the
// wrapper marks each prime's form in the constant block.
//
// Constant block (uint32, built by ops/kernels/ntt_wide.py wide_consts on
// the host and passed by value, so every read comes from the constant bank);
// 64-bit values as (lo, hi) slot pairs:
//   c[8*i + 0..7]     per prime i < 8: p, floor(2^32/p), (-2^32) mod p,
//                     N^-1 mod p, its Shoup companion, -p^-1 mod 2^32,
//                     2^64 mod p, 1 for the lazy butterflies (0: strict)
//   c[64..65]         q; c[66..67] M mod q (M the product of the num
//                     primes); c[68..69] floor(q/2)
//   c[72 + 2*i]       K_i = prod_{j<i} p_j mod q; c[88 + 2*i] its 64-bit
//                     Shoup companion floor(K_i * 2^64 / q)
//   c[104 + i]        Garner digits of floor(M/2)
//   c[112 + 2*i], +1  (prod_{j<i} p_j)^-1 mod p_i and its Shoup companion
//   c[128 + 16*i + 2*j], +1  prod_{k<j} p_k mod p_i (j < i), Shoup companion
// Twiddles `tw`: per prime [2][N] uint2 pairs (ops/kernels/ntt.py
// twiddle_pairs).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "modarith.cuh"
#include "ntt_regs.cuh"

namespace {

using rz::regs::Plan;

constexpr int kMaxPrimes = 8;
constexpr int kQ = 64, kMModQ = 66, kHalfQ = 68, kK = 72, kKShoup = 88, kHalfDigits = 104,
              kInv = 112, kW = 128;
constexpr int kFwdThreads = 128;  // K7's block: four groups at N <= 512
// Registers a thread may take: N = 8192's group of 512 threads must fit a
// block. K7 holds its int64 row (2E registers) across the planes and K8
// its Garner epilogue; a lower cap spills both.
constexpr int kRegCap = 128;

struct WideConsts {
  uint32_t c[256];
};

__device__ __forceinline__ uint64_t c64(const WideConsts& k, int slot) {
  return static_cast<uint64_t>(k.c[slot]) | (static_cast<uint64_t>(k.c[slot + 1]) << 32);
}

// w * x mod q by Shoup's trick on 64-bit words: w < q < 2^63 a constant with
// ws = floor(w * 2^64 / q), any uint64 x. r lands in [0, 2q) < 2^64.
__device__ __forceinline__ uint64_t shoup_mul64(uint64_t w, uint64_t ws, uint64_t x,
                                                uint64_t q) {
  const uint64_t r = w * x - __umul64hi(ws, x) * q;
  return r >= q ? r - q : r;
}

template <int L>
constexpr int kGroupThreads = Plan<L>::VT < 32 ? 32 : Plan<L>::VT;

// First index of vector cc (of E/4) of thread vt in pass 0's layout.
template <int L>
__device__ __forceinline__ uint32_t vec_first(uint32_t vt, int cc) {
  return (vt << 2) + (static_cast<uint32_t>(cc) << (L - Plan<L>::kTop));
}

// The same in the last pass's layout: E consecutive indices a thread.
template <int L>
__device__ __forceinline__ uint32_t vec_last(uint32_t vt, int cc) {
  return (vt << Plan<L>::LE) + 4 * static_cast<uint32_t>(cc);
}

template <int L>
__global__ void __maxnreg__(kRegCap)
    ntt_fwd_wide_kernel(const int64_t* __restrict__ x, uint32_t* __restrict__ out,
                        const uint2* __restrict__ tw, const __grid_constant__ WideConsts k,
                        int num, int rows) {
  using P = Plan<L>;
  constexpr int N = P::N, E = P::E, VT = P::VT, GT = kGroupThreads<L>;
  extern __shared__ uint4 smem_vec[];
  const int G = blockDim.x / GT, g = threadIdx.x / GT, gt = threadIdx.x % GT;
  const uint32_t vt = gt & (VT - 1);  // below N = 128 lanes past VT repeat lane vt
  const bool writer = gt < VT;
  const size_t row = static_cast<size_t>(blockIdx.x) * G + g;
  if (row >= static_cast<size_t>(rows)) return;  // the whole group
  longlong2 raw[E / 2];
  const int64_t* src = x + row * N;
#pragma unroll
  for (int cc = 0; cc < E / 4; ++cc) {
    const longlong2* s2 = reinterpret_cast<const longlong2*>(src + vec_first<L>(vt, cc));
    raw[2 * cc] = __ldg(s2);
    raw[2 * cc + 1] = __ldg(s2 + 1);
  }
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem_vec) + g * N;
#pragma unroll 1
  for (int i = 0; i < num; ++i) {
    const uint32_t p = k.c[8 * i], one_sh = k.c[8 * i + 1], neg = k.c[8 * i + 2];
    const uint32_t pinv = k.c[8 * i + 5], r2 = k.c[8 * i + 6];
    uint32_t v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint64_t w = static_cast<uint64_t>(e & 1 ? raw[e / 2].y : raw[e / 2].x);
      const uint32_t r_lo = rz::shoup_mul(1u, one_sh, static_cast<uint32_t>(w), p);
      const int32_t hi = static_cast<int32_t>(static_cast<uint32_t>(w >> 32));
      const uint32_t r_hi = rz::mont_mul(rz::reduce_i32(hi, p, one_sh, neg), r2, p, pinv);
      v[e] = rz::add_mod(r_lo, r_hi, p);
    }
    const uint2* twi = tw + 2 * i * N;
    if (k.c[8 * i + 7]) {
      rz::regs::fwd<L, GT, false>(v, buf, twi, vt, writer, g, p);
#pragma unroll
      for (int e = 0; e < E; ++e) {  // [0, 4p) -> [0, p)
        v[e] = min(v[e], v[e] - 2 * p);
        v[e] = min(v[e], v[e] - p);
      }
    } else {
      rz::regs::fwd<L, GT, true>(v, buf, twi, vt, writer, g, p);
    }
    if (writer) {
      uint32_t* o = out + (static_cast<size_t>(i) * rows + row) * N;
#pragma unroll
      for (int cc = 0; cc < E / 4; ++cc)
        *reinterpret_cast<uint4*>(o + vec_last<L>(vt, cc)) =
            make_uint4(v[4 * cc], v[4 * cc + 1], v[4 * cc + 2], v[4 * cc + 3]);
    }
  }
}

// One coefficient's N^-1-scaled residues x[0..NUM) -> the centered int64.
template <int NUM>
__device__ __forceinline__ int64_t garner_fold(const uint32_t (&x)[NUM], const WideConsts& k) {
  uint32_t v[NUM];
#pragma unroll
  for (int i = 0; i < NUM; ++i) {
    const uint32_t p = k.c[8 * i];
    uint32_t t = x[i];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const int w = kW + 16 * i + 2 * j;
      t = rz::sub_mod(t, rz::shoup_mul(k.c[w], k.c[w + 1], v[j], p), p);
    }
    v[i] = i == 0 ? t : rz::shoup_mul(k.c[kInv + 2 * i], k.c[kInv + 2 * i + 1], t, p);
  }
  // x > floor(M/2): lexicographic digit compare, most significant last
  bool gt = v[NUM - 1] > k.c[kHalfDigits + NUM - 1];
  bool eq = v[NUM - 1] == k.c[kHalfDigits + NUM - 1];
#pragma unroll
  for (int i = NUM - 2; i >= 0; --i) {
    gt = gt || (eq && v[i] > k.c[kHalfDigits + i]);
    eq = eq && v[i] == k.c[kHalfDigits + i];
  }
  const uint64_t q = c64(k, kQ), m_mod_q = c64(k, kMModQ);
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NUM; ++i) {
    acc += shoup_mul64(c64(k, kK + 2 * i), c64(k, kKShoup + 2 * i), v[i], q);
    acc = acc >= q ? acc - q : acc;
  }
  if (gt) acc = acc >= m_mod_q ? acc - m_mod_q : acc + (q - m_mod_q);
  return acc > c64(k, kHalfQ) ? -static_cast<int64_t>(q - acc) : static_cast<int64_t>(acc);
}

// The block's tile [NUM][N] -> its row of out, two coefficients a thread
// at a time.
template <int NUM, int N>
__device__ __forceinline__ void fold_row(const uint32_t* tile, int64_t* __restrict__ out,
                                         const WideConsts& k) {
  for (int j = 2 * threadIdx.x; j < N; j += 2 * blockDim.x) {
    uint32_t lo[NUM], hi[NUM];
#pragma unroll
    for (int i = 0; i < NUM; ++i) {
      const uint2 t = *reinterpret_cast<const uint2*>(tile + i * N + j);
      lo[i] = t.x;
      hi[i] = t.y;
    }
    *reinterpret_cast<longlong2*>(out + j) =
        make_longlong2(garner_fold<NUM>(lo, k), garner_fold<NUM>(hi, k));
  }
}

// A block (one group) per row.
template <int L>
__global__ void __maxnreg__(kRegCap)
    ntt_inv_wide_kernel(const uint32_t* __restrict__ xhat, int64_t* __restrict__ out,
                        const uint2* __restrict__ tw, const __grid_constant__ WideConsts k,
                        int num, int rows) {
  using P = Plan<L>;
  constexpr int N = P::N, E = P::E, VT = P::VT, GT = kGroupThreads<L>;
  extern __shared__ uint4 smem_vec[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem_vec);  // [num][N]
  const uint32_t vt = threadIdx.x & (VT - 1);
  const bool writer = threadIdx.x < VT;
  const size_t row = blockIdx.x;
#pragma unroll 1
  for (int i = 0; i < num; ++i) {
    const uint32_t p = k.c[8 * i];
    const uint32_t* src = xhat + (static_cast<size_t>(i) * rows + row) * N;
    uint32_t v[E];
#pragma unroll
    for (int cc = 0; cc < E / 4; ++cc) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(src + vec_last<L>(vt, cc)));
      v[4 * cc] = a.x;
      v[4 * cc + 1] = a.y;
      v[4 * cc + 2] = a.z;
      v[4 * cc + 3] = a.w;
    }
    uint32_t* slot = tile + i * N;
    const uint2* twi = tw + (2 * i + 1) * N;
    if (k.c[8 * i + 7])
      rz::regs::inv<L, GT, false>(v, slot, twi, vt, writer, 0, p);
    else
      rz::regs::inv<L, GT, true>(v, slot, twi, vt, writer, 0, p);
    const uint32_t ninv = k.c[8 * i + 3], ninv_sh = k.c[8 * i + 4];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = rz::shoup_mul(ninv, ninv_sh, v[e], p);
    rz::regs::group_sync<GT>(0);  // every reader of the last transpose is done
    if (writer) {
#pragma unroll
      for (int cc = 0; cc < E / 4; ++cc)
        *reinterpret_cast<uint4*>(slot + vec_first<L>(vt, cc)) =
            make_uint4(v[4 * cc], v[4 * cc + 1], v[4 * cc + 2], v[4 * cc + 3]);
    }
  }
  __syncthreads();
  int64_t* o = out + row * N;
  switch (num) {
    case 1: fold_row<1, N>(tile, o, k); break;
    case 2: fold_row<2, N>(tile, o, k); break;
    case 3: fold_row<3, N>(tile, o, k); break;
    case 4: fold_row<4, N>(tile, o, k); break;
    case 5: fold_row<5, N>(tile, o, k); break;
    case 6: fold_row<6, N>(tile, o, k); break;
    case 7: fold_row<7, N>(tile, o, k); break;
    default: fold_row<8, N>(tile, o, k); break;
  }
}

// Past the 48 KB default a kernel must ask for its dynamic shared memory;
// the wrapper raises before a K8 tile outgrows a block's 227 KB.
int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int L>
int launch_fwd(const int64_t* x, uint32_t* out, const uint2* tw, const WideConsts& k, int num,
               int rows, cudaStream_t stream) {
  constexpr int N = 1 << L, GT = kGroupThreads<L>;
  static_assert(kRegCap * GT <= 65536, "a group must fit a block's registers");
  const auto kern = ntt_fwd_wide_kernel<L>;
  const int groups = GT >= kFwdThreads ? 1 : kFwdThreads / GT;
  const size_t smem = static_cast<size_t>(groups) * N * sizeof(uint32_t);
  if (const int err = set_smem(reinterpret_cast<const void*>(kern), smem)) return err;
  const unsigned blocks = static_cast<unsigned>((rows + groups - 1) / groups);
  kern<<<blocks, groups * GT, smem, stream>>>(x, out, tw, k, num, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_inv(const uint32_t* xhat, int64_t* out, const uint2* tw, const WideConsts& k,
               int num, int rows, cudaStream_t stream) {
  constexpr int N = 1 << L, GT = kGroupThreads<L>;
  static_assert(kRegCap * GT <= 65536, "a group must fit a block's registers");
  const auto kern = ntt_inv_wide_kernel<L>;
  const size_t smem = static_cast<size_t>(num) * N * sizeof(uint32_t);
  if (const int err = set_smem(reinterpret_cast<const void*>(kern), smem)) return err;
  kern<<<rows, GT, smem, stream>>>(xhat, out, tw, k, num, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename Launch>
int dispatch(int n, Launch&& launch) {
  switch (n) {
    case 4: return launch(std::integral_constant<int, 2>{});
    case 8: return launch(std::integral_constant<int, 3>{});
    case 16: return launch(std::integral_constant<int, 4>{});
    case 32: return launch(std::integral_constant<int, 5>{});
    case 64: return launch(std::integral_constant<int, 6>{});
    case 128: return launch(std::integral_constant<int, 7>{});
    case 256: return launch(std::integral_constant<int, 8>{});
    case 512: return launch(std::integral_constant<int, 9>{});
    case 1024: return launch(std::integral_constant<int, 10>{});
    case 2048: return launch(std::integral_constant<int, 11>{});
    case 4096: return launch(std::integral_constant<int, 12>{});
    case 8192: return launch(std::integral_constant<int, 13>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x int64 [rows, n] -> out uint32 [num, rows, n]; c the host constant block.
extern "C" int rz_ntt_fwd_wide(const int64_t* x, uint32_t* out, const void* tw,
                               const uint32_t* c, int num, int rows, int n, void* stream) {
  if (num < 1 || num > kMaxPrimes) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  WideConsts k;
  std::memcpy(k.c, c, sizeof(k.c));
  const uint2* w = static_cast<const uint2*>(tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(n, [&](auto l) {
    return launch_fwd<decltype(l)::value>(x, out, w, k, num, rows, s);
  });
}

// xhat uint32 [num, rows, n] -> out centered int64 [rows, n].
extern "C" int rz_ntt_inv_wide(const uint32_t* xhat, int64_t* out, const void* tw,
                               const uint32_t* c, int num, int rows, int n, void* stream) {
  if (num < 1 || num > kMaxPrimes) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  WideConsts k;
  std::memcpy(k.c, c, sizeof(k.c));
  const uint2* w = static_cast<const uint2*>(tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(n, [&](auto l) {
    return launch_inv<decltype(l)::value>(xhat, out, w, k, num, rows, s);
  });
}
