// A negacyclic NTT whose plane lives in registers, for K1/K2 (ntt.cu), K5
// (scalar_mul_add.cu), K7/K8 (ntt_wide.cu) and K9 (ntt_one.cu), with the
// group helpers they share: a group's size, the vectors of its first and
// last layouts, the checked shared-memory request and the dispatch over
// N = 4..8192.
//
// A plane of N = 2^L coefficients is held by VT = 2^(L-LE) threads (a
// "group": one warp at N = 512, VT/32 warps above, and below N = 128 one
// warp whose lanes past VT repeat the first VT), each with E = 2^LE
// coefficients in registers. Which index bits a thread's registers hold is
// the pass's layout: within a pass every butterfly stage runs on register
// pairs, with no exchange and no barrier. Between passes the group writes
// its plane to a shared-memory buffer and reads it back in the next layout,
// one transpose with a warp (or group) barrier on each side. The stages
// unroll: L, LE and the butterfly form are template parameters; the prime
// is a run-time value.
//
// Layouts, forward (stage bits from L-1 down to 0; the inverse runs the
// same passes backwards):
//   pass 0: registers hold index bits {0, 1} and the top LE-2 bits, so
//           each thread loads and stores 16-byte vectors, the warp's
//           vectors contiguous; its stages are the top LE-2 bits;
//   pass p: registers hold LE consecutive bits, the next LE stage bits
//           down (the last pass the bits 0..LE-1, so E consecutive
//           coefficients a thread).
// At N = 512 (LE = 4): stages 8-7, 6-3 and 2-0, two transposes a
// transform. The shared-memory index is XOR-swizzled on its low five bits
// by the bits above them (a linear map found at compile time) so that no
// layout's loads or stores meet a bank conflict.
//
// Two butterfly forms. K1, K2, K5, K7 and K8 choose one per prime by the
// rule of ringzk_tpu/ops/pallas/ntt_kernel.py _fwd_stages /
// _inv_stages; K9 (ntt_one.cu) takes the strict form at every prime:
//   lazy (kStrict = false), for 4p < 2^32 (p < 2^30: the three base CRT
//     primes and 469762049): Harvey's forms, as _fwd_stages_lazy /
//     _inv_stages_lazy; forward values stay in [0, 4p), inverse values in
//     [0, 2p). The caller reduces strictly afterwards (a Montgomery
//     product, the Shoup product by N^-1, or two conditional subtracts),
//     so the residues equal those of the strict stages bit for bit for
//     inputs in [0, p);
//   strict (kStrict = true), any p < 2^31 (the wide rings' extension
//     primes 2013265921, 2130706433, 1811939329, 2113929217 lie at or
//     above 2^30, where 4p no longer fits a word): every add, subtract and
//     Shoup product reduced to [0, p), as _fwd_stages_strict /
//     _inv_stages_strict; 2p < 2^32, so no value leaves uint32. Its add,
//     subtract and Shoup products are MontCtx's (ringzk_tpu/ops/
//     montgomery.py) on every uint32, the subtract rz::sub_mod (the wrapped
//     difference, plus p where a < b), so a plane outside [0, p), which K9
//     takes as given, wraps as ringzk_tpu/ops/ntt.py _fwd_one / _inv_one
//     wrap it. A subtract as min(d, d + p) would differ there (a = 2^32 - 1,
//     b = 0 gives p - 1, not 2^32 - 1).
//
// Twiddles `tw`: per prime [2][N] of uint2 (w, floor(w 2^32 / p)), psi_rev
// then psi_inv_rev (ops/kernels/ntt.py twiddle_pairs). Forward
// and inverse read the same index for the stage on bit b and the pair
// whose lower index is j: 2^(L-1-b) + (j >> (b+1)).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "modarith.cuh"

namespace rz::regs {

__host__ __device__ constexpr int popc_c(uint32_t v) {
  int c = 0;
  for (; v; v &= v - 1) ++c;
  return c;
}

// The low bits of v placed, in order, on the set bits of mask.
__host__ __device__ constexpr uint32_t deposit(uint32_t v, uint32_t mask) {
  uint32_t out = 0;
  for (int b = 0; b < 32; ++b)
    if (mask >> b & 1u) {
      out |= (v & 1u) << b;
      v >>= 1;
    }
  return out;
}

// Registers a thread holds: 4 below N = 256, 8 at 256, 16 from 512 on.
__host__ __device__ constexpr int le_for(int L) { return L <= 7 ? 2 : (L == 8 ? 3 : 4); }

template <int L>
struct Plan {
  static constexpr int LE = le_for(L);
  static constexpr int N = 1 << L, E = 1 << LE, VT = 1 << (L - LE);
  static constexpr int kTop = LE - 2;  // top bits in pass 0
  static constexpr int kPasses = 1 + (L - kTop + LE - 1) / LE;
  static constexpr uint32_t kAll = (1u << L) - 1;

  // forward stage bits of pass p: hi(p) down to lo(p) (none when hi < lo)
  __host__ __device__ static constexpr int hi(int p) {
    return p == 0 ? L - 1 : L - kTop - 1 - (p - 1) * LE;
  }
  __host__ __device__ static constexpr int lo(int p) {
    return p == 0 ? L - kTop : (hi(p) - LE + 1 > 0 ? hi(p) - LE + 1 : 0);
  }
  // index bits held in registers in pass p
  __host__ __device__ static constexpr uint32_t rmask(int p) {
    return p == 0 ? 3u | (((1u << kTop) - 1) << (L - kTop))
                  : ((1u << LE) - 1) << (lo(p) > 0 ? lo(p) : 0);
  }
};

// The swizzle: bit h >= 5 of an index flips the low five bits by a mask,
// five bits each in the word below (mask of bit h at 5 * (h - 5)). A
// layout is free of bank conflicts when its lane bits (the lowest five
// index bits outside its registers, fewer when VT < 32) reach independent
// bank bits: a low bit its own, a high bit its mask. The masks are the
// first solution of a depth-first search over them in increasing order;
// conflict_free() checks every layout of the plan at compile time.
__host__ __device__ constexpr uint64_t swizzle_masks(int L) {
  switch (L) {
    case 6: return 0x5;
    case 7: return 0x2aa;
    case 8: return 0x64a2;
    case 9: return 0xa2041;
    case 10: return 0xc1041;
    case 11: return 0x8a0a2;
    case 12: return 0x920c1;
    case 13: return 0xa2041;
    default: return 0;
  }
}

// j with its low five bits flipped by the masks of its set bits above them
template <int L>
__host__ __device__ constexpr uint32_t swizzle(uint32_t j) {
  uint32_t s = 0;
  for (int h = 5; h < L; ++h)
    if (j >> h & 1u) s ^= static_cast<uint32_t>(swizzle_masks(L) >> (5 * (h - 5))) & 31u;
  return j ^ s;
}

template <int L>
__host__ __device__ constexpr bool conflict_free() {
  using P = Plan<L>;
  for (int p = 0; p < P::kPasses; ++p) {
    const uint32_t free = ~P::rmask(p) & P::kAll;
    uint32_t basis[5] = {};
    int n = 0, r = 0;
    for (int b = 0; b < L && n < 5; ++b) {
      if (!(free >> b & 1u)) continue;
      ++n;
      uint32_t x = swizzle<L>(1u << b) & 31u;  // the bank bits index bit b moves
      for (int i = 0; i < r; ++i)
        if ((x ^ basis[i]) < x) x ^= basis[i];
      if (x) basis[r++] = x;
    }
    if (r < n) return false;
  }
  return true;
}

// Barrier of one group: the warp, or GT threads under named barrier 1 + g.
template <int GT>
__device__ __forceinline__ void group_sync(int g) {
  if constexpr (GT == 32)
    __syncwarp();
  else
    __barrier_sync_count(1 + g, GT);
}

// the unswizzled index bits of thread vt in pass p
template <int L, int p>
__device__ __forceinline__ uint32_t index_part(uint32_t vt) {
  constexpr uint32_t free = ~Plan<L>::rmask(p) & Plan<L>::kAll;
  uint32_t j = 0;
  int k = 0;
#pragma unroll
  for (int b = 0; b < L; ++b)
    if (free >> b & 1u) j |= (vt >> k++ & 1u) << b;
  return j;
}

// Plane of one group in layout `from` -> layout `to`, through buf [N].
template <int L, int GT, int from, int to>
__device__ __forceinline__ void transpose(uint32_t (&x)[Plan<L>::E], uint32_t* buf,
                                          uint32_t vt, bool writer, int g) {
  using P = Plan<L>;
  static_assert(conflict_free<L>(), "a layout of this plan meets bank conflicts");
  group_sync<GT>(g);  // every reader of the last transpose is done
  if (writer) {
    const uint32_t t = swizzle<L>(index_part<L, from>(vt));
#pragma unroll
    for (int e = 0; e < P::E; ++e) buf[t ^ swizzle<L>(deposit(e, P::rmask(from)))] = x[e];
  }
  group_sync<GT>(g);
  const uint32_t t = swizzle<L>(index_part<L, to>(vt));
#pragma unroll
  for (int e = 0; e < P::E; ++e) x[e] = buf[t ^ swizzle<L>(deposit(e, P::rmask(to)))];
}

// The stages of pass p, forward (Cooley-Tukey, descending bits) or
// inverse (Gentleman-Sande, ascending bits), on the registers x, in the
// lazy or the strict form (see the header).
template <int L, int p, bool kInverse, bool kStrict = false>
__device__ __forceinline__ void pass_stages(uint32_t (&x)[Plan<L>::E],
                                            const uint2* __restrict__ tw, uint32_t vt,
                                            uint32_t prime) {
  using P = Plan<L>;
  constexpr uint32_t R = P::rmask(p);
  constexpr int nst = P::hi(p) - P::lo(p) + 1;
  const uint32_t two_p = 2 * prime;
  const uint32_t tj = index_part<L, p>(vt);
#pragma unroll
  for (int s = 0; s < nst; ++s) {
    const int b = kInverse ? P::lo(p) + s : P::hi(p) - s;
    const int rb = popc_c(R & ((1u << b) - 1));  // register bit of index bit b
    const uint2* twb = tw + (1u << (L - 1 - b)) + (tj >> (b + 1));
#pragma unroll
    for (int e0 = 0; e0 < P::E; ++e0) {
      if (e0 >> rb & 1) continue;
      const int e1 = e0 | 1 << rb;
      const uint2 w = __ldg(twb + (deposit(e0, R) >> (b + 1)));
      if constexpr (kStrict) {
        // [0, p) in and out (any uint32 in: MontCtx's values); min(v,
        // v - p) reduces v < 2p, sub_mod is MontCtx.sub
        const uint32_t x0 = x[e0], x1 = x[e1];
        if (!kInverse) {
          uint32_t pr = w.x * x1 - __umulhi(w.y, x1) * prime;
          pr = min(pr, pr - prime);
          const uint32_t s0 = x0 + pr;
          x[e0] = min(s0, s0 - prime);
          x[e1] = sub_mod(x0, pr, prime);
        } else {
          const uint32_t s0 = x0 + x1;
          const uint32_t df = sub_mod(x0, x1, prime);
          const uint32_t pr = w.x * df - __umulhi(w.y, df) * prime;
          x[e0] = min(s0, s0 - prime);
          x[e1] = min(pr, pr - prime);
        }
      } else if (!kInverse) {
        uint32_t x0 = x[e0];
        x0 = min(x0, x0 - two_p);  // [0, 4p) -> [0, 2p)
        const uint32_t pr = w.x * x[e1] - __umulhi(w.y, x[e1]) * prime;  // [0, 2p)
        x[e0] = x0 + pr;
        x[e1] = x0 + two_p - pr;
      } else {
        const uint32_t x0 = x[e0], x1 = x[e1];
        const uint32_t s0 = x0 + x1;
        const uint32_t df = x0 + two_p - x1;  // (0, 4p)
        x[e0] = min(s0, s0 - two_p);
        x[e1] = w.x * df - __umulhi(w.y, df) * prime;
      }
    }
  }
}

// Forward transform from pass p on: x in pass 0's layout -> the NTT image
// in the last pass's layout. Lazy: values in [0, 4p) in and out; strict:
// [0, p) (any uint32 in).
template <int L, int GT, bool kStrict = false, int p = 0>
__device__ __forceinline__ void fwd(uint32_t (&x)[Plan<L>::E], uint32_t* buf,
                                    const uint2* __restrict__ tw, uint32_t vt, bool writer,
                                    int g, uint32_t prime) {
  if constexpr (p < Plan<L>::kPasses) {
    if constexpr (p > 0) transpose<L, GT, p - 1, p>(x, buf, vt, writer, g);
    pass_stages<L, p, false, kStrict>(x, tw, vt, prime);
    fwd<L, GT, kStrict, p + 1>(x, buf, tw, vt, writer, g, prime);
  }
}

// Inverse transform without the N^-1 scaling, from pass p down: x in the
// last pass's layout -> pass 0's layout. Lazy: values in [0, 2p) in and
// out; strict: [0, p) (any uint32 in). `tw` is the inverse table.
template <int L, int GT, bool kStrict = false, int p = Plan<L>::kPasses - 1>
__device__ __forceinline__ void inv(uint32_t (&x)[Plan<L>::E], uint32_t* buf,
                                    const uint2* __restrict__ tw, uint32_t vt, bool writer,
                                    int g, uint32_t prime) {
  if constexpr (p >= 0) {
    if constexpr (p < Plan<L>::kPasses - 1) transpose<L, GT, p + 1, p>(x, buf, vt, writer, g);
    pass_stages<L, p, true, kStrict>(x, tw, vt, prime);
    inv<L, GT, kStrict, p - 1>(x, buf, tw, vt, writer, g, prime);
  }
}

// Threads of a group: its VT, and one warp below N = 128.
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

// Thread vt's int32 coefficients of a row in pass 0's layout, as 16-byte
// vectors through the read-only cache.
template <int L>
__device__ __forceinline__ void load_i32(int32_t (&a)[Plan<L>::E],
                                         const int32_t* __restrict__ src, uint32_t vt) {
#pragma unroll
  for (int cc = 0; cc < Plan<L>::E / 4; ++cc) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src + vec_first<L>(vt, cc)));
    a[4 * cc] = v.x;
    a[4 * cc + 1] = v.y;
    a[4 * cc + 2] = v.z;
    a[4 * cc + 3] = v.w;
  }
}

// Past the 48 KB default a kernel must ask for its dynamic shared memory;
// the wrappers raise before a request outgrows a block's 227 KB.
inline int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// launch(std::integral_constant<int, log2(n)>) for n = 4..8192.
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

}  // namespace rz::regs
