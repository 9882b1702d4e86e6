// Modular arithmetic on uint32 residues, shared by the port's kernels.
//
// Device twins of ringzk_tpu/ops/montgomery.py's MontCtx (R = 2^32) and of
// ringzk_tpu_torch/ops/montgomery.py. The TPU has no 64-bit integer
// datapath and builds its products from 16-bit halves; Hopper has a native
// 32x32->64 multiply (and __umulhi), so every product here is one
// instruction. Results are the unique residues the JAX package returns.
#pragma once

#include <cstdint>

namespace rz {

// a * b * 2^-32 mod p for any uint32 a and b < p < 2^32. The sum
// t + m*p can exceed 2^64 when p > 2^31, so the high halves are added
// separately: the low halves cancel to 0 mod 2^32 by the choice of m and
// carry exactly when lo(t) != 0. u < 2p < 2^33 fits uint64.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t p,
                                             uint32_t pinv_neg) {
  uint64_t t = static_cast<uint64_t>(a) * b;
  uint32_t t_lo = static_cast<uint32_t>(t);
  uint32_t m = t_lo * pinv_neg;
  uint64_t u = (t >> 32) + __umulhi(m, p) + (t_lo != 0u);
  return static_cast<uint32_t>(u >= p ? u - p : u);
}

// (a + b) mod p for a, b in [0, p), any odd p < 2^32.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  uint64_t s = static_cast<uint64_t>(a) + b;
  return static_cast<uint32_t>(s >= p ? s - p : s);
}

// (a + b) mod p for a, b in [0, p), p < 2^31, as MontCtx.add computes it
// there: the uint32 sum wraps and one conditional subtract follows, so
// inputs outside [0, p) give the JAX package's value too.
__device__ __forceinline__ uint32_t add_mod31(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

// (a - b) mod p for a, b in [0, p). For any uint32 a and b it is
// MontCtx.sub's value (a - b, plus p where a < b, wrapping), which the
// strict butterflies (ntt_regs.cuh kStrict) rely on for K9.
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + (p - b);
}

// w * x mod p by Shoup's trick: w < p < 2^31 a constant with
// ws = floor(w * 2^32 / p), any uint32 x. r lands in [0, 2p).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t w, uint32_t ws, uint32_t x,
                                              uint32_t p) {
  uint32_t q = __umulhi(ws, x);
  uint32_t r = w * x - q * p;
  return r >= p ? r - p : r;
}

// int32 x -> x mod p in [0, p) for p < 2^31: the two's-complement bits
// reduced by a Shoup product with w = 1 (ws = floor(2^32 / p)), then
// corrected by (-2^32) mod p for negative x.
__device__ __forceinline__ uint32_t reduce_i32(int32_t x, uint32_t p, uint32_t one_shoup,
                                               uint32_t neg_corr) {
  uint32_t r = shoup_mul(1u, one_shoup, static_cast<uint32_t>(x), p);
  return x < 0 ? add_mod(r, neg_corr, p) : r;
}

// [0, q) -> centered int32 in [-(q-1)/2, q/2].
__device__ __forceinline__ int32_t to_centered(uint32_t u, uint32_t q) {
  return static_cast<int32_t>(u > q / 2 ? u - q : u);
}

}  // namespace rz
