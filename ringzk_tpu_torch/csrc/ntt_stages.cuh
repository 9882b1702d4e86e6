// The NTT stages and the Garner fold on rows held in shared memory, shared
// by K1/K2 (ntt.cu) and K9 (ntt_one.cu). K5 (scalar_mul_add.cu) and K7/K8
// (ntt_wide.cu) run the register-resident transform (ntt_regs.cuh); K5
// reads the constant block below.
//
// A block holds `np` planes of one row, plane j at s + j*n, each reduced to
// [0, p) for its prime. Every stage reduces strictly to [0, p), so the
// results are the unique residues the JAX package returns. The butterflies
// are MontCtx's strict forms for p < 2^31 (add_mod31, sub_mod, shoup_mul),
// so a plane outside [0, p), which K9 takes as given, wraps as ntt._fwd_one
// and _inv_one wrap it.
//
// Constant block `c` (uint32, built by ops/kernels/ntt.py kernel_consts):
//   c[8*i + 0..6]  per prime i: p, floor(2^32/p), (-2^32) mod p,
//                  N^-1 mod p, its Shoup companion, -p^-1 mod 2^32,
//                  2^64 mod p (the to-Montgomery multiplier)
//   c[24..27]      q, -q^-1 mod 2^32, 2^32 mod q, (prod of the num primes) mod q
//   c[28..30]      Garner digits of floor(M/2)
//   c[31..32]      (prod_{j<i} p_j) mod q in Montgomery form, i = 1, 2
//   c[33..34]      (prod_{j<i} p_j)^-1 mod p_i, i = 1, 2; c[35..36] Shoup
//   c[37..38]      p_0 mod p_2 and its Shoup companion
// Twiddles `tw`: [primes, 4, N] = psi_rev, Shoup, psi_inv_rev, Shoup.
#pragma once

#include <cstdint>

#include "modarith.cuh"

namespace rz {

constexpr int kGarner = 24;

// Forward negacyclic NTT (Cooley-Tukey over psi_rev) of np planes; plane j
// uses prime i0 + j. Ends with a __syncthreads().
__device__ __forceinline__ void fwd_stages(uint32_t* s, int np, int i0,
                                           const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ c, int n, int logn) {
  const int half = n >> 1;
  for (int st = 0; st < logn; ++st) {
    const int sh = logn - 1 - st;  // t = n >> (st + 1) = 1 << sh
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int g = b >> sh;
      const int a0 = (g << (sh + 1)) + (b & ((1 << sh) - 1));
      const int a1 = a0 + (1 << sh);
      const int wi = (1 << st) + g;
      for (int j = 0; j < np; ++j) {
        const int i = i0 + j;
        const uint32_t p = c[8 * i];
        const uint32_t* w = tw + static_cast<size_t>(i) * 4 * n;
        uint32_t* sj = s + j * n;
        const uint32_t x0 = sj[a0];
        const uint32_t pr = shoup_mul(__ldg(w + wi), __ldg(w + n + wi), sj[a1], p);
        sj[a0] = add_mod31(x0, pr, p);
        sj[a1] = sub_mod(x0, pr, p);
      }
    }
    __syncthreads();
  }
}

// Inverse negacyclic NTT (Gentleman-Sande over psi_inv_rev), without the
// N^-1 scaling, of np planes; plane j uses prime j. Ends with a
// __syncthreads().
__device__ __forceinline__ void inv_stages(uint32_t* s, int np,
                                           const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ c, int n, int logn) {
  const int half = n >> 1;
  for (int st = 0; st < logn; ++st) {
    const int h = n >> (st + 1);
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int g = b >> st;
      const int a0 = (g << (st + 1)) + (b & ((1 << st) - 1));
      const int a1 = a0 + (1 << st);
      for (int i = 0; i < np; ++i) {
        const uint32_t p = c[8 * i];
        const uint32_t* w = tw + static_cast<size_t>(i) * 4 * n + 2 * n;
        uint32_t* si = s + i * n;
        const uint32_t x0 = si[a0], x1 = si[a1];
        si[a0] = add_mod31(x0, x1, p);
        si[a1] = shoup_mul(__ldg(w + h + g), __ldg(w + n + h + g), sub_mod(x0, x1, p), p);
      }
    }
    __syncthreads();
  }
}

// Coefficient j of the num inverse images in s (before N^-1) -> the value
// mod q in [0, q): the per-prime N^-1 scaling, Garner's mixed-radix CRT and
// the fold x mod q = sum_i v_i * (prod_{j<i} p_j mod q) - [x > M/2] * (M mod q).
__device__ __forceinline__ uint32_t crt_mod_q(const uint32_t* s, int j, int num, int n,
                                              const uint32_t* __restrict__ c) {
  uint32_t v[3];
  for (int i = 0; i < num; ++i)
    v[i] = shoup_mul(c[8 * i + 3], c[8 * i + 4], s[i * n + j], c[8 * i]);
  // Garner: x = v0 + v1*p0 + v2*p0*p1 with 0 <= v_i < p_i
  if (num > 1) {
    const uint32_t p1 = c[8];
    uint32_t t = sub_mod(v[1], shoup_mul(1u, c[9], v[0], p1), p1);
    v[1] = shoup_mul(c[33], c[35], t, p1);
  }
  if (num > 2) {
    const uint32_t p2 = c[16];
    uint32_t t = sub_mod(v[2], shoup_mul(1u, c[17], v[0], p2), p2);
    t = sub_mod(t, shoup_mul(c[37], c[38], v[1], p2), p2);
    v[2] = shoup_mul(c[34], c[36], t, p2);
  }
  // x > floor(M/2): lexicographic digit compare, most significant last
  bool gt = v[num - 1] > c[28 + num - 1];
  bool eq = v[num - 1] == c[28 + num - 1];
  for (int i = num - 2; i >= 0; --i) {
    gt = gt || (eq && v[i] > c[28 + i]);
    eq = eq && v[i] == c[28 + i];
  }
  const uint32_t q = c[kGarner], qinv = c[kGarner + 1];
  uint32_t acc = mont_mul(v[0], c[kGarner + 2], q, qinv);
  for (int i = 1; i < num; ++i) acc = add_mod(acc, mont_mul(v[i], c[31 + i - 1], q, qinv), q);
  return sub_mod(acc, gt ? c[kGarner + 3] : 0u, q);
}

inline int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// One butterfly per thread per stage, at least one warp, at most 256 threads.
inline int threads_for(int n) {
  int t = n / 2;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

}  // namespace rz
