// K5: out = t + d * m mod q, centered int32, in one kernel.
//
// Replaces both fused forms of ringzk_tpu/ops/pallas/ntt_kernel.py:
// scalar_mul_add_pallas (K5, _scalar_mul_add_kernel: rows of m on a grid
// axis, d transformed again for every row) and scalar_mul_add_pallas_v2
// (K5b, _scalar_mul_add_kernel_v2: rows in the block, d transformed once).
// Both compute the composed chain of ringzk_tpu/ops/ntt.py
// RingContext.scalar_mul_add: fwd_const(d), fwd(m), dot_hat, inv and the
// centered add of t; this kernel returns the same integers bit for bit.
//
// Shapes: d int32 [B, N]; m, t, out int32 [B, rows, N], contiguous; the
// first num (1..3) CRT primes; N = 4..8192. m and t may hold any int32
// (verify's m is c1 off the wire): m is reduced per prime as
// reduce_i32_centered does, and t enters the final add as uint32
// t + (t < 0 ? q : 0) through MontCtx.add's arithmetic (a 32-bit wrap
// below q = 2^31), so a t outside the centered range gives the
// reference's value too.
//
// What bounds it on this card: its integer instructions and the latency
// between them, not the bytes. It must read d once and m and
// t once (4N*B*(1 + 2*rows) bytes) and write out once (4N*B*rows): 2.68 GB
// at the open response's shape (B=131072, rows=3, num=1), 0.80 ms at
// 3.35 TB/s; num*(rows + 1) forward and num*rows inverse transforms of
// N/2*log2(N) butterflies (about nine instructions each, three of them
// half-rate IMADs) come to a similar time at the full instruction rate (chip_smoke.py
// k5_bound prices both). Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py [7]): 2.120 ms at the response shape, 1.810 ms at
// the verify shape (rows=1, num=2), against 8.785 and 5.565 ms for the
// first form of this kernel (a block of 256 threads per batch element,
// one butterfly per thread, a __syncthreads() per stage).
//
// Design: a block takes one batch element, one group of threads per row
// of m (a warp at N <= 512; see ntt_regs.cuh), up to six groups side by
// side, each looping over its rows. The groups first transform d, one
// prime each, into shared memory in Montgomery form (the block's one
// barrier follows); each group's first row of m is already loading. Per
// row and prime a group reduces the row, runs the forward transform in
// registers (ntt_regs.cuh: the stages between two transposes need no
// exchange and no barrier; twiddles are uint2 pairs read through the
// read-only cache), multiplies by d's image, runs the inverse (t loads
// meanwhile) and scales by N^-1, keeping all num results in registers;
// Garner, the mod-q fold and the add of t follow in registers and the row
// leaves with 16-byte stores. Nothing but d, m, t and out touches device
// memory: the composed chain's [num, B, rows, N] images and products never
// exist. A cap of 96 registers (a few spilled bytes) keeps about twenty
// warps resident an SM, and six groups a block keep rows=12's blocks
// small enough to pack: both measured faster than the compiler's own
// choice.
//
// Constant block `c` (uint32, ops/kernels/ntt.py kernel_consts; layout in
// ntt_stages.cuh): per prime i at 8i: p, floor(2^32/p), (-2^32) mod p,
// N^-1, its Shoup companion, -p^-1 mod 2^32, 2^64 mod p; at 24: q,
// -q^-1 mod 2^32, 2^32 mod q, M mod q; 28..30 the digits of floor(M/2);
// 31..38 Garner's constants.

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "ntt_regs.cuh"

namespace {

using rz::regs::Plan;

constexpr int kMaxGroups = 6;  // groups a block (named barriers 1..6)

template <int NUM>
struct Consts {
  uint32_t p[NUM], one_sh[NUM], neg[NUM], ninv[NUM], ninv_sh[NUM], pinv[NUM], r2[NUM];
  uint32_t q, qinv, r1, m_mod_q, half[NUM];
  uint32_t k_mont[2], g_inv[2], g_inv_sh[2], p0_p2, p0_p2_sh;

  __device__ __forceinline__ explicit Consts(const uint32_t* __restrict__ c) {
#pragma unroll
    for (int i = 0; i < NUM; ++i) {
      p[i] = __ldg(c + 8 * i);
      one_sh[i] = __ldg(c + 8 * i + 1);
      neg[i] = __ldg(c + 8 * i + 2);
      ninv[i] = __ldg(c + 8 * i + 3);
      ninv_sh[i] = __ldg(c + 8 * i + 4);
      pinv[i] = __ldg(c + 8 * i + 5);
      r2[i] = __ldg(c + 8 * i + 6);
      half[i] = __ldg(c + 28 + i);
    }
    q = __ldg(c + 24);
    qinv = __ldg(c + 25);
    r1 = __ldg(c + 26);
    m_mod_q = __ldg(c + 27);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      k_mont[i] = __ldg(c + 31 + i);
      g_inv[i] = __ldg(c + 33 + i);
      g_inv_sh[i] = __ldg(c + 35 + i);
    }
    p0_p2 = __ldg(c + 37);
    p0_p2_sh = __ldg(c + 38);
  }

  // residues v_i (scaled by N^-1, in [0, p_i)) -> the value mod q in
  // [0, q): Garner's mixed-radix digits, then
  // x mod q = sum_i v_i (prod_{j<i} p_j mod q) - [x > M/2] (M mod q).
  __device__ __forceinline__ uint32_t crt(uint32_t (&v)[NUM]) const {
    if constexpr (NUM > 1) {
      const uint32_t t1 = rz::sub_mod(v[1], rz::shoup_mul(1u, one_sh[1], v[0], p[1]), p[1]);
      v[1] = rz::shoup_mul(g_inv[0], g_inv_sh[0], t1, p[1]);
    }
    if constexpr (NUM > 2) {
      uint32_t t2 = rz::sub_mod(v[2], rz::shoup_mul(1u, one_sh[2], v[0], p[2]), p[2]);
      t2 = rz::sub_mod(t2, rz::shoup_mul(p0_p2, p0_p2_sh, v[1], p[2]), p[2]);
      v[2] = rz::shoup_mul(g_inv[1], g_inv_sh[1], t2, p[2]);
    }
    bool gt = v[NUM - 1] > half[NUM - 1];
    bool eq = v[NUM - 1] == half[NUM - 1];
#pragma unroll
    for (int i = NUM - 2; i >= 0; --i) {
      gt = gt || (eq && v[i] > half[i]);
      eq = eq && v[i] == half[i];
    }
    uint32_t acc = rz::mont_mul(v[0], r1, q, qinv);
#pragma unroll
    for (int i = 1; i < NUM; ++i)
      acc = rz::add_mod(acc, rz::mont_mul(v[i], k_mont[i - 1], q, qinv), q);
    return rz::sub_mod(acc, gt ? m_mod_q : 0u, q);
  }

  // (x + the uint32 form of t) mod q, centered, as MontCtx.add computes it:
  // below 2^31 the sum wraps in 32 bits (so a t far outside the centered
  // range gives the reference's value too), above it a carry-out subtracts.
  __device__ __forceinline__ int32_t add_t(uint32_t x, int32_t t) const {
    const uint32_t ub = static_cast<uint32_t>(t) + (t < 0 ? q : 0u);
    return rz::to_centered(q < 0x80000000u ? rz::add_mod31(x, ub, q) : rz::add_mod(x, ub, q), q);
  }
};

// Vector cc (of E/4) of thread vt in pass 0's layout starts at this index.
template <int L>
__device__ __forceinline__ uint32_t vec_at(uint32_t vt, int cc) {
  return (vt << 2) + (static_cast<uint32_t>(cc) << (L - Plan<L>::kTop));
}

template <int L>
__device__ __forceinline__ void load_plane(int32_t (&a)[Plan<L>::E],
                                           const int32_t* __restrict__ src, uint32_t vt) {
#pragma unroll
  for (int cc = 0; cc < Plan<L>::E / 4; ++cc) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src + vec_at<L>(vt, cc)));
    a[4 * cc] = v.x;
    a[4 * cc + 1] = v.y;
    a[4 * cc + 2] = v.z;
    a[4 * cc + 3] = v.w;
  }
}

// Registers a thread may take: 96 (see the design note), and at N = 8192
// at most 128, so that a group of 512 threads fits in a block.
template <int L>
constexpr int kRegCap = Plan<L>::VT >= 512 ? 128 : 96;

template <int L, int NUM>
__global__ void __maxnreg__(kRegCap<L>)
    scalar_mul_add_kernel(const int32_t* __restrict__ d, const int32_t* __restrict__ m,
                          const int32_t* __restrict__ t, int32_t* __restrict__ out,
                          const uint2* __restrict__ tw, const uint32_t* __restrict__ c,
                          int rows) {
  using P = Plan<L>;
  constexpr int N = P::N, E = P::E, VT = P::VT, GT = VT < 32 ? 32 : VT;
  extern __shared__ uint4 smem_vec[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_vec);
  const int G = blockDim.x / GT, g = threadIdx.x / GT, gt = threadIdx.x % GT;
  const uint32_t vt = gt & (VT - 1);  // below N = 128 lanes past VT repeat lane vt
  const bool writer = gt < VT;
  uint32_t* dimg = smem;                 // [NUM][E][VT]: d's images, Montgomery form
  uint32_t* buf = smem + (NUM + g) * N;  // this group's exchange buffer
  const size_t b = blockIdx.x;
  const Consts<NUM> k(c);

  // the group's first row is in flight while d is transformed
  int32_t raw[E];
  if (g < rows) load_plane<L>(raw, m + (b * rows + g) * N, vt);
  // d at prime i by group i mod G
  if (g < NUM) {
    int32_t draw[E];
    load_plane<L>(draw, d + b * N, vt);
#pragma unroll
    for (int i = 0; i < NUM; ++i) {
      if (i % G != g) continue;
      uint32_t x[E];
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = rz::reduce_i32(draw[e], k.p[i], k.one_sh[i], k.neg[i]);
      rz::regs::fwd<L, GT>(x, buf, tw + 2 * i * N, vt, writer, g, k.p[i]);
      if (writer) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          dimg[i * N + e * VT + vt] = rz::mont_mul(x[e], k.r2[i], k.p[i], k.pinv[i]);
      }
    }
  }
  __syncthreads();

  for (int r = g; r < rows; r += G) {
    const size_t row = b * rows + r;
    if (r != g) load_plane<L>(raw, m + row * N, vt);
    uint32_t v[NUM][E];
    int32_t tv[E];
#pragma unroll
    for (int i = 0; i < NUM; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = rz::reduce_i32(raw[e], k.p[i], k.one_sh[i], k.neg[i]);
      rz::regs::fwd<L, GT>(v[i], buf, tw + 2 * i * N, vt, writer, g, k.p[i]);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[i][e] = rz::mont_mul(v[i][e], dimg[i * N + e * VT + vt], k.p[i], k.pinv[i]);
      if (i == NUM - 1) load_plane<L>(tv, t + row * N, vt);  // arrives during the inverse
      rz::regs::inv<L, GT>(v[i], buf, tw + (2 * i + 1) * N, vt, writer, g, k.p[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = rz::shoup_mul(k.ninv[i], k.ninv_sh[i], v[i][e], k.p[i]);
    }
    if (!writer) continue;
    int32_t* o = out + row * N;
#pragma unroll
    for (int cc = 0; cc < E / 4; ++cc) {
      int32_t os[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t rr[NUM];
#pragma unroll
        for (int i = 0; i < NUM; ++i) rr[i] = v[i][4 * cc + j];
        os[j] = k.add_t(k.crt(rr), tv[4 * cc + j]);
      }
      *reinterpret_cast<int4*>(o + vec_at<L>(vt, cc)) = make_int4(os[0], os[1], os[2], os[3]);
    }
  }
}

template <int L, int NUM>
int launch(const int32_t* d, const int32_t* m, const int32_t* t, int32_t* out, const uint2* tw,
           const uint32_t* c, int batch, int rows, cudaStream_t stream) {
  constexpr int N = 1 << L, VT = Plan<L>::VT, GT = VT < 32 ? 32 : VT;
  const auto kern = scalar_mul_add_kernel<L, NUM>;
  static int max_threads = 0;  // per instance: what its registers allow
  if (max_threads == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_threads = attr.maxThreadsPerBlock;
  }
  constexpr int kSmemMax = 227 * 1024;
  int groups = rows < kMaxGroups ? rows : kMaxGroups;
  if (groups > max_threads / GT) groups = max_threads / GT;
  if (groups > kSmemMax / (4 * N) - NUM) groups = kSmemMax / (4 * N) - NUM;
  if (groups < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(NUM + groups) * N * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scalar_mul_add_kernel<L, NUM>
      <<<batch, groups * GT, smem, stream>>>(d, m, t, out, tw, c, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_num(int num, const int32_t* d, const int32_t* m, const int32_t* t, int32_t* out,
               const uint2* tw, const uint32_t* c, int batch, int rows, cudaStream_t s) {
  switch (num) {
    case 1: return launch<L, 1>(d, m, t, out, tw, c, batch, rows, s);
    case 2: return launch<L, 2>(d, m, t, out, tw, c, batch, rows, s);
    case 3: return launch<L, 3>(d, m, t, out, tw, c, batch, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rz_scalar_mul_add(const int32_t* d, const int32_t* m, const int32_t* t,
                                 int32_t* out, const void* tw, const uint32_t* c, int num,
                                 int batch, int rows, int n, void* stream) {
  if (batch == 0 || rows == 0) return 0;
  const uint2* w = static_cast<const uint2*>(tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch_num<2>(num, d, m, t, out, w, c, batch, rows, s);
    case 8: return launch_num<3>(num, d, m, t, out, w, c, batch, rows, s);
    case 16: return launch_num<4>(num, d, m, t, out, w, c, batch, rows, s);
    case 32: return launch_num<5>(num, d, m, t, out, w, c, batch, rows, s);
    case 64: return launch_num<6>(num, d, m, t, out, w, c, batch, rows, s);
    case 128: return launch_num<7>(num, d, m, t, out, w, c, batch, rows, s);
    case 256: return launch_num<8>(num, d, m, t, out, w, c, batch, rows, s);
    case 512: return launch_num<9>(num, d, m, t, out, w, c, batch, rows, s);
    case 1024: return launch_num<10>(num, d, m, t, out, w, c, batch, rows, s);
    case 2048: return launch_num<11>(num, d, m, t, out, w, c, batch, rows, s);
    case 4096: return launch_num<12>(num, d, m, t, out, w, c, batch, rows, s);
    case 8192: return launch_num<13>(num, d, m, t, out, w, c, batch, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
