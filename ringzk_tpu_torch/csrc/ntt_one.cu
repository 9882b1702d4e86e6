// K9: the single-prime strict negacyclic NTT, forward and inverse, on the
// register-resident transform of ntt_regs.cuh.
//
// Replaces ringzk_tpu/ops/pallas/ntt_kernel.py fwd_one_pallas and
// inv_one_pallas (_fwd_kernel / _inv_kernel through _call), the function of
// ringzk_tpu/ops/ntt.py _fwd_one / _inv_one: uint32 [rows, N] -> uint32
// [rows, N] at one prime p < 2^31 of a ring (the three base CRT primes, or
// a wide ring's extension primes, some at or above 2^30), N = 4..8192;
// natural in and bit-reversed out (forward), bit-reversed in and natural
// out with the N^-1 scaling (inverse). There is no Garner step.
//
// What bounds it on this card: memory traffic. A row moves 4N bytes in and
// 4N out against N/2 log2(N) butterflies (a Shoup product, an add and a
// subtract each), and at N = 512 the bytes take longer than those 32-bit
// operations at the card's integer rate. So each coefficient crosses
// device memory once each way, in 16-byte vectors, and every stage between
// runs in registers.
//
// Why its butterflies subtract as MontCtx does: the input is taken as
// given, with no reduction, and the JAX package's butterflies are
// MontCtx's add, sub and shoup_mul (ringzk_tpu/ops/montgomery.py) at every
// prime. On [0, p) they give the unique residues; other values wrap: add's
// uint32 sum wraps before its conditional subtract, and sub adds p where
// a < b. A difference taken as min(d, d + p) differs there (a = 2^32 - 1,
// b = 0: sub gives 2^32 - 1, the min form p - 1); the lazy form, or K1's
// two conditional subtracts before its stores, would bring the forward's
// output into [0, p) where JAX's lies outside it. So K9 runs ntt_regs.cuh's
// strict form (kStrict = true, whose subtract is rz::sub_mod, MontCtx's) at
// every prime and reduces nothing else; its add and Shoup products equal
// MontCtx's on every uint32 for p < 2^31.
//
// Design, as K1 and K2 (ntt.cu) at one prime: one group of threads per row
// (a warp at N <= 512, N/512 warps above; below N = 128 the lanes past N/4
// repeat), four groups a block at N <= 512; groups past the last row leave
// whole. The forward reads its row once, as 16-byte vectors in pass 0's
// layout, runs every stage in registers with the swizzled transposes
// between passes (through the group's N words of shared memory), and
// stores the image straight from the last pass's layout, E consecutive
// coefficients a thread. The inverse runs the same backwards: it reads in
// the last pass's layout, runs the inverse stages, applies N^-1 by a Shoup
// product in registers and stores from pass 0's layout.
//
// Constants: the wrapper passes a host block of three words (ops/kernels/
// ntt_one.py one_consts: p, N^-1 mod p, its Shoup companion floor(N^-1
// 2^32 / p)), which the kernel takes by value (__grid_constant__), so it
// reads them from the constant bank. Twiddles: prime i's [2][N] uint2 pairs
// (ops/kernels/ntt.py twiddle_pairs), the forward table then the inverse.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "modarith.cuh"
#include "ntt_regs.cuh"

namespace {

using rz::regs::kGroupThreads;
using rz::regs::Plan;
using rz::regs::vec_first;
using rz::regs::vec_last;

// one_consts' three words
struct OneConsts {
  uint32_t p, n_inv, n_inv_shoup;
};

constexpr int kThreads = 128;  // a block: four groups at N <= 512
// Registers a thread may take: N = 8192's group of 512 threads must fit a
// block.
constexpr int kRegCap = 128;

// Vector cc of thread vt: pass 0's layout, or the last pass's.
template <int L, bool kLast>
__device__ __forceinline__ uint32_t vec_at(uint32_t vt, int cc) {
  return kLast ? vec_last<L>(vt, cc) : vec_first<L>(vt, cc);
}

// One row per group: the forward reads pass 0's layout and writes the last
// pass's, the inverse the other way round.
template <int L, bool kInverse>
__device__ __forceinline__ void one_row(const uint32_t* __restrict__ x,
                                        uint32_t* __restrict__ out,
                                        const uint2* __restrict__ tw, const OneConsts& k,
                                        int rows) {
  using P = Plan<L>;
  constexpr int N = P::N, E = P::E, VT = P::VT, GT = kGroupThreads<L>;
  extern __shared__ uint4 smem_vec[];
  const int G = blockDim.x / GT, g = threadIdx.x / GT, gt = threadIdx.x % GT;
  const uint32_t vt = gt & (VT - 1);  // below N = 128 lanes past VT repeat lane vt
  const bool writer = gt < VT;
  const size_t row = static_cast<size_t>(blockIdx.x) * G + g;
  if (row >= static_cast<size_t>(rows)) return;  // the whole group
  const uint32_t* src = x + row * N;
  uint32_t v[E];
#pragma unroll
  for (int cc = 0; cc < E / 4; ++cc) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(src + vec_at<L, kInverse>(vt, cc)));
    v[4 * cc] = a.x;
    v[4 * cc + 1] = a.y;
    v[4 * cc + 2] = a.z;
    v[4 * cc + 3] = a.w;
  }
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem_vec) + g * N;
  if constexpr (kInverse) {
    rz::regs::inv<L, GT, true>(v, buf, tw + N, vt, writer, g, k.p);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = rz::shoup_mul(k.n_inv, k.n_inv_shoup, v[e], k.p);
  } else {
    rz::regs::fwd<L, GT, true>(v, buf, tw, vt, writer, g, k.p);
  }
  if (writer) {
    uint32_t* o = out + row * N;
#pragma unroll
    for (int cc = 0; cc < E / 4; ++cc)
      *reinterpret_cast<uint4*>(o + vec_at<L, !kInverse>(vt, cc)) =
          make_uint4(v[4 * cc], v[4 * cc + 1], v[4 * cc + 2], v[4 * cc + 3]);
  }
}

template <int L>
__global__ void __maxnreg__(kRegCap)
    ntt_fwd_one_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                       const uint2* __restrict__ tw, const __grid_constant__ OneConsts k,
                       int rows) {
  one_row<L, false>(x, out, tw, k, rows);
}

template <int L>
__global__ void __maxnreg__(kRegCap)
    ntt_inv_one_kernel(const uint32_t* __restrict__ xhat, uint32_t* __restrict__ out,
                       const uint2* __restrict__ tw, const __grid_constant__ OneConsts k,
                       int rows) {
  one_row<L, true>(xhat, out, tw, k, rows);
}

template <bool kInverse>
int launch_rows(const uint32_t* x, uint32_t* out, const void* tw, const uint32_t* c, int rows,
                int n, void* stream) {
  if (rows == 0) return 0;
  OneConsts k;
  std::memcpy(&k, c, sizeof(k));
  const uint2* w = static_cast<const uint2*>(tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rz::regs::dispatch(n, [&](auto l) {
    constexpr int L = decltype(l)::value, N = 1 << L, GT = kGroupThreads<L>;
    static_assert(kRegCap * GT <= 65536, "a group must fit a block's registers");
    const auto kern = kInverse ? ntt_inv_one_kernel<L> : ntt_fwd_one_kernel<L>;
    const int groups = GT >= kThreads ? 1 : kThreads / GT;
    const size_t smem = static_cast<size_t>(groups) * N * sizeof(uint32_t);
    if (const int err = rz::regs::set_smem(reinterpret_cast<const void*>(kern), smem))
      return err;
    const unsigned blocks = static_cast<unsigned>((rows + groups - 1) / groups);
    kern<<<blocks, groups * GT, smem, s>>>(x, out, w, k, rows);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// x uint32 [rows, n] (taken as given) -> its image, bit-reversed; tw prime
// i's twiddle pairs, c the host block of one_consts.
extern "C" int rz_ntt_fwd_one(const uint32_t* x, uint32_t* out, const void* tw,
                              const uint32_t* c, int rows, int n, void* stream) {
  return launch_rows<false>(x, out, tw, c, rows, n, stream);
}

// xhat uint32 [rows, n], bit-reversed -> natural order times N^-1.
extern "C" int rz_ntt_inv_one(const uint32_t* xhat, uint32_t* out, const void* tw,
                              const uint32_t* c, int rows, int n, void* stream) {
  return launch_rows<true>(xhat, out, tw, c, rows, n, stream);
}
