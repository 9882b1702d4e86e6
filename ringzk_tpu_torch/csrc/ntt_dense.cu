// K10: the single-prime negacyclic NTT as one int8 GEMM (the dense engine).
//
// Replaces archive/ntt_dense_kernel.py dense_apply_pallas (_dense_kernel),
// the transform of archive/ntt_mxu.py fwd_one_dense / inv_one_dense: the
// four balanced base-256 digits of each int32 of x [rows, N] form the row
// [rows, 4N] (columns ordered (u, j)), which is multiplied by a constant
// int8 operator M [4N, 4N] (ops/ntt_dense.py _tables_dense: the psi twist,
// the bit-reversed order, the digit weights 256^u and, for the inverse,
// N^-1 and the psi^-j un-twist) into int32 planes h [rows, 4, N], folded mod
// p plane by plane: out = sum_w (h_w mod p) * 256^w mod p in [0, p), uint32.
//
// What bounds it on this card: the tensor cores. A row costs 2 * 4N * 4N
// int8 operations against 8N bytes of traffic (the operator, 4 MB at N=512
// and 16 MB at N=1024, stays in L2): 4N = 2,048 operations per byte at N=512.
//
// Design: K3's GEMM (matvec_tiles.cuh digit_gemm, kDense) with the
// contraction taken over j in 32-deep slices: the producer stages
// x[b, j0 .. j0 + 32] once as int32, and the consumers split it into its
// four digits u in registers (byte u of x + 0x80808080, ^ 0x80) and
// multiply digit u with the sixteen N x N blocks (u, w) of the operator,
// M[u*N + j, w*N + c] (ops/kernels/ntt_dense.py dense_planes, packed once
// by the wrapper into the K-major tiles wgmma reads), accumulating output
// plane w: 16 wgmma a stage into 4 accumulators. The [rows, 4N] digit matrix
// never reaches device memory, and x is read once per 64-column tile (not
// once per digit). Each warpgroup's 64 x 64 output tile holds all four
// planes of its columns in registers, so the per-plane fold
// (ntt_mxu._fold_planes: a reduction of each plane's int32 bits, a
// Montgomery product by 256^w * R mod p, a strict add) stays in registers
// too. A contraction sum is at most 4N * 128^2 = 2^26 at N=1024: int32 is
// exact. Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 3.37 ms
// forward or inverse at 393,216 rows, N=512 (49% of the int8 peak), where
// torch._int_mm of the digit planes alone takes 4.64 ms with the operator
// column-major and 25.0 ms row-major.
//
// Constant block `c` (uint32): p, -p^-1 mod 2^32, floor(2^32 / p),
// (-2^32) mod p, 256^w * R mod p for w < 4.

#include "matvec_tiles.cuh"

namespace {

using rz::mv::kKeyDigits;

struct FoldPlanes {
  uint32_t* out;
  const uint32_t* c;

  __device__ __forceinline__ uint32_t fold(const int32_t (&h)[kKeyDigits]) const {
    const uint32_t p = __ldg(c), pinv = __ldg(c + 1), one_sh = __ldg(c + 2),
                   neg_corr = __ldg(c + 3);
    uint32_t r = rz::reduce_i32(h[0], p, one_sh, neg_corr);
#pragma unroll
    for (int w = 1; w < kKeyDigits; ++w) {
      const uint32_t hw = rz::reduce_i32(h[w], p, one_sh, neg_corr);
      r = rz::add_mod31(r, rz::mont_mul(hw, __ldg(c + 4 + w), p, pinv), p);
    }
    return r;
  }

  __device__ __forceinline__ void operator()(size_t idx, const int32_t (&h0)[kKeyDigits],
                                             const int32_t (&h1)[kKeyDigits]) const {
    *reinterpret_cast<uint2*>(out + idx) = make_uint2(fold(h0), fold(h1));
  }
};

__global__ void __launch_bounds__(rz::mv::kThreads, 1)
    ntt_dense_kernel(const __grid_constant__ rz::mv::Args a) {
  rz::mv::digit_gemm<kKeyDigits, true>(a, FoldPlanes{static_cast<uint32_t*>(a.out), a.c});
}

}  // namespace

extern "C" int rz_ntt_dense(const int32_t* x, const int8_t* m, uint32_t* out, const uint32_t* c,
                            int rows, int n, void* stream) {
  if (n < 32 || n % rz::mv::kBK) return static_cast<int>(cudaErrorInvalidValue);
  const rz::mv::Args a{{}, m, out, c, rows, n, n,
                       (n + rz::mv::kBN - 1) / rz::mv::kBN, n / rz::mv::kBK};
  return rz::mv::launch<kKeyDigits, true>(ntt_dense_kernel, x, a,
                                          static_cast<cudaStream_t>(stream));
}
