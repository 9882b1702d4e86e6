// K3: the int8 digit matvec with its single-REDC mod-q fold, for keys that
// store the operator with its planes side by side.
//
// Replaces ringzk_tpu/ops/pallas/matvec_kernel.py matvec_digits_pallas
// (_matvec_kernel / _digits_matmul_fold), the algebra of
// ringzk_tpu/ops/conv_mxu.py matvec_digits.
//
// v int32 [B, kN], the packed operator (ops/kernels/matvec.py pack_planes of
// the key's [kN, 4 * rowsN] planes), out centered int32 [B, rowsN]. The
// GEMM, its pipeline and its fold are matvec_tiles.cuh's; K6 runs the same
// body on the same packed tensor and differs only in its name, so that a
// profile tells the two layouts' paths apart.
//
// What bounds it on this card: the int8 tensor cores at v_digits = 3 (at
// B = 131072, kN = 1536, rowsN = 512 one call is 1.2e12 multiply-adds,
// 1.25 ms at the dense int8 peak, against 0.8 GB of v read once and
// 0.27 GB written), and the bytes from L2 into the SMs: each CTA reads its
// 128 rows of v as int32 (4 bytes per k per row, for v_digits one-byte
// digits) and its 64 operator columns, 24 KB a k step, about 9.6 GB from L2
// a call. The design (matvec_tiles.cuh): a four-stage ring filled by one
// producer thread (a TMA box of v and a cp.async.bulk of the packed
// operator per stage) with mbarriers, the digit split in the consumers'
// registers, wgmma with A from registers and the pre-packed K-major operator
// from shared memory, and column tiles of one batch slab adjacent in the
// launch order so that v comes from device memory about once. Measured by
// chip_smoke.py on an H100 80GB HBM3 at 700 W: 2.36 ms at v_digits = 3,
// 53% of the int8 peak; 1.48 ms at v_digits = 1 (28%), where the 9.6 GB
// from L2 (about 6.5 TB/s) set the time rather than the multiply-adds.

#include "matvec_tiles.cuh"

namespace {

template <int VD>
__global__ void __launch_bounds__(rz::mv::kThreads, 1)
    matvec_digits_kernel(const __grid_constant__ rz::mv::Args a) {
  rz::mv::digit_gemm<VD, false>(
      a, rz::mv::FoldCentered{static_cast<int32_t*>(a.out), a.c});
}

}  // namespace

extern "C" int rz_matvec_digits(const int32_t* v, const int8_t* w, int32_t* out,
                                const uint32_t* c, int B, int kn, int rows_n, int v_digits,
                                void* stream) {
  return rz::mv::launch_matvec<matvec_digits_kernel<1>, matvec_digits_kernel<2>,
                               matvec_digits_kernel<3>, matvec_digits_kernel<4>>(
      v, w, out, c, B, kn, rows_n, v_digits, stream);
}
