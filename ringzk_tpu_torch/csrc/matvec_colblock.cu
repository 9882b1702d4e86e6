// K6: the int8 digit matvec with its single-REDC mod-q fold, for keys past
// the resident gate, which store the blocked operator (N >= 1024 at the
// default parameters).
//
// Replaces ringzk_tpu/ops/pallas/matvec_kernel.py:217
// matvec_digits_colblock (_matvec_colblock_kernel / _digits_matmul_fold).
//
// v int32 [B, kN], the packed operator (ops/kernels/matvec.py pack_planes of
// the key's [4, kN, rowsN] planes: the same tensor the side-by-side layout
// of the same key packs to), out centered int32 [B, rowsN]. The body is
// K3's (matvec_tiles.cuh); only the name differs.
//
// What bounds it: the int8 operations. At open's N = 1024 shapes
// (B = 131072, kN = 3072, rowsN = 1024, v_digits = 3) one call is 4.9e12
// int8 multiply-adds, 5.0 ms at the dense int8 peak, against 1.6 GB of v
// read and 0.54 GB written (0.64 ms at the memory rate). The TPU kernel keeps
// a [128, kN] input slab in VMEM while column slabs stream past it; here a
// CTA stages 32-deep k slices of 128 rows of v (one TMA box) and one
// 64-column operator tile (one cp.async.bulk) through a four-stage ring
// with mbarriers, and the 16 column
// tiles of one batch slab run next to each other in the launch order, so the
// slab is read from device memory about once and from L2 16 times (25.8 GB
// from L2 a call at N = 1024, with 12.9 GB of operator tiles). The operator
// (12.6 MB at N = 1024) fits the 50 MB L2; at N = 2048 (50 MB) and N = 4096
// (201 MB) it does not, and each CTA streams its column tile's 4 * kN * 64
// bytes: 192 slabs x 32 tiles x 1.6 MB = 9.7 GB at N = 2048 (B = 24576),
// 16 x 64 x 3.1 MB = 3.2 GB at N = 4096 (B = 2048), against v read once
// (0.6 and 0.1 GB). The 132 CTAs in flight cover about four slabs at
// N = 2048 and two at N = 4096, so the whole operator passes through L2
// about once per four (two) slabs: some 2.4 GB (1.6 GB) from device memory.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 7.91 ms at
// N = 1024, v_digits = 3 (63% of the int8 peak), 4.82 ms at v_digits = 1
// (35%), 5.54 ms at N = 2048 (68%) and 1.83 ms at N = 4096 (68%).

#include "matvec_tiles.cuh"

namespace {

template <int VD>
__global__ void __launch_bounds__(rz::mv::kThreads, 1)
    matvec_colblock_kernel(const __grid_constant__ rz::mv::Args a) {
  rz::mv::digit_gemm<VD, false>(
      a, rz::mv::FoldCentered{static_cast<int32_t*>(a.out), a.c});
}

}  // namespace

extern "C" int rz_matvec_colblock(const int32_t* v, const int8_t* w, int32_t* out,
                                  const uint32_t* c, int B, int kn, int rows_n, int v_digits,
                                  void* stream) {
  return rz::mv::launch_matvec<matvec_colblock_kernel<1>, matvec_colblock_kernel<2>,
                               matvec_colblock_kernel<3>, matvec_colblock_kernel<4>>(
      v, w, out, c, B, kn, rows_n, v_digits, stream);
}
