// The narrow ring's centred mod-q add and sub, in one pass.
//
// Replaces no TPU kernel: the JAX package's zq.add_centered / sub_centered
// are a few jnp operations that XLA fuses into one elementwise loop. In
// eager PyTorch the same chain (ops/kernels/modq.py modq_add_plain /
// modq_sub_plain: to_unsigned of both operands, MontCtx.add or sub,
// to_centered) runs as about twenty int64 passes, each writing an 8-byte
// [B, rows, N] intermediate to device memory; on an H100 those passes took
// half of an opening proof batch's device time. This kernel computes the
// same integers, bit for bit.
//
// Semantics, for every int32 a and b (not only centred ones): an operand
// enters as the uint32 a + (a < 0 ? q : 0), wrapping (to_unsigned); the add
// takes MontCtx.add's branch for its q: below 2^31 the uint32 sum wraps and
// one conditional subtract follows (rz::add_mod31), above 2^31 a carry-out
// also subtracts (rz::add_mod); the sub is MontCtx.sub's compare-and-add
// (rz::sub_mod); the residue is centred as to_centered does, wrapping
// (rz::to_centered).
//
// Shapes: a, b, out int32 of `count` elements, contiguous and on 16-byte
// boundaries (the wrapper broadcasts and copies what is not); q odd, q < 2^32.
//
// What bounds it on this card: bytes. Each element reads 8 B and writes 4 B,
// 12 B at 3.35 TB/s: 0.48 ms for open N=512's commit add ([131072, 2, 512]),
// against about 20 32-bit integer operations an element, a third of that
// time at the ALU rate (1.673e13/s). Measured on an H100 80GB HBM3 at 700 W:
// 0.56 ms there, 86% of the bound, against 18.6 ms for the plain chain;
// 1.10 ms at [131072, 2, 1024] (87%). chip_smoke.py [7] times it at each
// of the benchmark cells' shapes beside its bound.
//
// Design: a grid-stride loop over 16-byte vectors, four elements a thread a
// pass from each operand and one 16-byte store, at most eight blocks of 256
// threads an SM: every thread of the card is resident, each with two
// 16-byte loads in flight. The last count mod 4 elements go to a masked
// scalar tail. The arithmetic stays in registers (no int64 value is ever
// stored), and nothing but a, b and out touches device memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: an SM's whole complement

// An int32 operand as MontCtx's uint32 residue: a + q for a < 0, wrapping.
__device__ __forceinline__ uint32_t to_unsigned(int32_t a, uint32_t q) {
  return static_cast<uint32_t>(a) + (a < 0 ? q : 0u);
}

// Carry: q > 2^31, where MontCtx.add tracks the carry-out of the sum.
template <bool Sub, bool Carry>
__device__ __forceinline__ int32_t addsub(int32_t a, int32_t b, uint32_t q) {
  const uint32_t ua = to_unsigned(a, q), ub = to_unsigned(b, q);
  uint32_t u;
  if constexpr (Sub) {
    u = rz::sub_mod(ua, ub, q);
  } else if constexpr (Carry) {
    u = rz::add_mod(ua, ub, q);
  } else {
    u = rz::add_mod31(ua, ub, q);
  }
  return rz::to_centered(u, q);
}

template <bool Sub, bool Carry>
__global__ void __launch_bounds__(kThreads)
    modq_addsub_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                       int32_t* __restrict__ out, uint32_t q, long long count) {
  const long long vecs = count / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int4* a4 = reinterpret_cast<const int4*>(a);
  const int4* b4 = reinterpret_cast<const int4*>(b);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = first; i < vecs; i += stride) {
    const int4 x = __ldg(a4 + i), y = __ldg(b4 + i);
    out4[i] = make_int4(addsub<Sub, Carry>(x.x, y.x, q), addsub<Sub, Carry>(x.y, y.y, q),
                        addsub<Sub, Carry>(x.z, y.z, q), addsub<Sub, Carry>(x.w, y.w, q));
  }
  const long long tail = 4 * vecs + first;
  if (tail < count) out[tail] = addsub<Sub, Carry>(a[tail], b[tail], q);
}

template <bool Sub>
int launch(const int32_t* a, const int32_t* b, int32_t* out, uint32_t q, long long count,
           void* stream) {
  if (count == 0) return 0;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long needed = (count / 4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
  const int blocks = static_cast<int>(needed < 1 ? 1 : needed < cap ? needed : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q < 0x80000000u) {
    modq_addsub_kernel<Sub, false><<<blocks, kThreads, 0, s>>>(a, b, out, q, count);
  } else {
    modq_addsub_kernel<Sub, true><<<blocks, kThreads, 0, s>>>(a, b, out, q, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = (a + b) mod q, centred; a, b any int32 (see the note above).
extern "C" int rz_modq_add(const int32_t* a, const int32_t* b, int32_t* out, unsigned q,
                           long long count, void* stream) {
  return launch<false>(a, b, out, q, count, stream);
}

// out = (a - b) mod q, centred.
extern "C" int rz_modq_sub(const int32_t* a, const int32_t* b, int32_t* out, unsigned q,
                           long long count, void* stream) {
  return launch<true>(a, b, out, q, count, stream);
}
