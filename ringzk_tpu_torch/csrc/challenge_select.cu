// K4: challenge support selection (top-kappa lanes of a row of uint32 keys).
//
// Replaces ringzk_tpu/ops/pallas/challenge_kernel.py challenge_select_pallas
// (_challenge_kernel), the selection rule of ringzk_tpu/ops/sampling.py
// _mask_topk: keep every lane whose key is above the kappa-th largest key,
// plus the first (kappa - #above) lanes equal to it in ascending lane
// order; emit the lane's sign there and 0 elsewhere.
//
// What bounds it on this card: memory traffic. Per row it must read the
// keys and signs (8N bytes) and write the result (4N): 0.24 ms at
// B=131072, N=512 at 3.35 TB/s. The 32-step search costs a compare and an
// add per key and step, below that at the 32-bit rate. Measured on an
// H100 80GB HBM3 at 700 W (chip_smoke.py [7]): 0.333 ms there, against
// 2.273 ms for the first form of this kernel (a block per row, one key a
// thread, a block barrier every step).
//
// Design: one warp per row for N <= 1024, eight rows to a block, and no
// block barrier. Each thread holds the row's keys in 16-byte vectors, the
// vector at lanes 4t + 4Tc (thread t of T, chunk c), so every load and
// store of the warp is 512 contiguous bytes. The kappa-th largest key is
// found MSB first: step `bit` keeps cand = thr | 2^bit when at least kappa
// keys are >= cand, each count one __reduce_add_sync. Tie ranks follow
// lane order: chunk by chunk, an exclusive warp scan of each thread's tie
// count plus the ties of earlier chunks and of the thread's earlier
// vector lanes. For N = 2048-8192 a row takes N/1024 warps (one block),
// whose per-warp sums meet once a step in shared memory, double buffered
// so that one barrier a step suffices. No sort, as on the TPU.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;  // rows of a one-warp-per-row block
constexpr int kMaxWarps = 8;      // warps of a row at N = 8192

// Row-wide sums over the W warps of one row: a warp reduction, and for
// W > 1 the warp sums exchanged through `red` (two buffers of kMaxWarps,
// alternated by the caller's parity so that one barrier a call suffices).
template <int W>
struct RowSum {
  int* red;
  int parity = 0;

  __device__ __forceinline__ int operator()(int v) {
    v = __reduce_add_sync(0xffffffffu, v);
    if constexpr (W == 1) {
      return v;
    } else {
      int* slot = red + parity * kMaxWarps;
      parity ^= 1;
      if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
      __syncthreads();
      int s = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) s += slot[w];
      return s;
    }
  }

  // (exclusive prefix of v over the row's threads in thread order, total)
  __device__ __forceinline__ int2 scan(int v) {
    const int lane = threadIdx.x & 31;
    int incl = v;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += o;
    }
    const int warp_total = __shfl_sync(0xffffffffu, incl, 31);
    if constexpr (W == 1) {
      return make_int2(incl - v, warp_total);
    } else {
      int* slot = red + parity * kMaxWarps;
      parity ^= 1;
      if (lane == 31) slot[threadIdx.x >> 5] = warp_total;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        before += w < static_cast<int>(threadIdx.x >> 5) ? slot[w] : 0;
        total += slot[w];
      }
      return make_int2(before + incl - v, total);
    }
  }
};

// KV 16-byte vectors of keys per thread, W warps per row.
template <int KV, int W>
__global__ void challenge_select_kernel(const int32_t* __restrict__ u,
                                        const int32_t* __restrict__ signs,
                                        int32_t* __restrict__ out, int rows, int n,
                                        int kappa) {
  __shared__ int red[2 * kMaxWarps];
  constexpr int T = 32 * W;  // threads of a row
  const int tid = threadIdx.x % T;
  const size_t row = static_cast<size_t>(blockIdx.x) * (blockDim.x / T) + threadIdx.x / T;
  if (row >= static_cast<size_t>(rows)) return;  // whole warps: W == 1 blocks hold 8 rows
  // threads holding keys: all of them, but below N = 128 only the first N/4
  const bool has = tid < (n >> 2);
  const size_t base = row * n;

  uint32_t key[4 * KV];
#pragma unroll
  for (int c = 0; c < KV; ++c) {
    int4 v = make_int4(0, 0, 0, 0);
    if (has) v = *reinterpret_cast<const int4*>(u + base + 4 * tid + 4 * T * c);
    key[4 * c] = v.x;
    key[4 * c + 1] = v.y;
    key[4 * c + 2] = v.z;
    key[4 * c + 3] = v.w;
  }

  RowSum<W> row_sum{red};
  // thr = the largest T with #(key >= T) >= kappa: the kappa-th largest key.
  // Threads without keys hold 0, which no cand >= 1 counts.
  uint32_t thr = 0;
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = thr | (1u << bit);
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < 4 * KV; ++e) cnt += key[e] >= cand;
    if (row_sum(cnt) >= kappa) thr = cand;
  }
  int above = 0;
#pragma unroll
  for (int e = 0; e < 4 * KV; ++e) above += key[e] > thr;
  const int need = kappa - row_sum(above);

  int before = 0;  // threshold ties in earlier chunks
#pragma unroll
  for (int c = 0; c < KV; ++c) {
    bool eq[4];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      eq[i] = has && key[4 * c + i] == thr;
      cnt += eq[i];
    }
    const int2 sc = row_sum.scan(cnt);
    int rank = before + sc.x;
    before += sc.y;
    if (!has) continue;
    const size_t at = base + 4 * tid + 4 * T * c;
    const int4 s = *reinterpret_cast<const int4*>(signs + at);
    const int sv[4] = {s.x, s.y, s.z, s.w};
    int o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool keep = key[4 * c + i] > thr || (eq[i] && rank < need);
      rank += eq[i];
      o[i] = keep ? sv[i] : 0;
    }
    *reinterpret_cast<int4*>(out + at) = make_int4(o[0], o[1], o[2], o[3]);
  }
}

template <int KV, int W>
int launch(const int32_t* u, const int32_t* signs, int32_t* out, int rows, int n, int kappa,
           cudaStream_t stream) {
  const int per_block = W == 1 ? kRowsPerBlock : 1;
  const int blocks = (rows + per_block - 1) / per_block;
  challenge_select_kernel<KV, W><<<blocks, 32 * W * per_block, 0, stream>>>(u, signs, out, rows,
                                                                            n, kappa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rz_challenge_select(const int32_t* u, const int32_t* signs, int32_t* out,
                                   int rows, int n, int kappa, void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: case 8: case 16: case 32: case 64: case 128:
      return launch<1, 1>(u, signs, out, rows, n, kappa, s);
    case 256: return launch<2, 1>(u, signs, out, rows, n, kappa, s);
    case 512: return launch<4, 1>(u, signs, out, rows, n, kappa, s);
    case 1024: return launch<8, 1>(u, signs, out, rows, n, kappa, s);
    case 2048: return launch<8, 2>(u, signs, out, rows, n, kappa, s);
    case 4096: return launch<8, 4>(u, signs, out, rows, n, kappa, s);
    case 8192: return launch<8, 8>(u, signs, out, rows, n, kappa, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
