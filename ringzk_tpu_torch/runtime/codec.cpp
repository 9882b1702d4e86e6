// Native RZK1 row codec of the PyTorch port: per-row trailing-zero-trimmed
// zigzag varints, the compact encoding of ``utils/serial.py``.
//
// The port's own copy of ringzk_tpu/runtime/codec.cpp, with the same C
// interface and the same bytes, and two changes to the decoder:
//   * a varint whose value passes 32 bits is corrupt (on its fifth byte,
//     b > 0x0F); the JAX package's copy drops those bits and wraps;
//   * rzk_decode_rows_ex names the fault it met (RZK_FAULT_*), so the caller
//     raises the same message as the numpy decoder: every row's header and
//     varint terminators are checked first, in order, and a varint that is
//     too long or too large is reported only when the stream is whole, as
//     the vectorized numpy decoder does.
//
// Row format (per polynomial of row_len coefficients):
//   u32 LE kept       -- number of coefficients kept (trailing zeros trimmed)
//   kept x varint     -- zigzag-encoded little-endian base-128 varints
//
// Built at first use by ringzk_tpu_torch/runtime/__init__.py with the host
// C++ compiler (-O3 -shared -fPIC -pthread).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

enum : int32_t {
  RZK_OK = 0,
  RZK_FAULT_HEADER = 1,    // the payload ends inside a row header
  RZK_FAULT_KEPT = 2,      // a row keeps more coefficients than it has
  RZK_FAULT_TRUNCATED = 3, // the payload ends inside the varints of a row
  RZK_FAULT_VARINT = 4,    // a varint longer than 5 bytes or past 32 bits
};

extern "C" {

// Upper bound on encoded size for allocation: 4 bytes header + 5 bytes per
// coefficient, per row.
uint64_t rzk_encode_bound(uint64_t n_rows, uint64_t row_len) {
  return n_rows * (4 + 5 * row_len);
}

// Encode n_rows rows of row_len int32 coeffs. Returns bytes written.
uint64_t rzk_encode_rows(const int32_t* data, uint64_t n_rows,
                         uint64_t row_len, uint8_t* out) {
  uint8_t* p = out;
  for (uint64_t r = 0; r < n_rows; ++r) {
    const int32_t* row = data + r * row_len;
    uint64_t kept = row_len;
    while (kept > 0 && row[kept - 1] == 0) --kept;
    p[0] = (uint8_t)(kept);
    p[1] = (uint8_t)(kept >> 8);
    p[2] = (uint8_t)(kept >> 16);
    p[3] = (uint8_t)(kept >> 24);
    p += 4;
    for (uint64_t i = 0; i < kept; ++i) {
      uint32_t z = ((uint32_t)row[i] << 1) ^ (uint32_t)(row[i] >> 31);  // zigzag
      while (z >= 0x80) {
        *p++ = (uint8_t)(z | 0x80);
        z >>= 7;
      }
      *p++ = (uint8_t)z;
    }
  }
  return (uint64_t)(p - out);
}

// Decode into a pre-zeroed n_rows x row_len int32 buffer. Returns bytes
// consumed and sets *fault to RZK_OK, or returns 0 and sets *fault to the
// first fault met (structural faults, in row order, before varint faults).
uint64_t rzk_decode_rows_ex(const uint8_t* in, uint64_t in_len, int32_t* data,
                            uint64_t n_rows, uint64_t row_len,
                            int32_t* fault) {
  const uint8_t* p = in;
  const uint8_t* end = in + in_len;
  bool bad_varint = false;
  for (uint64_t r = 0; r < n_rows; ++r) {
    if (end - p < 4) {
      *fault = RZK_FAULT_HEADER;
      return 0;
    }
    uint32_t kept = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                    ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    p += 4;
    if (kept > row_len) {
      *fault = RZK_FAULT_KEPT;
      return 0;
    }
    int32_t* row = data + r * row_len;
    for (uint32_t i = 0; i < kept; ++i) {
      uint64_t z = 0;
      int len = 0;
      for (;;) {
        if (p >= end) {
          *fault = RZK_FAULT_TRUNCATED;
          return 0;
        }
        uint8_t b = *p++;
        if (len < 5) z |= (uint64_t)(b & 0x7F) << (7 * len);
        ++len;
        if (!(b & 0x80)) break;
      }
      if (len > 5 || z > 0xFFFFFFFFull) {
        bad_varint = true;  // reported once the rows are whole
        continue;
      }
      uint32_t u = (uint32_t)z;
      row[i] = (int32_t)((u >> 1) ^ (~(u & 1) + 1));  // un-zigzag
    }
  }
  if (bad_varint) {
    *fault = RZK_FAULT_VARINT;
    return 0;
  }
  *fault = RZK_OK;
  return (uint64_t)(p - in);
}

// The JAX package's entry point: bytes consumed, or 0 on malformed input.
uint64_t rzk_decode_rows(const uint8_t* in, uint64_t in_len, int32_t* data,
                         uint64_t n_rows, uint64_t row_len) {
  int32_t fault;
  return rzk_decode_rows_ex(in, in_len, data, n_rows, row_len, &fault);
}

// Multithreaded encode for large payloads (the multi-host interchange path:
// e.g. 64K proofs' worth of responses). Rows are independent, so each thread
// encodes a contiguous row chunk into its bound-sized slot of `out`; the
// main thread then compacts the slots left with memmove. Byte-identical
// output to rzk_encode_rows. n_threads <= 1 falls through to single-thread.
uint64_t rzk_encode_rows_mt(const int32_t* data, uint64_t n_rows,
                            uint64_t row_len, uint8_t* out,
                            uint32_t n_threads) {
  if (n_threads <= 1 || n_rows < 2 * n_threads) {
    return rzk_encode_rows(data, n_rows, row_len, out);
  }
  uint64_t chunk = (n_rows + n_threads - 1) / n_threads;
  uint64_t slot = chunk * (4 + 5 * row_len);  // per-chunk bound
  std::vector<uint64_t> sizes(n_threads, 0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (uint32_t t = 0; t < n_threads; ++t) {
    uint64_t r0 = (uint64_t)t * chunk;
    if (r0 >= n_rows) break;
    uint64_t rows_here = (r0 + chunk <= n_rows) ? chunk : (n_rows - r0);
    threads.emplace_back([=, &sizes]() {
      sizes[t] = rzk_encode_rows(data + r0 * row_len, rows_here, row_len,
                                 out + (uint64_t)t * slot);
    });
  }
  for (auto& th : threads) th.join();
  // compact: slot t's bytes move to the end of slot t-1's bytes
  uint64_t total = sizes[0];
  for (uint32_t t = 1; t < n_threads; ++t) {
    if (sizes[t] == 0) continue;
    std::memmove(out + total, out + (uint64_t)t * slot, sizes[t]);
    total += sizes[t];
  }
  return total;
}

}  // extern "C"
