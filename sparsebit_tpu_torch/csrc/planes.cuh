// The column-plane ("fold") containers, shared by the column-plane
// matmuls K6/K7/K8 (quant_matmul_planes.cu) and K4's plane mode
// (layer_fused.cu through w4a8.cuh's ptile): code extraction, and the
// cp.async copies both use to stream the planes into shared memory.
//
// Layout (ops/packing.py): with p = 8 / bits codes per byte and NP = N / p,
// byte [k, c] of a 2/4/8-bit "w" holds output column j * NP + c at bits
// j * bits. 3-bit is low2 (K, N/4) plus high1 (K, N/8), NP = N / 8: output
// column j * NP + c takes its low two bits from low2 [k, (j % 2) * NP + c]
// at shift 2 * (j / 2) and bit 2 from high1 [k, c] at shift j. The "pl"
// serving concat holds low2 and high1 side by side in one row.
#pragma once

#include <cstdint>

namespace sbt {

// Unsigned code of output plane j from the low (or only) byte and, at 3
// bits, the high1 byte.
template <int BITS>
__device__ __forceinline__ int plane_code(uint32_t lo, uint32_t hi, int j) {
  if (BITS == 8) return static_cast<int>(lo);
  if (BITS == 3)
    return static_cast<int>(((lo >> (2 * (j >> 1))) & 3u) |
                            (((hi >> j) & 1u) << 2));
  return static_cast<int>((lo >> (j * BITS)) & ((1u << BITS) - 1u));
}

// Four rows of one byte column (row stride bytes apart), k ascending from
// the low byte.
__device__ __forceinline__ uint32_t rows4(const uint8_t* p, int stride) {
  const uint32_t a = __byte_perm(p[0], p[stride], 0x0040);
  const uint32_t b = __byte_perm(p[2 * stride], p[3 * stride], 0x0040);
  return __byte_perm(a, b, 0x5410);
}

// The dp4a word of plane j from the four-row words (rows4) of the low (or
// only) bytes of its plane parity (lo) and, at 3 bits, of high1 (hi).
// 8-bit codes are shifted by -128 to fit a signed byte.
template <int BITS>
__device__ __forceinline__ int plane_word(uint32_t lo, uint32_t hi, int j) {
  if (BITS == 8) return static_cast<int>(lo ^ 0x80808080u);  // code - 128
  if (BITS == 3)
    return static_cast<int>(((lo >> (2 * (j >> 1))) & 0x03030303u) |
                            (((hi >> j) & 0x01010101u) << 2));
  constexpr uint32_t mask = BITS == 4 ? 0x0f0f0f0fu : 0x03030303u;
  return static_cast<int>((lo >> (j * BITS)) & mask);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy vec bytes (16, 8 or 4 by cp.async; 1 by a plain load) from src to
// shared dst, or zeros when !valid. src and dst are vec-aligned.
__device__ __forceinline__ void copy_chunk(void* dst, const uint8_t* src,
                                           int vec, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? vec : 0;
  switch (vec) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(n)
                   : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(src), "r"(n)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(n)
                   : "memory");
      break;
    default:
      *static_cast<uint8_t*>(dst) = valid ? __ldg(src) : uint8_t{0};
  }
}

}  // namespace sbt
