// Code extraction from the column-plane ("fold") containers, shared by the
// column-plane matmuls K6/K7/K8 (quant_matmul_planes.cu) and K4's plane
// mode (layer_fused.cu through w4a8.cuh's PlaneRows).
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

}  // namespace sbt
