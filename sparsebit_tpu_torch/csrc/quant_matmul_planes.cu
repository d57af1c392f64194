// K6, K7, K8: group-factored matmuls over the column-plane ("fold")
// weight containers, with f32 or int8 activations.
//
// Replaces sparsebit_tpu/ops/quant_matmul.py:57 _qmm_kernel (K8, f32 x,
// "w" planes at 2/4/8 bits), :241 _qmm3_kernel (K7, 3-bit low2 + high1
// planes, f32 or int8 x) and :844 _qmm_a8_kernel (K6, int8 x, "w" planes).
//
// Layout: planes.cuh. low2 and high1 may be column slices of one array
// (the "pl" concat), so each comes with its own row stride.
//
// Math: out[m, n] = sum_g s_g * (dot_g - xsum_g * z_g), dot_g and xsum_g
// over the group's k rows, each group term in f32 and the groups added in
// order. Int8 x (K6, K7 a8): dot_g and xsum_g are exact int32 (__dp4a on
// the unpacked codes); 8-bit codes and zeros shift by -128 so that the
// codes fit a signed byte. Qparams are f32 or bf16, (G, N), or (1, N) per
// channel (one group of K rows). The caller scales int8 results per token.
//
// Bound on the H100: at decode (M <= 64) the weight stream, K * N * bits / 8
// bytes plus the qparams, over 3.35 TB/s. Design, simple first: a block
// owns 32 output columns (one per lane) and all M rows (four warps, one row
// group each), so every weight byte leaves device memory once per launch;
// the block walks K in steps of 32 rows, each thread loading its 32 bytes
// of the step into registers and the x tile going through shared memory.
// Not tuned: byte loads, and blocks of N / 32 columns.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowGroups = kThreads / 32;
constexpr int kCols = 32;  // output columns per block
constexpr int KT = 32;     // k rows per step

__device__ __forceinline__ float load_qparam(const void* p, size_t i,
                                             int bf16) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

template <int BITS>
struct Planes {
  static constexpr int P = BITS == 3 ? 8 : (BITS == 8 ? 1 : 8 / BITS);
  static constexpr int CU = kCols / P;  // packed columns per block
};

template <bool A8>
struct XTile {
  using T = float;
  static constexpr int W = KT;
};
template <>
struct XTile<true> {
  using T = int;  // four int8 activations of consecutive k
  static constexpr int W = KT / 4;
};

template <int BITS, bool A8, int MR>
__global__ void __launch_bounds__(kThreads) planes_kernel(
    const void* __restrict__ xv, const uint8_t* __restrict__ wlo, int ld_lo,
    const uint8_t* __restrict__ whi, int ld_hi, const void* s, const void* z,
    int sz_bf16, float* __restrict__ out, int M, int N, int K, int gs) {
  using Pl = Planes<BITS>;
  using X = XTile<A8>;
  using Dot = typename X::T;
  constexpr int ROWS = kRowGroups * MR;
  __shared__ typename X::T x_sm[ROWS][X::W];
  __shared__ Dot xsum_sm[ROWS];

  const int tid = threadIdx.x, lane = tid % 32, rg = tid / 32;
  const int NPu = N / Pl::P;
  const int u = blockIdx.x * Pl::CU + lane % Pl::CU;
  const int j = lane / Pl::CU;  // output plane of this lane
  const int n = j * NPu + u;
  const bool col_ok = u < NPu;
  const uint8_t* plo = wlo + (BITS == 3 ? (j & 1) * NPu : 0) + u;
  const uint8_t* phi = whi + u;
  const float zshift = (A8 && BITS == 8) ? 128.f : 0.f;

  float acc[MR];
  Dot dot[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    acc[i] = 0.f;
    dot[i] = 0;
  }
  if (tid < ROWS) xsum_sm[tid] = 0;

  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous step's tile is consumed
    for (int idx = tid; idx < ROWS * X::W; idx += kThreads) {
      const int r = idx / X::W, c = idx % X::W;
      typename X::T val = 0;
      if (r < M) {
        if constexpr (A8)
          val = reinterpret_cast<const int*>(
              static_cast<const int8_t*>(xv) + static_cast<size_t>(r) * K +
              k0)[c];
        else
          val = static_cast<const float*>(xv)[static_cast<size_t>(r) * K +
                                              k0 + c];
      }
      x_sm[r][c] = val;
    }
    uint32_t wl[KT], wh[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      wl[kk] = col_ok ? plo[static_cast<size_t>(k0 + kk) * ld_lo] : 0u;
      wh[kk] = (BITS == 3 && col_ok)
                   ? phi[static_cast<size_t>(k0 + kk) * ld_hi]
                   : 0u;
    }
    __syncthreads();
    if (tid < ROWS) {  // this step's part of the row's group sum
      Dot part = 0;
#pragma unroll
      for (int c = 0; c < X::W; ++c) {
        if constexpr (A8)
          part = __dp4a(x_sm[tid][c], 0x01010101, part);
        else
          part = __fadd_rn(part, x_sm[tid][c]);
      }
      if constexpr (A8)
        xsum_sm[tid] += part;
      else
        xsum_sm[tid] = __fadd_rn(xsum_sm[tid], part);
    }
    if constexpr (A8) {
#pragma unroll
      for (int c = 0; c < KT / 4; ++c) {
        int cw = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          int code =
              sbt::plane_code<BITS>(wl[4 * c + t], wh[4 * c + t], j) -
              static_cast<int>(zshift);
          cw |= (code & 0xff) << (8 * t);
        }
#pragma unroll
        for (int i = 0; i < MR; ++i)
          dot[i] = __dp4a(x_sm[rg + kRowGroups * i][c], cw, dot[i]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const float code =
            static_cast<float>(sbt::plane_code<BITS>(wl[kk], wh[kk], j));
#pragma unroll
        for (int i = 0; i < MR; ++i)
          dot[i] = __fmaf_rn(x_sm[rg + kRowGroups * i][kk], code, dot[i]);
      }
    }
    if ((k0 + KT) % gs == 0) {  // group end: fold it into the f32 sums
      const int g = (k0 + KT) / gs - 1;
      __syncthreads();  // every row's xsum of the group is complete
      float sg = 0.f, zg = 0.f;
      if (col_ok) {
        const size_t off = static_cast<size_t>(g) * N + n;
        sg = load_qparam(s, off, sz_bf16);
        zg = load_qparam(z, off, sz_bf16) - zshift;
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float xsum =
            static_cast<float>(xsum_sm[rg + kRowGroups * i]);
        acc[i] = __fadd_rn(
            acc[i], __fmul_rn(__fsub_rn(static_cast<float>(dot[i]),
                                        __fmul_rn(xsum, zg)),
                              sg));
        dot[i] = 0;
      }
      __syncthreads();  // every thread has read the group's xsum
      if (tid < ROWS) xsum_sm[tid] = 0;
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int m = rg + kRowGroups * i;
    if (m < M) out[static_cast<size_t>(m) * N + n] = acc[i];
  }
}

template <int BITS, bool A8>
cudaError_t launch_rows(const void* x, const uint8_t* wlo, int ld_lo,
                        const uint8_t* whi, int ld_hi, const void* s,
                        const void* z, int sz_bf16, float* out, int M, int N,
                        int K, int gs, cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols);
#define SBT_PLANES_LAUNCH(MR)                                               \
  planes_kernel<BITS, A8, MR><<<grid, kThreads, 0, st>>>(                   \
      x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16, out, M, N, K, gs)
  if (M <= kRowGroups)
    SBT_PLANES_LAUNCH(1);
  else if (M <= 2 * kRowGroups)
    SBT_PLANES_LAUNCH(2);
  else if (M <= 4 * kRowGroups)
    SBT_PLANES_LAUNCH(4);
  else
    SBT_PLANES_LAUNCH(16);
#undef SBT_PLANES_LAUNCH
  return cudaGetLastError();
}

template <bool A8>
cudaError_t launch_bits(int bits, const void* x, const uint8_t* wlo,
                        int ld_lo, const uint8_t* whi, int ld_hi,
                        const void* s, const void* z, int sz_bf16,
                        float* out, int M, int N, int K, int gs,
                        cudaStream_t st) {
  switch (bits) {
    case 2:
      return launch_rows<2, A8>(x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                out, M, N, K, gs, st);
    case 3:
      return launch_rows<3, A8>(x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                out, M, N, K, gs, st);
    case 4:
      return launch_rows<4, A8>(x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                out, M, N, K, gs, st);
    case 8:
      return launch_rows<8, A8>(x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                out, M, N, K, gs, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out (M, N) f32. x (M, K): int8 when a8, else f32. wlo: "w" planes, or the
// 3-bit low2, row stride ld_lo bytes; whi: the 3-bit high1 (row stride
// ld_hi), ignored otherwise. s, z (G, N) f32 or bf16 (sz_bf16); gs is the
// effective group size (K per channel). M <= 64, K % gs == 0, gs % 32 == 0,
// N / 32 output tiles (checked by the wrapper).
extern "C" int sbt_qmm_planes(const void* x, int a8, const void* wlo,
                              int ld_lo, const void* whi, int ld_hi, int bits,
                              const void* s, const void* z, int sz_bf16,
                              void* out, int M, int N, int K, int gs,
                              void* stream) {
  if (M < 1 || M > 64 || gs % KT || K % gs)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto lo = static_cast<const uint8_t*>(wlo);
  auto hi = static_cast<const uint8_t*>(whi);
  auto o = static_cast<float*>(out);
  cudaError_t e =
      a8 ? launch_bits<true>(bits, x, lo, ld_lo, hi, ld_hi, s, z, sz_bf16, o,
                             M, N, K, gs, st)
         : launch_bits<false>(bits, x, lo, ld_lo, hi, ld_hi, s, z, sz_bf16,
                              o, M, N, K, gs, st);
  return static_cast<int>(e);
}
