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
// Math: out[m, n] = sum_g s_g * (x_g . (C_g - z_g)), the groups in order.
// Int8 x (K6, K7 a8): the group dot is exact int32 (__dp4a), folded as
// s_g * (dot_g - xsum_g * z_g) with xsum_g exact as well; 8-bit codes and
// zeros shift by -128 so that the codes fit a signed byte. F32 x (K8, K7):
// FMA in f32 of x and (code - z_g), the code taken to f32 exactly, then
// times s_g at the group's end (the same sum as the factored form up to
// f32 rounding, without the cancellation of x.C against xsum * z). No
// TF32. Qparams are f32 or bf16, (G, N), or (1, N) per channel (one group
// of K rows). The caller scales int8 results per token.
//
// Bound on the H100: at decode (M <= 64) the weight stream, K * N * bits / 8
// bytes plus the qparams, over 3.35 TB/s; at M = 64 the f32 FMAs (67
// TFLOP/s). Design:
//   - a block owns CB byte columns of the planes and with them all P
//     output planes (columns j * NP + c): each weight byte leaves device
//     memory once per launch and is decoded into P columns. Its threads
//     are CB byte columns x RG row groups of MR rows;
//   - K is split across blocks at group boundaries (gps groups a split)
//     so that every shape has ~2 blocks an SM; each split writes an f32
//     partial (M, N) and a second launch adds the partials in split
//     order: two calls give equal bits, nothing is atomic;
//   - a ring of kStages stages of KT = 32 rows in shared memory, filled by
//     cp.async 16 bytes a copy (narrower where a base pointer, a row
//     stride or NP is not 16-byte aligned, byte loads where not even 4),
//     kStages - 1 stages in flight ahead of the one being read, one block
//     barrier a stage. A stage holds the weight rows (low2 of the even
//     planes, of the odd planes and high1 at 3 bits) and the x slice of
//     those rows (zeros past M), so x also leaves L2 once per block;
//   - the next group's scales and zeros are loaded a group ahead into
//     registers;
//   - int8: four rows of a byte column become one 32-bit word (two byte
//     permutes), and each plane's dp4a word is a shift and a mask of it
//     (3 bits: low2 | high1 << 2 in three operations); f32: a code becomes
//     f32 by an OR into the mantissa of 2^23 and a subtraction.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int KT = 32;       // k rows a stage
constexpr int kLogKT = 5;
constexpr int kStages = 4;   // ring depth
constexpr int kXsF = KT + 4;   // f32 x row stride in shared memory (floats)
constexpr int kXs8 = KT + 16;  // int8 x row stride (bytes)

__device__ __forceinline__ float load_qparam(const void* p, size_t i,
                                             int bf16) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

template <int BITS>
struct Planes {
  static constexpr int P = BITS == 3 ? 8 : (BITS == 8 ? 1 : 8 / BITS);
  static constexpr int NA = BITS == 3 ? 3 : 1;  // byte arrays a row
};

__device__ __forceinline__ float code_f32(int code) {
  return __uint_as_float(0x4B000000u | static_cast<uint32_t>(code)) -
         8388608.f;
}

// grid (tiles, splits), kThreads threads: thread (rg, cc) holds rows
// rg * MR .. + MR - 1 of byte column c0 + cc, all P planes.
template <int BITS, bool A8, int MR>
__global__ void __launch_bounds__(kThreads) planes_kernel(
    const void* __restrict__ xv, const uint8_t* __restrict__ wlo, int ld_lo,
    const uint8_t* __restrict__ whi, int ld_hi, const void* s, const void* z,
    int sz_bf16, float* __restrict__ dst, int M, int N, int K, int gs,
    int CB, int gps, int vec) {
  using Pl = Planes<BITS>;
  constexpr int P = Pl::P, NA = Pl::NA;
  constexpr int XB = A8 ? 1 : 4;  // bytes an x value
  constexpr int XS = A8 ? kXs8 : kXsF * 4;  // x row stride, bytes
  extern __shared__ __align__(16) uint8_t smem[];

  const int RG = kThreads / CB, ROWS = RG * MR;
  const int NP = N / P;
  const int tid = threadIdx.x, cc = tid % CB, rg = tid / CB;
  const int c0 = blockIdx.x * CB, c = c0 + cc;
  const bool col_ok = c < NP;
  const int G = K / gs, g0 = blockIdx.y * gps;
  const int g1 = min(G, g0 + gps);
  const int k0 = g0 * gs;
  const int nst = (g1 - g0) * gs / KT, spg = gs / KT;
  const size_t w_stage = static_cast<size_t>(NA) * KT * CB;
  const size_t stage = w_stage + static_cast<size_t>(ROWS) * XS;
  const float zshift = (A8 && BITS == 8) ? 128.f : 0.f;

  // chunks a weight row: 2^lw (CB and vec are powers of two), so that
  // the copy indices are shifts, not divisions
  const int lw = __ffs(CB / vec) - 1;
  auto issue = [&](int st) {
    uint8_t* sw = smem + static_cast<size_t>(st % kStages) * stage;
    const int kr = k0 + st * KT;
    const int n_w = NA * KT << lw;
    constexpr int xch = KT * XB / 16;  // x chunks a row
    const int n_all = n_w + ROWS * xch;
    for (int i = tid; i < n_all; i += kThreads) {
      if (i < n_w) {
        const int a = i >> (lw + kLogKT), r = (i >> lw) & (KT - 1);
        const int ch = i & ((1 << lw) - 1);
        const int col = c0 + ch * vec;
        const uint8_t* row =
            a == 2 ? whi + static_cast<size_t>(kr + r) * ld_hi
                   : wlo + static_cast<size_t>(kr + r) * ld_lo + a * NP;
        sbt::copy_chunk(sw + (a * KT + r) * CB + ch * vec, row + col, vec,
                   col < NP);
      } else {
        const int j = i - n_w, m = j / xch, ch = j % xch;
        const uint8_t* src =
            static_cast<const uint8_t*>(xv) +
            (static_cast<size_t>(m < M ? m : 0) * K + kr) * XB + ch * 16;
        sbt::copy_chunk(sw + w_stage + m * XS + ch * 16, src, 16, m < M);
      }
    }
  };

  float acc[MR][P], dotf[MR][P];
  int doti[MR][P], xsum[MR];
  float sc[P], zc[P], sn[P], zn[P];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    xsum[i] = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      acc[i][j] = dotf[i][j] = 0.f;
      doti[i][j] = 0;
    }
  }
  auto load_sz = [&](int g) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      sn[j] = zn[j] = 0.f;
      if (col_ok) {
        const size_t off = static_cast<size_t>(g) * N + j * NP + c;
        sn[j] = load_qparam(s, off, sz_bf16);
        zn[j] = load_qparam(z, off, sz_bf16) - zshift;
      }
    }
  };
  load_sz(g0);

  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) issue(st);
    sbt::cp_commit();
  }
  for (int st = 0; st < nst; ++st) {
    sbt::cp_wait<kStages - 2>();
    __syncthreads();  // stage st is in; stage st - 1 is read by all
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    sbt::cp_commit();
    if (st % spg == 0) {  // a group starts: its qparams, the next's ahead
      const int g = g0 + st / spg;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        sc[j] = sn[j];
        zc[j] = zn[j];
      }
      if (g + 1 < g1) load_sz(g + 1);
    }
    const uint8_t* sw = smem + static_cast<size_t>(st % kStages) * stage;
    const uint8_t* w0 = sw + cc;
    const uint8_t* sx = sw + w_stage + static_cast<size_t>(rg) * MR * XS;
    if constexpr (A8) {
#pragma unroll 2
      for (int kk = 0; kk < KT; kk += 4) {
        int xw[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xw[i] = *reinterpret_cast<const int*>(sx + i * XS + kk);
        const uint32_t lo0 = sbt::rows4(w0 + kk * CB, CB);
        const uint32_t lo1 =
            NA == 3 ? sbt::rows4(w0 + (KT + kk) * CB, CB) : 0u;
        const uint32_t hi =
            NA == 3 ? sbt::rows4(w0 + (2 * KT + kk) * CB, CB) : 0u;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int cw =
              sbt::plane_word<BITS>((BITS == 3 && (j & 1)) ? lo1 : lo0, hi, j);
#pragma unroll
          for (int i = 0; i < MR; ++i) doti[i][j] = __dp4a(xw[i], cw, doti[i][j]);
        }
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xsum[i] = __dp4a(xw[i], 0x01010101, xsum[i]);
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < KT; kk += 4) {
        float4 xq[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xq[i] = *reinterpret_cast<const float4*>(sx + i * XS + kk * 4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t lo0 = w0[(kk + t) * CB];
          const uint32_t lo1 = NA == 3 ? w0[(KT + kk + t) * CB] : 0u;
          const uint32_t hi = NA == 3 ? w0[(2 * KT + kk + t) * CB] : 0u;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const float cz = code_f32(sbt::plane_code<BITS>(
                                 (BITS == 3 && (j & 1)) ? lo1 : lo0, hi,
                                 j)) -
                             zc[j];
#pragma unroll
            for (int i = 0; i < MR; ++i) {
              const float xi = t == 0   ? xq[i].x
                               : t == 1 ? xq[i].y
                               : t == 2 ? xq[i].z
                                        : xq[i].w;
              dotf[i][j] = fmaf(xi, cz, dotf[i][j]);
            }
          }
        }
      }
    }
    if ((st + 1) % spg == 0) {  // the group ends: fold it in
#pragma unroll
      for (int i = 0; i < MR; ++i) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if constexpr (A8) {
            acc[i][j] = __fadd_rn(
                acc[i][j],
                __fmul_rn(__fsub_rn(static_cast<float>(doti[i][j]),
                                    __fmul_rn(static_cast<float>(xsum[i]),
                                              zc[j])),
                          sc[j]));
            doti[i][j] = 0;
          } else {
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(dotf[i][j], sc[j]));
            dotf[i][j] = 0.f;
          }
        }
        xsum[i] = 0;
      }
    }
  }
  sbt::cp_wait<0>();
  if (!col_ok) return;
  float* o = dst + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int m = rg * MR + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < P; ++j)
      o[static_cast<size_t>(m) * N + j * NP + c] = acc[i][j];
  }
}

// out = sum over the splits, in split order, of part (splits, MN).
__global__ void planes_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, size_t MN,
                                     int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float a = part[i];
  for (int sp = 1; sp < splits; ++sp) a += part[sp * MN + i];
  out[i] = a;
}

template <int BITS, bool A8, int MR>
cudaError_t launch_one(const void* x, const uint8_t* wlo, int ld_lo,
                       const uint8_t* whi, int ld_hi, const void* s,
                       const void* z, int sz_bf16, float* dst, int M, int N,
                       int K, int gs, int CB, int gps, int splits, int vec,
                       cudaStream_t st) {
  using Pl = Planes<BITS>;
  const int rows = kThreads / CB * MR;
  const size_t stage = static_cast<size_t>(Pl::NA) * KT * CB +
                       static_cast<size_t>(rows) * (A8 ? kXs8 : kXsF * 4);
  const size_t smem = kStages * stage;
  auto kern = planes_kernel<BITS, A8, MR>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int NP = N / Pl::P;
  const dim3 grid((NP + CB - 1) / CB, splits);
  kern<<<grid, kThreads, smem, st>>>(x, wlo, ld_lo, whi, ld_hi, s, z,
                                     sz_bf16, dst, M, N, K, gs, CB, gps, vec);
  return cudaGetLastError();
}

template <int BITS, bool A8>
cudaError_t launch_rows(int MR, const void* x, const uint8_t* wlo, int ld_lo,
                        const uint8_t* whi, int ld_hi, const void* s,
                        const void* z, int sz_bf16, float* dst, int M, int N,
                        int K, int gs, int CB, int gps, int splits, int vec,
                        cudaStream_t st) {
#define SBT_PLANES_LAUNCH(R)                                                 \
  return launch_one<BITS, A8, R>(x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,   \
                                 dst, M, N, K, gs, CB, gps, splits, vec, st)
  switch (MR) {
    case 1: SBT_PLANES_LAUNCH(1);
    case 2: SBT_PLANES_LAUNCH(2);
    case 4: SBT_PLANES_LAUNCH(4);
    default: SBT_PLANES_LAUNCH(8);
  }
#undef SBT_PLANES_LAUNCH
}

template <bool A8>
cudaError_t launch_bits(int bits, int MR, const void* x, const uint8_t* wlo,
                        int ld_lo, const uint8_t* whi, int ld_hi,
                        const void* s, const void* z, int sz_bf16,
                        float* dst, int M, int N, int K, int gs, int CB,
                        int gps, int splits, int vec, cudaStream_t st) {
  switch (bits) {
    case 2:
      return launch_rows<2, A8>(MR, x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                dst, M, N, K, gs, CB, gps, splits, vec, st);
    case 3:
      return launch_rows<3, A8>(MR, x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                dst, M, N, K, gs, CB, gps, splits, vec, st);
    case 4:
      return launch_rows<4, A8>(MR, x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                dst, M, N, K, gs, CB, gps, splits, vec, st);
    case 8:
      return launch_rows<8, A8>(MR, x, wlo, ld_lo, whi, ld_hi, s, z, sz_bf16,
                                dst, M, N, K, gs, CB, gps, splits, vec, st);
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool aligned(uintptr_t v, int a) { return v % a == 0; }

}  // namespace

// out (M, N) f32. x (M, K): int8 when a8, else f32, 16-byte aligned. wlo:
// "w" planes, or the 3-bit low2, row stride ld_lo bytes; whi: the 3-bit
// high1 (row stride ld_hi), ignored otherwise. s, z (G, N) f32 or bf16
// (sz_bf16); gs is the effective group size (K per channel). The plan
// (ops/quant_matmul.planes_plan): MR rows a thread (1, 2, 4, 8), CB byte
// columns a block (256 / CB row groups, MR * 256 / CB >= M), gps groups a
// K split. With more than one split, part holds (splits, M, N) f32
// partials; else it is unused. M <= 64, K % gs == 0, gs % 32 == 0.
extern "C" int sbt_qmm_planes(const void* x, int a8, const void* wlo,
                              int ld_lo, const void* whi, int ld_hi, int bits,
                              const void* s, const void* z, int sz_bf16,
                              void* out, int M, int N, int K, int gs, int MR,
                              int CB, int gps, void* part, void* stream) {
  const int P = bits == 3 ? 8 : (bits == 8 ? 1 : 8 / bits);
  if (M < 1 || M > 64 || gs < KT || gs % KT || K % gs || N % P ||
      !(MR == 1 || MR == 2 || MR == 4 || MR == 8) || CB < 16 ||
      CB > kThreads || kThreads % CB || MR * (kThreads / CB) < M ||
      gps < 1 || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NP = N / P;
  const int G = K / gs;
  const int splits = (G + gps - 1) / gps;
  // the widest copy every weight row start and the tile columns allow
  int vec = 16;
  auto lo = static_cast<const uint8_t*>(wlo);
  auto hi = static_cast<const uint8_t*>(whi);
  while (vec > 1 &&
         !(aligned(reinterpret_cast<uintptr_t>(lo), vec) &&
           aligned(ld_lo, vec) && aligned(NP, vec) &&
           (bits != 3 || (aligned(reinterpret_cast<uintptr_t>(hi), vec) &&
                          aligned(ld_hi, vec)))))
    vec = vec == 4 ? 1 : vec / 2;
  auto st = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(out);
  cudaError_t e =
      a8 ? launch_bits<true>(bits, MR, x, lo, ld_lo, hi, ld_hi, s, z,
                             sz_bf16, dst, M, N, K, gs, CB, gps, splits, vec,
                             st)
         : launch_bits<false>(bits, MR, x, lo, ld_lo, hi, ld_hi, s, z,
                              sz_bf16, dst, M, N, K, gs, CB, gps, splits, vec,
                              st);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t MN = static_cast<size_t>(M) * N;
  planes_reduce_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0,
                         st>>>(static_cast<const float*>(part),
                               static_cast<float*>(out), MN, splits);
  return static_cast<int>(cudaGetLastError());
}
