// K9: decode-batch bf16 matvec  out (B, N) f32 = bf16(x) (B, K) @ W (K, N)
// bf16, products exact in f32 and summed in f32.
//
// Replaces sparsebit_tpu/ops/matvec.py:21 _mv_kernel (bf16_matvec), the
// lm_head streamer.
//
// Bound on the H100: the K*N*2 bytes of W over 3.35 TB/s (LLaMA-7B's
// 4096 x 32000 head: 262 MB, 78 us); x and out are noise. The kernel is a
// pure stream, so the design is about bytes in flight and every SM busy:
//   - a block owns a 256-column tile and a range of K rows; each lane
//     reads 8 neighbouring bf16 columns of a row with one 16-byte load
//     (a warp reads 512 contiguous bytes of a row) and issues kUnroll = 8
//     rows' loads before their FMAs, so a 256-thread block has 32 KB of W
//     in flight;
//   - K is split across the block's 8 warps (rows interleaved) and across
//     `splits` blocks, chosen by the wrapper so that the grid holds at
//     least two blocks per SM (125 column tiles x 4 splits at 7B);
//   - x for the block's own K range only sits in shared memory, converted
//     once to f32 and laid out (k, b) so that one row's B values are one
//     broadcast read; at most kMaxRange rows, so no opt-in is needed;
//   - the warps' sums meet in shared memory and are added in warp order;
//     with splits > 1 each block writes its partial (split, B, N) and a
//     second launch adds the splits in split order. No atomics: two runs
//     of a call give the same bits.
// When N % 8 != 0 or W is not 16-byte aligned, the same kernel reads W one
// bf16 at a time (kVec = false).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 256;       // columns per block: 32 lanes x 8
constexpr int kUnroll = 8;       // rows in flight per lane
constexpr int kMaxRange = 1024;  // K rows per block (x in shared memory)

__device__ __forceinline__ void unpack8(const uint4& v, float* w) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);             // low bf16
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);  // high bf16
  }
}

template <int B>
__device__ __forceinline__ void fma_row(float (&acc)[B][8], const float* w,
                                        const float* xk) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const float xv = xk[b];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
  }
}

// One 8-column row segment of W at column col0 (< N): a 16-byte load on
// the vector path, else bf16 by bf16 with the ragged edge masked.
template <bool kVec>
__device__ __forceinline__ uint4 load_seg(const __nv_bfloat16* __restrict__ w,
                                          size_t off, int ncols) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(w + off));
  const unsigned short* p = reinterpret_cast<const unsigned short*>(w + off);
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < ncols ? __ldg(p + 2 * i) : 0u;
    const uint32_t hi = 2 * i + 1 < ncols ? __ldg(p + 2 * i + 1) : 0u;
    u[i] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// grid (ceil(N / kCols), splits); block kThreads. part (splits, B, N) f32
// (the output itself when splits == 1).
template <int B, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    bf16_matvec_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       float* __restrict__ part, int K, int N, int range) {
  __shared__ float x_sm[kMaxRange * B];  // (k - k0, b)
  __shared__ float red[kWarps][kCols];
  const int k0 = blockIdx.y * range;
  const int k1 = min(K, k0 + range);
  for (int i = threadIdx.x; i < (k1 - k0) * B; i += kThreads) {
    const int b = i / (k1 - k0), kk = i % (k1 - k0);  // coalesced along K
    x_sm[kk * B + b] =
        __bfloat162float(x[static_cast<size_t>(b) * K + k0 + kk]);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kCols + 8 * lane;
  const int ncols = min(8, N - col0);  // <= 0: lane past the edge
  float acc[B][8];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.f;

  if (ncols > 0) {
    int k = k0 + warp;  // this warp's rows: k, k + kWarps, ...
    for (; k + kWarps * (kUnroll - 1) < k1; k += kWarps * kUnroll) {
      uint4 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        wv[u] = load_seg<kVec>(
            w, static_cast<size_t>(k + kWarps * u) * N + col0, ncols);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float wf[8];
        unpack8(wv[u], wf);
        fma_row<B>(acc, wf, x_sm + (k + kWarps * u - k0) * B);
      }
    }
    for (; k < k1; k += kWarps) {
      float wf[8];
      unpack8(load_seg<kVec>(w, static_cast<size_t>(k) * N + col0, ncols),
              wf);
      fma_row<B>(acc, wf, x_sm + (k - k0) * B);
    }
  }

  // the warps' sums, added in warp order, one batch row at a time
  const int n = blockIdx.x * kCols + threadIdx.x;
  float* dst = part + static_cast<size_t>(blockIdx.y) * B * N;
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp][8 * lane + e] = acc[b][e];
    __syncthreads();
    if (n < N) {
      float t = red[0][threadIdx.x];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) t += red[wi][threadIdx.x];
      dst[static_cast<size_t>(b) * N + n] = t;
    }
    __syncthreads();
  }
}

// out[i] = sum of part[j][i] over the splits j, in split order.
__global__ void __launch_bounds__(256)
    add_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int splits, int total) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float t = part[i];
  for (int j = 1; j < splits; ++j)
    t += part[static_cast<size_t>(j) * total + i];
  out[i] = t;
}

template <int B>
int launch(const void* x, const void* w, void* out, void* part, int K, int N,
           int splits, cudaStream_t st) {
  const int range = (K + splits - 1) / splits;
  if (range > kMaxRange) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  float* dst = static_cast<float*>(splits > 1 ? part : out);
  const dim3 grid((N + kCols - 1) / kCols, splits);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const __nv_bfloat16*>(w);
  if (vec)
    bf16_matvec_kernel<B, true><<<grid, kThreads, 0, st>>>(xp, wp, dst, K, N,
                                                          range);
  else
    bf16_matvec_kernel<B, false><<<grid, kThreads, 0, st>>>(xp, wp, dst, K,
                                                           N, range);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int total = B * N;
  add_splits_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), splits,
      total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, K) bf16 with 1 <= B <= 8; w (K, N) bf16, N even; out (B, N) f32;
// part (splits, B, N) f32 scratch (unused when splits == 1), with
// ceil(K / splits) <= 1024.
extern "C" int sbt_bf16_matvec(const void* x, const void* w, void* out,
                               int B, int K, int N, void* part, int splits,
                               void* stream) {
  if (splits < 1 || K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 1: return launch<1>(x, w, out, part, K, N, splits, st);
    case 2: return launch<2>(x, w, out, part, K, N, splits, st);
    case 3: return launch<3>(x, w, out, part, K, N, splits, st);
    case 4: return launch<4>(x, w, out, part, K, N, splits, st);
    case 5: return launch<5>(x, w, out, part, K, N, splits, st);
    case 6: return launch<6>(x, w, out, part, K, N, splits, st);
    case 7: return launch<7>(x, w, out, part, K, N, splits, st);
    case 8: return launch<8>(x, w, out, part, K, N, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
