// K9: decode-batch bf16 matvec  out (B, N) f32 = bf16(x) (B, K) @ W (K, N)
// bf16, products exact in f32 and summed in f32.
//
// Replaces sparsebit_tpu/ops/matvec.py:21 _mv_kernel (bf16_matvec), the
// lm_head streamer.
//
// Bound on the H100: the K*N*2 bytes of W over 3.35 TB/s (LLaMA-7B's
// 4096 x 32000 head: 262 MB, 78 us); x and out are noise. Design: x (at
// most 8 rows) sits in shared memory; a block owns 64 columns, each lane
// reads two neighbouring bf16 columns (a warp reads 128 contiguous bytes
// of a row), and the block's 8 warps split K into 8 ranges so that 8
// independent row streams are in flight per block. The warps' partial
// sums meet in shared memory and are added in warp order. The ragged N
// edge is masked; N must be even.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 64;  // columns per block: 32 lanes x 2

template <int B>
__global__ void __launch_bounds__(kWarps * 32)
    bf16_matvec_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       float* __restrict__ out, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* x_sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (B, K)
  __shared__ float part[kWarps][B][kCols];
  for (int i = threadIdx.x; i < B * K; i += blockDim.x) x_sm[i] = x[i];
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * kCols + 2 * lane;
  const int per = (K + kWarps - 1) / kWarps;
  const int k0 = warp * per, k1 = min(K, k0 + per);
  float acc[B][2];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b][0] = acc[b][1] = 0.f;
  if (col < N) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      __nv_bfloat162 wv = *reinterpret_cast<const __nv_bfloat162*>(
          w + static_cast<size_t>(k) * N + col);
      float w0 = __low2float(wv), w1 = __high2float(wv);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float xv = __bfloat162float(x_sm[b * K + k]);
        acc[b][0] += xv * w0;
        acc[b][1] += xv * w1;
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    part[warp][b][2 * lane] = acc[b][0];
    part[warp][b][2 * lane + 1] = acc[b][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * kCols; i += blockDim.x) {
    int b = i / kCols, c = i % kCols;
    int n = blockIdx.x * kCols + c;
    if (n >= N) continue;
    float t = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) t += part[wi][b][c];
    out[static_cast<size_t>(b) * N + n] = t;
  }
}

template <int B>
int launch(const void* x, const void* w, void* out, int K, int N,
           cudaStream_t st) {
  const size_t smem = static_cast<size_t>(B) * K * sizeof(__nv_bfloat16);
  // static + dynamic shared memory above 48 KB needs the opt-in
  if (smem + sizeof(float) * kWarps * B * kCols > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bf16_matvec_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bf16_matvec_kernel<B><<<(N + kCols - 1) / kCols, kWarps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, K) bf16 with 1 <= B <= 8; w (K, N) bf16, N even; out (B, N) f32.
extern "C" int sbt_bf16_matvec(const void* x, const void* w, void* out,
                               int B, int K, int N, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (B) {
    case 1: return launch<1>(x, w, out, K, N, st);
    case 2: return launch<2>(x, w, out, K, N, st);
    case 3: return launch<3>(x, w, out, K, N, st);
    case 4: return launch<4>(x, w, out, K, N, st);
    case 5: return launch<5>(x, w, out, K, N, st);
    case 6: return launch<6>(x, w, out, K, N, st);
    case 7: return launch<7>(x, w, out, K, N, st);
    case 8: return launch<8>(x, w, out, K, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
