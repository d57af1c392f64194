// K1: W4A8 matmul over signed row-pair 4-bit weights, optionally one layer
// of a layer stack.
//
// Replaces sparsebit_tpu/ops/quant_matmul.py:443 _qmm_u4_kernel
// (_quant_matmul_pallas_u4) and :693 _qmm_u4_stacked_kernel
// (_quant_matmul_pallas_u4_stacked): one kernel serves both, a layer being
// a pointer offset into the (L, K/2, N) / (L, G, N) stacks.
//
// Bound on the H100: at decode (M <= 64) the weight stream, K*N/2 bytes
// plus 2*G*N qparams, over 3.35 TB/s; at admission (M up to 16k) the int8
// operations. This first version uses __dp4a on CUDA cores (about a tenth
// of the int8 tensor-core rate) and a register double buffer to keep the
// next weight tile in flight while the current one is multiplied; the
// decode tile (8 x 32) keeps every SM busy at N = 4096. wgmma and TMA
// come later.
#include "w4a8.cuh"

namespace {

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(sbt::Tile<BM, BN, TM, TN>::THREADS)
    qmm_s4_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
                  const uint8_t* __restrict__ w, const void* s, const void* z,
                  int sz_bf16, float* __restrict__ out, int M, int N, int K,
                  int gs) {
  using T = sbt::Tile<BM, BN, TM, TN>;
  const int row0 = blockIdx.y * BM;
  const sbt::ColPlain cm{static_cast<int>(blockIdx.x) * BN, N};
  float acc[TM][TN];
  sbt::wtile<BM, BN, TM, TN>(sbt::AInt8{x8, M, K}, sbt::S4Rows{w, N}, s, z,
                             sz_bf16, N, K, gs, row0, cm, acc);
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    int row = row0 + ty + tm * T::TY;
    if (row >= M) continue;
    float scale = xs[row];
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      int col = cm(tx + tn * T::TX);
      if (col >= 0)
        out[static_cast<size_t>(row) * N + col] = acc[tm][tn] * scale;
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const int8_t* x8, const float* xs, const uint8_t* w,
            const void* s, const void* z, int sz_bf16, float* out, int M,
            int N, int K, int gs, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_s4_kernel<BM, BN, TM, TN>
      <<<grid, sbt::Tile<BM, BN, TM, TN>::THREADS, 0, st>>>(
          x8, xs, w, s, z, sz_bf16, out, M, N, K, gs);
}

}  // namespace

// out (M, N) f32 = xs[m] * sum_g s_g (dot_g - xsum_g (z_g - 8)).
// x8 (M, K) int8; xs (M,) f32; w (K/2, N) s4r bytes; s, z (G, N) f32 or
// bf16 (sz_bf16). The caller passes pointers already offset to a layer.
// K % gs == 0 and gs % 64 == 0 (checked by the wrapper).
extern "C" int sbt_qmm_s4(const void* x8, const void* xs, const void* w,
                          const void* s, const void* z, int sz_bf16,
                          void* out, int M, int N, int K, int gs,
                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int8_t*>(x8);
  auto xsc = static_cast<const float*>(xs);
  auto wb = static_cast<const uint8_t*>(w);
  auto o = static_cast<float*>(out);
  if (M <= 8)
    launch<8, 32, 1, 1>(x, xsc, wb, s, z, sz_bf16, o, M, N, K, gs, st);
  else
    launch<64, 64, 4, 4>(x, xsc, wb, s, z, sz_bf16, o, M, N, K, gs, st);
  return static_cast<int>(cudaGetLastError());
}
