// K1: W4A8 matmul over signed row-pair 4-bit weights, optionally one layer
// of a layer stack.
//
// Replaces sparsebit_tpu/ops/quant_matmul.py:443 _qmm_u4_kernel
// (_quant_matmul_pallas_u4) and :693 _qmm_u4_stacked_kernel
// (_quant_matmul_pallas_u4_stacked): one kernel serves both, a layer being
// a pointer offset into the (L, K/2, N) / (L, G, N) stacks.
//
// Bound on the H100: at decode (M <= 64) the weight stream, K*N/2 bytes
// plus 2*G*N qparams, over 3.35 TB/s; at admission (M in the hundreds)
// the int8 operations, 2*M*K*N over 1,979 TOP/s, which only the tensor
// cores reach. The kernel is w4a8.cuh's s4tile on mma.sync.m16n8k32 int8
// (not wgmma: see s4tile's note) in K4's two tiles, two blocks an SM: 16 x
// 256 at M <= 16, else 64 x 128 over 64-row tiles of M. The plan is a
// function of the shape alone (ops/quant_matmul.k1_plan):
//   M <= 64  streaming: K split at group boundaries (gps groups a split,
//            from K, N, gs only) so that the few column tiles fill the
//            card; a second launch adds the splits' partials in split
//            order (the plain version _qmm_s4_plain(gps=...) repeats it);
//   M > 64   admission: no split, the groups in order, bit-equal to the
//            sequential _qmm_s4_plain. Far from the tensor cores' rate:
//            the exact f32 fold of every group (seven instructions an
//            output a group) costs about as many instructions as the
//            decode and the mma work of the group (PERF.md).
#include "w4a8.cuh"

namespace {

using Rows16 = sbt::S4Cfg<16, 256, 1, 8, 6, 2>;  // M <= 16
using Rows64 = sbt::S4Cfg<64, 128, 2, 4, 6, 2>;  // M > 16

// grid (column tiles, K splits, row tiles). With part null the block
// writes xs * acc to out; else its split's partial to part[split].
template <class C>
__global__ void __launch_bounds__(C::THREADS, 2)
    qmm_s4_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
                  const uint8_t* __restrict__ w, const void* s, const void* z,
                  int sz_bf16, float* __restrict__ out,
                  float* __restrict__ part, int M, int N, int K, int gs,
                  int gps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int col0 = blockIdx.x * C::BN, row0 = blockIdx.z * C::BM;
  const int G = K / gs, g0 = blockIdx.y * gps, g1 = min(G, g0 + gps);
  const int Mt = min(C::BM, M - row0);
  const int es = sz_bf16 ? 2 : 4;
  const int vec_q = min(sbt::copy_width(s, static_cast<size_t>(N) * es),
                        sbt::copy_width(z, static_cast<size_t>(N) * es));
  float acc[C::MT][C::NT][4];
  sbt::s4tile<C>(x8 + static_cast<size_t>(row0) * K, Mt, K, w, N,
                 sbt::copy_width(w, N), s, z, sz_bf16, N, vec_q, gs, g0, g1,
                 col0, N, smem, acc);
  const sbt::S4Out<C> o;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = o.row(mt, r), col = col0 + o.col(j, r);
        if (row >= Mt || col >= N) continue;
        const size_t at = static_cast<size_t>(row0 + row) * N + col;
        if (part == nullptr)
          out[at] = __fmul_rn(acc[mt][j][r], xs[row0 + row]);
        else
          part[static_cast<size_t>(blockIdx.y) * M * N + at] =
              acc[mt][j][r];
      }
}

// out = xs * (((part[0] + part[1]) + ...) + part[P-1]), split order.
__global__ void split_sum_kernel(const float* __restrict__ part,
                                 const float* __restrict__ xs,
                                 float* __restrict__ out, int M, int N,
                                 int P) {
  const size_t MN = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < MN; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = part[i];
    for (int p = 1; p < P; ++p) v = __fadd_rn(v, part[p * MN + i]);
    out[i] = __fmul_rn(v, xs[i / N]);
  }
}

template <class C>
cudaError_t launch(const int8_t* x, const float* xs, const uint8_t* w,
                   const void* s, const void* z, int sz_bf16, float* out,
                   float* part, int M, int N, int K, int gs, int gps,
                   cudaStream_t st) {
  auto kern = qmm_s4_kernel<C>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (attr != cudaSuccess) return attr;
  const int G = K / gs, splits = (G + gps - 1) / gps;
  dim3 grid((N + C::BN - 1) / C::BN, splits, (M + C::BM - 1) / C::BM);
  kern<<<grid, C::THREADS, C::BYTES, st>>>(x, xs, w, s, z, sz_bf16, out,
                                            splits > 1 ? part : nullptr, M,
                                            N, K, gs, gps);
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int n = (M * N + 255) / 256;
    split_sum_kernel<<<n < 1024 ? n : 1024, 256, 0, st>>>(part, xs, out, M,
                                                           N, splits);
  }
  return cudaGetLastError();
}

}  // namespace

// out (M, N) f32 = xs[m] * sum_g s_g (dot_g - xsum_g (z_g - 8)).
// x8 (M, K) int8, 16-byte aligned; xs (M,) f32; w (K/2, N) s4r bytes; s,
// z (G, N) f32 or bf16 (sz_bf16). The caller passes pointers already
// offset to a layer. K % gs == 0 and gs % 64 == 0 (checked by the
// wrapper). gps: groups a K split (M <= 64; G above, no split); part:
// (ceil(G / gps), M, N) f32 scratch when that is more than one split.
extern "C" int sbt_qmm_s4(const void* x8, const void* xs, const void* w,
                          const void* s, const void* z, int sz_bf16,
                          void* out, int M, int N, int K, int gs, int gps,
                          void* part, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int8_t*>(x8);
  auto xsc = static_cast<const float*>(xs);
  auto wb = static_cast<const uint8_t*>(w);
  auto o = static_cast<float*>(out);
  auto pt = static_cast<float*>(part);
  if (M < 1 || gs < 64 || gs % 64 || K % gs || gps < 1 ||
      (M > 64 && gps < K / gs) ||
      reinterpret_cast<uintptr_t>(x8) % 16 || K % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      M <= 16 ? launch<Rows16>(x, xsc, wb, s, z, sz_bf16, o, pt, M, N, K, gs,
                               gps, st)
              : launch<Rows64>(x, xsc, wb, s, z, sz_bf16, o, pt, M, N, K, gs,
                               gps, st));
}
