// K3: the decode FFN block  out = x + W2(q8(silu(g) * u)),
// [g, u] = W13(q8(rmsnorm(x) * w)), both W4A8 over s4r weights.
//
// Replaces sparsebit_tpu/ops/ffn_fused.py:45 _ffn_kernel (ffn_block_fused).
//
// The TPU kernel ran norm, W13, GLU and W2 in one sequential grid, holding
// the (B, 2F) hidden row in VMEM: the GLU pairs gate column j with up
// column F + j, and the int8 requantization of silu(g) * u needs the
// absmax over all F columns of a row before any W2 tile starts; the
// sequential grid gave both for free. Hopper blocks run in no order, so
// here one cooperative launch of a persistent grid (as many blocks as fit,
// two an SM) runs the FFN phases of K4's layer loop, ffn_phases.cuh: the
// norm, W13 on the int8 tensor cores (w4a8.cuh's s4tile, a cp.async ring
// of 8 KB weight stages) split along K at group boundaries by
// ops/quant_matmul.s4_plan so that a decode batch fills the card, the GLU
// after a grid barrier, the requantized rows after another, then W2 the
// same way and the residual; five grid barriers in all.
// Bound on the H100: the weight stream of W13 and W2 (3 * dim * F / 2
// bytes plus qparams) over 3.35 TB/s; the partials and the GLU rows make
// one round trip through L2.
#include <cooperative_groups.h>

#include "ffn_phases.cuh"

namespace cg = cooperative_groups;

namespace {

using Rows16 = sbt::S4Cfg<16, 256, 1, 8, 6, 2>;  // B <= 16 (K1's, K4's)
using Rows64 = sbt::S4Cfg<64, 128, 2, 4, 6, 2>;  // B <= 64

// Two blocks an SM (<= 128 registers): at 64 rows the tile otherwise
// takes 163 registers and the grid one block an SM (PERF.md, K3).
template <class C>
__global__ void __launch_bounds__(sbt::kGridThreads, 2)
    ffn_block_kernel(sbt::FfnArgs a, const float* x, const void* nw,
                     float* out) {
  static_assert(C::THREADS == sbt::kGridThreads, "one block size");
  extern __shared__ __align__(16) uint8_t smem[];  // C::BYTES
  __shared__ float red[sbt::kGridThreads];
  __shared__ int amax_sm[sbt::kMaxGridRows];
  cg::grid_group grid = cg::this_grid();
  sbt::ffn_s4<C>(a, 0, x, nw, out, smem, amax_sm, red,
                 [&](sbt::FfnMark m) {
                   if (m != sbt::kW2SumDone) grid.sync();  // the launch ends
                 });
}

template <class C>
cudaError_t launch(sbt::FfnArgs a, const float* x, const void* nw,
                   float* out, cudaStream_t st) {
  auto kern = ffn_block_kernel<C>;
  int grid = 0;
  cudaError_t e = sbt::grid_size(kern, C::BYTES, &grid);
  if (e != cudaSuccess) return e;
  void* params[] = {&a, &x, &nw, &out};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                  dim3(sbt::kGridThreads), params, C::BYTES,
                                  st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// out (B, dim) f32 = x + as * W2(q8(act)), act = silu(g) * u of [g | u] =
// xs * W13(xq), (xq, xs) = q8(rmsnorm(x) * nw). x (B, dim) f32; nw (dim)
// f32 or bf16 (nw_bf16); w13 (dim/2, 2F), w2 (F/2, dim) s4r bytes with
// (dim/gs, 2F) and (F/gs, dim) scales and zeros, f32 or bf16 (sz_bf16).
// g13, g2: groups a K split of W13 and W2 (ops/quant_matmul.s4_plan).
// Scratch: xq (B, dim) int8, xs (B), act (B, F), amax (B) f32, aq (B, F)
// int8, part (max(splits13 * 2F, splits2 * dim) * B) f32. B <= 64, gs a
// multiple of 64 dividing dim and F.
extern "C" int sbt_ffn_block(const void* x, const void* nw, const void* w13,
                             const void* s13, const void* z13,
                             const void* w2, const void* s2, const void* z2,
                             void* out, void* xq, void* xs, void* act,
                             void* amax, void* aq, void* part, int sz_bf16,
                             int nw_bf16, int B, int dim, int F, int gs,
                             int g13, int g2, float eps, void* stream) {
  if (B < 1 || B > sbt::kMaxGridRows || gs < 64 || gs % 64 || dim % gs ||
      F % gs || g13 < 1 || g2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  sbt::FfnArgs a;
  a.w13 = static_cast<const uint8_t*>(w13);
  a.w2 = static_cast<const uint8_t*>(w2);
  a.s13 = s13; a.z13 = z13; a.s2 = s2; a.z2 = z2;
  a.xq = static_cast<int8_t*>(xq);
  a.xs = static_cast<float*>(xs);
  a.act = static_cast<float*>(act);
  a.amax_g = static_cast<float*>(amax);
  a.aq = static_cast<int8_t*>(aq);
  a.part = static_cast<float*>(part);
  a.sz_bf16 = sz_bf16; a.nw_bf16 = nw_bf16;
  a.B = B; a.dim = dim; a.F = F; a.gs = gs; a.g13 = g13; a.g2 = g2;
  a.f2 = F;  // one unpadded layer a launch
  a.eps = eps;
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  return static_cast<int>(B <= 16 ? launch<Rows16>(a, xf, nw, o, st)
                                  : launch<Rows64>(a, xf, nw, o, st));
}
