// K3: the decode FFN block  out = x + W2(q8(silu(g) * u)),
// [g, u] = W13(q8(rmsnorm(x) * w_li)), both W4A8 over stacked s4r weights.
//
// Replaces sparsebit_tpu/ops/ffn_fused.py:45 _ffn_kernel (ffn_block_fused).
//
// The TPU kernel ran norm, W13, GLU and W2 in one sequential grid, holding
// the (B, 2F) hidden row in VMEM: the int8 requantization of silu(g)*u
// needs the absmax over all F columns of a row before any W2 tile starts,
// and the sequential grid gave that for free. Hopper blocks run in no
// order, so the dependency is resolved with three launches of this
// module's kernels:
//   1. prologue: one block per row computes the f32 norm, its int8 codes
//      and scale, and zeroes the row's absmax slot;
//   2. W13 + GLU: each block multiplies a tile of gate columns and the
//      matching tile of up columns (ColGLU), applies silu(g)*u, writes the
//      f32 product row and raises the row's absmax with atomicMax on the
//      float bits (valid: the values are non-negative);
//   3. W2 with requantization on load (AF32Requant) and the residual add.
// Bound on the H100: the weight stream of W13 and W2 (3*dim*F/2 bytes plus
// qparams) over 3.35 TB/s; the f32 hidden row (B*F*4 bytes) makes one
// round trip through L2.
#include "w4a8.cuh"

namespace {

constexpr int kPrologueThreads = 256;

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i) t += red[i];
  return t;
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < static_cast<int>(blockDim.x) / 32; ++i)
    t = fmaxf(t, red[i]);
  return t;
}

// xn = xf * rsqrt(mean(xf^2) + eps) * w, in f32 (the TPU kernel's own
// formula, no cast back to x's dtype); xq/xs its per-row int8 codes/scale.
__global__ void __launch_bounds__(kPrologueThreads)
    ffn_prologue_kernel(const float* __restrict__ x, const void* nw,
                        int nw_bf16, int8_t* __restrict__ xq,
                        float* __restrict__ xs, float* __restrict__ amax,
                        int dim, float eps) {
  __shared__ float red[32];
  const int row = blockIdx.x;
  const float* xr = x + static_cast<size_t>(row) * dim;
  float ss = 0.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x) ss += xr[i] * xr[i];
  const float var = block_sum(ss, red) / static_cast<float>(dim);
  const float r = rsqrtf(var + eps);
  float mx = 0.f;
  for (int i = threadIdx.x; i < dim; i += blockDim.x)
    mx = fmaxf(mx, fabsf(xr[i] * r * sbt::load_qparam(nw, i, nw_bf16)));
  const float scale = sbt::row_scale(block_max(mx, red));
  for (int i = threadIdx.x; i < dim; i += blockDim.x) {
    float xn = xr[i] * r * sbt::load_qparam(nw, i, nw_bf16);
    xq[static_cast<size_t>(row) * dim + i] =
        static_cast<int8_t>(sbt::quant8(xn, scale));
  }
  if (threadIdx.x == 0) {
    xs[row] = scale;
    amax[row] = 0.f;
  }
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(sbt::Tile<BM, BN, TM, TN>::THREADS)
    ffn_w13_glu_kernel(const int8_t* __restrict__ xq,
                       const float* __restrict__ xs,
                       const uint8_t* __restrict__ w, const void* s,
                       const void* z, int sz_bf16, float* __restrict__ act,
                       float* __restrict__ amax, int M, int F, int K,
                       int gs) {
  using T = sbt::Tile<BM, BN, TM, TN>;
  constexpr int HALF = BN / 2;
  static_assert(TN % 2 == 0, "gate and up columns pair within a thread");
  __shared__ int amax_sm[BM];
  if (threadIdx.x < BM) amax_sm[threadIdx.x] = 0;
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * HALF;
  const sbt::ColGLU cm{j0, F, HALF};
  float acc[TM][TN];
  sbt::w4a8_tile<BM, BN, TM, TN>(sbt::AInt8{xq, M, K}, w, s, z, sz_bf16,
                                 2 * F, K, gs, row0, cm, acc);
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    int rl = ty + tm * T::TY;
    int row = row0 + rl;
    if (row >= M) continue;
    float scale = xs[row];
    float mx = 0.f;
#pragma unroll
    for (int tn = 0; tn < TN / 2; ++tn) {
      int j = j0 + tx + tn * T::TX;  // tile column < HALF: a gate column
      if (j >= F) continue;
      float g = acc[tm][tn] * scale;
      float u = acc[tm][tn + TN / 2] * scale;
      float sig = 1.f / (1.f + expf(-g));
      float a = (g * sig) * u;
      act[static_cast<size_t>(row) * F + j] = a;
      mx = fmaxf(mx, fabsf(a));
    }
    atomicMax(&amax_sm[rl], __float_as_int(mx));
  }
  __syncthreads();
  if (threadIdx.x < BM && row0 + static_cast<int>(threadIdx.x) < M)
    atomicMax(reinterpret_cast<int*>(amax) + row0 + threadIdx.x,
              amax_sm[threadIdx.x]);
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(sbt::Tile<BM, BN, TM, TN>::THREADS)
    ffn_w2_resid_kernel(const float* __restrict__ act,
                        const float* __restrict__ amax,
                        const float* __restrict__ xres,
                        const uint8_t* __restrict__ w, const void* s,
                        const void* z, int sz_bf16, float* __restrict__ out,
                        int M, int N, int F, int gs) {
  using T = sbt::Tile<BM, BN, TM, TN>;
  const int row0 = blockIdx.y * BM;
  const sbt::ColPlain cm{static_cast<int>(blockIdx.x) * BN, N};
  float acc[TM][TN];
  sbt::w4a8_tile<BM, BN, TM, TN>(sbt::AF32Requant{act, amax, M, F}, w, s, z,
                                 sz_bf16, N, F, gs, row0, cm, acc);
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    int row = row0 + ty + tm * T::TY;
    if (row >= M) continue;
    float scale = sbt::row_scale(amax[row]);
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      int col = cm(tx + tn * T::TX);
      if (col < 0) continue;
      size_t o = static_cast<size_t>(row) * N + col;
      out[o] = xres[o] + acc[tm][tn] * scale;
    }
  }
}

}  // namespace

// 1. x (B, dim) f32, nw (dim,) f32/bf16 -> xq (B, dim) int8, xs (B,) f32,
//    amax (B,) zeroed.
extern "C" int sbt_ffn_prologue(const void* x, const void* nw, void* xq,
                                void* xs, void* amax, int nw_bf16, int B,
                                int dim, float eps, void* stream) {
  ffn_prologue_kernel<<<B, kPrologueThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), nw, nw_bf16, static_cast<int8_t*>(xq),
      static_cast<float*>(xs), static_cast<float*>(amax), dim, eps);
  return static_cast<int>(cudaGetLastError());
}

// 2. act (B, F) f32 = silu(g) * u of [g | u] = xs * W13(xq); amax (B,)
//    raised to each row's max |act|. w (K/2, 2F) s4r; s, z (G, 2F).
extern "C" int sbt_ffn_w13_glu(const void* xq, const void* xs, const void* w,
                               const void* s, const void* z, int sz_bf16,
                               void* act, void* amax, int M, int F, int K,
                               int gs, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const int8_t*>(xq);
  auto xsc = static_cast<const float*>(xs);
  auto wb = static_cast<const uint8_t*>(w);
  auto a = static_cast<float*>(act);
  auto mx = static_cast<float*>(amax);
  if (M <= 8) {
    dim3 grid((F + 31) / 32, (M + 7) / 8);
    ffn_w13_glu_kernel<8, 64, 1, 2><<<grid, 256, 0, st>>>(
        x, xsc, wb, s, z, sz_bf16, a, mx, M, F, K, gs);
  } else {
    dim3 grid((F + 31) / 32, (M + 63) / 64);
    ffn_w13_glu_kernel<64, 64, 4, 4><<<grid, 256, 0, st>>>(
        x, xsc, wb, s, z, sz_bf16, a, mx, M, F, K, gs);
  }
  return static_cast<int>(cudaGetLastError());
}

// 3. out (B, N) f32 = xres + as * W2(q8(act)), as = row_scale(amax).
//    w (F/2, N) s4r; s, z (G2, N).
extern "C" int sbt_ffn_w2_resid(const void* act, const void* amax,
                                const void* xres, const void* w,
                                const void* s, const void* z, int sz_bf16,
                                void* out, int M, int N, int F, int gs,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(act);
  auto mx = static_cast<const float*>(amax);
  auto xr = static_cast<const float*>(xres);
  auto wb = static_cast<const uint8_t*>(w);
  auto o = static_cast<float*>(out);
  if (M <= 8) {
    dim3 grid((N + 31) / 32, (M + 7) / 8);
    ffn_w2_resid_kernel<8, 32, 1, 1><<<grid, 256, 0, st>>>(
        a, mx, xr, wb, s, z, sz_bf16, o, M, N, F, gs);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    ffn_w2_resid_kernel<64, 64, 4, 4><<<grid, 256, 0, st>>>(
        a, mx, xr, wb, s, z, sz_bf16, o, M, N, F, gs);
  }
  return static_cast<int>(cudaGetLastError());
}
