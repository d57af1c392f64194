// The decode FFN half of a decoder layer on a persistent cooperative grid:
//     out = xin + W2(q8(silu(g) * u)),  [g, u] = W13(q8(rms_norm(xin) * nw)),
// shared by K3 (ffn_fused.cu: one layer a launch) and K4 (layer_fused.cu:
// every layer of the backbone in one launch). It holds the FFN phases, the
// ordered block reductions and row quantizations they use, the s4r matmul
// phase (w4a8.cuh's s4tile over items (column tile, K split), the split
// from ops/quant_matmul.s4_plan) and the persistent grid's sizing.
//
// Phases, each ended by a grid-wide barrier (the caller's sync, which K4
// also stamps into its phase trace):
//   norm   a block a row: f32 rms norm, int8 codes and the row's scale;
//   W13    s4r tiles (column tile, K split), each split's partial written;
//   GLU    the partials added in split order, then silu(g) * u for gate
//          column j and up column F + j (in different tiles, hence after
//          the barrier) and each row's absmax;
//   q8     the int8 rows of the GLU output against that absmax (W2's
//          requantization needs every column of a row first);
//   W2     s4r tiles over the int8 rows, each split's partial written;
//   sum    the partials added in split order, scaled, plus the residual.
// Every float sum is taken in one fixed order (a thread's strided partial,
// then a 256-wide tree; the K splits in split order) and no multiply-add
// is contracted, so the plain version (ops/ffn_fused._ffn_plain, which
// repeats that order) and the kernels agree bit for bit.
#pragma once

#include "w4a8.cuh"

namespace sbt {

constexpr int kGridThreads = 256;  // every block of K3 and K4
constexpr int kMaxGridRows = 64;   // B
constexpr int kMaxBlocksPerSM = 2;

// The FFN half's operands and scratch (K4's Args extends them). Weights
// are layer stacks: w13 (L, dim/2, 2F) and w2 (L, f2/2, dim) s4r bytes with
// (L, K/gs, N) scales and zeros, f32 or bf16 (sz_bf16). f2 >= F: a W2
// K-padded by QuantLinear.with_k_pad carries f2 - F rows of code 0, zero
// 0 and scale 1 a layer, whose groups fold to exactly 0 against the zero
// rows of the GLU; the phases read W2's first F rows of each layer only,
// so a padded model keeps the unpadded model's K split and bits.
struct FfnArgs {
  const uint8_t *w13, *w2;
  const void *s13, *z13, *s2, *z2;
  int8_t* xq;     // (B, dim) int8 rows of the norm
  float* xs;      // (B) their scales
  float* act;     // (B, F) silu(g) * u
  float* amax_g;  // (B) each row's max |act|
  int8_t* aq;     // (B, >= F) q8(act)
  float* part;    // (splits, B, N) each matmul's K-split partials
  int sz_bf16, nw_bf16, B, dim, F, gs;
  int f2;       // rows of one layer of the W2 stack (>= F)
  int g13, g2;  // groups a K split of W13 and W2 (s4_plan)
  float eps;
};

// Phases of the FFN half, each naming the grid barrier that ends it.
enum FfnMark : int {
  kFfnNormDone, kW13Done, kGluDone, kQ8ActDone, kW2Done, kW2SumDone
};

__device__ __forceinline__ const void* qp_at(const void* p, size_t i,
                                             int bf16) {
  return static_cast<const char*>(p) + i * (bf16 ? 2 : 4);
}

// Ordered block reductions over all kGridThreads threads: the plain
// version's attention.ordered_sum folds the partials in this same tree.
__device__ inline float tree_sum(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int w = kGridThreads / 2; w >= 1; w >>= 1) {
    if (t < w) red[t] = __fadd_rn(red[t], red[t + w]);
    __syncthreads();
  }
  float r = red[0];
  __syncthreads();
  return r;
}

__device__ inline float tree_max(float v, float* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int w = kGridThreads / 2; w >= 1; w >>= 1) {
    if (t < w) red[t] = fmaxf(red[t], red[t + w]);
    __syncthreads();
  }
  float r = red[0];
  __syncthreads();
  return r;
}

// xq[row] = int8(rms_norm(xr) * nw), xs[row] its scale; f32 throughout:
// var = sum(x^2) / dim, xn = (x * (1 / sqrt(var + eps))) * nw.
__device__ inline void norm_quant_row(const float* xr, const void* nw,
                                      int nw_bf16, int dim, float eps,
                                      int8_t* xq, float* xs, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < dim; i += kGridThreads)
    ss = __fadd_rn(ss, __fmul_rn(xr[i], xr[i]));
  const float var = __fdiv_rn(tree_sum(ss, red), static_cast<float>(dim));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  float mx = 0.f;
  for (int i = threadIdx.x; i < dim; i += kGridThreads)
    mx = fmaxf(mx, fabsf(__fmul_rn(__fmul_rn(xr[i], r),
                                   load_qparam(nw, i, nw_bf16))));
  const float scale = row_scale(tree_max(mx, red));
  for (int i = threadIdx.x; i < dim; i += kGridThreads)
    xq[i] = static_cast<int8_t>(quant8(
        __fmul_rn(__fmul_rn(xr[i], r), load_qparam(nw, i, nw_bf16)), scale));
  if (threadIdx.x == 0) *xs = scale;
}

// For every output i < n, over the whole grid: f(i).
template <class F>
__device__ __forceinline__ void grid_for(size_t n, const F& f) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kGridThreads) +
                  threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * kGridThreads)
    f(i);
}

// dst (B, K) int8 = q8(src (B, K) f32) against each row's absmax, four
// codes a word, the whole grid striding over the words (AF32Requant's
// codes): the int8 rows the Wo and W2 tiles stream.
__device__ inline void quant_rows_grid(const float* src, const float* amax,
                                       int B, int K, int8_t* dst) {
  const AF32Requant q{src, amax, B, K};
  const int kw = K / 4;
  grid_for(static_cast<size_t>(B) * kw, [&](size_t i) {
    const int row = static_cast<int>(i / kw);
    reinterpret_cast<int*>(dst)[i] =
        q.word(row, 4 * static_cast<int>(i - static_cast<size_t>(row) * kw));
  });
}

// One s4r matmul phase with the tensor-core tile C (s4tile) over the int8
// rows x (a.B, K): items (column tile, K split) over the grid, each writing
// its split's partial sum of groups [p * gps, (p + 1) * gps) in order to
// a.part[p]; after a grid barrier (sync) every output adds the partials in
// split order: sum(f) hands f the function i -> that sum of output i = row
// * N + col. The plain version repeats that order (_qmm_s4_plain with the
// plan's gps). w, s, z are layer stacks of K_st >= K rows a layer (the
// rows past K, a with_k_pad W2's zero groups, are not read), li the layer.
template <class C, class Sync, class Sum>
__device__ __forceinline__ void s4_phase(const int8_t* x, const uint8_t* w,
                                         const void* s, const void* z,
                                         int li, int K, int K_st, int N,
                                         int gps, const FfnArgs& a,
                                         uint8_t* smem, const Sync& sync,
                                         const Sum& sum) {
  const int G = K / a.gs, splits = (G + gps - 1) / gps;
  const int tiles = (N + C::BN - 1) / C::BN;
  const int es = a.sz_bf16 ? 2 : 4;
  const size_t G_st = K_st / a.gs;
  const uint8_t* wl = w + static_cast<size_t>(li) * (K_st / 2) * N;
  const void* sl = qp_at(s, li * G_st * N, a.sz_bf16);
  const void* zl = qp_at(z, li * G_st * N, a.sz_bf16);
  const int vec_w = copy_width(wl, N);
  const int vec_q = min(copy_width(sl, static_cast<size_t>(N) * es),
                        copy_width(zl, static_cast<size_t>(N) * es));
  const size_t BN_ = static_cast<size_t>(a.B) * N;
  const S4Out<C> o;
  for (int item = blockIdx.x; item < tiles * splits; item += gridDim.x) {
    const int tile = item % tiles, p = item / tiles;
    const int g0 = p * gps, col0 = tile * C::BN;
    float acc[C::MT][C::NT][4];
    s4tile<C>(x, a.B, K, wl, N, vec_w, sl, zl, a.sz_bf16, N, vec_q, a.gs, g0,
              min(G, g0 + gps), col0, N, smem, acc);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = o.row(mt, r), col = col0 + o.col(j, r);
          if (row < a.B && col < N)
            a.part[p * BN_ + static_cast<size_t>(row) * N + col] =
                acc[mt][j][r];
        }
  }
  sync();
  sum([&](size_t i) {
    float v = a.part[i];
    for (int p = 1; p < splits; ++p) v = __fadd_rn(v, a.part[p * BN_ + i]);
    return v;
  });
}

// norm phase: xq, xs of every row from xin (B, dim) and the norm weight
// nw (dim), a block a row; amax_g zeroed for the GLU.
__device__ inline void ffn_norm_rows(const FfnArgs& a, const float* xin,
                                     const void* nw, float* red) {
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    norm_quant_row(xin + static_cast<size_t>(b) * a.dim, nw, a.nw_bf16,
                   a.dim, a.eps, a.xq + static_cast<size_t>(b) * a.dim,
                   a.xs + b, red);
    if (threadIdx.x == 0) a.amax_g[b] = 0.f;
  }
}

// GLU phase: act = silu(g) * u over the whole grid, gate_up(row, j, g, u)
// giving row's gate column j and up column F + j, and amax_g raised to
// each row's max |act| (atomicMax on the float bits: the values are not
// negative). amax_sm: kMaxGridRows ints of shared memory.
template <class GateUp>
__device__ inline void glu_rows(const FfnArgs& a, int* amax_sm,
                                const GateUp& gate_up) {
  const int B = a.B, F = a.F;
  if (static_cast<int>(threadIdx.x) < B) amax_sm[threadIdx.x] = 0;
  __syncthreads();
  grid_for(static_cast<size_t>(B) * F, [&](size_t i) {
    const int rl = static_cast<int>(i / F), j = static_cast<int>(i % F);
    float g, u;
    gate_up(rl, j, g, u);
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
    const float v = __fmul_rn(__fmul_rn(g, sig), u);
    a.act[i] = v;
    atomicMax(&amax_sm[rl], __float_as_int(fabsf(v)));
  });
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < B)
    atomicMax(reinterpret_cast<int*>(a.amax_g) + threadIdx.x,
              amax_sm[threadIdx.x]);
}

// The whole FFN half of layer li on the s4r tiles C: out (B, dim) = xin +
// W2(q8(silu(g) * u)), nw the layer's norm weight; sync(mark) after each
// phase (a grid barrier). out may not alias xin.
template <class C, class Sync>
__device__ inline void ffn_s4(const FfnArgs& a, int li, const float* xin,
                              const void* nw, float* out, uint8_t* smem,
                              int* amax_sm, float* red, const Sync& sync) {
  const int B = a.B, dim = a.dim, F = a.F, F2 = 2 * F;
  ffn_norm_rows(a, xin, nw, red);
  sync(kFfnNormDone);
  s4_phase<C>(a.xq, a.w13, a.s13, a.z13, li, dim, dim, F2, a.g13, a, smem,
              [&] { sync(kW13Done); }, [&](const auto& split_sum) {
                glu_rows(a, amax_sm, [&](int rl, int j, float& g, float& u) {
                  const size_t at = static_cast<size_t>(rl) * F2 + j;
                  g = __fmul_rn(split_sum(at), a.xs[rl]);
                  u = __fmul_rn(split_sum(at + F), a.xs[rl]);
                });
              });
  sync(kGluDone);
  quant_rows_grid(a.act, a.amax_g, B, F, a.aq);
  sync(kQ8ActDone);
  s4_phase<C>(a.aq, a.w2, a.s2, a.z2, li, F, a.f2, dim, a.g2, a, smem,
              [&] { sync(kW2Done); }, [&](const auto& split_sum) {
                grid_for(static_cast<size_t>(B) * dim, [&](size_t i) {
                  const int row = static_cast<int>(i / dim);
                  out[i] = __fadd_rn(
                      xin[i], __fmul_rn(split_sum(i), row_scale(a.amax_g[row])));
                });
              });
  sync(kW2SumDone);
}

// Blocks of the persistent grid of kernel kern: as many as fit on the card
// at once, at most kMaxBlocksPerSM an SM. smem: its dynamic shared memory,
// allowed past 48 KB first, so that the occupancy query sees the launch's
// own size.
template <class Kern>
inline cudaError_t grid_size(Kern kern, int smem, int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    kGridThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *grid = sms * (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM);
  return cudaSuccess;
}

}  // namespace sbt
