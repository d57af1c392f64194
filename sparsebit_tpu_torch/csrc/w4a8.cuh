// W4A8 tile core shared by the K1 matmul (quant_matmul.cu) and the fused
// FFN (ffn_fused.cu).
//
// Math (sparsebit_tpu/ops/quant_matmul.py:443-471, _qmm_u4_kernel): for
// int8 activations x8 (M, K) and 4-bit codes C (K, N) stored as signed
// row pairs ("s4r": byte [k/2, n] holds code-8 of rows k and k+1, even row
// in the low nibble), with per-group (G = K/gs, N) scales s and zeros z,
//     acc[m, n] = sum_g s_g * (dot_g - xsum_g * (z_g - 8)),
//     dot_g = sum_{k in g} x8[m, k] * (C[k, n] - 8)   (exact int32),
//     xsum_g = sum_{k in g} x8[m, k]                 (exact int32),
// each group term in f32, in that order, summed over g in order.
//
// Tiling: a block owns a BM x BN output tile and walks K in steps of
// BK = 64 rows. Each step copies the x8 tile (BM x 64 bytes) and the s4r
// tile (32 x BN bytes, neighbouring threads on neighbouring columns, so
// the reads coalesce) into shared memory, the weights decoded to int8 and
// transposed so that one 32-bit word holds 4 consecutive k of one column.
// Threads then run __dp4a over the words; the next step's global loads are
// issued into registers before the current step's dot products (register
// double buffering). At the end of every group the int32 dots are folded
// into the f32 accumulators with that group's scale and zero, read once
// per (group, column) and never past row G-1.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sbt {

constexpr int BK = 64;       // k rows per pipeline step
constexpr int KW = BK / 4;   // 32-bit words (4 codes) per row per step

__device__ __forceinline__ float load_qparam(const void* p, size_t i,
                                             int bf16) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         ((d & 0xff) << 24);
}

// Two s4r bytes of one column (rows 2r and 2r+1 of the K/2 axis) -> the
// four signed codes of k = 4r..4r+3 as one dp4a word, k ascending.
__device__ __forceinline__ int decode_s4_pair(uint32_t b0, uint32_t b1) {
  int lo0 = static_cast<int>(static_cast<int8_t>(b0 << 4)) >> 4;
  int hi0 = static_cast<int>(static_cast<int8_t>(b0)) >> 4;
  int lo1 = static_cast<int>(static_cast<int8_t>(b1 << 4)) >> 4;
  int hi1 = static_cast<int>(static_cast<int8_t>(b1)) >> 4;
  return pack4(lo0, hi0, lo1, hi1);
}

__device__ __forceinline__ int quant8(float v, float scale) {
  float r = rintf(v / scale);  // half to even, like jnp.round
  r = fminf(fmaxf(r, -128.f), 127.f);
  return static_cast<int>(r);
}

// A operand: int8 rows (M, K).
struct AInt8 {
  const int8_t* x;
  int M, K;
  __device__ __forceinline__ int word(int row, int k) const {
    if (row >= M) return 0;
    return *reinterpret_cast<const int*>(x + static_cast<size_t>(row) * K +
                                         k);
  }
};

// Per-row int8 scale of tokenwise_quant: max(absmax, 1e-8) * (1/127), the
// multiply that XLA makes of the reference's division by 127.
__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(absmax, 1e-8f) * (1.0f / 127.0f);
}

// A operand: f32 rows (M, K) quantized to int8 on load against the row's
// absmax.
struct AF32Requant {
  const float* a;
  const float* amax;
  int M, K;
  __device__ __forceinline__ int word(int row, int k) const {
    if (row >= M) return 0;
    float4 v = *reinterpret_cast<const float4*>(
        a + static_cast<size_t>(row) * K + k);
    float s = row_scale(amax[row]);
    return pack4(quant8(v.x, s), quant8(v.y, s), quant8(v.z, s),
                 quant8(v.w, s));
  }
};

// Tile column -> weight column, or -1 past the edge.
struct ColPlain {
  int n0, N;
  __device__ __forceinline__ int operator()(int c) const {
    int n = n0 + c;
    return n < N ? n : -1;
  }
};

// GLU pairing over a fused [gate | up] weight of 2F columns: tile columns
// [0, half) are gate columns j0.., [half, 2*half) the up columns F+j0..
struct ColGLU {
  int j0, F, half;
  __device__ __forceinline__ int operator()(int c) const {
    int j = j0 + (c < half ? c : c - half);
    if (j >= F) return -1;
    return c < half ? j : F + j;
  }
};

template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int TX = BN / TN;
  static constexpr int TY = BM / TM;
  static constexpr int THREADS = TX * TY;
  static constexpr int XW = BM * KW;  // x words per step
  static constexpr int WP = BN * KW;  // (column, word) pairs per step
  static constexpr int XW_T = (XW + THREADS - 1) / THREADS;
  static constexpr int WP_T = WP / THREADS;
  static_assert(WP % THREADS == 0, "weight pairs must split evenly");
};

// Accumulates acc[tm][tn] for rows row0 + ty + tm*TY and tile columns
// tx + tn*TX. w, s, z already point at the layer; N is the row stride of
// w (bytes) and of s/z (elements).
template <int BM, int BN, int TM, int TN, class A, class ColMap>
__device__ __forceinline__ void w4a8_tile(
    const A& a, const uint8_t* __restrict__ w, const void* s, const void* z,
    int sz_bf16, int N, int K, int gs, int row0, const ColMap& cm,
    float (&acc)[TM][TN]) {
  using T = Tile<BM, BN, TM, TN>;
  __shared__ int xs_sm[BM][KW + 1];
  __shared__ int ws_sm[BN][KW + 1];
  __shared__ int xsum_sm[BM];

  const int tid = threadIdx.x;
  const int tx = tid % T::TX, ty = tid / T::TX;
  int xr[T::XW_T];
  uint32_t wr0[T::WP_T], wr1[T::WP_T];
  int wcol[T::WP_T];
  int idot[TM][TN];
#pragma unroll
  for (int i = 0; i < T::WP_T; ++i) wcol[i] = cm((tid + i * T::THREADS) % BN);
#pragma unroll
  for (int tm = 0; tm < TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      acc[tm][tn] = 0.f;
      idot[tm][tn] = 0;
    }
  if (tid < BM) xsum_sm[tid] = 0;

  const int nk = K / BK;
  const int steps_per_group = gs / BK;

  auto load = [&](int ks) {
    const int k0 = ks * BK;
#pragma unroll
    for (int i = 0; i < T::XW_T; ++i) {
      int idx = tid + i * T::THREADS;
      if (idx < T::XW) xr[i] = a.word(row0 + idx / KW, k0 + 4 * (idx % KW));
    }
#pragma unroll
    for (int i = 0; i < T::WP_T; ++i) {
      int kw = (tid + i * T::THREADS) / BN;
      if (wcol[i] >= 0) {
        const uint8_t* p =
            w + static_cast<size_t>(k0 / 2 + 2 * kw) * N + wcol[i];
        wr0[i] = p[0];
        wr1[i] = p[N];
      } else {
        wr0[i] = wr1[i] = 0;
      }
    }
  };

  load(0);
  for (int ks = 0; ks < nk; ++ks) {
    __syncthreads();  // the previous step's dot products are done
#pragma unroll
    for (int i = 0; i < T::XW_T; ++i) {
      int idx = tid + i * T::THREADS;
      if (idx < T::XW) {
        xs_sm[idx / KW][idx % KW] = xr[i];
        atomicAdd(&xsum_sm[idx / KW], __dp4a(xr[i], 0x01010101, 0));
      }
    }
#pragma unroll
    for (int i = 0; i < T::WP_T; ++i) {
      int idx = tid + i * T::THREADS;
      ws_sm[idx % BN][idx / BN] = decode_s4_pair(wr0[i], wr1[i]);
    }
    __syncthreads();
    if (ks + 1 < nk) load(ks + 1);
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int av[TM];
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) av[tm] = xs_sm[ty + tm * T::TY][kw];
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) {
        int b = ws_sm[tx + tn * T::TX][kw];
#pragma unroll
        for (int tm = 0; tm < TM; ++tm)
          idot[tm][tn] = __dp4a(av[tm], b, idot[tm][tn]);
      }
    }
    if ((ks + 1) % steps_per_group == 0) {
      const int g = ks / steps_per_group;
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) {
        int col = cm(tx + tn * T::TX);
        float sg = 0.f, zg = 0.f;
        if (col >= 0) {
          size_t off = static_cast<size_t>(g) * N + col;
          sg = load_qparam(s, off, sz_bf16);
          zg = load_qparam(z, off, sz_bf16) - 8.f;  // s4r stores code-8
        }
#pragma unroll
        for (int tm = 0; tm < TM; ++tm) {
          float xsum = static_cast<float>(xsum_sm[ty + tm * T::TY]);
          float d = static_cast<float>(idot[tm][tn]);
          acc[tm][tn] = __fadd_rn(
              acc[tm][tn],
              __fmul_rn(__fsub_rn(d, __fmul_rn(xsum, zg)), sg));
          idot[tm][tn] = 0;
        }
      }
      __syncthreads();  // every thread has read this group's xsum
      if (tid < BM) xsum_sm[tid] = 0;
    }
  }
}

}  // namespace sbt
