// W4A8 tile cores: s4tile (int8 tensor cores over s4r: K1, quant_matmul.cu;
// K4's 4-bit mode, layer_fused.cu; K3, ffn_fused.cu, through
// ffn_phases.cuh) and ptile (dp4a over the 2/3-bit plane concat: K4's
// plane mode), both with the same epilogue order.
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
// K4's true-width 2/3-bit "pl" concat (PlaneRows) goes through ptile, the
// same product on __dp4a with a plane-aware tile (its columns span all
// planes of a run of byte columns, each byte read once and decoded into
// the words of all its planes) fed by a cp.async ring; unsigned plane
// codes take the zero unshifted:
//     acc[m, n] = sum_g s_g * (dot_g - xsum_g * z_g).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "planes.cuh"

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

__device__ __forceinline__ int quant8(float v, float scale) {
  float r = rintf(v / scale);  // half to even, like jnp.round
  r = fminf(fmaxf(r, -128.f), 127.f);
  return static_cast<int>(r);
}

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

// The true-width plane concat "pl" (planes.cuh) of a weight of N (padded)
// columns: (K, 3N/8) bytes [low2 | high1] at 3 bits, the (K, N/4) fold
// array at 2 bits. Column n is byte column c = n % NP of plane p = n / NP;
// unsigned codes. Byte column c of array a of row k (3 bits: a = 0 the even
// planes' low2, 1 the odd planes', 2 high1) is w[k * ld + a * NP + c].
template <int BITS>
struct PlaneRows {
  const uint8_t* w;
  int ld;  // row stride in bytes: 3N/8 or N/4
  int NP;  // byte columns (columns per plane): N/8 or N/4
  static_assert(BITS == 2 || BITS == 3, "plane rows are 2 or 3 bits");
  static constexpr int P = BITS == 3 ? 8 : 4;   // planes
  static constexpr int NA = BITS == 3 ? 3 : 1;  // byte arrays a row
};

// Tile column t of a plane tile over byte columns [c0, c0 + W): plane
// t / W, byte column c0 + t % W; -1 past NP or past the logical width N.
struct ColPlanes {
  int c0, W, NP, N;
  __device__ __forceinline__ int operator()(int t) const {
    const int p = t / W, c = c0 + t % W;
    const int n = p * NP + c;
    return (c < NP && n < N) ? n : -1;
  }
};

// A BM x BN output tile of ptile, TM x TN outputs a thread: thread (tx,
// ty) owns rows ty + tm * TY and tile columns tx + tn * TX.
template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int TX = BN / TN;
  static constexpr int TY = BM / TM;
  static constexpr int THREADS = TX * TY;
};

// ptile's shared memory for a BM x BN plane tile (W = BN / P byte
// columns): a ring of NST stages, each the raw weight bytes [NA][BK][W]
// and the int8 x rows [BM][BK] of one 64-row step, then the decoded dp4a
// words [BN][KW + 1].
template <int BM, int BN, int BITS>
struct PlaneSmem {
  using Src = PlaneRows<BITS>;
  static constexpr int W = BN / Src::P;
  static constexpr int WB = Src::NA * BK * W;  // weight bytes a stage
  static constexpr int STAGE = WB + BM * BK;
  static constexpr int FIT = 20480 / STAGE;  // stages in 20 KB
  static constexpr int NST = FIT < 3 ? 3 : (FIT > 8 ? 8 : FIT);
  static constexpr int WORDS = NST * STAGE;  // offset of the words
  static constexpr int BYTES = WORDS + BN * (KW + 1) * 4;
};

// The s4r product above over a plane concat with a plane-aware tile: its BN
// columns are W = BN / P byte columns x all P planes (ColPlanes), so each
// weight byte is read once. Int8 x rows x (M <= BM used, row stride K)
// and the tile's weight bytes stream through a cp.async ring of NST
// stages (NST - 1 in flight ahead of the one being read), vec bytes a
// copy (16, 8 or 4, dividing W; 1 where the rows are not so aligned).
// Each step, the thread of (byte column, k word) unit decodes the four
// rows of its byte column into the dp4a words of its P columns, then
// every thread runs __dp4a over the words of its outputs and, at each
// group's end, folds the int32 dots into its f32 sums in the order above
// (each group's qparams read once a column). A thread
// whose rows are all past M skips the dot products (at B = 1, seven of
// the eight row warps), and each thread sums its own rows' x codes.
// Groups [g0, g1) of the K / gs: with terms null, acc is their sum in
// group order from 0; else acc stays 0 and group g's f32 term goes to
// terms[((g - g0) * M + row) * cm.N + col], so that a caller can add
// them to the sum of the groups before g0 in order, exactly.
template <int BM, int BN, int TM, int TN, int BITS>
__device__ __forceinline__ void ptile(
    const int8_t* x, int M, const PlaneRows<BITS>& src, int vec,
    const void* s, const void* z, int sz_bf16, int N, int K, int gs, int g0,
    int g1, float* terms, const ColPlanes& cm, uint8_t* smem,
    float (&acc)[TM][TN]) {
  using T = Tile<BM, BN, TM, TN>;
  using Sm = PlaneSmem<BM, BN, BITS>;
  constexpr int P = PlaneRows<BITS>::P, NA = PlaneRows<BITS>::NA;
  constexpr int W = Sm::W, NST = Sm::NST;
  static_assert(W * P == BN && W % 4 == 0, "whole 4-byte copies a row");
  int* ws_sm = reinterpret_cast<int*>(smem + Sm::WORDS);
  const int tid = threadIdx.x;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int spg = gs / BK, ks0 = g0 * spg, nk = (g1 - g0) * spg;
  const bool live = ty < M;  // some row of this thread is a real row
  int idot[TM][TN], xsum[TM];
  float sg[TN], zg[TN];
#pragma unroll
  for (int tm = 0; tm < TM; ++tm) {
    xsum[tm] = 0;
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      acc[tm][tn] = 0.f;
      idot[tm][tn] = 0;
    }
  }
  __syncthreads();  // the previous tile has read the ring and the words

  const int lw = __ffs(W / vec) - 1;  // 2^lw copies a weight row
  auto issue = [&](int st) {
    uint8_t* sw = smem + (st % NST) * Sm::STAGE;
    const int k0 = (ks0 + st) * BK;
    const int n_w = NA * BK << lw;
    for (int i = tid; i < n_w + BM * (BK / 16); i += T::THREADS) {
      if (i < n_w) {
        const int ar = i >> lw, c = (i & ((1 << lw) - 1)) * vec;  // (a, row)
        const int ra = ar / BK, r = ar % BK;
        copy_chunk(sw + ar * W + c,
                   src.w + static_cast<size_t>(k0 + r) * src.ld +
                       ra * src.NP + cm.c0 + c,
                   vec, cm.c0 + c < src.NP);
      } else {
        const int j = i - n_w, m = j / (BK / 16), c = (j % (BK / 16)) * 16;
        copy_chunk(sw + Sm::WB + m * BK + c,
                   reinterpret_cast<const uint8_t*>(x) +
                       static_cast<size_t>(m < M ? m : 0) * K + k0 + c,
                   16, m < M);
      }
    }
  };

  for (int st = 0; st < NST - 1; ++st) {
    if (st < nk) issue(st);
    cp_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_wait<NST - 2>();
    __syncthreads();  // step ks is in; step ks - 1 is read by all
    if (ks + NST - 1 < nk) issue(ks + NST - 1);
    cp_commit();
    const uint8_t* sw = smem + (ks % NST) * Sm::STAGE;
    const uint8_t* sx = sw + Sm::WB;
    const int g = g0 + ks / spg;
    if (ks % spg == 0) {  // a group starts: its qparams, read at its end
#pragma unroll
      for (int tn = 0; tn < TN; ++tn) {
        const int col = cm(tx + tn * T::TX);
        sg[tn] = zg[tn] = 0.f;
        if (col >= 0) {
          const size_t off = static_cast<size_t>(g) * N + col;
          sg[tn] = load_qparam(s, off, sz_bf16);
          zg[tn] = load_qparam(z, off, sz_bf16);
        }
      }
    }
    // (byte column, k word) units
    for (int u = tid; u < W * KW; u += T::THREADS) {
      const int uc = u % W, ukw = u / W;
      uint32_t r[NA];
#pragma unroll
      for (int ra = 0; ra < NA; ++ra)
        r[ra] = rows4(sw + (ra * BK + 4 * ukw) * W + uc, W);
#pragma unroll
      for (int p = 0; p < P; ++p)
        ws_sm[(p * W + uc) * (KW + 1) + ukw] = plane_word<BITS>(
            r[BITS == 3 ? (p & 1) : 0], BITS == 3 ? r[NA - 1] : 0u, p);
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        int av[TM];
#pragma unroll
        for (int tm = 0; tm < TM; ++tm) {
          av[tm] = *reinterpret_cast<const int*>(
              sx + (ty + tm * T::TY) * BK + 4 * kw);
          xsum[tm] = __dp4a(av[tm], 0x01010101, xsum[tm]);
        }
#pragma unroll
        for (int tn = 0; tn < TN; ++tn) {
          const int b = ws_sm[(tx + tn * T::TX) * (KW + 1) + kw];
#pragma unroll
          for (int tm = 0; tm < TM; ++tm)
            idot[tm][tn] = __dp4a(av[tm], b, idot[tm][tn]);
        }
      }
    }
    if ((ks + 1) % spg == 0) {  // the group ends: fold it in
#pragma unroll
      for (int tm = 0; tm < TM; ++tm) {
        const float xs = static_cast<float>(xsum[tm]);
        const int row = ty + tm * T::TY;
#pragma unroll
        for (int tn = 0; tn < TN; ++tn) {
          const float d = static_cast<float>(idot[tm][tn]);
          const float t =
              __fmul_rn(__fsub_rn(d, __fmul_rn(xs, zg[tn])), sg[tn]);
          if (terms == nullptr) {
            acc[tm][tn] = __fadd_rn(acc[tm][tn], t);
          } else {
            const int col = cm(tx + tn * T::TX);
            if (row < M && col >= 0)
              terms[(static_cast<size_t>(g - g0) * M + row) * cm.N + col] =
                  t;
          }
          idot[tm][tn] = 0;
        }
        xsum[tm] = 0;
      }
    }
  }
  cp_wait<0>();
}

// ---- s4r on the int8 tensor cores: s4tile ----------------------------------
//
// The s4r product above on mma.sync.m16n8k32 (s8 x s8 -> s32): K1 at every
// M and K4's four 4-bit matmul phases. mma.sync, not wgmma: its fragments
// live in registers, so the nibble decode writes the B operand straight
// from a shared-memory stage with no second pass through shared memory,
// and one warp's tile is self-contained; wgmma would need the decoded int8
// tile written back to shared memory in its swizzled layout first (a
// later step toward the card's full int8 rate).
//
// Decode. Four s4r rows (a "quad": k = 8q..8q+7) of one column, one byte
// each, make a column word cw; (cw << 4) & 0xF0F0F0F0 holds 16 x the codes
// of the even k (8q, 8q+2, 8q+4, 8q+6) as int8 and cw & 0xF0F0F0F0 those of
// the odd k, no sign extension needed. The int8 x words are permuted the
// same way (bytes 0,2,4,6 and 1,3,5,7 of the 8 k), the integer dot is then
// 16 x the true dot and >> 4 gives it back exactly. One mma's B fragment
// is a thread's (even, odd) pair of one column: k-block t of the k32 step
// for lane (g, t), so the even/odd order is the same in A and B.
//
// Tile. A block of 8 warps owns BM x BN outputs over the groups [g0, g1)
// of K (a K split at group boundaries); a warp owns MT m16 tiles x NT
// columns a thread (NT n8 tiles): lane (g, t) decodes columns NT*g..NT*g+NT-1
// of the warp's run and feeds column NT*g + j to n8 tile j. Weight rows,
// int8 x rows and, at a group's last stage, its scales and zeros stream
// through a cp.async ring of NST stages of KS = 64 k (32 s4r rows), SPS
// of them read between two block barriers while NST - SPS are in flight,
// so no qparam is read from global memory at a group's end. A weight stage is
// row-major with the 16-byte runs of row r swizzled (run c stored at c ^
// 2 * ((r / 4) % 4)): a warp's copies fill every bank evenly and a warp's
// column-word loads (rows 4t + i, t = 0..3) hit 32 distinct banks (a
// quad-major layout, conflict-free for the loads, serialized the copies
// on bank conflicts); x rows are padded to 96 bytes for the same.
// m16 tiles wholly past M issue no mma and load no x, and a tile's rows
// 8..15 load no x when they are all past M (at B <= 8: the padding rows
// ride along in the mma as zeros and cost no other instruction).
//
// Numerics: at each group end the int32 dots (exact) and the row's x sum
// (exact; each lane of a quad sums its k-blocks, two shuffles add them)
// fold into f32 as acc + (dot - xsum * (z - 8)) * s, ptile's order.
template <int BM_, int BN_, int WM_, int WN_, int NST_, int SPS_>
struct S4Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, NST = NST_;
  static constexpr int SPS = SPS_;  // stages a block barrier
  static_assert(NST >= 2 * SPS, "SPS stages read while NST - SPS fly");
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / (WM * 16);  // m16 tiles a warp
  static constexpr int WC = BN / WN;         // columns a warp
  static constexpr int NT = WC / 8;          // columns a lane (n8 tiles)
  static constexpr int KS = 64;              // k a stage
  static constexpr int XS = KS + 32;         // bytes an x row, padded
  static constexpr int WB = KS / 2 * BN;     // weight bytes a stage
  static constexpr int XB = BM * XS;
  static constexpr int QB = 8 * BN;          // scales then zeros (<= f32)
  static constexpr int STAGE = WB + XB + QB;
  static constexpr int BYTES = NST * STAGE;  // dynamic shared memory
  static_assert(BM == WM * MT * 16 && MT >= 1, "whole m16 tiles a warp");
  static_assert(NT == 4 || NT == 8, "4 or 8 columns a lane");
  static_assert(BN % 128 == 0, "whole swizzle rows (8 runs of 16 bytes)");
  static_assert(STAGE % 16 == 0, "16-byte stages");
};

// Widest copy (16, 8, 4 or 1 bytes) that a base pointer and a row stride
// (bytes) allow.
__device__ __forceinline__ int copy_width(const void* p, size_t stride) {
  int v = 16;
  while (v > 1 &&
         (reinterpret_cast<uintptr_t>(p) % v != 0 || stride % v != 0))
    v = v == 4 ? 1 : v / 2;
  return v;
}

// Byte offset in a weight stage of byte cb of s4r row r (row stride bn).
__device__ __forceinline__ int stage_at(int r, int cb, int bn) {
  return r * bn + (((cb >> 4) ^ (((r >> 2) & 3) << 1)) << 4) + (cb & 15);
}

// Column words of 4 columns from the 4 rows of a quad (r[i]: bytes of row
// i, column j in byte j): cw[j] byte i = row i's byte of column j.
__device__ __forceinline__ void quad_columns(const uint32_t (&r)[4],
                                             uint32_t* cw) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  cw[0] = __byte_perm(lo01, lo23, 0x5410);
  cw[1] = __byte_perm(lo01, lo23, 0x7632);
  cw[2] = __byte_perm(hi01, hi23, 0x5410);
  cw[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Output (row, column) of acc[mt][j][r] within the tile, for this lane.
template <class C>
struct S4Out {
  int row_w, col_w, g, t;
  __device__ __forceinline__ S4Out() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    row_w = (warp / C::WN) * C::MT * 16;
    col_w = (warp % C::WN) * C::WC;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ __forceinline__ int row(int mt, int r) const {
    return row_w + mt * 16 + g + 8 * (r >> 1);
  }
  __device__ __forceinline__ int col(int j, int r) const {
    return col_w + C::NT * (2 * t + (r & 1)) + j;
  }
};

// acc = the s4r product of int8 rows x (M rows used, row stride ldx, 16-
// byte aligned) and columns [col0, col0 + BN) of w (row stride ldw bytes;
// N columns, those past it zero) over the groups [g0, g1), in C-fragment
// order (S4Out maps it). s, z: (G, ldq) qparams, f32 or bf16. vec_w,
// vec_q: the copy widths (copy_width) of w and of the qparam rows.
template <class C>
__device__ __forceinline__ void s4tile(
    const int8_t* x, int M, int ldx, const uint8_t* w, int ldw, int vec_w,
    const void* s, const void* z, int sz_bf16, int ldq, int vec_q, int gs,
    int g0, int g1, int col0, int N, uint8_t* smem,
    float (&acc)[C::MT][C::NT][4]) {
  constexpr int MT = C::MT, NT = C::NT, NST = C::NST, KS = C::KS;
  constexpr int BN = C::BN;
  const S4Out<C> o;
  const int es = sz_bf16 ? 2 : 4;
  const int spg = gs / KS, nk = (g1 - g0) * spg, kb = g0 * gs;
  const int mrows = min(C::BM, (M + 15) & ~15);
  int idot[MT][NT][4], xsum[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xsum[mt][0] = xsum[mt][1] = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        idot[mt][j][r] = 0;
        acc[mt][j][r] = 0.f;
      }
  }
  __syncthreads();  // the previous tile has read the ring

  const int lw = __ffs(BN / vec_w) - 1;       // 2^lw copies a weight row
  const int lq = __ffs(BN * es / vec_q) - 1;  // 2^lq copies a qparam row
  auto issue = [&](int st) {
    uint8_t* sw = smem + (st % NST) * C::STAGE;
    const int k0 = kb + st * KS;
    const int n_w = (KS / 2) << lw, n_x = mrows * (KS / 16);
    const int n_q = (st % spg == spg - 1) ? 2 << lq : 0;
    for (int i = threadIdx.x; i < n_w + n_x + n_q; i += C::THREADS) {
      if (i < n_w) {
        const int r = i >> lw, cb = (i & ((1 << lw) - 1)) * vec_w;
        copy_chunk(sw + stage_at(r, cb, BN),
                   w + static_cast<size_t>(k0 / 2 + r) * ldw + col0 + cb,
                   vec_w, col0 + cb < N);
      } else if (i < n_w + n_x) {
        const int j = i - n_w, m = j / (KS / 16), c = (j % (KS / 16)) * 16;
        copy_chunk(sw + C::WB + m * C::XS + c,
                   reinterpret_cast<const uint8_t*>(x) +
                       static_cast<size_t>(m < M ? m : 0) * ldx + k0 + c,
                   16, m < M);
      } else {
        const int j = i - n_w - n_x, h = j >> lq;
        const int cb = (j & ((1 << lq) - 1)) * vec_q;
        const size_t at = (static_cast<size_t>(k0 / gs) * ldq + col0) * es;
        copy_chunk(sw + C::WB + C::XB + h * 4 * BN + cb,
                   static_cast<const uint8_t*>(h ? z : s) + at + cb, vec_q,
                   col0 + cb / es < N);
      }
    }
  };

  constexpr int SPS = C::SPS;
  for (int st = 0; st < NST - SPS; ++st) {
    if (st < nk) issue(st);
    cp_commit();
  }
  const int wcol = o.col_w + NT * o.g;  // this lane's first column
  const int woff = stage_at(4 * o.t, wcol, BN);  // + (16 k32 + i) * BN
  for (int ks0 = 0; ks0 < nk; ks0 += SPS) {
    cp_wait<NST - 2 * SPS>();
    __syncthreads();  // stages ks0.. are in; the SPS before them are read
#pragma unroll
    for (int u = 0; u < SPS; ++u) {
      if (ks0 + NST - SPS + u < nk) issue(ks0 + NST - SPS + u);
      cp_commit();
    }
#pragma unroll 1
    for (int ks = ks0; ks < min(nk, ks0 + SPS); ++ks) {
      const uint8_t* sw = smem + (ks % NST) * C::STAGE;
      const uint8_t* sx = sw + C::WB;
#pragma unroll
      for (int k32 = 0; k32 < KS / 32; ++k32) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (o.row_w + mt * 16 >= M) continue;  // warp-uniform
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h && o.row_w + mt * 16 + 8 >= M) {  // rows 8..15 all padding
              a[mt][1] = a[mt][3] = 0;
              continue;
            }
            const uint2 v = *reinterpret_cast<const uint2*>(
                sx + (o.row_w + mt * 16 + o.g + 8 * h) * C::XS + k32 * 32 +
                8 * o.t);
            a[mt][h] = __byte_perm(v.x, v.y, 0x6420);      // even k
            a[mt][2 + h] = __byte_perm(v.x, v.y, 0x7531);  // odd k
            xsum[mt][h] = __dp4a(static_cast<int>(v.x), 0x01010101,
                                 __dp4a(static_cast<int>(v.y), 0x01010101,
                                        xsum[mt][h]));
          }
        }
        const uint8_t* q = sw + 16 * k32 * BN + woff;
        uint32_t cw[NT];
        if constexpr (NT == 4) {
          uint32_t r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = *reinterpret_cast<const uint32_t*>(q + i * BN);
          quad_columns(r, cw);
        } else {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint2 v = *reinterpret_cast<const uint2*>(q + i * BN);
            lo[i] = v.x;
            hi[i] = v.y;
          }
          quad_columns(lo, cw);
          quad_columns(hi, cw + 4);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint32_t e = (cw[j] << 4) & 0xF0F0F0F0u;
          const uint32_t d = cw[j] & 0xF0F0F0F0u;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (o.row_w + mt * 16 < M) mma_s8(idot[mt][j], a[mt], e, d);
        }
      }
      if ((ks + 1) % spg == 0) {  // the group ends: fold it in
        const uint8_t* sq = sw + C::WB + C::XB;
        float xf[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int v = xsum[mt][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            xf[mt][h] = static_cast<float>(v);
            xsum[mt][h] = 0;
          }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = o.col(j, c);
            const float sg = load_qparam(sq, col, sz_bf16);
            const float zg = load_qparam(sq + 4 * BN, col, sz_bf16) - 8.f;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 2 * h + c;
                const float dd = static_cast<float>(idot[mt][j][r] >> 4);
                acc[mt][j][r] = __fadd_rn(
                    acc[mt][j][r],
                    __fmul_rn(__fsub_rn(dd, __fmul_rn(xf[mt][h], zg)), sg));
                idot[mt][j][r] = 0;
              }
          }
      }
    }
  }
  cp_wait<0>();
}

}  // namespace sbt
