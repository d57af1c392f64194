// K2: fused per-head int8 quantization of the new K/V row, in-place cache
// row commit, and masked-softmax GQA decode attention over the cache.
//
// Replaces sparsebit_tpu/ops/attention.py:662 _attn_update_kernel
// (decode_attention_update).
//
// Math (_group_attention's roundings, attention.py:46-96): for each query
// head of kv head h and batch row b, over rows s <= len_b,
//     score_s = (bf16(q) . k_s) * ks_s * D^-1/2,  m = max_s score_s,
//     p_s = exp(score_s - m),  out = sum_s bf16(p_s * vs_s) v_s / sum_s p_s,
// products and sums in f32. p * vs is rounded against the GLOBAL max m,
// so an online softmax (running max, rescaled partial sums) would change
// bits beyond the order of the sums: the row max must be known before any
// bf16(p * vs) is formed.
//
// Design. The rows [0, len_b] of one (batch row, kv head) are split into
// C contiguous ranges of ceil((len_b + 1) / C) rows, one for each CTA of a
// thread-block cluster of C (ops/attention.k2_cluster: C from B, Hkv and S
// so that the grid holds two CTAs an SM). Each CTA streams its rows' K
// codes and scales, then its V codes and scales, in tiles of T rows
// through a cp.async ring of kStages stages (16-byte copies where D and
// the cache allow; 4 stages, not more: a smaller CTA lets more of them
// share an SM, which the latency-bound stream needs more), and
//   1. scores its rows, every lane busy: LPR lanes a row, each on 16 bytes
//      of the codes (made f32 by a byte permute and an add) against q
//      (bf16-rounded f32 in shared memory, laid out so that a row's lanes
//      read consecutive float4s), the row's sum by shuffles;
//   2. publishes its per-head maxima; after a cluster barrier every CTA
//      reads the others' through distributed shared memory and takes the
//      global max;
//   3. forms p = exp(s - m) and its sum over its rows, then, as its V
//      tiles arrive (in flight since step 1), bf16(p * vs) of each tile's
//      rows and the mix: each thread owns one 4-byte word of the V rows
//      for up to 8 query heads (with fewer heads than thread groups, one
//      head over one of SG row groups), its sums in registers;
//   4. after a second cluster barrier, each CTA writes a share of the
//      outputs: the CTAs' sums added in rank order, then out = num / den.
// The batch rows are taken longest first (blockIdx.z is a rank by
// length), so that the CTAs with the most rows start first and the short
// ones fill in behind them.
// The new rows are quantized once, by the CTA whose range holds row
// len_b, which commits them in place at [li, b, len_b] and reads them from
// its shared memory (never from the global write: the race the TPU kernel
// avoided by patching its VMEM slab); no other CTA reads row len_b.
// Query heads are taken RB at a time (a pass of the whole sequence for
// each RB), RB bounded by the shared memory of q, the scores and the mix.
// ops/attention._attn_update_cluster_plain is this split on the CPU.
// The cache layout is the port's own: k, v (L, B, S, Hkv, D) int8 and
// ks, vs (L, B, S, Hkv) f32 without lane padding.
// Bound on the H100: the cache bytes of rows [0, len_b] (2 * D + 8 bytes a
// row and head) over 3.35 TB/s.
#include <cooperative_groups.h>

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "planes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 512;
constexpr int kStages = 4;           // ring stages (kStages - 1 in flight)
constexpr int kMaxCluster = 8;
constexpr int kScoreFloats = 16384;  // a CTA's scores (64 KB)
constexpr int kQFloats = 8192;       // RB heads of q, and of the mix sums
constexpr int kMaxHeadsThread = 8;   // query heads a thread mixes, at most
constexpr int kMaxOrdered = 1024;    // batch rows ordered by length

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int8_t quant8(float v, float scale) {
  float r = fminf(fmaxf(rintf(v / scale), -128.f), 127.f);
  return static_cast<int8_t>(r);
}

// The four int8 codes of w as exact f32: byte b ^ 0x80 = b + 128 as the
// low mantissa byte of 2^23, less 2^23 + 128 (a byte permute and an add a
// code, where a conversion instruction runs at a quarter of the rate).
__device__ __forceinline__ void codes_f32(uint32_t w, float (&f)[4]) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.f;
}

struct Args {
  const float *q, *kn, *vn;
  int8_t *kc, *vc;
  float *ks, *vs;
  const int* length;
  float* out;
  int li, B, S, Hkv, H, D;
  int C;     // CTAs a cluster: a (batch row, kv head)
  int DP;    // D rounded up to 16 bytes: a row of the tiles, q, the mix
  int LPR;   // lanes a row when scoring, 16 bytes of the row each
  int QS;    // floats of a head's q in shared memory (16 * LPR)
  int T;     // rows a tile, a multiple of 4 (16-byte stages)
  int RB;    // query heads a pass
  int RMAX;  // rows a CTA at most, ceil(S / C)
  int vec;   // bytes a copy of a cache row (16, 8, 4 or 1)
  float inv_sqrt_d;
  // shared memory offsets (bytes), after the ring at 0
  int o_q, o_sc, o_acc, o_mx, o_gm, o_den, o_part, o_len, o_kr, o_vr,
      o_misc;
};

// Max and sum over one warp's lanes.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// HPT: query heads a thread mixes at most, 1 or kMaxHeadsThread (whose
// sums take 32 registers: the one-head instantiation keeps four CTAs an SM)
template <int HPT>
__global__ void __launch_bounds__(kThreads, HPT == 1 ? 4 : 2)
    attn_update_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int D = a.D, DP = a.DP, T = a.T, RB = a.RB, LPR = a.LPR;
  const int n_rep = a.H / a.Hkv;
  const int STG = T * DP + 4 * T;  // a stage: T rows, then T scales

  float* qf = reinterpret_cast<float*>(smem + a.o_q);     // (RB, QS)
  float* sc = reinterpret_cast<float*>(smem + a.o_sc);    // (RB, RMAX)
  float* acc = reinterpret_cast<float*>(smem + a.o_acc);  // mix partials
  float* mx = reinterpret_cast<float*>(smem + a.o_mx);    // (RB)
  float* gm = reinterpret_cast<float*>(smem + a.o_gm);    // (RB)
  float* den = reinterpret_cast<float*>(smem + a.o_den);  // (RB)
  float* part = reinterpret_cast<float*>(smem + a.o_part);  // warp partials
  int* lens = reinterpret_cast<int*>(smem + a.o_len);     // (B), ordered
  int8_t* krow = reinterpret_cast<int8_t*>(smem + a.o_kr);  // (DP)
  int8_t* vrow = reinterpret_cast<int8_t*>(smem + a.o_vr);  // (DP)
  float* misc = reinterpret_cast<float*>(smem + a.o_misc);  // ksc, vsc, b

  // The batch rows by length, longest first: blockIdx.z takes the row of
  // that rank, so that the longest rows' CTAs are launched first and the
  // short ones fill in behind them.
  int b = blockIdx.z;
  if (a.B <= kMaxOrdered) {
    for (int i = tid; i < a.B; i += kThreads) lens[i] = a.length[i];
    __syncthreads();
    for (int j = tid; j < a.B; j += kThreads) {
      int r = 0;
      for (int i = 0; i < a.B; ++i)
        r += lens[i] > lens[j] || (lens[i] == lens[j] && i < j);
      if (r == static_cast<int>(blockIdx.z))
        reinterpret_cast<int*>(misc)[2] = j;
    }
    __syncthreads();
    b = reinterpret_cast<int*>(misc)[2];
  }
  const int len = a.length[b];
  const int n = len + 1;  // rows attended
  const int R = (n + C - 1) / C;
  const int r0 = min(n, rank * R), r1 = min(n, r0 + R), nr = r1 - r0;
  const bool holds_new = r0 <= len && len < r1;
  const size_t lb = static_cast<size_t>(a.li) * a.B + b;  // (layer, row)

  // The tile sequence: for each pass of RB query heads, nt K tiles of the
  // CTA's rows, then nt V tiles. Row len_b is never copied.
  const int nt = (nr + T - 1) / T;
  const int passes = (n_rep + RB - 1) / RB;
  const int total = passes * 2 * nt;
  const int cpr = D / a.vec;  // copies a row
  auto issue = [&](int i) {
    const int j = i % (2 * nt), kind = j / nt, t = j % nt;
    const int s0 = r0 + t * T, nrt = min(T, r1 - s0);
    uint8_t* st = smem + (i % kStages) * STG;
    const int8_t* codes = kind ? a.vc : a.kc;
    const float* scales = kind ? a.vs : a.ks;
    const int items = nrt * (cpr + 1);
    for (int it = tid; it < items; it += kThreads) {
      if (it < nrt * cpr) {
        const int sl = it / cpr, c = (it - sl * cpr) * a.vec, s = s0 + sl;
        const size_t row = (lb * a.S + s) * a.Hkv + h;
        sbt::copy_chunk(st + sl * DP + c,
                        reinterpret_cast<const uint8_t*>(codes) + row * D + c,
                        a.vec, s != len);
      } else {
        const int sl = it - nrt * cpr, s = s0 + sl;
        const size_t row = (lb * a.S + s) * a.Hkv + h;
        sbt::copy_chunk(st + T * DP + 4 * sl,
                        reinterpret_cast<const uint8_t*>(scales + row), 4,
                        s != len);
      }
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) issue(i);
    sbt::cp_commit();
  }
  // stage of tile i, in, after every thread has read tile i - 1
  auto arrive = [&](int i) {
    sbt::cp_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < total) issue(i + kStages - 1);
    sbt::cp_commit();
    return smem + (i % kStages) * STG;
  };

  // 1. the new rows of this head (their copies already on their way):
  // quantized, committed in place, kept
  if (holds_new) {
    const float* knr = a.kn + (static_cast<size_t>(b) * a.Hkv + h) * D;
    const float* vnr = a.vn + (static_cast<size_t>(b) * a.Hkv + h) * D;
    float km = 0.f, vm = 0.f;
    for (int d = tid; d < D; d += kThreads) {
      km = fmaxf(km, fabsf(knr[d]));
      vm = fmaxf(vm, fabsf(vnr[d]));
    }
    km = warp_max(km);
    vm = warp_max(vm);
    if (lane == 0) {
      part[warp] = km;
      part[kWarps + warp] = vm;
    }
    __syncthreads();
    km = part[0];
    vm = part[kWarps];
    for (int w = 1; w < kWarps; ++w) {
      km = fmaxf(km, part[w]);
      vm = fmaxf(vm, part[kWarps + w]);
    }
    // max(absmax, 1e-8) * (1/127): XLA's form of the reference's / 127,
    // rounded to bf16 before the codes are taken (kv_cache.py:82)
    const float ksc = bf16_round(fmaxf(km, 1e-8f) * (1.0f / 127.0f));
    const float vsc = bf16_round(fmaxf(vm, 1e-8f) * (1.0f / 127.0f));
    const size_t row = (lb * a.S + len) * a.Hkv + h;
    for (int d = tid; d < DP; d += kThreads) {
      const int8_t kq = d < D ? quant8(knr[d], ksc) : int8_t{0};
      const int8_t vq = d < D ? quant8(vnr[d], vsc) : int8_t{0};
      krow[d] = kq;
      vrow[d] = vq;
      if (d < D) {
        a.kc[row * D + d] = kq;
        a.vc[row * D + d] = vq;
      }
    }
    if (tid == 0) {
      a.ks[row] = ksc;
      a.vs[row] = vsc;
      misc[0] = ksc;
      misc[1] = vsc;
    }
    __syncthreads();
  }

  const float ksc = misc[0], vsc = misc[1];  // read only for row len_b
  const int WPR = DP / 4;                    // words a row
  const int RPW = 32 / LPR;                  // rows a warp scores at once
  const int l16 = lane % LPR;                // 16-byte chunk of the row
  // the mix: thread (word w, group gi); gi takes heads gi, gi + G, ... or,
  // with fewer heads than groups, head gi % rb over rows sg, sg + SG, ...
  const int G = kThreads / WPR;
  const int w = tid % WPR, gi = tid / WPR;
  for (int pass = 0; pass < passes; ++pass) {
    const int h0 = pass * RB, rb = min(RB, n_rep - h0);
    const int ib = pass * 2 * nt;  // this pass's first tile
    const float* qb =
        a.q + (static_cast<size_t>(b) * a.H + h * n_rep + h0) * D;
    // q bf16-rounded, word 4c + j of the row at float4 j * LPR + c, so
    // that the lanes of a row read consecutive float4s
    for (int i = tid; i < rb * a.QS; i += kThreads) {
      const int r = i / a.QS, pos = i - r * a.QS;
      const int f4 = pos / 4, j = f4 / LPR, c = f4 - j * LPR;
      const int d = 16 * c + 4 * j + pos % 4;
      qf[i] = d < D ? bf16_round(qb[static_cast<size_t>(r) * D + d]) : 0.f;
    }

    // scores of the CTA's rows: LPR lanes a row, 16 bytes each
    for (int t = 0; t < nt; ++t) {
      const uint8_t* st = arrive(ib + t);
      const int s0 = r0 + t * T, nrt = min(T, r1 - s0);
      const float* st_scale = reinterpret_cast<const float*>(st + T * DP);
      for (int base = 0; base < nrt; base += kWarps * RPW) {
        const int sl = base + warp * RPW + lane / LPR;
        const bool valid = sl < nrt && 16 * l16 < DP;
        const int s = s0 + sl;
        float kf[16];
        if (valid) {
          const uint8_t* kr = s == len ? reinterpret_cast<const uint8_t*>(krow)
                                       : st + sl * DP;
          const uint4 kv = *reinterpret_cast<const uint4*>(kr + 16 * l16);
          codes_f32(kv.x, *reinterpret_cast<float(*)[4]>(kf));
          codes_f32(kv.y, *reinterpret_cast<float(*)[4]>(kf + 4));
          codes_f32(kv.z, *reinterpret_cast<float(*)[4]>(kf + 8));
          codes_f32(kv.w, *reinterpret_cast<float(*)[4]>(kf + 12));
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) kf[e] = 0.f;
        }
        for (int r = 0; r < rb; ++r) {
          const float4* qv =
              reinterpret_cast<const float4*>(qf + r * a.QS) + l16;
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 qq = qv[j * LPR];
            dot = fmaf(qq.x, kf[4 * j], dot);
            dot = fmaf(qq.y, kf[4 * j + 1], dot);
            dot = fmaf(qq.z, kf[4 * j + 2], dot);
            dot = fmaf(qq.w, kf[4 * j + 3], dot);
          }
          for (int o = LPR / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (sl < nrt && l16 == 0) {
            const float ksv = s == len ? ksc : st_scale[sl];
            sc[r * a.RMAX + s - r0] =
                __fmul_rn(__fmul_rn(dot, ksv), a.inv_sqrt_d);
          }
        }
      }
    }
    __syncthreads();

    // the CTA's maxima (WH warps a head), then the cluster's
    const int WH = rb < kWarps ? kWarps / rb : 1;
    for (int it = warp; it < rb * WH; it += kWarps) {
      const int r = it / WH, pw = it - r * WH;
      float m = -INFINITY;
      for (int sl = pw * 32 + lane; sl < nr; sl += WH * 32)
        m = fmaxf(m, sc[r * a.RMAX + sl]);
      m = warp_max(m);
      if (lane == 0) part[it] = m;
    }
    __syncthreads();
    for (int r = tid; r < rb; r += kThreads) {
      float m = part[r * WH];
      for (int pw = 1; pw < WH; ++pw) m = fmaxf(m, part[r * WH + pw]);
      mx[r] = m;
    }
    cluster.sync();
    for (int r = tid; r < rb; r += kThreads) {
      float m = -INFINITY;
      for (int c = 0; c < C; ++c)
        m = fmaxf(m, cluster.map_shared_rank(mx, c)[r]);
      gm[r] = m;
    }
    __syncthreads();

    // p = exp(s - m) in place, and its sum over the CTA's rows
    for (int it = warp; it < rb * WH; it += kWarps) {
      const int r = it / WH, pw = it - r * WH;
      float sum = 0.f;
      for (int sl = pw * 32 + lane; sl < nr; sl += WH * 32) {
        const float p = expf(sc[r * a.RMAX + sl] - gm[r]);
        sc[r * a.RMAX + sl] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) part[it] = sum;
    }
    __syncthreads();
    for (int r = tid; r < rb; r += kThreads) {
      float sum = part[r * WH];
      for (int pw = 1; pw < WH; ++pw) sum += part[r * WH + pw];
      den[r] = sum;
    }

    // the mix, bf16(p * vs) . v, each thread's sums in registers
    const bool by_rows = rb < G;
    const int SG = by_rows ? G / rb : 1;
    const int sg = by_rows ? gi / rb : 0;
    const int rh = by_rows ? gi % rb : gi;  // first head
    const int hpt = by_rows ? 1 : (rb - gi + G - 1) / G;  // heads
    const bool mixes = gi < G && sg < SG;
    float mix[HPT][4];
#pragma unroll
    for (int k = 0; k < HPT; ++k)
      mix[k][0] = mix[k][1] = mix[k][2] = mix[k][3] = 0.f;
    for (int t = 0; t < nt; ++t) {
      const uint8_t* st = arrive(ib + nt + t);
      const int s0 = r0 + t * T, nrt = min(T, r1 - s0);
      const float* st_scale = reinterpret_cast<const float*>(st + T * DP);
      float* p = sc + (s0 - r0);
      for (int i = tid; i < rb * nrt; i += kThreads) {  // p2, in place
        const int r = i / nrt, sl = i - r * nrt;
        const float vsv = s0 + sl == len ? vsc : st_scale[sl];
        p[r * a.RMAX + sl] = bf16_round(p[r * a.RMAX + sl] * vsv);
      }
      __syncthreads();
      if (!mixes) continue;
      for (int sl = sg; sl < nrt; sl += SG) {
        const uint32_t vw =
            s0 + sl == len
                ? reinterpret_cast<const uint32_t*>(vrow)[w]
                : reinterpret_cast<const uint32_t*>(st + sl * DP)[w];
        float vf[4];
        codes_f32(vw, vf);
#pragma unroll
        for (int k = 0; k < HPT; ++k) {
          if (k < hpt) {
            const float p2 = p[(rh + k * G) * a.RMAX + sl];
            mix[k][0] = fmaf(p2, vf[0], mix[k][0]);
            mix[k][1] = fmaf(p2, vf[1], mix[k][1]);
            mix[k][2] = fmaf(p2, vf[2], mix[k][2]);
            mix[k][3] = fmaf(p2, vf[3], mix[k][3]);
          }
        }
      }
    }
    // partials to shared memory: (row group, head) rows of DP floats
    if (mixes) {
#pragma unroll
      for (int k = 0; k < HPT; ++k)
        if (k < hpt)
          reinterpret_cast<float4*>(acc)[((sg * rb + rh + k * G) * DP) / 4 +
                                         w] =
              make_float4(mix[k][0], mix[k][1], mix[k][2], mix[k][3]);
    }
    __syncthreads();
    if (SG > 1) {  // the row groups' sums, in group order
      for (int i = tid; i < rb * DP; i += kThreads) {
        float v = acc[i];
        for (int g = 1; g < SG; ++g) v += acc[g * rb * DP + i];
        acc[i] = v;
      }
    }
    cluster.sync();

    // a share of the outputs: the CTAs' sums in rank order
    float* ob =
        a.out + (static_cast<size_t>(b) * a.H + h * n_rep + h0) * D;
    for (int e = rank * kThreads + tid; e < rb * D; e += C * kThreads) {
      const int r = e / D, d = e - r * D;
      float num = 0.f, dn = 0.f;
      for (int c = 0; c < C; ++c) {
        num += cluster.map_shared_rank(acc, c)[r * DP + d];
        dn += cluster.map_shared_rank(den, c)[r];
      }
      ob[e] = num / dn;
    }
    cluster.sync();  // no CTA reuses or leaves its shared memory before
  }
}

}  // namespace

// q (B, H, D) f32; kn, vn (B, Hkv, D) f32; k, v (L, B, S, Hkv, D) int8 and
// ks, vs (L, B, S, Hkv) f32 updated in place at [li, b, length[b]];
// length (B,) int32 < S; out (B, H, D) f32. D <= 512. cluster: CTAs a
// (batch row, kv head), a power of two <= 8 with ceil(S / cluster) <=
// 16384 (ops/attention.k2_cluster). inv_sqrt_d is 1/sqrt(D) rounded once
// to f32, as the reference's scalar.
extern "C" int sbt_attn_update(const void* q, const void* kn, const void* vn,
                               void* k, void* v, void* ks, void* vs,
                               const void* length, void* out, int li, int B,
                               int S, int Hkv, int H, int D, float inv_sqrt_d,
                               int cluster, void* stream) {
  const int C = cluster;
  if (D < 1 || D > kMaxD || Hkv < 1 || H % Hkv || S < 1 || C < 1 ||
      C > kMaxCluster || (C & (C - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.kn = static_cast<const float*>(kn);
  a.vn = static_cast<const float*>(vn);
  a.kc = static_cast<int8_t*>(k);
  a.vc = static_cast<int8_t*>(v);
  a.ks = static_cast<float*>(ks);
  a.vs = static_cast<float*>(vs);
  a.length = static_cast<const int*>(length);
  a.out = static_cast<float*>(out);
  a.li = li; a.B = B; a.S = S; a.Hkv = Hkv; a.H = H; a.D = D;
  a.inv_sqrt_d = inv_sqrt_d;
  a.C = C;
  a.DP = (D + 15) & ~15;
  a.LPR = 1;  // a power of two, 16 bytes of a row each
  while (16 * a.LPR < a.DP) a.LPR *= 2;
  a.QS = 16 * a.LPR;
  a.T = (8192 / a.DP < 16 ? 16 : (8192 / a.DP > 64 ? 64 : 8192 / a.DP)) & ~3;
  a.RMAX = (S + C - 1) / C;
  const int n_rep = H / Hkv;
  const int G = kThreads / (a.DP / 4);  // mix groups
  int RB = kQFloats / a.QS;
  if (RB > n_rep) RB = n_rep;
  if (RB > kMaxHeadsThread * G) RB = kMaxHeadsThread * G;
  if (RB > kScoreFloats / a.RMAX) RB = kScoreFloats / a.RMAX;
  if (RB < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.RB = RB;
  int vec = 16;  // the widest copy every row start allows
  while (vec > 1 && (D % vec || reinterpret_cast<uintptr_t>(k) % vec ||
                     reinterpret_cast<uintptr_t>(v) % vec))
    vec = vec == 4 ? 1 : vec / 2;
  a.vec = vec;
  const int WH = RB < kWarps ? kWarps / RB : 1;
  auto up16 = [](int x) { return (x + 15) & ~15; };
  int at = kStages * (a.T * a.DP + 4 * a.T);
  a.o_q = at;    at += up16(4 * RB * a.QS);
  a.o_sc = at;   at += up16(4 * RB * a.RMAX);
  a.o_acc = at;  at += 4 * (RB > G ? RB : G) * a.DP;
  a.o_mx = at;   at += up16(4 * RB);
  a.o_gm = at;   at += up16(4 * RB);
  a.o_den = at;  at += up16(4 * RB);
  a.o_part = at; at += up16(4 * (RB * WH > 2 * kWarps ? RB * WH : 2 * kWarps));
  a.o_len = at;  at += up16(4 * (B <= kMaxOrdered ? B : 0));
  a.o_kr = at;   at += a.DP;
  a.o_vr = at;   at += a.DP;
  a.o_misc = at; at += 16;
  const int smem = at;
  auto kern = RB > G ? attn_update_kernel<kMaxHeadsThread>
                     : attn_update_kernel<1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
