// K4: the decode megakernel. One cooperative launch runs the whole
// decoder backbone for one token per row:
//     x' = x + Wo(attn(rope(Wqkv(rms_norm(x))), cache))
//     x  = x' + W2(q8(silu(g) * u)),  [g, u] = W13(q8(rms_norm(x')))
// for every layer, over an int8 KV cache that is contiguous or paged.
//
// Replaces sparsebit_tpu/ops/layer_fused.py:213 _layer_kernel
// (fused_decoder_layers), in its 4-bit nibble mode (_mm_step, signed row
// pairs "s4r") and its true-width 2/3-bit plane mode (_mm_step_planes,
// wbits 2/3: the "pl" concat of ops/packing.pack_planes_serving).
//
// The TPU kernel walked one sequential grid through five phases per
// layer, with every intermediate in VMEM. Hopper blocks run in no order,
// so here a persistent grid (as many blocks as fit on the card at once,
// launched with cudaLaunchCooperativeKernel) walks the phases of each
// layer and meets at a grid-wide barrier (cooperative_groups grid.sync)
// after each one:
//   A  attn norm + int8 quant of x, one block per row;
//   1  Wqkv: W4A8 tiles over the output columns;
//   2  attention, one work item per (row, kv head): rope, int8 K/V row
//      quant (bf16-rounded scales) and in-place commit at
//      min(pos, S_cache - 1), then the int8 attention of the reference's
//      _flat_attention_rows_int8 for the item's query heads (int8 q,
//      dp4a scores, f32 softmax, 7-bit probabilities, int32 value mix);
//      each item raises its row's absmax with atomicMax on float bits;
//   3  the int8 rows of the attention output (the whole grid, a
//      barrier), then Wo + residual;
//   C  ffn norm + int8 quant, one block per row;
//   4  W13, a barrier, then silu(g) * u and the row absmax;
//   5  the int8 rows of the GLU output, a barrier, then W2 + residual
//      into the carried row.
// Phases C, 4 and 5 of s4r mode are ffn_phases.cuh's, which K3
// (ffn_fused.cu) runs as a launch of its own; plane mode shares their
// norm, GLU and requantization.
// Each matmul ends with a barrier and a pass that adds its K splits (s4r
// mode: every matmul; plane mode: Wo and W2's two halves) before its
// epilogue. The bit width is a template parameter. BITS 4 reads s4r row
// pairs (zero - 8 in the epilogue) through w4a8.cuh's s4tile, the int8
// tensor-core tile K1 also runs: each matmul's (column tile, K split)
// items stream 8 KB weight stages through a cp.async ring, the plan
// (gq, go, g13, g2 groups a split, ops/quant_matmul.s4_plan) a function
// of (K, N, gs) only, so B = 1 and batched rows agree bit for bit; the
// splits' partials are added in split order. BITS 2/3 read the plane
// concat through w4a8.cuh's ptile: output column n is byte column n % NP
// of plane n / NP, with unsigned codes and the zero unshifted, and a tile
// is W byte columns x all P planes (3 bits: 8, 2 bits: 4), so every byte
// of the stream is read once and decoded into P dp4a words. The tile's
// weight bytes and its int8 x rows stream through a cp.async ring, so
// plane mode hands every matmul int8 rows in memory: Wo's and W2's inputs
// are quantized by the whole grid before them (one more barrier each).
// Gate column j and up column F + j of W13 lie in different byte columns,
// so plane mode pairs them through a scratch row after one more grid
// barrier. Wo and W2 (N = dim) give fewer column tiles than there are
// blocks, so each tile's K is split in two halves, added in group order
// after a barrier (plane_phase): twelve barriers a layer (s4r mode:
// thirteen). At B <= 8, Wqkv takes 8 x 64 tiles, W13 8 x 128 (one round
// of tiles), Wo and W2 8 x 32.
// Plane-mode weights may be padded past their logical width
// (ops/packing.pallas_n_pad, e.g. LLaMA-7B's W13 2F = 22016 -> 22528);
// the padded width is the row stride of their scales and zeros and sets
// NP, while every phase computes only the logical columns (the GLU pairs
// gate j with up F + j, which may lie in different planes).
// Every float sum is taken in one fixed order (a thread's strided
// partial, then a 256-wide tree), which the plain version in
// ops/layer_fused.py repeats, and no multiply-add is contracted: kernel
// and plain version agree bit for bit.
// The cache is a pool of blocks: row s of batch row b is row s % block of
// block bt[b, s / block]; a contiguous cache is B blocks of S rows.
// Bound on the H100: the weight and qparam stream of all layers (about
// 3.44 GB at LLaMA-7B INT4-g128, 2.66 GB of planes plus bf16 qparams at
// INT3-g128) plus the KV rows up to each row's length, over 3.35 TB/s.
// The s4r mode keeps 4 stages of 8 KB in flight a block, decodes two
// nibbles a byte with two logic ops into the tensor cores' operand, and
// fills the grid with K splits; its matmuls still run at about three
// times their byte bound (the decode, mma and group fold of a stage take
// longer than the stage's share of HBM time), and the attention phase is
// now the largest at B >= 8.
// Plane mode keeps NST - 1 steps in flight, copies 4-16 bytes a row and
// splits Wo's and W2's K, and pays for its dp4a decode and barriers in
// each 64-row step (the phase trace of a build with -DSBT_PHASE_TRACE,
// which chip_smoke.py makes, shows where).
#include <cooperative_groups.h>

#include <type_traits>

#include "ffn_phases.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = sbt::kGridThreads;
constexpr int kMaxD = 256;
constexpr int kMaxRep = 8;

using sbt::grid_for;
using sbt::qp_at;
using sbt::tree_max;
using sbt::tree_sum;

// The phases of a layer, each named at the grid barrier that ends it.
enum Phase : int {
  kStart = 1, kAttnNorm, kWqkv, kWqkvSum, kAttention, kQ8Attn, kWo, kWoSum,
  kFfnNorm, kW13, kGlu, kQ8Act, kW2, kW2Sum, kPhaseEnd
};

#ifdef SBT_PHASE_TRACE
// The phase trace, compiled only into a build with -DSBT_PHASE_TRACE
// (chip_smoke.py makes one beside the kernel library): block 0 stamps
// %globaltimer (ns) and the phase that just ended at each layer's start
// and after each grid barrier, into (L, kMarks) pairs (phase, ns) of the
// buffer sbt_phase_trace_set gave it; sbt_phase_name names the phases.
constexpr int kMarks = 16;  // stamps a layer at most (s4r mode: 14)
const char* const kPhaseNames[kPhaseEnd] = {
    "", "start", "attn norm", "Wqkv", "Wqkv sum", "attention", "q8(attn)",
    "Wo", "Wo sum", "ffn norm", "W13", "GLU", "q8(act)", "W2", "W2 sum"};
__device__ unsigned long long* g_trace;

__device__ __forceinline__ void stamp(int li, int mark, Phase done) {
  if (g_trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    unsigned long long* at =
        g_trace + 2 * (static_cast<size_t>(li) * kMarks + mark);
    at[0] = static_cast<unsigned long long>(done);
    at[1] = t;
  }
}
#endif

// The FFN half's operands (w13, w2 and their qparams, xq, xs, act,
// amax_g, sizes, W13's and W2's split plan) come from sbt::FfnArgs; xq and
// xs also carry the attention norm's rows, aq also q8(aout) (B, Hq*D), and
// part also holds, in plane mode, Wo's and W2's first-half sums (B, dim)
// and then the second half's group terms (G - G0, B, dim).
struct Args : sbt::FfnArgs {
  const uint8_t *wq, *wo;
  const void *sq, *zq, *so, *zo;
  const void *an, *fn;
  int8_t *k, *v;
  float *ks, *vs;
  const int *bt, *pos;
  const float *cos, *sin;
  float* x;  // carried rows (B, dim): the input, then each layer's output
  float *qkv, *aout, *amax_a, *xmid, *sc;
  float* h13;  // plane mode: [gate | up] rows (B, 2F) before the GLU
  int L, Hq, Hkv, D;
  int nq_s, no_s, n13_s, n2_s;  // (padded) N: the s/z row strides
  int gq, go;                   // s4r mode: groups a K split of Wqkv, Wo
  int n_blocks, block, max_chunks, s_act;
  float inv_sqrt_d;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Cache row index (into the (.., Hkv) scale pool) of logical row s of
// batch row b, head h, layer li.
__device__ __forceinline__ size_t cache_row(const Args& a, int li, int b,
                                            int s, int h) {
  const int blk = a.bt[b * a.max_chunks + s / a.block];
  return ((static_cast<size_t>(li) * a.n_blocks + blk) * a.block +
          s % a.block) * a.Hkv + h;
}

// rotate-half rope of one head row: x * cos + rot * sin, rot = [-x2, x1]
__device__ __forceinline__ float rope_at(const float* xr, const float* c,
                                         const float* s, int d, int D) {
  const int h = D / 2;
  const float rot = d < h ? -xr[d + h] : xr[d - h];
  return __fadd_rn(__fmul_rn(xr[d], c[d]), __fmul_rn(rot, s[d]));
}

struct AttnSmem {
  float f[kMaxD];             // the row being quantized (k, v, then q)
  int8_t krow[kMaxD], vrow[kMaxD];
  int q8[kMaxRep * kMaxD / 4];  // query codes, 4 per word
  float qs[kMaxRep];
  int part[kThreads * 4];     // value-mix partials (groups x D)
};

// Quantize one head row held in sm.f to int8 with a bf16-rounded scale
// (kv_cache._quant_heads) into dst_sm and the cache; returns the scale.
__device__ float quant_kv_row(AttnSmem& sm, int D, int8_t* dst_sm,
                              int8_t* cache_row_ptr, float* red) {
  float mx = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads)
    mx = fmaxf(mx, fabsf(sm.f[d]));
  const float scale = bf16_round(sbt::row_scale(tree_max(mx, red)));
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const int8_t c = static_cast<int8_t>(sbt::quant8(sm.f[d], scale));
    dst_sm[d] = c;
    cache_row_ptr[d] = c;
  }
  return scale;
}

// Work item (b, h) of the attention phase.
__device__ void attention_item(const Args& a, int li, int b, int h,
                               AttnSmem& sm, float* red) {
  const int D = a.D, Hq = a.Hq, Hkv = a.Hkv;
  const int n_rep = Hq / Hkv;
  const int HD = Hq * D, KVD = Hkv * D;
  const int Nq = HD + 2 * KVD;
  const int len = a.pos[b];
  const int S_cache = a.max_chunks * a.block;
  const int lw = min(len, S_cache - 1);
  const int last = min(len, a.s_act - 1);  // rows [0, last] attend
  const float* qkv = a.qkv + static_cast<size_t>(b) * Nq;
  const float* cs = a.cos + static_cast<size_t>(b) * D;
  const float* sn = a.sin + static_cast<size_t>(b) * D;
  const int t = threadIdx.x;

  // 1. new K/V rows of this head: rope (k), int8 quant, in-place commit
  const size_t wrow = cache_row(a, li, b, lw, h);
  for (int d = t; d < D; d += kThreads)
    sm.f[d] = rope_at(qkv + HD + h * D, cs, sn, d, D);
  __syncthreads();
  const float ksc = quant_kv_row(sm, D, sm.krow, a.k + wrow * D, red);
  for (int d = t; d < D; d += kThreads) sm.f[d] = qkv[HD + KVD + h * D + d];
  __syncthreads();
  const float vsc = quant_kv_row(sm, D, sm.vrow, a.v + wrow * D, red);
  if (t == 0) {
    a.ks[wrow] = ksc;
    a.vs[wrow] = vsc;
  }

  // 2. the query heads of this kv head: rope, int8 codes, row scales
  for (int r = 0; r < n_rep; ++r) {
    const int j = h * n_rep + r;
    for (int d = t; d < D; d += kThreads)
      sm.f[d] = rope_at(qkv + j * D, cs, sn, d, D);
    __syncthreads();
    float mx = 0.f;
    for (int d = t; d < D; d += kThreads) mx = fmaxf(mx, fabsf(sm.f[d]));
    const float qs = fmaxf(tree_max(mx, red), 1e-30f) * (1.0f / 127.0f);
    for (int w = t; w < D / 4; w += kThreads) {
      int c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        c[i] = static_cast<int>(
            fminf(fmaxf(rintf(sm.f[4 * w + i] / qs), -127.f), 127.f));
      sm.q8[r * (D / 4) + w] = sbt::pack4(c[0], c[1], c[2], c[3]);
    }
    if (t == 0) sm.qs[r] = qs;
    __syncthreads();
  }

  // 3. scores: one warp per cache row, dp4a over the head's D codes
  const int lane = t % 32, warp = t / 32;
  float* scb = a.sc + (static_cast<size_t>(b) * Hq + h * n_rep) * S_cache;
  for (int s = warp; s <= last; s += kThreads / 32) {
    const size_t row = cache_row(a, li, b, s, h);
    const int* kw = reinterpret_cast<const int*>(
        s == len ? sm.krow : a.k + row * D);
    int dot[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) dot[r] = 0;
    for (int w = lane; w < D / 4; w += 32) {
      const int kv = kw[w];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < n_rep) dot[r] = __dp4a(sm.q8[r * (D / 4) + w], kv, dot[r]);
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      for (int o = 16; o > 0; o >>= 1)
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    if (lane == 0) {
      const float kscale = s == len ? ksc : a.ks[row];
      for (int r = 0; r < n_rep; ++r)
        scb[r * S_cache + s] = __fmul_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(dot[r]), sm.qs[r]),
                      kscale),
            a.inv_sqrt_d);
    }
  }
  __syncthreads();

  // 4. per query head: softmax, 7-bit probabilities, int32 value mix
  const int DW = D / 4;            // value words per row
  const int SG = kThreads / DW;    // row groups of the value mix
  const int wd = t % DW, sg = t / DW;
  float amax = 0.f;
  for (int r = 0; r < n_rep; ++r) {
    float* p = scb + r * S_cache;
    float m = -1e30f;
    for (int s = t; s <= last; s += kThreads) m = fmaxf(m, p[s]);
    m = tree_max(m, red);
    float den = 0.f, pm = 0.f;
    for (int s = t; s <= last; s += kThreads) {
      const float e = expf(__fsub_rn(p[s], m));
      den = __fadd_rn(den, e);
      const float vscale =
          s == len ? vsc : a.vs[cache_row(a, li, b, s, h)];
      const float p2 = __fmul_rn(e, vscale);
      p[s] = p2;
      pm = fmaxf(pm, p2);
    }
    den = tree_sum(den, red);
    const float psc = fmaxf(tree_max(pm, red), 1e-30f) * (1.0f / 127.0f);
    for (int s = t; s <= last; s += kThreads)
      p[s] = fminf(fmaxf(rintf(p[s] / psc), 0.f), 127.f);
    __syncthreads();
    int acc[4] = {0, 0, 0, 0};
    for (int s = sg; s <= last; s += SG) {
      const int p8 = static_cast<int>(p[s]);
      const int vw = s == len
          ? reinterpret_cast<const int*>(sm.vrow)[wd]
          : reinterpret_cast<const int*>(
                a.v + cache_row(a, li, b, s, h) * D)[wd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] += p8 * static_cast<int>(static_cast<int8_t>(vw >> (8 * i)));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.part[sg * D + 4 * wd + i] = acc[i];
    __syncthreads();
    const int j = h * n_rep + r;
    for (int d = t; d < D; d += kThreads) {
      int tot = 0;
      for (int g = 0; g < SG; ++g) tot += sm.part[g * D + d];
      const float o =
          __fdiv_rn(__fmul_rn(static_cast<float>(tot), psc), den);
      a.aout[static_cast<size_t>(b) * HD + j * D + d] = o;
      amax = fmaxf(amax, fabsf(o));
    }
    __syncthreads();
  }
  amax = tree_max(amax, red);
  if (t == 0)
    atomicMax(reinterpret_cast<int*>(a.amax_a) + b, __float_as_int(amax));
}

// One layer's plane concat of a (K, N) linear, (K, 3N/8) or (K, N/4), as
// ptile's source; the stack holds K_st >= K rows a layer.
template <int BITS>
struct Weights {
  using Src = sbt::PlaneRows<BITS>;
  __device__ static Src at(const uint8_t* w, int li, int K_st, int N) {
    const int ld = BITS == 3 ? 3 * N / 8 : N / 4;
    return Src{w + static_cast<size_t>(li) * K_st * ld, ld,
               BITS == 3 ? N / 8 : N / 4};
  }
};

template <int BM_, int BN_, int TM_, int TN_>
struct Cfg : sbt::Tile<BM_, BN_, TM_, TN_> {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
};

// Rows <= 8: 8 x 32 tiles (8 x 64 for the paired GLU tiles; plane mode:
// 8 x 64 for Wqkv, 8 x 128 for W13, 8 x 32 for Wo and W2); up to 64: 64 x
// 64 tiles. 256 threads either way.
using SmallP = Cfg<8, 32, 1, 1>;
using SmallG = Cfg<8, 64, 1, 2>;
using SmallW = Cfg<8, 128, 1, 4>;
using LargeP = Cfg<64, 64, 4, 4>;
// s4r mode's tensor-core tiles (sbt::s4tile): 16 x 256 at B <= 16, 64 x
// 128 up to 64 rows; a ring of 6 stages, 2 read a block barrier.
using S4Small = sbt::S4Cfg<16, 256, 1, 8, 6, 2>;
using S4Large = sbt::S4Cfg<64, 128, 2, 4, 6, 2>;

// One matmul phase of plane mode with C's tiles: every tile of this
// block over the padded width NS of a plane-concat weight (K rows read of
// the K_st >= K rows a layer of the stack holds, logical width N), each
// tile W = BN / P byte columns x all P planes (sbt::ptile)
// over the int8 rows x (B, K); epi(row, col, sum) for every row < B and
// logical column col. With split (Wo and W2, whose N gives fewer tiles
// than there are blocks) each tile's K is halved: the first half's block
// sums groups [0, G0) in order into a.part, the second half's block
// writes each later group's term, and after one more barrier (sync) every
// output adds the terms to the first half's sum in group order: the
// sequential sum, bit for bit, on twice the blocks.
template <class C, int BITS, class Sync, class Epi>
__device__ __forceinline__ void plane_phase(const int8_t* x, const uint8_t* w,
                                            const void* s, const void* z,
                                            int li, int K, int K_st,
                                            int NS, int N, const Args& a,
                                            uint8_t* smem, bool split,
                                            const Sync& sync,
                                            const Epi& epi) {
  using TC = sbt::Tile<C::BM, C::BN, C::TM, C::TN>;
  const auto src = Weights<BITS>::at(w, li, K_st, NS);
  const int G = K / a.gs, G0 = split ? (G + 1) / 2 : G;
  const size_t G_st = K_st / a.gs;
  const void* sl = qp_at(s, li * G_st * NS, a.sz_bf16);
  const void* zl = qp_at(z, li * G_st * NS, a.sz_bf16);
  constexpr int W = C::BN / Weights<BITS>::Src::P;
  // the widest copy (at most W bytes) that every row start and NP allow
  int vec = W > 16 ? 16 : W;
  while (vec > 1 && (reinterpret_cast<uintptr_t>(src.w) % vec ||
                     src.ld % vec || src.NP % vec))
    vec = vec == 4 ? 1 : vec / 2;
  const int tx = threadIdx.x % TC::TX, ty = threadIdx.x / TC::TX;
  const int tiles = (src.NP + W - 1) / W;
  const size_t BN_ = static_cast<size_t>(a.B) * N;
  float* terms = a.part + BN_;
  for (int item = blockIdx.x; item < (split ? 2 : 1) * tiles;
       item += gridDim.x) {
    const int tile = item % tiles, h = item / tiles;
    if (h && G0 == G) continue;  // one group: no second half
    const sbt::ColPlanes cm{tile * W, W, src.NP, N};
    float acc[C::TM][C::TN];
    sbt::ptile<C::BM, C::BN, C::TM, C::TN>(
        x, a.B, src, vec, sl, zl, a.sz_bf16, NS, K, a.gs, h ? G0 : 0,
        h ? G : G0, h ? terms : nullptr, cm, smem, acc);
    if (h) continue;
#pragma unroll
    for (int tm = 0; tm < C::TM; ++tm) {
      const int row = ty + tm * TC::TY;
      if (row >= a.B) continue;
#pragma unroll
      for (int tn = 0; tn < C::TN; ++tn) {
        const int col = cm(tx + tn * TC::TX);
        if (col < 0) continue;
        if (split)
          a.part[static_cast<size_t>(row) * N + col] = acc[tm][tn];
        else
          epi(row, col, acc[tm][tn]);
      }
    }
  }
  if (!split) return;
  sync();
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.B * N;
       i += gridDim.x * kThreads) {
    float v = a.part[i];
    for (int g = 0; g < G - G0; ++g) v = __fadd_rn(v, terms[g * BN_ + i]);
    epi(i / N, i % N, v);
  }
}

template <class P, class G, int BITS, class S4>
__global__ void __launch_bounds__(kThreads)
    layers_fused_kernel(Args a) {
  static_assert(P::THREADS == kThreads && G::THREADS == kThreads &&
                    S4::THREADS == kThreads,
                "one block size for every phase");
  // plane mode's W13 tiles: 8 x 128 at B <= 8 (one round of tiles)
  using W13 = std::conditional_t<P::BM <= 8, SmallW, G>;
  constexpr int PB = BITS == 4 ? 2 : BITS;  // (no plane tiles at 4 bits)
  constexpr int kPlaneP = sbt::PlaneSmem<P::BM, P::BN, PB>::BYTES;
  constexpr int kPlaneG = sbt::PlaneSmem<G::BM, G::BN, PB>::BYTES;
  constexpr int kPlaneW = sbt::PlaneSmem<W13::BM, W13::BN, PB>::BYTES;
  constexpr int kPlanePG = kPlaneP > kPlaneG ? kPlaneP : kPlaneG;
  __shared__ __align__(16) uint8_t plane_sm[
      BITS == 4 ? 16 : (kPlanePG > kPlaneW ? kPlanePG : kPlaneW)];
  extern __shared__ __align__(16) uint8_t s4_sm[];  // s4r: S4::BYTES
  __shared__ float red[kThreads];
  __shared__ AttnSmem sm;
  __shared__ int amax_sm[sbt::kMaxGridRows];
  cg::grid_group grid = cg::this_grid();

  const int B = a.B, dim = a.dim, D = a.D, F = a.F, F2 = 2 * F;
  const int HD = a.Hq * D, Nq = HD + 2 * a.Hkv * D;

  for (int li = 0; li < a.L; ++li) {
#ifdef SBT_PHASE_TRACE
    int mark = 0;
    stamp(li, mark++, kStart);
#endif
    auto sync = [&](Phase done) {
      grid.sync();
#ifdef SBT_PHASE_TRACE
      stamp(li, mark++, done);
#else
      (void)done;
#endif
    };
    const void* an = qp_at(a.an, static_cast<size_t>(li) * dim, a.nw_bf16);
    const void* fn = qp_at(a.fn, static_cast<size_t>(li) * dim, a.nw_bf16);

    // A: attn norm + quant; zero the attention-out absmax
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      sbt::norm_quant_row(a.x + static_cast<size_t>(b) * dim, an, a.nw_bf16,
                          dim, a.eps, a.xq + static_cast<size_t>(b) * dim,
                          a.xs + b, red);
      if (threadIdx.x == 0) a.amax_a[b] = 0.f;
    }
    sync(kAttnNorm);

    // 1: qkv = xs * Wqkv(xq)
    const auto qkv_out = [&](int row, int col, float v) {
      a.qkv[static_cast<size_t>(row) * Nq + col] = __fmul_rn(v, a.xs[row]);
    };
    if constexpr (BITS != 4) {
      plane_phase<G, BITS>(a.xq, a.wq, a.sq, a.zq, li, dim, dim, a.nq_s, Nq,
                           a, plane_sm, false, [] {}, qkv_out);
      sync(kWqkv);
    } else {
      sbt::s4_phase<S4>(a.xq, a.wq, a.sq, a.zq, li, dim, dim, Nq, a.gq, a,
                        s4_sm,
                        [&] { sync(kWqkv); }, [&](const auto& split_sum) {
                          grid_for(static_cast<size_t>(B) * Nq, [&](size_t i) {
                            qkv_out(i / Nq, i % Nq, split_sum(i));
                          });
                        });
      sync(kWqkvSum);
    }

    // 2: rope, K/V row commit, int8 attention
    for (int it = blockIdx.x; it < B * a.Hkv; it += gridDim.x)
      attention_item(a, li, it / a.Hkv, it % a.Hkv, sm, red);
    sync(kAttention);

    // 3: xmid = x + as * Wo(q8(aout)), the int8 rows quantized first
    sbt::quant_rows_grid(a.aout, a.amax_a, B, HD, a.aq);
    sync(kQ8Attn);
    const auto wo_out = [&](int row, int col, float v) {
      const size_t o = static_cast<size_t>(row) * dim + col;
      a.xmid[o] =
          __fadd_rn(a.x[o], __fmul_rn(v, sbt::row_scale(a.amax_a[row])));
    };
    if constexpr (BITS != 4) {
      plane_phase<P, BITS>(a.aq, a.wo, a.so, a.zo, li, HD, HD, a.no_s, dim,
                           a, plane_sm, true, [&] { sync(kWo); }, wo_out);
    } else {
      sbt::s4_phase<S4>(a.aq, a.wo, a.so, a.zo, li, HD, HD, dim, a.go, a,
                        s4_sm,
                        [&] { sync(kWo); }, [&](const auto& split_sum) {
                          grid_for(static_cast<size_t>(B) * dim, [&](size_t i) {
                            wo_out(i / dim, i % dim, split_sum(i));
                          });
                        });
    }
    sync(kWoSum);

    // C, 4, 5: the FFN half, x = xmid + W2(q8(silu(g) * u)). s4r mode
    // runs ffn_phases.cuh's phases (K3's too); plane mode its own matmuls
    // around the same norm, GLU and requantization phases.
    if constexpr (BITS == 4) {
      sbt::ffn_s4<S4>(a, li, a.xmid, fn, a.x, s4_sm, amax_sm, red,
                      [&](sbt::FfnMark m) { sync(Phase(kFfnNorm + m)); });
    } else {
      sbt::ffn_norm_rows(a, a.xmid, fn, red);
      sync(kFfnNorm);
      // 4: [g | u] = xs * W13(xq) into h13, a barrier (gate j and up F + j
      // may lie in different planes), then silu(g) * u and its row absmax
      plane_phase<W13, BITS>(a.xq, a.w13, a.s13, a.z13, li, dim, dim,
                             a.n13_s, F2, a, plane_sm, false, [] {},
                             [&](int row, int col, float v) {
                               a.h13[static_cast<size_t>(row) * F2 + col] =
                                   __fmul_rn(v, a.xs[row]);
                             });
      sync(kW13);
      sbt::glu_rows(a, amax_sm, [&](int rl, int j, float& g, float& u) {
        g = a.h13[static_cast<size_t>(rl) * F2 + j];
        u = a.h13[static_cast<size_t>(rl) * F2 + F + j];
      });
      sync(kGlu);
      // 5: x = xmid + gs * W2(q8(act)), the int8 rows quantized first
      sbt::quant_rows_grid(a.act, a.amax_g, B, F, a.aq);
      sync(kQ8Act);
      plane_phase<P, BITS>(a.aq, a.w2, a.s2, a.z2, li, F, a.f2, a.n2_s, dim,
                           a, plane_sm, true, [&] { sync(kW2); },
                           [&](int row, int col, float v) {
                             const size_t o = static_cast<size_t>(row) * dim +
                                              col;
                             a.x[o] = __fadd_rn(
                                 a.xmid[o],
                                 __fmul_rn(v, sbt::row_scale(a.amax_g[row])));
                           });
      sync(kW2Sum);
    }
  }
}


// The dynamic shared memory of K4: s4r mode's ring (plane mode's tiles
// use static shared memory).
template <int BITS, class S4>
constexpr int kDynSmem = BITS == 4 ? S4::BYTES : 0;

template <class P, class G, int BITS, class S4>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = layers_fused_kernel<P, G, BITS, S4>;
  constexpr int smem = kDynSmem<BITS, S4>;
  int grid = 0;
  cudaError_t e = sbt::grid_size(kern, smem, &grid);
  if (e != cudaSuccess) return e;
  Args copy = a;
  void* params[] = {&copy};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                  dim3(kThreads), params, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The instantiation for wbits and B rows: plane mode by B <= 8, s4r mode
// by B <= 16 (its tiles are m16 tiles).
template <int BITS, class F>
cudaError_t with_kernel(int B, const F& f) {
  if constexpr (BITS == 4)
    return B <= 16 ? f.template operator()<SmallP, SmallG, 4, S4Small>()
                   : f.template operator()<LargeP, LargeP, 4, S4Large>();
  else
    return B <= 8 ? f.template operator()<SmallP, SmallG, BITS, S4Small>()
                  : f.template operator()<LargeP, LargeP, BITS, S4Large>();
}

struct Launcher {
  const Args& a;
  cudaStream_t st;
  template <class P, class G, int BITS, class S4>
  cudaError_t operator()() const {
    return launch<P, G, BITS, S4>(a, st);
  }
};

template <int BITS>
cudaError_t launch_rows(const Args& a, cudaStream_t st) {
  return with_kernel<BITS>(a.B, Launcher{a, st});
}

}  // namespace

// Weights of wbits 4: wq (L, dim/2, Nq), wo (L, Hq*D/2, dim), w13 (L,
// dim/2, 2F), w2 (L, f2/2, dim) s4r bytes; of wbits 3 or 2: the plane
// concat (L, K, 3Ns/8) or (L, K, Ns/4) of each (K = f2 for W2). f2 >= F:
// W2's rows a layer, K-padded by QuantLinear.with_k_pad with exact-zero
// groups that K4 does not read (ffn_phases.cuh); with Ns = nq_s, no_s,
// n13_s, n2_s >= Nq, dim, 2F, dim the padded widths (equal at 4 bits).
// Scales/zeros (L, K/gs, Ns) (bf16 when sz_bf16, else f32); an/fn (L,
// dim) norms (bf16 when nw_bf16). Cache pools k, v (Lc, n_blocks, block,
// Hkv, D) int8, ks, vs (Lc, n_blocks, block, Hkv) f32, block table bt
// (B, max_chunks) int32, pos (B,) int32, cos/sin (B, D) f32. x (B, dim)
// f32 holds the input rows and receives the output. The rest is scratch: xq (B, dim) int8, xs (B),
// qkv (B, Nq), aout (B, Hq*D), amax_a (B), xmid (B, dim), act (B, F),
// amax_g (B), sc (B, Hq, max_chunks*block), part and, in plane mode, h13
// (B, 2F), all f32, and aq (B, max(Hq*D, F)) int8. part: plane mode (B,
// dim, 1 + max(Hq*D, F) / gs / 2); s4r mode max over the four matmuls of
// (splits, B, N), splits = ceil(K / gs / g) for gq, go, g13, g2 groups a
// K split of Wqkv, Wo, W13, W2 (ops/quant_matmul.s4_plan). B <= 64, D a
// power of two <= 256, Hq/Hkv <= 8, K dims multiples of 64 and of gs.
extern "C" int sbt_layers_fused(
    const void* wq, const void* sq, const void* zq, const void* wo,
    const void* so, const void* zo, const void* w13, const void* s13,
    const void* z13, const void* w2, const void* s2, const void* z2,
    const void* an, const void* fn, void* k, void* v, void* ks, void* vs,
    const void* bt, const void* pos, const void* cos, const void* sin,
    void* x, void* xq, void* xs, void* qkv, void* aout, void* amax_a,
    void* xmid, void* act, void* amax_g, void* sc, void* h13, void* aq,
    void* part, int sz_bf16, int nw_bf16,
    int L, int B, int dim, int Hq, int Hkv, int D, int F, int gs, int f2,
    int wbits, int nq_s, int no_s, int n13_s, int n2_s, int gq, int go,
    int g13, int g2, int n_blocks,
    int block, int max_chunks, int s_act, float eps, float inv_sqrt_d,
    void* stream) {
  const int Nq = (Hq + 2 * Hkv) * D;
  const int pmul = wbits == 3 ? 8 : 4;  // plane-mode N multiple
  const bool widths_ok =
      wbits == 4 ? (nq_s == Nq && no_s == dim && n13_s == 2 * F &&
                    n2_s == dim)
                 : ((wbits == 2 || wbits == 3) && nq_s >= Nq &&
                    no_s >= dim && n13_s >= 2 * F && n2_s >= dim &&
                    nq_s % pmul == 0 && no_s % pmul == 0 &&
                    n13_s % pmul == 0 && n2_s % pmul == 0);
  if (B < 1 || B > 64 || D > kMaxD || D % 4 || kThreads % (D / 4) ||
      Hq % Hkv || Hq / Hkv > kMaxRep || s_act < 1 ||
      s_act > max_chunks * block || !widths_ok || f2 < F || f2 % gs ||
      (wbits == 4 && (gq < 1 || go < 1 || g13 < 1 || g2 < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.wq = static_cast<const uint8_t*>(wq);
  a.wo = static_cast<const uint8_t*>(wo);
  a.w13 = static_cast<const uint8_t*>(w13);
  a.w2 = static_cast<const uint8_t*>(w2);
  a.sq = sq; a.zq = zq; a.so = so; a.zo = zo;
  a.s13 = s13; a.z13 = z13; a.s2 = s2; a.z2 = z2;
  a.an = an; a.fn = fn;
  a.k = static_cast<int8_t*>(k);
  a.v = static_cast<int8_t*>(v);
  a.ks = static_cast<float*>(ks);
  a.vs = static_cast<float*>(vs);
  a.bt = static_cast<const int*>(bt);
  a.pos = static_cast<const int*>(pos);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.x = static_cast<float*>(x);
  a.xq = static_cast<int8_t*>(xq);
  a.xs = static_cast<float*>(xs);
  a.qkv = static_cast<float*>(qkv);
  a.aout = static_cast<float*>(aout);
  a.amax_a = static_cast<float*>(amax_a);
  a.xmid = static_cast<float*>(xmid);
  a.act = static_cast<float*>(act);
  a.amax_g = static_cast<float*>(amax_g);
  a.sc = static_cast<float*>(sc);
  a.h13 = static_cast<float*>(h13);
  a.aq = static_cast<int8_t*>(aq);
  a.part = static_cast<float*>(part);
  a.sz_bf16 = sz_bf16; a.nw_bf16 = nw_bf16;
  a.L = L; a.B = B; a.dim = dim; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.F = F;
  a.gs = gs; a.f2 = f2; a.n_blocks = n_blocks; a.block = block;
  a.nq_s = nq_s; a.no_s = no_s; a.n13_s = n13_s; a.n2_s = n2_s;
  a.gq = gq; a.go = go; a.g13 = g13; a.g2 = g2;
  a.max_chunks = max_chunks; a.s_act = s_act;
  a.eps = eps; a.inv_sqrt_d = inv_sqrt_d;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = wbits == 4   ? launch_rows<4>(a, st)
                  : wbits == 3 ? launch_rows<3>(a, st)
                               : launch_rows<2>(a, st);
  return static_cast<int>(e);
}

#ifdef SBT_PHASE_TRACE
namespace {

// The grid size of an instantiation of K4, into *g.
struct GridOf {
  int* g;
  template <class P, class G, int BITS, class S4>
  cudaError_t operator()() const {
    return sbt::grid_size(layers_fused_kernel<P, G, BITS, S4>,
                     kDynSmem<BITS, S4>, g);
  }
};

// n grid barriers and nothing else: the cost of one barrier of K4's grid.
__global__ void __launch_bounds__(kThreads) grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

}  // namespace

// buf: (L, 16) pairs (phase, ns) of u64, zeroed, that every later K4
// launch fills (Phase names the phase that ended at each stamp), or null
// to stop.
extern "C" int sbt_phase_trace_set(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_trace, &buf, sizeof(buf)));
}

// The name of phase id (Phase), or null past the last.
extern "C" const char* sbt_phase_name(int id) {
  return id > 0 && id < kPhaseEnd ? kPhaseNames[id] : nullptr;
}

extern "C" int sbt_phase_marks() { return kMarks; }

// n_syncs grid barriers on the grid K4 launches for wbits (2, 3 or 4) and
// B rows; *grid receives its block count.
extern "C" int sbt_grid_sync_probe(int n_syncs, int wbits, int B, void* grid,
                                   void* stream) {
  int g = 0;
  const GridOf f{&g};
  cudaError_t e = wbits == 4   ? with_kernel<4>(B, f)
                  : wbits == 3 ? with_kernel<3>(B, f)
                               : with_kernel<2>(B, f);
  if (e != cudaSuccess) return static_cast<int>(e);
  *static_cast<int*>(grid) = g;
  void* params[] = {&n_syncs};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(grid_sync_probe_kernel), dim3(g),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
#endif  // SBT_PHASE_TRACE
