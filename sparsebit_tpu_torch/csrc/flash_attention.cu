// K10: causal flash attention forward, out = softmax(q kᵀ · sm_scale) v,
// never holding the (S, S) scores.
//
// Replaces JAX's bundled Pallas TPU kernel that
// sparsebit_tpu/llm/llama.py:155 causal_attention calls on the TPU:
// jax/experimental/pallas/ops/tpu/flash_attention.py:342
// _flash_attention_kernel_single_batch and :484 ..._single_step, launched
// from _flash_attention_impl (:758). Same arithmetic: scores and sums in
// f32, sm_scale multiplied into the scores after the dot (:408-409), P
// rounded to V's type before PV (:470-472), rows with l = 0 left at 0
// (:467). It keeps the accumulator unnormalised and divides by l once at
// the end (the TPU kernel renormalises every step), so the plain version
// (ops/flash_attention.flash_attention_plain) repeats this order.
//
// Layout: q, k, v, out are (B, H, S, D) / (B, Hkv, S, D) read through
// element strides (batch, head, row; the last dimension contiguous), so the
// port's (B, S, H, D) activations go in without a transposed copy. Query
// head h reads kv head h / (H / Hkv).
//
// Bound on the H100 at the prefill's shapes: operations. A causal 2048-row
// head at D = 128 is 4 * D * S(S+1)/2 = 1.07 GFLOP against 2 MB of q, k,
// v, out: ~540 FLOP a byte, above the bf16 ridge (~295). So the design
// feeds the tensor cores at Hopper's rate where it can:
//   - bf16 at D = 64 and 128 (flash_fwd_sm90_kernel, on flash_sm90.cuh,
//     FA3's forward shape): a persistent block on each SM walks a fixed
//     list of causal pairs of 128-row q tiles (tiles p and n - 1 - p of
//     one head: n + 1 key tiles a pair, so a static round-robin is
//     balanced), head by head so that the blocks at work share a few
//     heads' K/V in L2. Two consumer warpgroups own 64 q rows each; a
//     producer warp's lane 0 copies each job's Q once and K/V tiles
//     0 .. the diagonal by TMA (128-byte-swizzled panels, 4-D tensor maps
//     over the strided (B, H, S, D) views; rows past S read as zeros)
//     into a ring with full (K and V apart) and empty mbarriers, running
//     into the next job while this one ends. Key tiles are 128 wide, the
//     q tile's height: the diagonal tile is the only masked one (keys
//     past S lie above the diagonal of every stored row) and no tile is
//     wholly above a warpgroup's rows. A 64 x 128 f32 score tile (64
//     registers a thread) beside O (D / 2) stays within the 168
//     registers a thread that the 288-thread block gets (registers are
//     given by 4-warp groups, so as for 384; ptxas sizes the wgmma
//     pipeline against that budget). The ring holds as many stages as
//     fit beside Q in 227 KB: 3 at D = 128 (225 KB), 4 at D = 64. S =
//     Q Kᵀ is wgmma with both operands K-major from shared memory; the
//     online softmax keeps the running max of the raw scores and forms
//     P = exp2(s c - m c), c = sm_scale log2 e, on the special-function
//     unit; P is rounded to bf16 in registers as the A operand of O +=
//     P V, V read MN-major from the same stage (the descriptor's
//     transpose bit), so no tile is copied twice and P never goes
//     through shared memory. The warpgroups ping-pong (FA3): one issues
//     its previous tile's PV and this tile's scores while the other
//     forms its P;
//   - bf16 at D = 256 (flash_fwd_d256_kernel, the same scheme): O alone is
//     128 f32 registers a thread at D = 256, so no warpgroup can hold it
//     beside a score tile within the 168 registers a thread of a
//     288-thread block. Both consumer warpgroups take one 64-row q tile
//     and split O by columns (64 registers each): the first forms the
//     64 x 64 score tile (32 registers) and P, hands P to the second
//     through shared memory (bf16, one 128-byte-swizzled panel, two
//     buffers under full/empty mbarriers, with each row's rescale) and
//     adds P V into its columns with P in registers; the second adds P V
//     into its columns with P read from shared memory. Ring stages of 64
//     keys (the q tile's height: only the diagonal tile is masked); Q
//     32 KB, K in 3 stages and V in 2 (the score warpgroup runs ahead of
//     the second), 208 KB in all; the persistent schedule walks causal
//     pairs of 64-row q tiles. Also built and timed on an H100 (PERF.md):
//     FA3's split (384 threads, a producer warpgroup lowered to 40
//     registers by setmaxnreg, two consumers raised to 232, each with all
//     of its 64 rows' O over 128-row q tiles) kept ptxas's budget at the
//     launch's 168 registers, spilled and ran 1.7-2.8x slower; both
//     warpgroups forming the scores themselves (no hand-over, 3 of 2
//     products' tensor work) ran 5 % slower; one warpgroup holding all
//     of O spilled and ran 2x slower; three consumer warpgroups (416
//     threads are given registers as 512, 128 a thread) spilled and ran
//     1.25x slower;
//   - f32 models (flash_f32_kernel): FFMA, since no tensor core takes f32
//     (wgmma has no f32 operands, and TF32 would change what the kernel
//     computes), so the bound is the FFMA pipes' 67 TFLOP/s. Register-
//     tiled as an SGEMM is: 256 threads on a 128-row q tile (64 at
//     D = 256), 64-key tiles (32) in a two-stage cp.async ring beside Q;
//     a thread owns 4 x 8 scores (2 x 4) and O's rows of them by D / 8
//     columns, its operands read as float4 from XOR-swizzled tiles (10.7
//     FFMA a 16-byte load for the scores, 12.8 for PV; 5.3 and 7.5 at
//     D = 256, where the tiles are smaller; a quarter-warp's 8 lanes read
//     one row of Q or P by broadcast and 8 distinct chunks of K or V,
//     with no bank conflict; the swizzle's XOR is taken once a lane, 8
//     offsets, so the inner loops load at a pointer plus an immediate and
//     issue no integer work); the online softmax over the scaled scores
//     (P = exp(s sm_scale - m)), a row's max and sum reduced once a tile
//     over its 8 lanes, P through shared memory once a tile as PV's A
//     operand, no shuffle inside either product. A variant with a score
//     warpgroup and an output warpgroup ping-ponging through P (8 x 8
//     scores, fewer loads a FFMA) timed no faster;
//   - causal tiles above the diagonal are skipped; only the diagonal tile
//     and a ragged last tile are masked (rows past S load as zeros and are
//     not stored); the heaviest causal q tiles are scheduled first.
// The plain version (ops/flash_attention.flash_attention_plain) walks each
// kernel's key tiles and forms P as it does. Shared memory is dynamic, its
// limit set before the first launch of each instantiation. When the caller
// passes `lse` (training), K10 also writes each row's natural-log
// log-sum-exp there, in an instantiation of its own (kLse): the serving
// and eval paths pass null and run the kernel without that code.
//
// K11 and K12: the backward, replacing the same JAX module's
// _flash_attention_dkv_kernel (:796, launched at :1121) and
// _flash_attention_dq_kernel (:1146, launched at :1456), which run under
// jax.grad of the training loss. Same arithmetic (:830-930): P =
// exp(s · sm_scale - lse) under the causal mask (the reference keeps m
// and l: exp(s - m) / l), dV += Pᵀ dO with P rounded to dO's type, dP =
// dO Vᵀ, dS = (dP - di) P · sm_scale with di = sum(O dO) from the
// caller, dK += dSᵀ Q and dQ += dS K with dS rounded first, f32
// accumulators.
//
// Bound: operations. K11 does 4 causal-half products, K12 3, against q,
// k, v, dO and the gradients read or written once: at S = 2048, D = 128
// ~4x the bytes' time, at S = 512 near balance. So the design feeds the
// tensor cores at Hopper's rate (sm_90a, flash_sm90.cuh):
//   - wgmma, warp-specialised: at D = 64 and 128 a block is two consumer
//     warpgroups (64 rows each) and one producer warp whose lane 0 issues
//     TMA copies of 128-byte-swizzled 64-row tiles (4-D tensor maps over
//     the strided (B, H, S, D) views; rows past S read as zeros and are
//     not stored) into a ring of 3 stages (4 at D = 64) with full/empty
//     mbarriers (D = 256: below);
//   - the score products take both operands from shared memory (K-major);
//     at D = 64 and 128 the gradient products take P / dS (K11: Pᵀ / dSᵀ)
//     from registers, rounded to bf16 straight from the score
//     accumulators, and K, dO or Q from the same ring stage read MN-major
//     (the descriptor's transpose bit), so no tile is copied twice and
//     nothing the scores produce goes through shared memory;
//   - P = exp2(s · sm_scale log2 e - lse log2 e) on the special-function
//     unit, masked only on the diagonal tile (keys past S are above the
//     diagonal of every row that is stored); dP's product runs while P is
//     formed.
//   - K12: a block per (128-row q tile, head, batch row), the heaviest
//     tiles first; the producer streams K/V tiles 0 .. the diagonal; each
//     warpgroup holds its 64 rows' Q and dO and its dQ (D / 2 f32
//     registers a thread).
//   - K11: a block per (key tile, kv head, batch row); the producer
//     streams Q, dO and the rows' lse and di of the q tiles from the
//     diagonal down, over the kv head's query heads in order. At D = 64
//     each warpgroup owns 64 keys of a 128-key tile and sums both dK and
//     dV. At D = 128 both own one 64-key tile: the first forms Sᵀ and sums
//     dV, the second Sᵀ and dPᵀ and sums dK (5 products a tile instead of
//     4). One 64 x 128 sum a thread (64 registers) keeps each warpgroup
//     inside the 168 registers a thread that 384 (or 288) threads leave;
//     with both sums (128) ptxas serialised every wgmma and spilled, also
//     with setmaxnreg raising the consumers to 240 (its pipeline analysis
//     keeps the launch's budget).
//   - GQA: one block sums a kv head's gradients over all its query heads,
//     so no sum uses atomics and two launches give the same bits. At
//     hd 128 the 64-key blocks already number 256 at Hkv = 8, B = 1,
//     S = 2048, about two an SM; splitting the heads across blocks, with f32 sums
//     added by a second launch, took 6 % off there and was slower at
//     B = 4, S = 512, so it is not done.
//   - bf16 at D = 256 (flash_dkv_d256_kernel, flash_dq_d256_kernel): a
//     64 x 256 f32 sum is 128 registers a thread over one warpgroup, so
//     the sums are split by columns over warpgroups, and the two score
//     products of a 64 x 64 tile over two warpgroups: one forms S = Q Kᵀ
//     and P (m64n64, 32 registers), the other dP = dO Vᵀ and dS = (dP -
//     di) P · scale, P crossing in f32 through shared memory (16 KB; each
//     thread stores its fragment where the same thread of the other
//     warpgroup holds dP's, float4 stores and loads without conflicts).
//     P and dS go in bf16 into [query][key] panels (one 128-byte-swizzled
//     panel each) that the gradient products read from shared memory:
//     K12 reads dS as A (K-major), K11 reads P and dS as Pᵀ and dSᵀ (the
//     descriptor's transpose bit on A), so nothing is transposed by hand.
//     Each warpgroup issues its gradient product of a tile after its next
//     tile's score product and waits for it after that one, so the two
//     warpgroups' products, their exp2 and dS arithmetic and the hand-over
//     overlap. The score products read 128 KB of shared memory a tile
//     (m64n64, 4 KB a k-step); both warpgroups scoring 32 keys each with
//     both products (m64n32, 3 KB a k-step, Q and dO read twice: 192 KB)
//     ran 15-20 % slower (PERF.md, PR 24). Both kernels are persistent:
//     one block an SM walks causal pairs of tiles (n + 1 tiles of work
//     each), so the next job's copies overlap this job's last tile and
//     its stores instead of a block launch's start. K12: jobs are 64-row q
//     tiles of a (head, batch row), 288 threads, Q and dO resident (64 KB)
//     beside rings of two 64-key K and V stages that run on from job to
//     job (V released after dP, K after both dQ products), two dS buffers
//     and P's: 225 KB; each warpgroup adds dS K into 128 of dQ's columns
//     (64 registers). K11: jobs are 64-key tiles of a (kv head, batch
//     row), three consumer warpgroups and no producer warp (384 threads
//     keep 168 registers a thread; a fourth warp would cut them to 128):
//     K and V resident, rings of two Q and two dO stages that the third
//     warpgroup's first thread refills, one P (bf16, f32) and one dS
//     buffer, 225 KB; the two scoring warpgroups add Pᵀ dO into dV's
//     halves (64 registers each), the third dSᵀ Q into all of dK
//     (m64n256, 128 registers).
//   - f32 (FFMA, as K10's f32 forward): K11 (flash_dkv_f32_kernel) a block
//     of 256 threads per 64-key tile (32 at D = 256) walking the q tiles
//     from the diagonal down over every query head in order, Q, dO, lse
//     and di in a two-stage cp.async ring; phase A forms Sᵀ and dPᵀ as
//     4 x 4 register micro-tiles (2 x 2 at D = 256) and writes P and dS
//     once (key-major), phase B sums dV and dK as 4 keys x D / 16 columns
//     a thread (2 x D / 16) from the same ring stage. K12
//     (flash_dq_f32_kernel) a block of 256 threads per 64-row q tile (32
//     at D = 256) with Q and dO resident (64 KB at D <= 128) beside a
//     two-stage cp.async ring of 64-key K/V tiles (32; 128 KB) and the
//     dS tile (16 KB; 208 KB in all at D = 128, 196 KB at D = 256, where
//     a 64-row tile with two stages would need 264 KB), walking the key
//     tiles up to its diagonal; phase A forms S and dP as 4 x 4 register
//     micro-tiles (8 FFMA a 16-byte load; at D = 256 each thread sums a
//     quarter of d, the quarters added by two shuffles after the loop, so
//     the 32 x 32 tile keeps 4 x 4 micro-tiles) and writes dS once, phase
//     B adds dS K into dQ held as 4 rows x D / 16 (D / 32 at D = 256)
//     columns a thread (10.7 FFMA a load).
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_sm90.cuh"
#include "planes.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) log-sum-exp of each row for the backward, or null
  long long qs[3], ks[3], vs[3], os[3];  // element strides: batch, head, row
  int S, n_rep;
  float sm_scale;
  int B, H;
};

// Element offset of 16-byte chunk c of row r in a [rows][D] tile of
// `per` elements a chunk: chunks XOR-swizzled by the row's low 3 bits.
template <int D, int per>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) * per);
}

// Rows [row0, row0 + ROWS) of a (S, D) slab with row stride ss into a
// swizzled tile by a block of NT threads; rows past S are zero-filled.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int row0, int S) {
  constexpr int per = 16 / sizeof(T);
  constexpr int CH = D / per;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int row = row0 + r;
    const bool ok = row < S;
    const T* g = src + static_cast<long long>(ok ? row : 0) * ss + c * per;
    sbt::copy_chunk(dst + swz<D, per>(r, c),
                    reinterpret_cast<const uint8_t*>(g), 16, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The running max used to shift the exponent: -inf (a row with nothing
// unmasked yet) shifts by 0, so exp(-inf - 0) = 0 and no NaN appears.
__device__ __forceinline__ float shift_of(float m) {
  return m == -INFINITY ? 0.f : m;
}

// f32 on FFMA, register-tiled as an SGEMM is. A block of 256 threads (8
// warps) owns a BM-row q tile and walks BN-key tiles: 128 x 64 at D <= 128,
// 64 x 32 at D = 256 (two ring stages of K and V beside Q fit 227 KB only
// so). Warp w owns rows [w WM, w WM + WM); its lane (ty, tx) = (lane / 8,
// lane % 8) owns rows ty + 4 i (i < TM) of them, keys tx + 8 j (j < TN) of
// the tile and O's 16-byte column chunks tx + 8 c (c < CC). So a warp's
// 4 rows and 8 keys in one load are 4 and 8 distinct chunks of the swizzled
// tiles (no bank conflict), each read by 8 or 4 lanes at once (broadcast).
template <int D>
struct F32Fwd {
  static constexpr int NT = 256, kWarps = NT / 32;
  static constexpr int BM = D == 256 ? 64 : 128, BN = D == 256 ? 32 : 64;
  static constexpr int WM = BM / kWarps;  // rows a warp
  static constexpr int TM = WM / 4, TN = BN / 8, CC = D / 32;
  static constexpr size_t kSmem =
      static_cast<size_t>(BM + 4 * BN) * D * sizeof(float) +
      static_cast<size_t>(BM) * BN * sizeof(float);
};

// grid (ceil(S / BM) H B): block x takes q tile n_qt - 1 - x / (H B) (the
// heaviest tiles of every head first) of head x % H, batch row x / H % B.
template <int D, bool kLse>
__global__ void __launch_bounds__(F32Fwd<D>::NT, 1)
    flash_f32_kernel(const Args a) {
  using C = F32Fwd<D>;
  constexpr int NT = C::NT, BM = C::BM, BN = C::BN, WM = C::WM, TM = C::TM,
                TN = C::TN, CC = C::CC, CH = D / 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [BM][D]
  float* sk = sq + BM * D;                         // [2][BN][D]
  float* sv = sk + 2 * BN * D;                     // [2][BN][D]
  float* sp = sv + 2 * BN * D;                     // [BM][BN]: P

  const int S = a.S, n_qt = (S + BM - 1) / BM, HB = a.H * a.B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / HB;
  const int h = static_cast<int>(blockIdx.x) % a.H;
  const int b = static_cast<int>(blockIdx.x) / a.H % a.B;
  const int hk = h / a.n_rep, q0 = qt * BM;
  const float* qg = static_cast<const float*>(a.q) + b * a.qs[0] +
                    h * a.qs[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.ks[0] +
                    hk * a.ks[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.vs[0] +
                    hk * a.vs[1];
  // key tiles up to the one holding the tile's last row (keys past S lie
  // above the diagonal of every stored row)
  const int n_kt = min((q0 + BM - 1) / BN + 1, (S + BN - 1) / BN);

  load_tile<float, D, BM, NT>(sq, qg, a.qs[2], q0, S);
  load_tile<float, D, BN, NT>(sk, kg, a.ks[2], 0, S);
  load_tile<float, D, BN, NT>(sv, vg, a.vs[2], 0, S);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 3, tx = lane & 7, wrow = warp * WM;
  // The swizzle's chunk offsets, XORed once: chunk 8 b + u of a row r lies
  // at 32 b + 4 (u ^ (r & 7)) floats into it, and the lane's rows (of Q,
  // P) have r & 7 = ty ^ 4 (i & 1), its keys (of K) tx; V row 4 kc + e
  // holds the lane's chunk tx + 8 c at 32 c + 4 (tx ^ ((4 kc + e) & 7)).
  int oy[8], ox[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    oy[u] = 4 * (u ^ ty);
    ox[u] = 4 * (u ^ tx);
  }
  float o[TM][CC][4], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CC; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] =
        o[i][c][3] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_tile<float, D, BN, NT>(sk + (buf ^ 1) * BN * D, kg, a.ks[2],
                                  (j + 1) * BN, S);
      load_tile<float, D, BN, NT>(sv + (buf ^ 1) * BN * D, vg, a.vs[2],
                                  (j + 1) * BN, S);
      sbt::cp_commit();
      sbt::cp_wait<1>();
    } else {
      sbt::cp_wait<0>();
    }
    __syncthreads();
    const float* kt = sk + buf * BN * D;
    const float* vt = sv + buf * BN * D;
    const int k0 = j * BN;
    // a tile wholly above the warp's rows adds nothing: skipped
    if (k0 <= q0 + wrow + WM - 1) {
      // S = Q Kᵀ: TM x TN scores, a float4 of d at a time
      float s[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) s[i][n] = 0.f;
      const float* qr = sq + (wrow + ty) * D;
      const float* kr = kt + tx * D;
#pragma unroll 1
      for (int cb = 0; cb < CH / 8; ++cb)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float4 qv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              qr + 4 * i * D + 32 * cb + oy[u ^ ((i & 1) << 2)]);
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kr + 8 * n * D + 32 * cb + ox[u]);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            s[i][n] = fmaf(qv[i].x, kv.x, s[i][n]);
            s[i][n] = fmaf(qv[i].y, kv.y, s[i][n]);
            s[i][n] = fmaf(qv[i].z, kv.z, s[i][n]);
            s[i][n] = fmaf(qv[i].w, kv.w, s[i][n]);
          }
        }
      }

      // scale, mask (keys past a row: the diagonal's tiles, and so keys
      // past S), online softmax: each row's max and sum over its 8 lanes
      const bool need_mask = k0 + BN - 1 > q0 + wrow;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = q0 + wrow + ty + 4 * i;
        float mx = m[i];
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          float x = s[i][n] * a.sm_scale;
          if (need_mask && k0 + tx + 8 * n > row) x = -INFINITY;
          s[i][n] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        const float sh = shift_of(mx);
        const float alpha = expf(m[i] - sh);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const float p = expf(s[i][n] - sh);
          sum += p;
          const int kk = tx + 8 * n;
          sp[swz<BN, 4>(wrow + ty + 4 * i, kk >> 2) + (kk & 3)] = p;
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        sum += __shfl_xor_sync(kFull, sum, 4);
        l[i] = alpha * l[i] + sum;
        m[i] = mx;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          o[i][c][0] *= alpha;
          o[i][c][1] *= alpha;
          o[i][c][2] *= alpha;
          o[i][c][3] *= alpha;
        }
      }
      __syncwarp();  // P's rows are the warp's own

      // O += P V: a float4 of P (4 keys) a row, a float4 of V a chunk
      const float* pr = sp + (wrow + ty) * BN;
#pragma unroll 1
      for (int kb = 0; kb < BN / 32; ++kb)
#pragma unroll
      for (int ku = 0; ku < 8; ++ku) {
        float4 pv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          pv[i] = *reinterpret_cast<const float4*>(
              pr + 4 * i * BN + 32 * kb + oy[ku ^ ((i & 1) << 2)]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vt + (32 * kb + 4 * ku + e) * D + 32 * c +
                ox[(4 * ku + e) & 7]);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float p = e == 0   ? pv[i].x
                              : e == 1 ? pv[i].y
                              : e == 2 ? pv[i].z
                                       : pv[i].w;
              o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
              o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
              o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
              o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled, P rewritten, next
  }

  // out = O / l (rows with l = 0 stay 0), 16 bytes a chunk
  float* og = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + wrow + ty + 4 * i;
    if (row >= S) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    if (kLse && tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * S + row] =
          m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < CC; ++c)
      *reinterpret_cast<float4*>(og + static_cast<long long>(row) * a.os[2] +
                                 4 * (tx + 8 * c)) =
          make_float4(o[i][c][0] * inv, o[i][c][1] * inv, o[i][c][2] * inv,
                      o[i][c][3] * inv);
  }
}

// The kernel's dynamic shared memory limit, set before its first launch.
template <auto Kernel>
cudaError_t set_smem(size_t smem) {
  static bool configured = false;  // one flag per kernel instantiation
  if (configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  configured = e == cudaSuccess;
  return e;
}

template <auto Kernel, typename A>
cudaError_t launch(size_t smem, dim3 grid, const A& a, cudaStream_t st,
                   int threads) {
  const cudaError_t e = set_smem<Kernel>(smem);
  if (e != cudaSuccess) return e;
  Kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// K10 on the FFMA kernel (f32); bf16 runs launch_fwd_sm90 or
// launch_fwd_d256.
template <int D>
cudaError_t launch_fwd_f32(int B, int H, const Args& a, cudaStream_t st) {
  using C = F32Fwd<D>;
  const dim3 grid(static_cast<unsigned>((a.S + C::BM - 1) / C::BM) * H * B);
  return a.lse == nullptr
             ? launch<flash_f32_kernel<D, false>>(C::kSmem, grid, a, st, C::NT)
             : launch<flash_f32_kernel<D, true>>(C::kSmem, grid, a, st, C::NT);
}

// ---- K11 (dK, dV) and K12 (dQ): the backward ------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;  // (B, H, S)
  const float* di;   // (B, H, S)
  void* dq;          // K12
  void* dk;          // K11
  void* dv;          // K11
  long long qs[3], ks[3], vs[3], dos[3], dqs[3], dks[3], dvs[3];
  int S, n_rep;
  float sm_scale;
  int B, Hkv;  // read by the f32 K11's linear grid
};

// K11, f32 on FFMA, register-tiled as K10's f32 forward. A block of 256
// threads owns a BN-key tile of one kv head and batch row (64 keys at
// D <= 128, 32 at D = 256) and walks BM-row q tiles (BM = BN) from the
// diagonal down, over the kv head's query heads in order, Q, dO and the
// rows' lse and di arriving by cp.async in a ring of two stages. Warp w =
// (wk, wx) = (w / 2, w % 2) and lane (ky, x) = (lane / 8, lane % 8): the
// thread owns keys wk BN / 4 + ky + 4 i (i < AK) in both phases. Phase A
// scores queries wx BM / 2 + x + 8 j (j < AQ) into register micro-tiles of
// Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, forms P and dS there and writes each once
// into shared memory (key-major: Pᵀ, dSᵀ); phase B adds Pᵀ dO into dV and
// dSᵀ Q into dK on column chunks wx D / 8 + x + 8 c (c < CC), a float4 of
// Pᵀ / dSᵀ (4 queries) a key and a float4 of dO / Q a chunk, reading the
// ring stage phase A read. Queries in order, no atomics: the GQA sum keeps
// its order and its bits.
template <int D>
struct F32Dkv {
  static constexpr int NT = 256;
  static constexpr int BN = D == 256 ? 32 : 64, BM = BN;
  static constexpr int AK = BN / 16, AQ = BM / 16, CC = D / 64;
  static constexpr size_t kSmem =
      static_cast<size_t>(2 * BN + 4 * BM) * D * sizeof(float) +
      static_cast<size_t>(2 * BN * BM + 4 * BM) * sizeof(float);
};

// grid (ceil(S / BN) Hkv B): block x takes key tile x / (Hkv B) (the
// tiles with the most q tiles first) of kv head x % Hkv, batch row
// x / Hkv % B.
template <int D>
__global__ void __launch_bounds__(F32Dkv<D>::NT, 1)
    flash_dkv_f32_kernel(const BwdArgs a) {
  using C = F32Dkv<D>;
  constexpr int NT = C::NT, BN = C::BN, BM = C::BM, AK = C::AK, AQ = C::AQ,
                CC = C::CC, CH = D / 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // [BN][D]
  float* sv = sk + BN * D;                         // [BN][D]
  float* sq = sv + BN * D;                         // [2][BM][D]
  float* sdo = sq + 2 * BM * D;                    // [2][BM][D]
  float* sp = sdo + 2 * BM * D;                    // [BN][BM]: Pᵀ
  float* sds = sp + BN * BM;                       // [BN][BM]: dSᵀ
  float* sl = sds + BN * BM;                       // [2][BM]
  float* sdi = sl + 2 * BM;                        // [2][BM]

  const int S = a.S, HB = a.Hkv * a.B;
  const int jt = static_cast<int>(blockIdx.x) / HB;
  const int hk = static_cast<int>(blockIdx.x) % a.Hkv;
  const int b = static_cast<int>(blockIdx.x) / a.Hkv % a.B;
  const int H = a.Hkv * a.n_rep, j0 = jt * BN;
  const int n_qt = (S + BM - 1) / BM, per_head = n_qt - jt;
  const int n_it = a.n_rep * per_head;
  const float* kg = static_cast<const float*>(a.k) + b * a.ks[0] +
                    hk * a.ks[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.vs[0] +
                    hk * a.vs[1];

  auto issue = [&](int it, int buf) {  // q tile `it` of the walk into buf
    const int h = hk * a.n_rep + it / per_head;
    const int q0 = (jt + it % per_head) * BM;
    const float* qg = static_cast<const float*>(a.q) + b * a.qs[0] +
                      h * a.qs[1];
    const float* dg = static_cast<const float*>(a.dO) + b * a.dos[0] +
                      h * a.dos[1];
    load_tile<float, D, BM, NT>(sq + buf * BM * D, qg, a.qs[2], q0, S);
    load_tile<float, D, BM, NT>(sdo + buf * BM * D, dg, a.dos[2], q0, S);
    const long long row = (static_cast<long long>(b) * H + h) * S;
    for (int i = threadIdx.x; i < 2 * BM; i += NT) {  // lse, then di
      const int r = i % BM;
      const bool ok = q0 + r < S;
      const float* src = (i < BM ? a.lse : a.di) + row + (ok ? q0 + r : 0);
      sbt::copy_chunk((i < BM ? sl : sdi) + buf * BM + r,
                      reinterpret_cast<const uint8_t*>(src), 4, ok);
    }
  };

  load_tile<float, D, BN, NT>(sk, kg, a.ks[2], j0, S);
  load_tile<float, D, BN, NT>(sv, vg, a.vs[2], j0, S);
  issue(0, 0);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = warp >> 1, wx = warp & 1, ky = lane >> 3, x = lane & 7;
  const int krow = wk * (BN / 4) + ky;  // the thread's first key
  const int qcol = wx * (BM / 2) + x;   // phase A: its first query
  const int dch = wx * (D / 8) + x;     // phase B: its first column chunk
  // The swizzle's chunk offsets, XORed once (as K10's f32 forward): the
  // thread's keys (rows of K, V, Pᵀ, dSᵀ) have r & 7 = ky ^ 4 (i & 1),
  // its phase A queries x; Q / dO row 4 q4 + e holds its phase B chunk
  // dch + 8 c at 4 wx D / 8 + 32 c + 4 (x ^ ((4 q4 + e) & 7)).
  int oy[8], ox[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    oy[u] = 4 * (u ^ ky);
    ox[u] = 4 * (u ^ x);
  }
  float dk[AK][CC][4], dv[AK][CC][4];
#pragma unroll
  for (int i = 0; i < AK; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      issue(it + 1, buf ^ 1);
      sbt::cp_commit();
      sbt::cp_wait<1>();
    } else {
      sbt::cp_wait<0>();
    }
    __syncthreads();
    const int qt = jt + it % per_head, q0 = qt * BM;
    const float* qt_s = sq + buf * BM * D;
    const float* dt_s = sdo + buf * BM * D;

    // phase A: Sᵀ and dPᵀ, AK keys x AQ queries, a float4 of d at a time
    float s[AK][AQ], dp[AK][AQ];
#pragma unroll
    for (int i = 0; i < AK; ++i)
#pragma unroll
      for (int n = 0; n < AQ; ++n) s[i][n] = dp[i][n] = 0.f;
    const float* kr = sk + krow * D;    // V: + BN D
    const float* qr = qt_s + qcol * D;  // dO: + 2 BM D
#pragma unroll 1
    for (int cb = 0; cb < CH / 8; ++cb)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 kv[AK], vv[AK];
#pragma unroll
      for (int i = 0; i < AK; ++i) {
        const float* at = kr + 4 * i * D + 32 * cb + oy[u ^ ((i & 1) << 2)];
        kv[i] = *reinterpret_cast<const float4*>(at);
        vv[i] = *reinterpret_cast<const float4*>(at + BN * D);
      }
#pragma unroll
      for (int n = 0; n < AQ; ++n) {
        const float* at = qr + 8 * n * D + 32 * cb + ox[u];
        const float4 qv = *reinterpret_cast<const float4*>(at);
        const float4 ov = *reinterpret_cast<const float4*>(at + 2 * BM * D);
#pragma unroll
        for (int i = 0; i < AK; ++i) {
          s[i][n] = fmaf(kv[i].x, qv.x, s[i][n]);
          s[i][n] = fmaf(kv[i].y, qv.y, s[i][n]);
          s[i][n] = fmaf(kv[i].z, qv.z, s[i][n]);
          s[i][n] = fmaf(kv[i].w, qv.w, s[i][n]);
          dp[i][n] = fmaf(vv[i].x, ov.x, dp[i][n]);
          dp[i][n] = fmaf(vv[i].y, ov.y, dp[i][n]);
          dp[i][n] = fmaf(vv[i].z, ov.z, dp[i][n]);
          dp[i][n] = fmaf(vv[i].w, ov.w, dp[i][n]);
        }
      }
    }
    // P = exp(s · sm_scale - lse) under the causal mask (the diagonal
    // tile, and the ragged last one: queries past S), dS = (dP - di) P ·
    // sm_scale; each written once, key-major
    const bool need_mask = qt == jt || q0 + BM > S;
#pragma unroll
    for (int n = 0; n < AQ; ++n) {
      const int qc = qcol + 8 * n, qry = q0 + qc;
      const float l_q = sl[buf * BM + qc], d_q = sdi[buf * BM + qc];
#pragma unroll
      for (int i = 0; i < AK; ++i) {
        float p = 0.f;
        if (!need_mask || (j0 + krow + 4 * i <= qry && qry < S))
          p = expf(s[i][n] * a.sm_scale - l_q);
        const int at = swz<BM, 4>(krow + 4 * i, qc >> 2) + (qc & 3);
        sp[at] = p;
        sds[at] = (dp[i][n] - d_q) * p * a.sm_scale;
      }
    }
    __syncthreads();

    // phase B: dV += Pᵀ dO, dK += dSᵀ Q over the tile's queries in order
    const float* pr = sp + krow * BM;          // dSᵀ: + BN BM
    const float* xr = dt_s + 4 * wx * (D / 8);  // Q: - 2 BM D
#pragma unroll 1
    for (int qb = 0; qb < BM / 32; ++qb)
#pragma unroll
    for (int qu = 0; qu < 8; ++qu) {
      float4 pv[AK], sv4[AK];
#pragma unroll
      for (int i = 0; i < AK; ++i) {
        const float* at = pr + 4 * i * BM + 32 * qb + oy[qu ^ ((i & 1) << 2)];
        pv[i] = *reinterpret_cast<const float4*>(at);
        sv4[i] = *reinterpret_cast<const float4*>(at + BN * BM);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const float* at = xr + (32 * qb + 4 * qu + e) * D + 32 * c +
                            ox[(4 * qu + e) & 7];
          const float4 ov = *reinterpret_cast<const float4*>(at);
          const float4 qv = *reinterpret_cast<const float4*>(at - 2 * BM * D);
#pragma unroll
          for (int i = 0; i < AK; ++i) {
            const float p = e == 0   ? pv[i].x
                            : e == 1 ? pv[i].y
                            : e == 2 ? pv[i].z
                                     : pv[i].w;
            const float d = e == 0   ? sv4[i].x
                            : e == 1 ? sv4[i].y
                            : e == 2 ? sv4[i].z
                                     : sv4[i].w;
            dv[i][c][0] = fmaf(p, ov.x, dv[i][c][0]);
            dv[i][c][1] = fmaf(p, ov.y, dv[i][c][1]);
            dv[i][c][2] = fmaf(p, ov.z, dv[i][c][2]);
            dv[i][c][3] = fmaf(p, ov.w, dv[i][c][3]);
            dk[i][c][0] = fmaf(d, qv.x, dk[i][c][0]);
            dk[i][c][1] = fmaf(d, qv.y, dk[i][c][1]);
            dk[i][c][2] = fmaf(d, qv.z, dk[i][c][2]);
            dk[i][c][3] = fmaf(d, qv.w, dk[i][c][3]);
          }
        }
      }
    }
    __syncthreads();  // buf and the Pᵀ/dSᵀ tiles are refilled next
  }

  float* dkg = static_cast<float*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  float* dvg = static_cast<float*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int i = 0; i < AK; ++i) {
    const int key = j0 + krow + 4 * i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int col = 4 * (dch + 8 * c);
      *reinterpret_cast<float4*>(dkg + static_cast<long long>(key) *
                                           a.dks[2] + col) =
          make_float4(dk[i][c][0], dk[i][c][1], dk[i][c][2], dk[i][c][3]);
      *reinterpret_cast<float4*>(dvg + static_cast<long long>(key) *
                                           a.dvs[2] + col) =
          make_float4(dv[i][c][0], dv[i][c][1], dv[i][c][2], dv[i][c][3]);
    }
  }
}

// K12, f32 on FFMA, register-tiled as K10's and K11's f32 kernels. A block
// of 256 threads owns a BM-row q tile of one head and batch row, its Q and
// dO resident in shared memory and its rows' lse and di in registers, and
// walks the key tiles 0 .. the diagonal (BN = BM keys) in order, K and V
// arriving by cp.async in a ring of two stages. Phase A scores the tile:
// S = Q Kᵀ and dP = dO Vᵀ as 4 x 4 register micro-tiles a thread (rows
// ra + RA i, keys ka + 8 j), P = exp(s · sm_scale - lse) and dS = (dP - di)
// P · sm_scale formed there, dS written once into shared memory
// (query-major). At D = 256 the tile is 32 x 32 and a thread sums one
// quarter of d (DS = 4, the quarter lane / 8), the quarters added by two
// shuffles after the products. Phase B adds dS K into dQ, 4 rows x CC
// column chunks a thread, from the ring stage phase A read.
template <int D>
struct F32Dq {
  static constexpr int NT = 256;
  static constexpr int BM = D == 256 ? 32 : 64, BN = BM;
  static constexpr int DS = D == 256 ? 4 : 1;  // phase A: parts of d
  static constexpr int WR = BM / 16, WC = 8 / WR;  // phase B: warps' grid
  static constexpr int CPW = D / 4 / WC;  // phase B: chunks a column group
  static constexpr int CC = CPW / 8;      // phase B: chunks a thread
  static constexpr size_t kSmem =
      static_cast<size_t>(2 * BM + 4 * BN) * D * sizeof(float) +
      static_cast<size_t>(BM) * BN * sizeof(float);
};

// grid (ceil(S / BM) H B): block x takes q tile n_qt - 1 - x / (H B) (the
// heaviest tiles of every head first) of head x % H, batch row x / H % B.
template <int D>
__global__ void __launch_bounds__(F32Dq<D>::NT, 1)
    flash_dq_f32_kernel(const BwdArgs a) {
  using C = F32Dq<D>;
  constexpr int NT = C::NT, BM = C::BM, BN = C::BN, DS = C::DS, CC = C::CC,
                CPW = C::CPW, CH = D / 4;
  // phase A: a thread's rows ra + RA i; its Q rows' r & 7 is qa ^ 4 (i & 1)
  // at DS = 1 (rows 16 wr + ky + 4 i), the warp index at DS = 4 (rows
  // w + 8 i)
  constexpr int RA = DS == 1 ? 4 : 8, FLIP = DS == 1 ? 4 : 0;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [BM][D]
  float* sdo = sq + BM * D;                        // [BM][D]
  float* sk = sdo + BM * D;  // [2][K, V][BN][D]: a stage's V at + BN D
  float* sds = sk + 4 * BN * D;  // [BM][BN]: dS

  const int S = a.S, n_qt = (S + BM - 1) / BM;
  const int H = a.Hkv * a.n_rep, HB = H * a.B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / HB;
  const int h = static_cast<int>(blockIdx.x) % H;
  const int b = static_cast<int>(blockIdx.x) / H % a.B;
  const int hk = h / a.n_rep, q0 = qt * BM, n_kt = qt + 1;
  const float* qg = static_cast<const float*>(a.q) + b * a.qs[0] +
                    h * a.qs[1];
  const float* dg = static_cast<const float*>(a.dO) + b * a.dos[0] +
                    h * a.dos[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.ks[0] +
                    hk * a.ks[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.vs[0] +
                    hk * a.vs[1];

  load_tile<float, D, BM, NT>(sq, qg, a.qs[2], q0, S);
  load_tile<float, D, BM, NT>(sdo, dg, a.dos[2], q0, S);
  load_tile<float, D, BN, NT>(sk, kg, a.ks[2], 0, S);
  load_tile<float, D, BN, NT>(sk + BN * D, vg, a.vs[2], 0, S);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ky = lane >> 3, x = lane & 7;
  const int qa = DS == 1 ? ky : warp;
  const int ra = DS == 1 ? (warp >> 1) * 16 + ky : warp;  // phase A rows
  const int ka = (DS == 1 ? (warp & 1) * 32 : 0) + x;      // phase A keys
  const int part = DS == 1 ? 0 : lane >> 3;  // phase A's quarter of d
  const int rb = (warp / C::WC) * 16 + ky;   // phase B rows rb + 4 i
  const int cb0 = (warp % C::WC) * CPW;      // phase B's first chunk
  // The swizzle's chunk offsets, XORed once (as K10's f32 forward): chunk
  // 8 c + u of row r lies at 32 c + 4 (u ^ (r & 7)) floats into it; the
  // thread's keys (rows of K, V) have r & 7 = x, its phase B rows ky ^
  // 4 (i & 1), and K row 4 k4 + e holds its phase B chunk cb0 + x + 8 c at
  // 4 cb0 + 32 c + 4 (x ^ ((4 k4 + e) & 7)).
  int oq[8], oy[8], ox[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    oq[u] = 4 * (u ^ qa);
    oy[u] = 4 * (u ^ ky);
    ox[u] = 4 * (u ^ x);
  }
  const long long srow = (static_cast<long long>(b) * H + h) * S;
  float lse[4], di[4], dq[4][CC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + RA * i;
    lse[i] = row < S ? a.lse[srow + row] : 0.f;
    di[i] = row < S ? a.di[srow + row] : 0.f;
#pragma unroll
    for (int c = 0; c < CC; ++c)
      dq[i][c][0] = dq[i][c][1] = dq[i][c][2] = dq[i][c][3] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    // tile j has landed for every thread, and every thread is done with
    // tile j - 1 (its stage and dS), so tile j + 1's copy goes into that
    // stage now and lands during this tile's products
    sbt::cp_wait<0>();
    __syncthreads();
    if (j + 1 < n_kt) {
      float* nk = sk + (buf ^ 1) * 2 * BN * D;
      load_tile<float, D, BN, NT>(nk, kg, a.ks[2], (j + 1) * BN, S);
      load_tile<float, D, BN, NT>(nk + BN * D, vg, a.vs[2], (j + 1) * BN, S);
      sbt::cp_commit();
    }
    const float* kt = sk + buf * 2 * BN * D;  // V: + BN D

    // phase A: S and dP, 4 rows x 4 keys, a float4 of d at a time
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) s[i][n] = dp[i][n] = 0.f;
    const float* qr = sq + ra * D + part * (D / DS);  // dO: + BM D
    const float* kr = kt + ka * D + part * (D / DS);  // V: + BN D
#pragma unroll 1
    for (int cb = 0; cb < CH / 8 / DS; ++cb)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float4 qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* at =
            qr + RA * i * D + 32 * cb + oq[u ^ (FLIP * (i & 1))];
        qv[i] = *reinterpret_cast<const float4*>(at);
        ov[i] = *reinterpret_cast<const float4*>(at + BM * D);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* at = kr + 8 * n * D + 32 * cb + ox[u];
        const float4 kv = *reinterpret_cast<const float4*>(at);
        const float4 vv = *reinterpret_cast<const float4*>(at + BN * D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][n] = fmaf(qv[i].x, kv.x, s[i][n]);
          s[i][n] = fmaf(qv[i].y, kv.y, s[i][n]);
          s[i][n] = fmaf(qv[i].z, kv.z, s[i][n]);
          s[i][n] = fmaf(qv[i].w, kv.w, s[i][n]);
          dp[i][n] = fmaf(ov[i].x, vv.x, dp[i][n]);
          dp[i][n] = fmaf(ov[i].y, vv.y, dp[i][n]);
          dp[i][n] = fmaf(ov[i].z, vv.z, dp[i][n]);
          dp[i][n] = fmaf(ov[i].w, vv.w, dp[i][n]);
        }
      }
    }
    if constexpr (DS > 1) {  // the quarters of d, lanes 8 and 16 apart
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          s[i][n] += __shfl_xor_sync(kFull, s[i][n], 8);
          s[i][n] += __shfl_xor_sync(kFull, s[i][n], 16);
          dp[i][n] += __shfl_xor_sync(kFull, dp[i][n], 8);
          dp[i][n] += __shfl_xor_sync(kFull, dp[i][n], 16);
        }
    }
    // P = exp(s · sm_scale - lse) under the causal mask (the diagonal tile:
    // keys past a row, and so keys past S), dS = (dP - di) P · sm_scale,
    // written once (at DS = 4 each quarter writes one of the 4 rows)
    const bool mask = j == qt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ra + RA * i;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int kk = ka + 8 * n;
        float p = 0.f;
        if (!mask || kk <= r) p = expf(s[i][n] * a.sm_scale - lse[i]);
        if (DS == 1 || i == part)
          sds[swz<BN, 4>(r, kk >> 2) + (kk & 3)] =
              (dp[i][n] - di[i]) * p * a.sm_scale;
      }
    }
    __syncthreads();

    // phase B: dQ += dS K, a float4 of dS (4 keys) a row, a float4 of K a
    // chunk, the keys in order
    const float* pr = sds + rb * BN;
    const float* kc = kt + 4 * cb0;
#pragma unroll 1
    for (int kb = 0; kb < BN / 32; ++kb)
#pragma unroll
    for (int ku = 0; ku < 8; ++ku) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            pr + 4 * i * BN + 32 * kb + oy[ku ^ ((i & 1) << 2)]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kc + (32 * kb + 4 * ku + e) * D + 32 * c +
              ox[(4 * ku + e) & 7]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = e == 0   ? pv[i].x
                            : e == 1 ? pv[i].y
                            : e == 2 ? pv[i].z
                                     : pv[i].w;
            dq[i][c][0] = fmaf(d, kv.x, dq[i][c][0]);
            dq[i][c][1] = fmaf(d, kv.y, dq[i][c][1]);
            dq[i][c][2] = fmaf(d, kv.z, dq[i][c][2]);
            dq[i][c][3] = fmaf(d, kv.w, dq[i][c][3]);
          }
        }
      }
    }
  }

  float* dqg = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rb + 4 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CC; ++c)
      *reinterpret_cast<float4*>(dqg + static_cast<long long>(row) * a.dqs[2] +
                                 4 * (cb0 + x + 8 * c)) =
          make_float4(dq[i][c][0], dq[i][c][1], dq[i][c][2], dq[i][c][3]);
  }
}

// K10 runs on a Hopper kernel for bf16 (flash_fwd_sm90_kernel at D = 64
// and 128, flash_fwd_d256_kernel at 256), f32 on the FFMA one.
bool fwd_on_sm90(int dtype) { return dtype == 0; }

// K11 and K12 run on Hopper kernels for bf16 at every head_dim
// (flash_dkv_sm90_kernel / flash_dq_sm90_kernel at D = 64 and 128,
// flash_dkv_d256_kernel / flash_dq_d256_kernel at 256), f32 on the FFMA
// ones.
bool bwd_on_sm90(int dtype) { return dtype == 0; }

// ---- K11 and K12 on Hopper: bf16, D = 64 or 128 --------------------------
//
// Warp-specialised: two consumer warpgroups of 64 rows (K12: q rows, K11:
// keys) and one producer warp whose lane 0 issues every TMA copy into a
// ring of kStages stages (full/empty mbarriers). See the design note at
// the top of the file.

namespace sm = sbt::sm90;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Sm90Bwd {
  static constexpr int kWG = 2;                      // consumer warpgroups
  static constexpr int kThreads = kWG * 128 + 32;    // + the producer warp
  static constexpr int kDkvKeys = D == 128 ? 64 : 128;
  static constexpr int kTile = 64 * D * 2;           // bytes of 64 rows
  static constexpr int kPanel = 64 * 128;            // a 64-row panel
  static constexpr int kStages = D == 64 ? 4 : 3;    // ring depth
  static constexpr int kBars = 1 + 2 * kStages;
  // both: 2 kWG resident tiles (K12: Q, dO; K11: K, V) and 2 ring tiles a
  // stage (K12: K, V; K11: Q, dO with the rows' lse and di)
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(2 * kWG + 2 * kStages) * kTile +
      static_cast<size_t>(kStages) * 2 * 64 * sizeof(float) + kBars * 8;
};

// The first 1024-byte-aligned byte of dynamic shared memory (offset from
// p itself, so that the compiler still knows the address space).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + ((1024 - (sm::smem_u32(p) & 1023)) & 1023);
}

// A 64 x N f32 accumulator of one warpgroup as wgmma's register A
// operand: N / 16 K steps of 16 columns, each rounded to bf16.
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4],
                                         const float (&d)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

template <int D>
__device__ __forceinline__ void zero(float (&d)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) d[i] = 0.f;
}

// K12, grid (ceil(S / 128), H, B). Warpgroup w owns q rows [q0 + 64 w,
// q0 + 64 w + 64) of the block's 128; the producer streams the K/V tiles
// 0 .. the block's diagonal, both warpgroups consume every stage (the
// first skips the tile above its rows). Per tile: S = Q Kᵀ and dP = dO Vᵀ
// (A and B from shared memory, K-major), P = exp2(S · scale log2 e -
// lse log2 e), masked on the diagonal tile only, dS = (dP - di) P · scale
// rounded to bf16 in registers as the A operand of dQ += dS K (K read
// MN-major from the same stage).
template <int D>
__global__ void __launch_bounds__(Sm90Bwd<D>::kThreads, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const BwdArgs a) {
  using T = __nv_bfloat16;
  using C = Sm90Bwd<D>;
  constexpr int WG = C::kWG, ST = C::kStages, TILE = C::kTile,
                PANEL = C::kPanel, NP = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1k(smem_raw);  // [WG] tiles
  unsigned char* sdo = sq + WG * TILE;     // [WG]
  unsigned char* sk = sdo + WG * TILE;     // [ST]
  unsigned char* sv = sk + ST * TILE;      // [ST]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(
      sv + ST * TILE + ST * 2 * 64 * sizeof(float));
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.n_rep;
  const int S = a.S, q0 = qt * 64 * WG;
  const int n_kt = min(WG * (qt + 1), (S + 63) / 64);
  if (threadIdx.x == 0) {
    sm::mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(full + s, 1);
      sm::mbar_init(empty + s, WG * 128);
    }
    sm::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == WG) {  // the producer warp; one lane issues every copy
    if (threadIdx.x == WG * 128) {
      sm::mbar_arrive_tx(bar_q, 2 * WG * TILE);
      for (int w = 0; w < WG; ++w)
        for (int p = 0; p < NP; ++p) {
          sm::tma_load_4d(sq + w * TILE + p * PANEL, &tq, bar_q, 64 * p,
                          q0 + 64 * w, h, b);
          sm::tma_load_4d(sdo + w * TILE + p * PANEL, &tdo, bar_q, 64 * p,
                          q0 + 64 * w, h, b);
        }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % ST;
        if (j >= ST) sm::mbar_wait(empty + s, (j / ST - 1) & 1);
        sm::mbar_arrive_tx(full + s, 2 * TILE);
        for (int p = 0; p < NP; ++p) {
          sm::tma_load_4d(sk + s * TILE + p * PANEL, &tk, full + s, 64 * p,
                          64 * j, hk, b);
          sm::tma_load_4d(sv + s * TILE + p * PANEL, &tv, full + s, 64 * p,
                          64 * j, hk, b);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 64 * wg;  // the warpgroup's first row
  const int diag = r0 / 64;     // its diagonal key tile
  const bool live = r0 < S;
  const long long srow = (static_cast<long long>(b) * gridDim.y + h) * S;
  const float sl2 = a.sm_scale * kLog2e;
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    lse2[r] = row < S ? a.lse[srow + row] * kLog2e : 0.f;
    di[r] = row < S ? a.di[srow + row] : 0.f;
  }
  float dq[D / 2];
  zero(dq);
  const unsigned char* qw = sq + wg * TILE;
  const unsigned char* dow = sdo + wg * TILE;
  sm::mbar_wait(bar_q, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % ST;
    sm::mbar_wait(full + s, (j / ST) & 1);
    if (live && j <= diag) {
      const unsigned char* kt = sk + s * TILE;
      const unsigned char* vt = sv + s * TILE;
      float sc[32], dp[32];
      zero(sc);
      zero(dp);
      sm::fence_regs(sc);
      sm::fence_regs(dp);
      const uint64_t dqw = sm::opaque(sm::desc_k(qw));
      const uint64_t ddo = sm::opaque(sm::desc_k(dow));
      const uint64_t dkt = sm::desc_k(kt), dvt = sm::desc_k(vt);
      sm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm::wgmma_ss_n64(sc, dqw + sm::step_k<64>(kk),
                         dkt + sm::step_k<64>(kk), kk);
      sm::wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm::wgmma_ss_n64(dp, ddo + sm::step_k<64>(kk),
                         dvt + sm::step_k<64>(kk), kk);
      sm::wg_commit();
      sm::wg_wait<1>();  // S is in; P while dP runs
      sm::fence_regs(sc);
      const bool mask = j == diag;
      const int rel = sm::opaque(warp * 16 + g - 2 * t4);  // row - column
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          float p = sm::exp2_ftz(sc[4 * i + e] * sl2 - lse2[rr]);
          if (mask && 8 * i + (e & 1) > rel + 8 * rr) p = 0.f;
          sc[4 * i + e] = p;
        }
      sm::wg_wait<0>();
      sm::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = (dp[i] - di[(i >> 1) & 1]) * sc[i] * a.sm_scale;
      uint32_t da[4][4];
      acc_to_a(da, sc);
      sm::fence_regs(dq);
      sm::fence_regs(da);
      sm::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm::wgmma_rs<D>(dq, da[kk], sm::desc_mn<64>(kt) + sm::step_mn(kk));
      sm::wg_commit();
      sm::wg_wait<0>();
      sm::fence_regs(dq);
    }
    sm::mbar_arrive(empty + s);
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dqg + row * a.dqs[2] + 8 * i + 2 * t4) =
          pack_bf16(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
  }
}

// K11, grid (ceil(S / keys), Hkv, B), keys = Sm90Bwd<D>::kDkvKeys a
// block. The producer streams Q, dO (TMA) and the rows' lse log2 e and di
// (its 32 lanes) a q tile a stage, over the kv head's n_rep query heads in
// order, for each the q tiles from the block's diagonal down. A warpgroup scores 64 keys against a stage,
// Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with K, V as A from shared memory, forms Pᵀ
// and dSᵀ in registers and rounds them to bf16
// as the A operand of dV += Pᵀ dO and dK += dSᵀ Q (dO and Q read MN-major
// from the same stage), its sums in f32 registers over the whole walk:
//   - D = 64: warpgroup w owns keys [64 w, 64 w + 64) of the block's 128
//     and adds both dV and dK;
//   - D = 128: both own the block's 64 keys; the first adds dV (Sᵀ only),
//     the second dK (Sᵀ and dPᵀ), so that a thread holds one 64 x 128 sum
//     (64 registers) beside its scores and ptxas keeps the wgmma pipeline
//     within the launch's 168 registers.
// dK, dV are written once, in k's dtype, through their strides.
template <int D>
__global__ void __launch_bounds__(Sm90Bwd<D>::kThreads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const BwdArgs a) {
  using T = __nv_bfloat16;
  using C = Sm90Bwd<D>;
  constexpr int WG = C::kWG, ST = C::kStages, TILE = C::kTile,
                PANEL = C::kPanel, NP = D / 64, KEYS = C::kDkvKeys;
  constexpr bool kRoles = KEYS == 64;  // the warpgroups split dV and dK
  constexpr int KT = KEYS / 64;        // key tiles a block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1k(smem_raw);  // [KT] tiles
  unsigned char* sv = sk + KT * TILE;      // [KT]
  unsigned char* sq = sv + KT * TILE;      // [ST]
  unsigned char* sdo = sq + ST * TILE;     // [ST]
  float* sl = reinterpret_cast<float*>(sdo + ST * TILE);  // [ST][64]
  float* sdi = sl + ST * 64;                               // [ST][64]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sdi + ST * 64);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;

  const int kt = blockIdx.x;  // the heaviest key tiles (most q tiles) first
  const int hk = blockIdx.y, b = blockIdx.z, H = gridDim.y * a.n_rep;
  const int S = a.S, k0 = kt * KEYS;
  const int first = KT * kt;  // the block's diagonal q tile
  const int per_head = (S + 63) / 64 - first;
  const int n_it = a.n_rep * per_head, h0 = hk * a.n_rep;
  if (threadIdx.x == 0) {
    sm::mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(full + s, 32);
      sm::mbar_init(empty + s, WG * 128);
    }
    sm::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == WG) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      sm::mbar_arrive_tx(bar_kv, 2 * KT * TILE);
      for (int w = 0; w < KT; ++w)
        for (int p = 0; p < NP; ++p) {
          sm::tma_load_4d(sk + w * TILE + p * PANEL, &tk, bar_kv, 64 * p,
                          k0 + 64 * w, hk, b);
          sm::tma_load_4d(sv + w * TILE + p * PANEL, &tv, bar_kv, 64 * p,
                          k0 + 64 * w, hk, b);
        }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      if (it >= ST) sm::mbar_wait(empty + s, (it / ST - 1) & 1);
      const int h = h0 + it / per_head;
      const int q0 = (first + it % per_head) * 64;
      const long long row = (static_cast<long long>(b) * H + h) * S;
#pragma unroll
      for (int r = lane; r < 64; r += 32) {
        const bool ok = q0 + r < S;
        sl[s * 64 + r] = ok ? a.lse[row + q0 + r] * kLog2e : 0.f;
        sdi[s * 64 + r] = ok ? a.di[row + q0 + r] : 0.f;
      }
      if (lane == 0) {
        sm::mbar_arrive_tx(full + s, 2 * TILE);
        for (int p = 0; p < NP; ++p) {
          sm::tma_load_4d(sq + s * TILE + p * PANEL, &tq, full + s, 64 * p,
                          q0, h, b);
          sm::tma_load_4d(sdo + s * TILE + p * PANEL, &tdo, full + s, 64 * p,
                          q0, h, b);
        }
      } else {
        sm::mbar_arrive(full + s);
      }
    }
    return;
  }

  // ROLE 0: dV and dK (D = 64); 1: dV; 2: dK (D = 128, warpgroups 0, 1).
  // The role is fixed for the whole loop, so no wgmma sits on a branch
  // that ptxas must treat as divergent.
  auto consume = [&](auto role) {
    constexpr int ROLE = decltype(role)::value;
    constexpr bool kDv = ROLE != 2, kDk = ROLE != 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int key0 = k0 + (kRoles ? 0 : 64 * wg);  // the warpgroup's keys
    const int diag = key0 / 64;                     // their diagonal q tile
    const bool live = key0 < S;
    const float sl2 = a.sm_scale * kLog2e;
    // ROLE 0: dv, dk; else dv holds the warpgroup's one sum (dV or dK)
    float dv[D / 2], dk[ROLE == 0 ? D / 2 : 1];
    zero(dv);
    zero(dk);
    const unsigned char* kw = sk + (kRoles ? 0 : wg * TILE);
    const unsigned char* vw = sv + (kRoles ? 0 : wg * TILE);
    sm::mbar_wait(bar_kv, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      sm::mbar_wait(full + s, (it / ST) & 1);
      const int qt = first + it % per_head;
      if (live && qt >= diag) {
        const unsigned char* qs = sq + s * TILE;
        const unsigned char* ds = sdo + s * TILE;
        const bool mask = qt == diag;
        const float* l2 = sl + s * 64;
        const float* dd = sdi + s * 64;
        const uint64_t dkw = sm::opaque(sm::desc_k(kw));
        const uint64_t dvw = sm::opaque(sm::desc_k(vw));
        const uint64_t dqs = sm::desc_k(qs);
        const uint64_t dds = sm::desc_k(ds);
        float st[32], dpt[32];
        zero(st);
        sm::fence_regs(st);
        if constexpr (kDk) {
          zero(dpt);
          sm::fence_regs(dpt);
        }
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm::wgmma_ss_n64(st, dkw + sm::step_k<64>(kk),
                           dqs + sm::step_k<64>(kk), kk);
        sm::wg_commit();
        if constexpr (kDk) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            sm::wgmma_ss_n64(dpt, dvw + sm::step_k<64>(kk),
                             dds + sm::step_k<64>(kk), kk);
          sm::wg_commit();
          sm::wg_wait<1>();  // Sᵀ is in: Pᵀ while dPᵀ runs
        } else {
          sm::wg_wait<0>();
        }
        sm::fence_regs(st);
        const int rel = sm::opaque(warp * 16 + g - 2 * t4);  // key - q
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + 2 * t4;  // the thread's q columns
          const float2 lv = *reinterpret_cast<const float2*>(l2 + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p =
                sm::exp2_ftz(st[4 * i + e] * sl2 - (e & 1 ? lv.y : lv.x));
            if (mask && rel + 8 * (e >> 1) > 8 * i + (e & 1)) p = 0.f;
            st[4 * i + e] = p;
          }
        }
        uint32_t pa[4][4], sa[4][4];
        if constexpr (kDk) {
          sm::wg_wait<0>();  // dPᵀ is in
          sm::fence_regs(dpt);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float2 d2 =
                *reinterpret_cast<const float2*>(dd + 8 * i + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * i + e] = (dpt[4 * i + e] - (e & 1 ? d2.y : d2.x)) *
                               st[4 * i + e] * a.sm_scale;
          }
          acc_to_a(sa, dpt);
          sm::fence_regs(sa);
        }
        if constexpr (kDv) {
          acc_to_a(pa, st);
          sm::fence_regs(pa);
        }
        sm::fence_regs(dv);
        sm::fence_regs(dk);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t step = sm::step_mn(kk);
          if constexpr (ROLE == 0) {
            sm::wgmma_rs<D>(dv, pa[kk], sm::desc_mn<64>(ds) + step);
            sm::wgmma_rs<D>(dk, sa[kk], sm::desc_mn<64>(qs) + step);
          } else if constexpr (ROLE == 1) {
            sm::wgmma_rs<D>(dv, pa[kk], sm::desc_mn<64>(ds) + step);
          } else {
            sm::wgmma_rs<D>(dv, sa[kk], sm::desc_mn<64>(qs) + step);
          }
        }
        sm::wg_commit();
        sm::wg_wait<0>();
        sm::fence_regs(dv);
        sm::fence_regs(dk);
      }
      sm::mbar_arrive(empty + s);
    }

    T* dkg = static_cast<T*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
    T* dvg = static_cast<T*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + warp * 16 + g + 8 * r;
      if (key >= S) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * t4;
        const float2 v2 =
            make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
        float2 k2 = v2;  // ROLE 2: dv holds dK
        if constexpr (ROLE == 0)
          k2 = make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        if constexpr (kDv)
          *reinterpret_cast<uint32_t*>(dvg + key * a.dvs[2] + col) =
              pack_bf16(v2.x, v2.y);
        if constexpr (kDk)
          *reinterpret_cast<uint32_t*>(dkg + key * a.dks[2] + col) =
              pack_bf16(k2.x, k2.y);
      }
    }
  };
  if constexpr (!kRoles)
    consume(std::integral_constant<int, 0>());
  else if (wg == 0)
    consume(std::integral_constant<int, 1>());
  else
    consume(std::integral_constant<int, 2>());
}

// K11 (dkv) or K12 on the Hopper kernels: the four operands' tensor maps
// (64-row boxes), then the launch.
template <int D>
cudaError_t launch_bwd_sm90(bool dkv, int B, int H, int Hkv,
                            const BwdArgs& a, cudaStream_t st) {
  using C = Sm90Bwd<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm::tensor_map_bhsd(&tq, a.q, B, H, a.S, D, a.qs, 64) ||
      !sm::tensor_map_bhsd(&tk, a.k, B, Hkv, a.S, D, a.ks, 64) ||
      !sm::tensor_map_bhsd(&tv, a.v, B, Hkv, a.S, D, a.vs, 64) ||
      !sm::tensor_map_bhsd(&tdo, a.dO, B, H, a.S, D, a.dos, 64))
    return cudaErrorInvalidValue;
  const int n_tiles = (a.S + 64 * C::kWG - 1) / (64 * C::kWG);
  cudaError_t e;
  if (!dkv) {
    if ((e = set_smem<flash_dq_sm90_kernel<D>>(C::kSmem)) != cudaSuccess)
      return e;
    flash_dq_sm90_kernel<D><<<dim3(n_tiles, H, B), C::kThreads, C::kSmem,
                              st>>>(tq, tk, tv, tdo, a);
    return cudaGetLastError();
  }
  if ((e = set_smem<flash_dkv_sm90_kernel<D>>(C::kSmem)) != cudaSuccess)
    return e;
  const int k_tiles = (a.S + C::kDkvKeys - 1) / C::kDkvKeys;
  flash_dkv_sm90_kernel<D><<<dim3(k_tiles, Hkv, B), C::kThreads, C::kSmem,
                             st>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

// ---- K11 and K12 on Hopper: bf16, D = 256 ---------------------------------
//
// A 64 x 256 f32 sum is 128 registers a thread over one warpgroup, so at
// D = 256 the sums are split by columns over two warpgroups. One of them
// forms S = Q Kᵀ and P, the other dP = dO Vᵀ and dS (each a 64 x 64
// tile, 32 registers), P crossing from the first to the second in f32
// through shared memory; P and dS are written in bf16 into [query][key]
// panels that the gradient products read from shared memory. See the
// design note at the top of the file.

struct Sm90BwdD256 {
  static constexpr int D = 256;
  static constexpr int kTile = 64 * D * 2;    // 64 rows of Q, K, V or dO
  static constexpr int kPanel = 64 * 128;     // one of its 4 panels
  static constexpr int kPTile = 64 * 64 * 2;  // a 64 x 64 bf16 P or dS
  static constexpr int kStages = 2;           // ring depth
  // K12: two consumer warpgroups and the producer warp; Q and dO resident,
  // K and V in rings, dS in two buffers, P (f32) in one
  static constexpr int kDqThreads = 2 * 128 + 32;
  static constexpr size_t kDqSmem =
      1024 + static_cast<size_t>(2 + 2 * kStages) * kTile + 2 * kPTile +
      64 * 64 * 4 + (2 + 4 * kStages + 6) * 8;
  // K11: three consumer warpgroups (the third's first thread issues the
  // copies); K and V resident, Q and dO in rings, P (bf16 and f32) and dS
  // in one buffer each
  static constexpr int kDkvThreads = 3 * 128;
  static constexpr size_t kDkvSmem =
      1024 + static_cast<size_t>(2 + 2 * kStages) * kTile + 2 * kPTile +
      64 * 64 * 4 + (4 + 4 * kStages + 6) * 8;
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
                "over a block's shared memory");
};

// P = exp2(s · scale log2 e - lse log2 e) in place over a warpgroup's
// 64 x 64 score fragment (rows warp * 16 + g (+ 8), lse2 theirs), the keys
// above each row zeroed on the diagonal tile, and handed over in f32 at
// the thread's own slots of `pf`, where the same thread of the other
// warpgroup holds dP's fragment: float4 stores and loads, no conflicts.
__device__ __forceinline__ void d256_p(float (&sc)[32],
                                       const float (&lse2)[2], float sl2,
                                       bool diag) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int rel = warp * 16 + (lane >> 2) - 2 * (lane & 3);  // row - key
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = sm::exp2_ftz(sc[4 * i + e] * sl2 - lse2[e >> 1]);
      if (diag && 8 * i + (e & 1) > rel + 8 * (e >> 1)) p = 0.f;
      sc[4 * i + e] = p;
    }
}

__device__ __forceinline__ void d256_hand(float4* pf, const float (&sc)[32]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    pf[i * 128 + t] =
        make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
}

// dS = (dP - di) P · scale in place over the dP fragment, P from `pf`.
__device__ __forceinline__ void d256_ds(float (&dp)[32], const float4* pf,
                                        const float (&di)[2], float scale) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 p = pf[i * 128 + t];
    const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * i + e] = (dp[4 * i + e] - di[e >> 1]) * pe[e] * scale;
  }
}

// A warpgroup's 64 x 64 f32 tile (P or dS) rounded to bf16 into a
// [row][key] tile: one 128-byte-swizzled panel, chunk c of row r at chunk
// c ^ (r & 7), as wgmma reads it (K-major as A, or MN-major).
__device__ __forceinline__ void d256_put(unsigned char* tile,
                                         const float (&x)[32]) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(tile + row * 128 + ((i ^ (row & 7)) << 4) +
                                   4 * t4) =
          pack_bf16(x[4 * i + 2 * r], x[4 * i + 2 * r + 1]);
  }
}

// A 64 x N f32 sum (N = 2 NI) of a warpgroup into rows row0 + warp * 16 +
// g (+ 8) of `out`, columns col0 + 8 i + 2 t4, rows at or past S not
// stored.
template <int NI>
__device__ __forceinline__ void d256_store(__nv_bfloat16* out, long long ss,
                                           const float (&d)[4 * NI],
                                           int row0, int col0, int S) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i)
      *reinterpret_cast<uint32_t*>(out + row * ss + col0 + 8 * i + 2 * t4) =
          pack_bf16(d[4 * i + 2 * r], d[4 * i + 2 * r + 1]);
  }
}

// K12 at D = 256, persistent: grid min(units, SMs). A job is one 64-row q
// tile of one (head, batch row); a unit is the causal pair of q tiles
// n_qt - 1 - p and p (the middle tile of an odd n_qt alone), n_qt + 1 key
// tiles together, so units are of one size and block c takes units c,
// c + gridDim.x, ..., head by head (the blocks at work share a few heads'
// K and V in L2), the heavy tile of each first. Every role walks the same
// jobs. The producer warp's lane 0 copies each job's Q and dO once both
// warpgroups are done with the previous job's (its last score products),
// and the K and V tiles 0 .. the diagonal into rings of two stages each
// that run on from job to job (V first: a V stage is released once its
// dP product is done, a K stage once both dQ products that read it are),
// so the next job's copies overlap this job's last tile and its dQ
// store. Warpgroup 0 forms S = Q Kᵀ (m64n64, A and B K-major) and P =
// exp2(s · scale log2 e - lse log2 e), masked on the diagonal tile, and
// hands P in f32 to warpgroup 1 through shared memory (each thread's
// fragment where the same thread of warpgroup 1 holds dP's); warpgroup 1
// forms dP = dO Vᵀ, then dS = (dP - di) P · scale, and writes dS (bf16,
// one swizzled [row][key] panel, two buffers). Each adds dS K into its
// half of dQ's columns (A: the dS buffer, K-major; B: K's panels 2 w and
// 2 w + 1, MN-major) a tile late, issued after its next scores, so the
// two warpgroups' products and their exp2 and dS arithmetic overlap.
__global__ void __launch_bounds__(Sm90BwdD256::kDqThreads, 1)
    flash_dq_d256_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const BwdArgs a) {
  using T = __nv_bfloat16;
  using C = Sm90BwdD256;
  constexpr int ST = C::kStages, TL = C::kTile, PN = C::kPanel, NP = 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1k(smem_raw);  // Q
  unsigned char* sdo = sq + TL;            // dO
  unsigned char* sk = sdo + TL;            // [ST] K tiles
  unsigned char* sv = sk + ST * TL;        // [ST] V tiles
  unsigned char* sds = sv + ST * TL;       // [2] dS tiles
  float4* sp = reinterpret_cast<float4*>(sds + 2 * C::kPTile);  // P, f32
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sp + 8 * 128);
  uint64_t* q_empty = q_full + 1;     // the job's score products are done
  uint64_t* k_full = q_empty + 1;     // [ST]: a stage's K has landed
  uint64_t* k_empty = k_full + ST;    // [ST]: its dQ products are done
  uint64_t* v_full = k_empty + ST;    // [ST]: a stage's V has landed
  uint64_t* v_empty = v_full + ST;    // [ST]: its dP product is done
  uint64_t* ds_full = v_empty + ST;   // [2]: dS written
  uint64_t* ds_empty = ds_full + 2;   // [2]: its dQ products are done
  uint64_t* p_full = ds_empty + 2;    // P written
  uint64_t* p_empty = p_full + 1;     // P read

  const int S = a.S, n_qt = (S + 63) / 64, n_p = (n_qt + 1) / 2;
  const int H = a.Hkv * a.n_rep, units = n_p * H * a.B;
  if (threadIdx.x == 0) {
    sm::mbar_init(q_full, 1);
    sm::mbar_init(q_empty, 2 * 128);
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(k_full + s, 1);
      sm::mbar_init(k_empty + s, 2 * 128);
      sm::mbar_init(v_full + s, 1);
      sm::mbar_init(v_empty + s, 128);
    }
    for (int s = 0; s < 2; ++s) {
      sm::mbar_init(ds_full + s, 128);
      sm::mbar_init(ds_empty + s, 2 * 128);
    }
    sm::mbar_init(p_full, 128);
    sm::mbar_init(p_empty, 128);
    sm::mbar_fence_init();
  }
  __syncthreads();
  // the block's jobs in order: f(q tile, head, batch row) for each
  auto for_jobs = [&](auto f) {
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int p = u % n_p, hb = u / n_p;
      f(n_qt - 1 - p, hb % H, hb / H);  // the heavy tile first
      if (p != n_qt - 1 - p) f(p, hb % H, hb / H);
    }
  };
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // the producer warp; one lane issues every copy
    if (threadIdx.x == 2 * 128) {
      sm::tma_prefetch(&tq);
      sm::tma_prefetch(&tdo);
      sm::tma_prefetch(&tk);
      sm::tma_prefetch(&tv);
      int k = 0, r = 0;  // jobs, ring position
      for_jobs([&](int qt, int h, int b) {
        const int hk = h / a.n_rep;
        if (k > 0) sm::mbar_wait(q_empty, (k - 1) & 1);
        sm::mbar_arrive_tx(q_full, 2 * TL);
        for (int p = 0; p < NP; ++p) {
          sm::tma_load_4d(sq + p * PN, &tq, q_full, 64 * p, 64 * qt, h, b);
          sm::tma_load_4d(sdo + p * PN, &tdo, q_full, 64 * p, 64 * qt, h,
                          b);
        }
        for (int j = 0; j <= qt; ++j, ++r) {
          const int s = r % ST;
          if (r >= ST) sm::mbar_wait(v_empty + s, (r / ST - 1) & 1);
          sm::mbar_arrive_tx(v_full + s, TL);
          for (int p = 0; p < NP; ++p)
            sm::tma_load_4d(sv + s * TL + p * PN, &tv, v_full + s, 64 * p,
                            64 * j, hk, b);
          if (r >= ST) sm::mbar_wait(k_empty + s, (r / ST - 1) & 1);
          sm::mbar_arrive_tx(k_full + s, TL);
          for (int p = 0; p < NP; ++p)
            sm::tma_load_4d(sk + s * TL + p * PN, &tk, k_full + s, 64 * p,
                            64 * j, hk, b);
        }
        ++k;
      });
    }
    return;
  }

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2;
  float dq[64];  // dQ: the thread's rows by the warpgroup's 128 columns
  // dQ += dS K over ring position r's dS buffer and K stage (this
  // warpgroup's panels), issued and committed
  auto dq_product = [&](int r) {
    const uint64_t dsd = sm::desc_k(sds + (r & 1) * C::kPTile);
    const uint64_t dkm = sm::desc_mn<64>(sk + (r % ST) * TL + 2 * wg * PN);
    sm::fence_regs(dq);
    sm::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm::wgmma_ss_n128_mn(dq, dsd + sm::step_k<64>(kk),
                           dkm + sm::step_mn(kk));
    sm::wg_commit();
  };
  // position r's dQ product is done: release its stage and buffer
  auto dq_done = [&](int r) {
    sm::wg_wait<0>();
    sm::fence_regs(dq);
    sm::mbar_arrive(k_empty + r % ST);
    sm::mbar_arrive(ds_empty + (r & 1));
  };
  const float sl2 = a.sm_scale * kLog2e;
  int k = 0, r = 0;  // jobs, ring position
  for_jobs([&](int qt, int h, int b) {
    const int q0 = 64 * qt, n_kt = qt + 1;
    const long long srow = (static_cast<long long>(b) * H + h) * S;
    float st[2];  // warpgroup 0: its rows' lse log2 e; 1: their di
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + warp * 16 + g + 8 * i;
      st[i] = row >= S ? 0.f : wg == 0 ? a.lse[srow + row] * kLog2e
                                       : a.di[srow + row];
    }
    zero(dq);
    sm::mbar_wait(q_full, k & 1);
    if (wg == 0) {  // S and P
      const uint64_t dqd = sm::opaque(sm::desc_k(sq));
      for (int j = 0; j < n_kt; ++j, ++r) {
        const int s = r % ST;
        sm::mbar_wait(k_full + s, (r / ST) & 1);
        float sc[32];
        sm::fence_regs(sc);
        const uint64_t dkd = sm::desc_k(sk + s * TL);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)  // kk = 0 overwrites sc
          sm::wgmma_ss_n64(sc, dqd + sm::step_k<64>(kk),
                           dkd + sm::step_k<64>(kk), kk);
        sm::wg_commit();
        if (j > 0) {
          sm::mbar_wait(ds_full + ((r - 1) & 1), ((r - 1) >> 1) & 1);
          dq_product(r - 1);
          sm::wg_wait<1>();  // S is in; dQ runs on
        } else {
          sm::wg_wait<0>();
        }
        sm::fence_regs(sc);
        if (j == qt) sm::mbar_arrive(q_empty);  // the job's last S
        d256_p(sc, st, sl2, j == qt);
        if (r > 0) sm::mbar_wait(p_empty, (r - 1) & 1);
        d256_hand(sp, sc);
        sm::mbar_arrive(p_full);
        if (j > 0) dq_done(r - 1);
      }
    } else {  // dP and dS
      const uint64_t ddo = sm::opaque(sm::desc_k(sdo));
      for (int j = 0; j < n_kt; ++j, ++r) {
        const int s = r % ST;
        sm::mbar_wait(v_full + s, (r / ST) & 1);
        float dp[32];
        sm::fence_regs(dp);
        const uint64_t dvd = sm::desc_k(sv + s * TL);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)  // kk = 0 overwrites dp
          sm::wgmma_ss_n64(dp, ddo + sm::step_k<64>(kk),
                           dvd + sm::step_k<64>(kk), kk);
        sm::wg_commit();
        if (j > 0) {
          // K of position r - 1 (landed before warpgroup 0 scored it)
          sm::mbar_wait(k_full + (r - 1) % ST, ((r - 1) / ST) & 1);
          dq_product(r - 1);
          sm::wg_wait<1>();  // dP is in; dQ runs on
        } else {
          sm::wg_wait<0>();
        }
        sm::fence_regs(dp);
        sm::mbar_arrive(v_empty + s);
        if (j == qt) sm::mbar_arrive(q_empty);  // the job's last dP
        sm::mbar_wait(p_full, r & 1);
        d256_ds(dp, sp, st, a.sm_scale);
        sm::mbar_arrive(p_empty);
        if (r >= 2) sm::mbar_wait(ds_empty + (r & 1), ((r >> 1) - 1) & 1);
        d256_put(sds + (r & 1) * C::kPTile, dp);
        sm::fence_async_smem();  // dS is read by both warpgroups' wgmma
        sm::mbar_arrive(ds_full + (r & 1));
        if (j > 0) dq_done(r - 1);
      }
      sm::mbar_wait(k_full + (r - 1) % ST, ((r - 1) / ST) & 1);
    }
    // the job's last tile's dQ product, then dQ out
    sm::mbar_wait(ds_full + ((r - 1) & 1), ((r - 1) >> 1) & 1);
    dq_product(r - 1);
    dq_done(r - 1);
    d256_store<16>(static_cast<T*>(a.dq) + b * a.dqs[0] + h * a.dqs[1],
                   a.dqs[2], dq, q0, 128 * wg, S);
    ++k;
  });
}

// K11 at D = 256, persistent: grid min(units, SMs). A job is one 64-key
// tile of one (kv head, batch row); a unit is the pair of key tiles p and
// n - 1 - p (the middle tile of an odd n alone), n_rep (n + 1) q tiles
// together, so units are of one size and block c takes units c,
// c + gridDim.x, ..., the heavy key tile of each first. A job walks the
// kv head's query heads in order, for each the q tiles from the diagonal
// down. The third warpgroup's first thread copies each job's K and V once
// the previous job's last S and dP products are done, and the q tiles'
// Q and dO into rings of two stages each (Q and dO apart) that run on
// from job to job, a tile as soon as the stage it refills is released.
// Warpgroup 0 forms S = Q Kᵀ (m64n64, A and B K-major) and P = exp2(s ·
// scale log2 e - lse log2 e), masked on the diagonal tile, hands P in
// f32 to warpgroup 1 (each thread's fragment where the same thread of
// warpgroup 1 holds dP's) and writes it in bf16 (one swizzled [row][key]
// panel); warpgroup 1 forms dP = dO Vᵀ and dS = (dP - di) P · scale and
// writes dS the same way. Each of the two adds Pᵀ dO into its half of
// dV's columns (A: the P panel, MN-major; B: dO's panels 2 w and 2 w + 1,
// MN-major) a tile late, issued after its next scores; warpgroup 2 adds
// dSᵀ Q into all of dK (128 registers a thread). Each row's lse and di
// are read from global memory a tile ahead.
__global__ void __launch_bounds__(Sm90BwdD256::kDkvThreads, 1)
    flash_dkv_d256_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const BwdArgs a) {
  using T = __nv_bfloat16;
  using C = Sm90BwdD256;
  constexpr int ST = C::kStages, TL = C::kTile, PN = C::kPanel, NP = 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1k(smem_raw);  // K
  unsigned char* sv = sk + TL;             // V
  unsigned char* sq = sv + TL;             // [ST] Q tiles
  unsigned char* sdo = sq + ST * TL;       // [ST] dO tiles
  unsigned char* sp = sdo + ST * TL;       // P, bf16
  unsigned char* sds = sp + C::kPTile;     // dS, bf16
  float4* spf = reinterpret_cast<float4*>(sds + C::kPTile);  // P, f32
  uint64_t* k_full = reinterpret_cast<uint64_t*>(spf + 8 * 128);
  uint64_t* k_empty = k_full + 1;   // the job's S products are done
  uint64_t* v_full = k_empty + 1;
  uint64_t* v_empty = v_full + 1;   // the job's dP products are done
  uint64_t* q_full = v_empty + 1;   // [ST]: a stage's Q has landed
  uint64_t* q_empty = q_full + ST;  // [ST]: its S and dK products are done
  uint64_t* o_full = q_empty + ST;  // [ST]: a stage's dO has landed
  uint64_t* o_empty = o_full + ST;  // [ST]: its dV products are done
  uint64_t* pf_full = o_empty + ST;  // P (f32) written
  uint64_t* pf_empty = pf_full + 1;  // P (f32) read
  uint64_t* p_full = pf_empty + 1;   // P (bf16) written
  uint64_t* p_empty = p_full + 1;    // its dV products are done
  uint64_t* ds_full = p_empty + 1;   // dS written
  uint64_t* ds_empty = ds_full + 1;  // its dK product is done

  const int S = a.S, n = (S + 63) / 64, n_p = (n + 1) / 2;
  const int H = a.Hkv * a.n_rep, units = n_p * a.Hkv * a.B;
  if (threadIdx.x == 0) {
    sm::mbar_init(k_full, 1);
    sm::mbar_init(k_empty, 128);
    sm::mbar_init(v_full, 1);
    sm::mbar_init(v_empty, 128);
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(q_full + s, 1);
      sm::mbar_init(q_empty + s, 2 * 128);
      sm::mbar_init(o_full + s, 1);
      sm::mbar_init(o_empty + s, 2 * 128);
    }
    sm::mbar_init(pf_full, 128);
    sm::mbar_init(pf_empty, 128);
    sm::mbar_init(p_full, 128);
    sm::mbar_init(p_empty, 2 * 128);
    sm::mbar_init(ds_full, 128);
    sm::mbar_init(ds_empty, 128);
    sm::mbar_fence_init();
  }
  __syncthreads();
  // The block's jobs: job (u, half) is key tile kt_of(u, half) of kv head
  // u / n_p % Hkv, batch row u / n_p / Hkv, while u < units; its walk is
  // n_rep (n - kt) q tiles, tile i of query head h0 + i / (n - kt), q
  // tile kt + i % (n - kt).
  auto kt_of = [&](int u, int half) {
    return half == 0 ? u % n_p : n - 1 - u % n_p;
  };
  auto next_job = [&](int& u, int& half) {
    if (half == 0 && kt_of(u, 1) != kt_of(u, 0)) {
      half = 1;
    } else {
      u += gridDim.x;
      half = 0;
    }
  };
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // dK += dSᵀ Q over every q tile; its first thread copies
    const bool issuer = threadIdx.x == 2 * 128;
    // the issuer's cursor: the next tile to copy (job (iu, ih), tile ii,
    // ring position ir) and the jobs whose K and V it has copied
    int iu = blockIdx.x, ih = 0, ii = 0, ir = 0, ik = 0;
    auto issue_next = [&] {
      if (iu >= units) return;
      const int kt = kt_of(iu, ih), hb = iu / n_p, per = n - kt;
      const int hk = hb % a.Hkv, b = hb / a.Hkv;
      if (ii == 0) {  // the job's K and V, once the last one's are free
        if (ik > 0) {
          sm::mbar_wait(k_empty, (ik - 1) & 1);
          sm::mbar_wait(v_empty, (ik - 1) & 1);
        }
        sm::mbar_arrive_tx(k_full, TL);
        sm::mbar_arrive_tx(v_full, TL);
        for (int p = 0; p < NP; ++p) {
          sm::tma_load_4d(sk + p * PN, &tk, k_full, 64 * p, 64 * kt, hk, b);
          sm::tma_load_4d(sv + p * PN, &tv, v_full, 64 * p, 64 * kt, hk, b);
        }
        ++ik;
      }
      const int s = ir % ST, h = hk * a.n_rep + ii / per;
      const int q0 = 64 * (kt + ii % per);
      if (ir >= ST) sm::mbar_wait(q_empty + s, (ir / ST - 1) & 1);
      sm::mbar_arrive_tx(q_full + s, TL);
      for (int p = 0; p < NP; ++p)
        sm::tma_load_4d(sq + s * TL + p * PN, &tq, q_full + s, 64 * p, q0, h,
                        b);
      if (ir >= ST) sm::mbar_wait(o_empty + s, (ir / ST - 1) & 1);
      sm::mbar_arrive_tx(o_full + s, TL);
      for (int p = 0; p < NP; ++p)
        sm::tma_load_4d(sdo + s * TL + p * PN, &tdo, o_full + s, 64 * p, q0,
                        h, b);
      ++ir;
      if (++ii == a.n_rep * per) {
        ii = 0;
        next_job(iu, ih);
      }
    };
    if (issuer) {
      sm::tma_prefetch(&tq);
      sm::tma_prefetch(&tdo);
      sm::tma_prefetch(&tk);
      sm::tma_prefetch(&tv);
      issue_next();
      issue_next();
    }
    float dk[128];
    int r = 0;  // ring position
    for (int u = blockIdx.x, half = 0; u < units; next_job(u, half)) {
      const int kt = kt_of(u, half), hb = u / n_p;
      const int n_it = a.n_rep * (n - kt);
      zero(dk);
      for (int it = 0; it < n_it; ++it, ++r) {
        const int s = r % ST;
        sm::mbar_wait(q_full + s, (r / ST) & 1);
        sm::mbar_wait(ds_full, r & 1);
        const uint64_t dsd = sm::desc_mn<64>(sds);
        const uint64_t dqm = sm::desc_mn<64>(sq + s * TL);
        sm::fence_regs(dk);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          sm::wgmma_ss_n256_tt(dk, dsd + sm::step_mn(kk),
                               dqm + sm::step_mn(kk));
        sm::wg_commit();
        sm::wg_wait<0>();
        sm::fence_regs(dk);
        sm::mbar_arrive(ds_empty);
        sm::mbar_arrive(q_empty + s);
        if (issuer) issue_next();
      }
      d256_store<32>(static_cast<T*>(a.dk) + (hb / a.Hkv) * a.dks[0] +
                         (hb % a.Hkv) * a.dks[1],
                     a.dks[2], dk, 64 * kt, 0, S);
    }
    return;
  }

  // warpgroups 0 (S, P) and 1 (dP, dS): dV's columns [128 wg, 128 wg +
  // 128)
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2;
  float dv[64];
  // dV += Pᵀ dO over ring position r's dO stage (this warpgroup's
  // panels), issued and committed
  auto dv_product = [&](int r) {
    const uint64_t dpm = sm::desc_mn<64>(sp);
    const uint64_t dom = sm::desc_mn<64>(sdo + (r % ST) * TL + 2 * wg * PN);
    sm::fence_regs(dv);
    sm::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm::wgmma_ss_n128_tt(dv, dpm + sm::step_mn(kk), dom + sm::step_mn(kk));
    sm::wg_commit();
  };
  // position r's dV product is done: release its dO stage and P
  auto dv_done = [&](int r) {
    sm::wg_wait<0>();
    sm::fence_regs(dv);
    sm::mbar_arrive(o_empty + r % ST);
    sm::mbar_arrive(p_empty);
  };
  const float sl2 = a.sm_scale * kLog2e;
  int r = 0, k = 0;  // ring position, jobs
  for (int u = blockIdx.x, half = 0; u < units; next_job(u, half), ++k) {
    const int kt = kt_of(u, half), hb = u / n_p, per = n - kt;
    const int hk = hb % a.Hkv, b = hb / a.Hkv, n_it = a.n_rep * per;
    // warpgroup 0: the thread's two rows' lse log2 e in tile `it`; 1:
    // their di
    auto stats = [&](int it, float (&x)[2]) {
      const long long srow =
          (static_cast<long long>(b) * H + hk * a.n_rep + it / per) * S;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 64 * (kt + it % per) + warp * 16 + g + 8 * i;
        x[i] = row >= S ? 0.f : wg == 0 ? a.lse[srow + row] * kLog2e
                                        : a.di[srow + row];
      }
    };
    float st[2];
    stats(0, st);
    zero(dv);
    if (wg == 0) {  // S and P
      sm::mbar_wait(k_full, k & 1);
      const uint64_t dkd = sm::opaque(sm::desc_k(sk));
      for (int it = 0; it < n_it; ++it, ++r) {
        const int s = r % ST;
        float nst[2] = {0.f, 0.f};  // the next tile's
        if (it + 1 < n_it) stats(it + 1, nst);
        sm::mbar_wait(q_full + s, (r / ST) & 1);
        float sc[32];
        sm::fence_regs(sc);
        const uint64_t dqd = sm::desc_k(sq + s * TL);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)  // kk = 0 overwrites sc
          sm::wgmma_ss_n64(sc, dqd + sm::step_k<64>(kk),
                           dkd + sm::step_k<64>(kk), kk);
        sm::wg_commit();
        if (it > 0) {
          sm::mbar_wait(o_full + (r - 1) % ST, ((r - 1) / ST) & 1);
          dv_product(r - 1);
          sm::wg_wait<1>();  // S is in; dV runs on
        } else {
          sm::wg_wait<0>();
        }
        sm::fence_regs(sc);
        sm::mbar_arrive(q_empty + s);
        if (it == n_it - 1) sm::mbar_arrive(k_empty);  // the job's last S
        d256_p(sc, st, sl2, it % per == 0);
        if (r > 0) sm::mbar_wait(pf_empty, (r - 1) & 1);
        d256_hand(spf, sc);
        sm::mbar_arrive(pf_full);
        if (it > 0) dv_done(r - 1);
        // both dV products of position r - 1 are done with P
        if (r > 0) sm::mbar_wait(p_empty, (r - 1) & 1);
        d256_put(sp, sc);
        sm::fence_async_smem();  // P is read by both warpgroups' wgmma
        sm::mbar_arrive(p_full);
        st[0] = nst[0];
        st[1] = nst[1];
      }
    } else {  // dP and dS
      sm::mbar_wait(v_full, k & 1);
      const uint64_t dvd = sm::opaque(sm::desc_k(sv));
      for (int it = 0; it < n_it; ++it, ++r) {
        const int s = r % ST;
        float nst[2] = {0.f, 0.f};  // the next tile's
        if (it + 1 < n_it) stats(it + 1, nst);
        sm::mbar_wait(o_full + s, (r / ST) & 1);
        float dp[32];
        sm::fence_regs(dp);
        const uint64_t ddo = sm::desc_k(sdo + s * TL);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)  // kk = 0 overwrites dp
          sm::wgmma_ss_n64(dp, ddo + sm::step_k<64>(kk),
                           dvd + sm::step_k<64>(kk), kk);
        sm::wg_commit();
        if (it > 0) {
          sm::mbar_wait(p_full, (r - 1) & 1);
          dv_product(r - 1);
        }
        sm::wg_wait<0>();  // dP, and the previous tile's dV product
        sm::fence_regs(dp);
        if (it == n_it - 1) sm::mbar_arrive(v_empty);  // the job's last dP
        if (it > 0) dv_done(r - 1);
        sm::mbar_wait(pf_full, r & 1);
        d256_ds(dp, spf, st, a.sm_scale);
        sm::mbar_arrive(pf_empty);
        if (r > 0) sm::mbar_wait(ds_empty, (r - 1) & 1);
        d256_put(sds, dp);
        sm::fence_async_smem();  // dS is read by warpgroup 2's wgmma
        sm::mbar_arrive(ds_full);
        st[0] = nst[0];
        st[1] = nst[1];
      }
      sm::mbar_wait(p_full, (r - 1) & 1);
    }
    // the job's last tile's dV product, then dV out
    sm::mbar_wait(o_full + (r - 1) % ST, ((r - 1) / ST) & 1);
    dv_product(r - 1);
    dv_done(r - 1);
    d256_store<16>(static_cast<T*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1],
                   a.dvs[2], dv, 64 * kt, 128 * wg, S);
  }
}

// K11 (dkv) or K12 at D = 256 on the Hopper kernels: the four operands'
// tensor maps (64-row boxes), then the launch on a linear grid.
cudaError_t launch_bwd_d256(bool dkv, int B, int H, int Hkv,
                            const BwdArgs& a, cudaStream_t st) {
  using C = Sm90BwdD256;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm::tensor_map_bhsd(&tq, a.q, B, H, a.S, C::D, a.qs, 64) ||
      !sm::tensor_map_bhsd(&tk, a.k, B, Hkv, a.S, C::D, a.ks, 64) ||
      !sm::tensor_map_bhsd(&tv, a.v, B, Hkv, a.S, C::D, a.vs, 64) ||
      !sm::tensor_map_bhsd(&tdo, a.dO, B, H, a.S, C::D, a.dos, 64))
    return cudaErrorInvalidValue;
  // one block an SM, or one a unit (a pair of tiles) where there are fewer
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long units =
      static_cast<long long>((a.S + 127) / 128) * (dkv ? Hkv : H) * B;
  const dim3 grid(static_cast<unsigned>(std::min<long long>(units, n_sm)));
  if (!dkv) {
    if ((e = set_smem<flash_dq_d256_kernel>(C::kDqSmem)) != cudaSuccess)
      return e;
    flash_dq_d256_kernel<<<grid, C::kDqThreads, C::kDqSmem, st>>>(
        tq, tk, tv, tdo, a);
    return cudaGetLastError();
  }
  if ((e = set_smem<flash_dkv_d256_kernel>(C::kDkvSmem)) != cudaSuccess)
    return e;
  flash_dkv_d256_kernel<<<grid, C::kDkvThreads, C::kDkvSmem, st>>>(
      tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

// K11 (dkv) or K12 on the FFMA kernels (f32).
template <int D>
cudaError_t launch_bwd_f32(bool dkv, int B, int H, int Hkv,
                           const BwdArgs& a, cudaStream_t st) {
  if (dkv) {
    using C = F32Dkv<D>;
    const dim3 grid(static_cast<unsigned>((a.S + C::BN - 1) / C::BN) * Hkv *
                    B);
    return launch<flash_dkv_f32_kernel<D>>(C::kSmem, grid, a, st, C::NT);
  }
  using C = F32Dq<D>;
  const dim3 grid(static_cast<unsigned>((a.S + C::BM - 1) / C::BM) * H * B);
  return launch<flash_dq_f32_kernel<D>>(C::kSmem, grid, a, st, C::NT);
}

// ---- K10 on Hopper: bf16, D = 64 or 128 -----------------------------------
//
// A block is two consumer warpgroups and one producer warp (288 threads) on
// a 128-row q tile; K/V stream through a ring of 128-key stages. See the
// design note at the top of the file.

template <int D>
struct Sm90Fwd {
  static constexpr int kWG = 2;                      // consumer warpgroups
  static constexpr int kThreads = kWG * 128 + 32;    // + the producer warp
  static constexpr int kRows = 64 * kWG;             // q rows a job
  static constexpr int kKeys = 128;                  // keys a ring stage
  static constexpr int kQTile = 64 * D * 2;          // a warpgroup's Q
  static constexpr int kQPanel = 64 * 128;           // a 64-row panel
  static constexpr int kKvTile = kKeys * D * 2;      // a K or V tile
  static constexpr int kKvPanel = kKeys * 128;       // a 128-row panel
  // ring depth: as many stages as fit beside Q (225 of 227 KB at D = 128;
  // D = 256 runs flash_fwd_d256_kernel)
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kBars = 2 + 3 * kStages;  // Q full/empty; K, V, empty
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kWG) * kQTile +
      static_cast<size_t>(2 * kStages) * kKvTile + kBars * 8 +
      4 * sizeof(int);  // + the published jobs
  static_assert(kKeys == kRows, "the diagonal key tile is the q tile's");
  static_assert(D <= 128, "D = 256 runs flash_fwd_d256_kernel");
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// K10, persistent: grid min(units, SMs). A job is one 128-row q tile of
// one (head, batch row); a unit is the causal pair of q tiles n_qt - 1 - p
// and p (the middle tile of an odd n_qt alone), n_qt + 1 key tiles
// together, so units are of one size and block c takes units c,
// c + gridDim.x, ... balanced without atomics. Units go head by head, so
// the blocks at work at any time share the K and V of a few heads, read
// from HBM about once. The producer's lane 0 walks the block's jobs: per
// job it publishes (q tile, head) beside Q's barrier and copies Q (two
// 64-row tiles) once the previous job's last score product has read the
// old one, then K and V tiles 0 .. the diagonal into the ring (each with
// its own barrier, so the scores start before V lands); the next job's
// copies run during this one's last tiles and epilogue, and a q tile of
// -1 ends the block. Warpgroup w owns q rows [q0 + 64 w, q0 + 64 w + 64)
// of a job; per tile: S = Q Kᵀ (both operands K-major from shared memory,
// 64 x 128 f32), the diagonal tile masked, the running max m of the raw
// scores, P = exp2(s c - m c) with c = sm_scale log2 e, O and l rescaled
// by exp2(m_old c - m c), P rounded to bf16 in registers as the A operand
// of O += P V (V read MN-major from the same stage). O / l at the job's
// end (rows with l = 0 stay 0), stored through the output's strides; with
// kLse also each row's m sm_scale + log(l).
template <int D, bool kLse>
__global__ void __launch_bounds__(Sm90Fwd<D>::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Args a) {
  using T = __nv_bfloat16;
  using C = Sm90Fwd<D>;
  constexpr int WG = C::kWG, ST = C::kStages, QT = C::kQTile,
                KVT = C::kKvTile, NP = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1k(smem_raw);  // [WG] Q tiles
  unsigned char* sk = sq + WG * QT;        // [ST] K tiles
  unsigned char* sv = sk + ST * KVT;       // [ST] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + ST * KVT);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;  // [ST]: a stage's K has landed
  uint64_t* v_full = k_full + ST;  // [ST]: its V has
  uint64_t* empty = v_full + ST;   // [ST]: both warpgroups are done with it
  // [2][2]: a job's q tile and (batch row, head), published with its Q
  int* job = reinterpret_cast<int*>(empty + ST);

  const int S = a.S, H = a.H;
  if (threadIdx.x == 0) {
    sm::mbar_init(q_full, 1);
    sm::mbar_init(q_empty, WG * 128);
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(k_full + s, 1);
      sm::mbar_init(v_full + s, 1);
      sm::mbar_init(empty + s, WG * 128);
    }
    sm::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == WG) {  // the producer warp; one lane issues every copy
    if (threadIdx.x == WG * 128) {
      sm::tma_prefetch(&tq);
      sm::tma_prefetch(&tk);
      sm::tma_prefetch(&tv);
      const int n_qt = (S + C::kRows - 1) / C::kRows, n_p = (n_qt + 1) / 2;
      int it = 0, k = 0;  // ring position, jobs published
      for (int u = blockIdx.x; u < n_p * H * a.B; u += gridDim.x) {
        const int p = u % n_p, hb = u / n_p;
        const int h = hb % H, b = hb / H, hk = h / a.n_rep;
        for (int half = 0; half < 2; ++half) {  // the heavy tile first
          const int qt = half == 0 ? n_qt - 1 - p : p;
          if (half == 1 && p == n_qt - 1 - p) continue;  // odd n_qt's middle
          if (k > 0) sm::mbar_wait(q_empty, (k - 1) & 1);
          job[2 * (k & 1)] = qt;  // read by the consumers after q_full
          job[2 * (k & 1) + 1] = hb;
          sm::mbar_arrive_tx(q_full, WG * QT);
          for (int w = 0; w < WG; ++w)
            for (int pn = 0; pn < NP; ++pn)
              sm::tma_load_4d(sq + w * QT + pn * C::kQPanel, &tq, q_full,
                              64 * pn, qt * C::kRows + 64 * w, h, b);
          for (int j = 0; j <= qt; ++j, ++it) {
            const int s = it % ST;
            if (it >= ST) sm::mbar_wait(empty + s, (it / ST - 1) & 1);
            sm::mbar_arrive_tx(k_full + s, KVT);
            for (int pn = 0; pn < NP; ++pn)
              sm::tma_load_4d(sk + s * KVT + pn * C::kKvPanel, &tk,
                              k_full + s, 64 * pn, C::kKeys * j, hk, b);
            sm::mbar_arrive_tx(v_full + s, KVT);
            for (int pn = 0; pn < NP; ++pn)
              sm::tma_load_4d(sv + s * KVT + pn * C::kKvPanel, &tv,
                              v_full + s, 64 * pn, C::kKeys * j, hk, b);
          }
          ++k;
        }
      }
      if (k > 0) sm::mbar_wait(q_empty, (k - 1) & 1);
      job[2 * (k & 1)] = -1;  // no more jobs
      sm::mbar_arrive(q_full);
    }
    return;
  }

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float c = a.sm_scale * kLog2e;
  const unsigned char* qw = sq + wg * QT;
  float o[D / 2];
  // O += P V over ring position r's V (once it has landed), P the
  // previous tile's, then the wait.
  auto pv = [&](const uint32_t (&pa)[C::kKeys / 16][4], int r) {
    const int s = r % ST;
    sm::mbar_wait(v_full + s, (r / ST) & 1);
    const uint64_t dvt = sm::desc_mn<C::kKeys>(sv + s * KVT);
    sm::fence_regs(o);
    sm::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::kKeys / 16; ++kk)
      sm::wgmma_rs<D>(o, pa[kk], dvt + sm::step_mn(kk));
    sm::wg_commit();
    sm::wg_wait<0>();
    sm::fence_regs(o);
  };
  // Ping-pong (FA3's order): on its turn a warpgroup issues the previous
  // tile's O += P V and this tile's S = Q Kᵀ, then gives the turn to the
  // other (named barrier 1 + w is warpgroup w's turn) and forms this
  // tile's P while the other's products hold the tensor cores. P is
  // consumed before S is written, so the two never hold registers
  // together. Warpgroup 1 lets 0 go first; 0 takes the turn 1 gives
  // after its last tile once the block is done, so every turn given is
  // taken. A stage is released after its V has been read, Q after the
  // job's last score product.
  constexpr int kTurn = 2 * 128;
  if (wg == 1) sm::bar_arrive(1, kTurn);
  int it = 0;  // ring position
  for (int k = 0;; ++k) {  // the jobs the producer publishes, in order
    sm::mbar_wait(q_full, k & 1);
    const int qt = job[2 * (k & 1)];
    if (qt < 0) break;
    const int r0 = qt * C::kRows + 64 * wg;  // the warpgroup's first row
    const bool live = r0 < S;
    zero(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t pa[C::kKeys / 16][4];  // the previous tile's P, bf16
    for (int j = 0; j <= qt; ++j, ++it) {
      const int s = it % ST, prev = (it + ST - 1) % ST;
      sm::mbar_wait(k_full + s, (it / ST) & 1);
      sm::bar_sync(1 + wg, kTurn);
      if (!live) {
        sm::bar_arrive(2 - wg, kTurn);
        if (j > 0) sm::mbar_arrive(empty + prev);
        if (j == qt) sm::mbar_arrive(q_empty);
      } else {
        if (j > 0) {
          pv(pa, it - 1);
          sm::mbar_arrive(empty + prev);
        }
        float sc[64];
        sm::fence_regs(sc);
        const uint64_t dqw = sm::opaque(sm::desc_k(qw));
        const uint64_t dkt = sm::desc_k(sk + s * KVT);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // kk = 0 overwrites sc
          sm::wgmma_ss_n128(sc, dqw + sm::step_k<64>(kk),
                            dkt + sm::step_k<C::kKeys>(kk), kk);
        sm::wg_commit();
        sm::bar_arrive(2 - wg, kTurn);
        sm::wg_wait<0>();
        sm::fence_regs(sc);
        if (j == qt) {  // the diagonal tile: keys above each row masked
          sm::mbar_arrive(q_empty);
          const int rel = sm::opaque(64 * wg + warp * 16 + g - 2 * t4);
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * i + (e & 1) > rel + 8 * (e >> 1))
                sc[4 * i + e] = -INFINITY;
        }
        // rows g and g + 8 of the warp's 16: max across the quad's lanes
        float sh[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int i = 0; i < 16; ++i)
            mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          sh[r] = shift_of(mx) * c;
          alpha[r] = sm::exp2_ftz(m[r] * c - sh[r]);
          m[r] = mx;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe =
                sm::exp2_ftz(fmaf(sc[4 * i + e], c, -sh[e >> 1]));
            rs[e >> 1] += pe;
            sc[4 * i + e] = pe;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        acc_to_a(pa, sc);
        sm::fence_regs(pa);
      }
    }
    if (live) pv(pa, it - 1);
    sm::mbar_arrive(empty + (it - 1) % ST);
    if (!live) continue;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
    }
    const int hb = job[2 * (k & 1) + 1];  // read here, not held
    const int h = hb % H, b = hb / H;
    T* og = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + warp * 16 + g + 8 * r;
      if (row >= S) continue;
      if (kLse && t4 == 0)
        a.lse[(static_cast<long long>(b) * H + h) * S + row] =
            m[r] * a.sm_scale + logf(l[r]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(og + row * a.os[2] + 8 * i + 2 * t4) =
            pack_bf16(o[4 * i + 2 * r] * inv[r],
                      o[4 * i + 2 * r + 1] * inv[r]);
    }
  }
  if (wg == 0) sm::bar_sync(1, kTurn);
}

template <int D, bool kLse>
cudaError_t launch_fwd_sm90_k(const CUtensorMap& tq, const CUtensorMap& tk,
                              const CUtensorMap& tv, dim3 grid,
                              const Args& a, cudaStream_t st) {
  using C = Sm90Fwd<D>;
  const cudaError_t e = set_smem<flash_fwd_sm90_kernel<D, kLse>>(C::kSmem);
  if (e != cudaSuccess) return e;
  flash_fwd_sm90_kernel<D, kLse><<<grid, C::kThreads, C::kSmem, st>>>(
      tq, tk, tv, a);
  return cudaGetLastError();
}

// K10 on the Hopper kernel: Q's tensor map in 64-row boxes, K's and V's in
// 128-row boxes, then the launch (the kLse instantiation where lse is
// given).
template <int D>
cudaError_t launch_fwd_sm90(int B, int H, int Hkv, const Args& a,
                            cudaStream_t st) {
  using C = Sm90Fwd<D>;
  CUtensorMap tq, tk, tv;
  if (!sm::tensor_map_bhsd(&tq, a.q, B, H, a.S, D, a.qs, 64) ||
      !sm::tensor_map_bhsd(&tk, a.k, B, Hkv, a.S, D, a.ks, C::kKeys) ||
      !sm::tensor_map_bhsd(&tv, a.v, B, Hkv, a.S, D, a.vs, C::kKeys))
    return cudaErrorInvalidValue;
  // one block an SM, or one a unit (a causal pair of q tiles) where there
  // are fewer
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_qt = (a.S + C::kRows - 1) / C::kRows;
  const long long units = static_cast<long long>((n_qt + 1) / 2) * H * B;
  const dim3 grid(static_cast<unsigned>(std::min<long long>(units, n_sm)));
  return a.lse == nullptr ? launch_fwd_sm90_k<D, false>(tq, tk, tv, grid, a, st)
                          : launch_fwd_sm90_k<D, true>(tq, tk, tv, grid, a, st);
}

// ---- K10 on Hopper: bf16, D = 256 ------------------------------------------
//
// O of 64 rows is 128 f32 registers a thread at D = 256, so no warpgroup
// can hold it beside a score tile within the 168 registers a thread of a
// 288-thread block. The two consumer warpgroups take one 64-row q tile
// and split O by columns: the first forms S = Q Kᵀ and P and hands P to
// the second through shared memory; each adds P V into its 128 columns.
// See the design note at the top of the file.

struct Sm90FwdD256 {
  static constexpr int D = 256;
  static constexpr int kThreads = 2 * 128 + 32;  // + the producer warp
  static constexpr int kRows = 64;               // q rows a job
  static constexpr int kKeys = 64;               // keys a ring stage
  static constexpr int kTile = 64 * D * 2;       // a Q, K or V tile
  static constexpr int kPanel = 64 * 128;        // one of its 4 panels
  static constexpr int kPTile = 64 * 64 * 2;     // P, bf16
  static constexpr int kKStages = 3, kVStages = 2, kPBufs = 2;
  // Q full/empty; K full/empty, V full/empty, P full/empty
  static constexpr int kBars = 2 + 2 * (kKStages + kVStages + kPBufs);
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(1 + kKStages + kVStages) * kTile +
      static_cast<size_t>(kPBufs) * kPTile +
      static_cast<size_t>(kPBufs) * (2 * 64 + 4) * sizeof(float) +
      kBars * 8 + 4 * sizeof(int);
  static_assert(kKeys == kRows, "the diagonal key tile is the q tile's");
  static_assert(kSmem <= 232448, "over a block's shared memory");
};

// K10 at D = 256, persistent as flash_fwd_sm90_kernel: one block an SM
// walks causal pairs of 64-row q tiles, head by head. The producer's lane
// 0 publishes each job beside Q's barrier and copies Q once the previous
// job's last score product has read it, then K tiles into a ring of 3 and
// V tiles into a ring of 2, 0 .. the diagonal. The score warpgroup (0)
// forms per key tile S = Q Kᵀ (64 x 64 f32, both operands K-major from
// shared memory), the diagonal tile masked, the running max m of the raw
// scores, P = exp2(s c - m c) with c = sm_scale log2 e and the rescale
// exp2(m_old c - m c), and hands P (bf16, a 128-byte-swizzled K-major
// panel), the rescale and the tile's job over to warpgroup 1 in one of two
// buffers (at a job's last tile also 1 / l; with kLse it writes m sm_scale
// + log l); then it rescales its O (columns 0-127) and adds P V with P
// rounded to bf16 in registers as the A operand. Warpgroup 1 rescales its
// O (columns 128-255) and adds P V with P read from the buffer; both read
// V MN-major from the same stage. Each stores O / l at the job's last tile
// (rows with l = 0 stay 0).
template <bool kLse>
__global__ void __launch_bounds__(Sm90FwdD256::kThreads, 1)
    flash_fwd_d256_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Args a) {
  using T = __nv_bfloat16;
  using C = Sm90FwdD256;
  constexpr int KS = C::kKStages, VS = C::kVStages, TL = C::kTile,
                PN = C::kPanel, NP = C::D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1k(smem_raw);  // the job's Q tile
  unsigned char* sk = sq + TL;             // [KS] K tiles
  unsigned char* sv = sk + KS * TL;        // [VS] V tiles
  unsigned char* sp = sv + VS * TL;        // [2] P tiles
  // [2][64 rescales, 64 1 / l, 4 ints: q tile, batch row and head, key
  // tile, 0]: what goes with each P
  float* rec = reinterpret_cast<float*>(sp + C::kPBufs * C::kPTile);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(rec + C::kPBufs * 132);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;  // [KS]
  uint64_t* k_empty = k_full + KS;
  uint64_t* v_full = k_empty + KS;  // [VS]
  uint64_t* v_empty = v_full + VS;
  uint64_t* p_full = v_empty + VS;  // [2]
  uint64_t* p_empty = p_full + 2;
  int* job = reinterpret_cast<int*>(p_empty + 2);  // [2][2]

  const int S = a.S, H = a.H;
  if (threadIdx.x == 0) {
    sm::mbar_init(q_full, 1);
    sm::mbar_init(q_empty, 128);
    for (int s = 0; s < KS; ++s) {
      sm::mbar_init(k_full + s, 1);
      sm::mbar_init(k_empty + s, 128);
    }
    for (int s = 0; s < VS; ++s) {
      sm::mbar_init(v_full + s, 1);
      sm::mbar_init(v_empty + s, 2 * 128);
    }
    for (int s = 0; s < 2; ++s) {
      sm::mbar_init(p_full + s, 128);
      sm::mbar_init(p_empty + s, 128);
    }
    sm::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // the producer warp; one lane issues every copy
    if (threadIdx.x == 2 * 128) {
      sm::tma_prefetch(&tq);
      sm::tma_prefetch(&tk);
      sm::tma_prefetch(&tv);
      const int n_qt = (S + C::kRows - 1) / C::kRows, n_p = (n_qt + 1) / 2;
      int kp = 0, vp = 0, k = 0;  // ring positions, jobs published
      for (int u = blockIdx.x; u < n_p * H * a.B; u += gridDim.x) {
        const int p = u % n_p, hb = u / n_p;
        const int h = hb % H, b = hb / H, hk = h / a.n_rep;
        for (int half = 0; half < 2; ++half) {  // the heavy tile first
          const int qt = half == 0 ? n_qt - 1 - p : p;
          if (half == 1 && p == n_qt - 1 - p) continue;  // odd n_qt's middle
          if (k > 0) sm::mbar_wait(q_empty, (k - 1) & 1);
          job[2 * (k & 1)] = qt;  // read by the score warpgroup after q_full
          job[2 * (k & 1) + 1] = hb;
          sm::mbar_arrive_tx(q_full, TL);
          for (int pn = 0; pn < NP; ++pn)
            sm::tma_load_4d(sq + pn * PN, &tq, q_full, 64 * pn,
                            qt * C::kRows, h, b);
          for (int j = 0; j <= qt; ++j, ++kp, ++vp) {
            const int s = kp % KS, v = vp % VS;
            if (kp >= KS) sm::mbar_wait(k_empty + s, (kp / KS - 1) & 1);
            sm::mbar_arrive_tx(k_full + s, TL);
            for (int pn = 0; pn < NP; ++pn)
              sm::tma_load_4d(sk + s * TL + pn * PN, &tk, k_full + s,
                              64 * pn, C::kKeys * j, hk, b);
            if (vp >= VS) sm::mbar_wait(v_empty + v, (vp / VS - 1) & 1);
            sm::mbar_arrive_tx(v_full + v, TL);
            for (int pn = 0; pn < NP; ++pn)
              sm::tma_load_4d(sv + v * TL + pn * PN, &tv, v_full + v,
                              64 * pn, C::kKeys * j, hk, b);
          }
          ++k;
        }
      }
      if (k > 0) sm::mbar_wait(q_empty, (k - 1) & 1);
      job[2 * (k & 1)] = -1;  // no more jobs
      sm::mbar_arrive(q_full);
    }
    return;
  }

  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;  // the thread's rows row0 and row0 + 8
  const int col0 = 128 * wg;  // the warpgroup's first column of O
  float o[64];  // O: the thread's rows by the warpgroup's 128 columns
  // O / l into the output's rows of q tile qt (rows past S not stored)
  auto store_o = [&](int qt, int hb, const float (&inv)[2]) {
    const int h = hb % H, b = hb / H;
    T* og = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1] + col0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * C::kRows + row0 + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<uint32_t*>(og + row * a.os[2] + 8 * i + 2 * t4) =
            pack_bf16(o[4 * i + 2 * r] * inv[r],
                      o[4 * i + 2 * r + 1] * inv[r]);
    }
  };
  if (wg == 0) {  // the score warpgroup
    const float c = a.sm_scale * kLog2e;
    int kp = 0, vp = 0, pp = 0;  // ring positions, P buffers handed over
    for (int k = 0;; ++k) {  // the jobs the producer publishes, in order
      sm::mbar_wait(q_full, k & 1);
      const int qt = job[2 * (k & 1)];
      const int hb = job[2 * (k & 1) + 1];
      if (qt < 0) {  // tell the output warpgroup
        const int pb = pp & 1;
        if (pp >= 2) sm::mbar_wait(p_empty + pb, ((pp >> 1) - 1) & 1);
        if (t == 0) reinterpret_cast<int*>(rec + pb * 132 + 128)[0] = -1;
        sm::mbar_arrive(p_full + pb);
        break;
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      zero(o);
      for (int j = 0; j <= qt; ++j, ++kp, ++vp, ++pp) {
        const int s = kp % KS;
        sm::mbar_wait(k_full + s, (kp / KS) & 1);
        float sc[32];
        sm::fence_regs(sc);
        const uint64_t dq = sm::opaque(sm::desc_k(sq));
        const uint64_t dk = sm::desc_k(sk + s * TL);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < C::D / 16; ++kk)  // kk = 0 overwrites sc
          sm::wgmma_ss_n64(sc, dq + sm::step_k<64>(kk),
                           dk + sm::step_k<C::kKeys>(kk), kk);
        sm::wg_commit();
        sm::wg_wait<0>();
        sm::fence_regs(sc);
        sm::mbar_arrive(k_empty + s);
        if (j == qt) {  // the diagonal tile: keys above each row masked
          sm::mbar_arrive(q_empty);
          const int rel = sm::opaque(row0 - 2 * t4);  // row - column
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * i + (e & 1) > rel + 8 * (e >> 1))
                sc[4 * i + e] = -INFINITY;
        }
        // the thread's rows, each over its quad
        float sh[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          sh[r] = shift_of(mx) * c;
          alpha[r] = sm::exp2_ftz(m[r] * c - sh[r]);
          m[r] = mx;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe =
                sm::exp2_ftz(fmaf(sc[4 * i + e], c, -sh[e >> 1]));
            rs[e >> 1] += pe;
            sc[4 * i + e] = pe;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];

        // hand P over: bf16 into the buffer's swizzled panel (chunk i of
        // row r at chunk i ^ (r & 7)), with the rescale and the job
        const int pb = pp & 1;
        if (pp >= 2) sm::mbar_wait(p_empty + pb, ((pp >> 1) - 1) & 1);
        unsigned char* pt = sp + pb * C::kPTile;
        float* rc = rec + pb * 132;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<uint32_t*>(pt + row * 128 +
                                         ((i ^ (row & 7)) << 4) + 4 * t4) =
                pack_bf16(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]);
          if (t4 == 0) rc[row] = alpha[r];
        }
        float inv[2];
        if (j == qt) {  // the job's last tile: 1 / l, and the lse
          const int h = hb % H, b = hb / H;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float lr = l[r] + __shfl_xor_sync(kFull, l[r], 1);
            lr += __shfl_xor_sync(kFull, lr, 2);
            inv[r] = lr == 0.f ? 1.f : 1.f / lr;
            const int row = qt * C::kRows + row0 + 8 * r;
            if (t4 == 0) {
              rc[64 + row0 + 8 * r] = inv[r];
              if (kLse && row < S)
                a.lse[(static_cast<long long>(b) * H + h) * S + row] =
                    m[r] * a.sm_scale + logf(lr);
            }
          }
        }
        if (t == 0) {
          int* ri = reinterpret_cast<int*>(rc + 128);
          ri[0] = qt;
          ri[1] = hb;
          ri[2] = j;
        }
        sm::fence_async_smem();  // P is read by warpgroup 1's wgmma
        sm::mbar_arrive(p_full + pb);

        // O += P V over the first 128 columns, P from registers
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
        uint32_t pa[C::kKeys / 16][4];
        acc_to_a(pa, sc);
        const int v = vp % VS;
        sm::mbar_wait(v_full + v, (vp / VS) & 1);
        const uint64_t dv = sm::desc_mn<C::kKeys>(sv + v * TL);
        sm::fence_regs(o);
        sm::fence_regs(pa);
        sm::wg_fence();
#pragma unroll
        for (int kk = 0; kk < C::kKeys / 16; ++kk)
          sm::wgmma_rs<128>(o, pa[kk], dv + sm::step_mn(kk));
        sm::wg_commit();
        sm::wg_wait<0>();
        sm::fence_regs(o);
        sm::mbar_arrive(v_empty + v);
        if (j == qt) store_o(qt, hb, inv);
      }
    }
    return;
  }

  // warpgroup 1: the last 128 columns of O, P from the score warpgroup
  int vp = 0;
  for (int pp = 0;; ++pp, ++vp) {  // the P buffers, in order
    const int pb = pp & 1;
    sm::mbar_wait(p_full + pb, (pp >> 1) & 1);
    const float* rc = rec + pb * 132;
    const int* ri = reinterpret_cast<const int*>(rc + 128);
    const int qt = ri[0];
    if (qt < 0) break;
    const int hb = ri[1], j = ri[2];
    if (j == 0) {
      zero(o);
    } else {
      const float al[2] = {rc[row0], rc[row0 + 8]};
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= al[(i >> 1) & 1];
    }
    const int v = vp % VS;
    sm::mbar_wait(v_full + v, (vp / VS) & 1);
    const uint64_t dp = sm::opaque(sm::desc_k(sp + pb * C::kPTile));
    const uint64_t dv =
        sm::desc_mn<C::kKeys>(sv + v * TL) + ((2 * PN) >> 4);  // panel 2
    sm::fence_regs(o);
    sm::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::kKeys / 16; ++kk)
      sm::wgmma_ss_n128_mn(o, dp + sm::step_k<64>(kk), dv + sm::step_mn(kk));
    sm::wg_commit();
    sm::wg_wait<0>();
    sm::fence_regs(o);
    sm::mbar_arrive(v_empty + v);
    if (j == qt) {
      const float inv[2] = {rc[64 + row0], rc[64 + row0 + 8]};
      sm::mbar_arrive(p_empty + pb);
      store_o(qt, hb, inv);
    } else {
      sm::mbar_arrive(p_empty + pb);
    }
  }
}

// K10 at D = 256: the tensor maps in 64-row boxes, then the persistent
// launch (the kLse instantiation where lse is given).
cudaError_t launch_fwd_d256(int B, int H, int Hkv, const Args& a,
                            cudaStream_t st) {
  using C = Sm90FwdD256;
  CUtensorMap tq, tk, tv;
  if (!sm::tensor_map_bhsd(&tq, a.q, B, H, a.S, C::D, a.qs, C::kRows) ||
      !sm::tensor_map_bhsd(&tk, a.k, B, Hkv, a.S, C::D, a.ks, C::kKeys) ||
      !sm::tensor_map_bhsd(&tv, a.v, B, Hkv, a.S, C::D, a.vs, C::kKeys))
    return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_qt = (a.S + C::kRows - 1) / C::kRows;
  const long long units = static_cast<long long>((n_qt + 1) / 2) * H * B;
  const dim3 grid(static_cast<unsigned>(std::min<long long>(units, n_sm)));
  if (a.lse == nullptr) {
    if ((e = set_smem<flash_fwd_d256_kernel<false>>(C::kSmem)) != cudaSuccess)
      return e;
    flash_fwd_d256_kernel<false><<<grid, C::kThreads, C::kSmem, st>>>(
        tq, tk, tv, a);
  } else {
    if ((e = set_smem<flash_fwd_d256_kernel<true>>(C::kSmem)) != cudaSuccess)
      return e;
    flash_fwd_d256_kernel<true><<<grid, C::kThreads, C::kSmem, st>>>(
        tq, tk, tv, a);
  }
  return cudaGetLastError();
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The operands both backward kernels share, checked; false on what they do
// not take.
bool bwd_args(BwdArgs& a, const void* q, const void* k, const void* v,
              const void* dO, const void* lse, const void* di, int dtype,
              int B, int H, int Hkv, int S, int D, float sm_scale,
              const long long* strides, int n_strides) {
  const long long per = dtype == 0 ? 8 : 4;  // elements in 16 bytes
  bool ok = B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Hkv >= 1 &&
            H % Hkv == 0 && S >= 1 && (dtype == 0 || dtype == 1) &&
            (D == 64 || D == 128 || D == 256) && aligned(q) && aligned(k) &&
            aligned(v) && aligned(dO) && lse != nullptr && di != nullptr;
  for (int i = 0; i < n_strides; ++i) ok = ok && strides[i] % per == 0;
  if (!ok) return false;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.dos[i] = strides[9 + i];
  }
  a.S = S;
  a.n_rep = H / Hkv;
  a.sm_scale = sm_scale;
  a.B = B;
  a.Hkv = Hkv;
  return true;
}

cudaError_t launch_bwd(bool dkv, int dtype, int B, int H, int Hkv, int D,
                       const BwdArgs& a, cudaStream_t st) {
  if (bwd_on_sm90(dtype))
    return D == 64    ? launch_bwd_sm90<64>(dkv, B, H, Hkv, a, st)
           : D == 128 ? launch_bwd_sm90<128>(dkv, B, H, Hkv, a, st)
                      : launch_bwd_d256(dkv, B, H, Hkv, a, st);
  return D == 64    ? launch_bwd_f32<64>(dkv, B, H, Hkv, a, st)
         : D == 128 ? launch_bwd_f32<128>(dkv, B, H, Hkv, a, st)
                    : launch_bwd_f32<256>(dkv, B, H, Hkv, a, st);
}

}  // namespace

// dtype 0: bf16, 1: f32. q/out (B, H, S, D), k/v (B, Hkv, S, D), each
// through its element strides (batch, head, row) with the last dimension
// contiguous; every row 16-byte aligned. lse: null, or (B, H, S) f32
// receiving each row's log-sum-exp m + log(l) for the backward.
extern "C" int sbt_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int B,
    int H, int Hkv, int S, int D, float sm_scale, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  const long long per = dtype == 0 ? 8 : 4;  // elements in 16 bytes
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  bool ok = B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Hkv >= 1 &&
            H % Hkv == 0 && S >= 1 && (dtype == 0 || dtype == 1) &&
            (D == 64 || D == 128 || D == 256) && aligned(q) && aligned(k) &&
            aligned(v) && aligned(out);
  for (long long s : strides) ok = ok && s % per == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.S = S;
  a.n_rep = H / Hkv;
  a.sm_scale = sm_scale;
  a.B = B;
  a.H = H;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (fwd_on_sm90(dtype))
    e = D == 64    ? launch_fwd_sm90<64>(B, H, Hkv, a, st)
        : D == 128 ? launch_fwd_sm90<128>(B, H, Hkv, a, st)
                   : launch_fwd_d256(B, H, Hkv, a, st);
  else
    e = D == 64    ? launch_fwd_f32<64>(B, H, a, st)
        : D == 128 ? launch_fwd_f32<128>(B, H, a, st)
                   : launch_fwd_f32<256>(B, H, a, st);
  return static_cast<int>(e);
}

// K11: dK, dV (B, Hkv, S, D) of q (B, H, S, D), k/v (B, Hkv, S, D), dO
// (B, H, S, D), lse and di (B, H, S) f32 contiguous; the tensors through
// their element strides (batch, head, row), rows 16-byte aligned.
extern "C" int sbt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* di, void* dk, void* dv, int dtype, int B,
    int H, int Hkv, int S, int D, float sm_scale, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, void* stream) {
  const long long strides[18] = {q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,
                                 v_sb,  v_sh,  v_ss,  do_sb, do_sh, do_ss,
                                 dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  BwdArgs a = {};
  if (!bwd_args(a, q, k, v, dO, lse, di, dtype, B, H, Hkv, S, D, sm_scale,
                strides, 18) ||
      !aligned(dk) || !aligned(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 3; ++i) {
    a.dks[i] = strides[12 + i];
    a.dvs[i] = strides[15 + i];
  }
  return launch_bwd(true, dtype, B, H, Hkv, D, a,
                    static_cast<cudaStream_t>(stream));
}

// K12: dQ (B, H, S, D); operands as sbt_flash_bwd_dkv's.
extern "C" int sbt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* di, void* dq, int dtype, int B, int H,
    int Hkv, int S, int D, float sm_scale, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh,
    long long dq_ss, void* stream) {
  const long long strides[15] = {q_sb, q_sh, q_ss, k_sb,  k_sh,  k_ss,
                                 v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
                                 dq_sb, dq_sh, dq_ss};
  BwdArgs a = {};
  if (!bwd_args(a, q, k, v, dO, lse, di, dtype, B, H, Hkv, S, D, sm_scale,
                strides, 15) ||
      !aligned(dq))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dq = dq;
  for (int i = 0; i < 3; ++i) a.dqs[i] = strides[12 + i];
  return launch_bwd(false, dtype, B, H, Hkv, D, a,
                    static_cast<cudaStream_t>(stream));
}
