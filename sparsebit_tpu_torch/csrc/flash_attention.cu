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
// v, out: ~540 FLOP a byte, above the bf16 ridge (~295). Design (FA2's
// shape on mma.sync; wgmma, TMA and warp specialisation are a later step):
//   - bf16: a block per (64-row q tile, head, batch row), four warps of 16
//     q rows; K/V tiles of 64 rows double-buffered in shared memory by
//     cp.async (16-byte chunks, XOR-swizzled so both the copies and the
//     ldmatrix reads are bank-conflict-free); QKᵀ and PV on
//     mma.sync.m16n8k16 bf16 with f32 accumulators, V through
//     ldmatrix.trans; the online softmax in registers, P converted to bf16
//     in registers as PV's A operand; q fragments held in registers at
//     D <= 128, read from shared memory at D = 256;
//   - f32 models: the same tiling on FFMA (no tensor cores), 32-row q and
//     kv tiles, one key a lane for the scores, D / 32 output columns a lane;
//   - causal tiles above the diagonal are skipped; only the diagonal tile
//     and a ragged last tile are masked (rows past S load as zeros and are
//     not stored); the heaviest causal q tiles are scheduled first.
// Shared memory is dynamic (160 KB at D = 256), its limit set before the
// first launch of each instantiation. When the caller passes `lse`
// (training), K10 also writes each row's log-sum-exp m + log(l) there, in
// an instantiation of its own (kLse): the serving and eval paths pass null
// and run the kernel without that code.
//
// K11 and K12: the backward, replacing the same JAX module's
// _flash_attention_dkv_kernel (:796, launched at :1121) and
// _flash_attention_dq_kernel (:1146, launched at :1456), which run under
// jax.grad of the training loss. Same arithmetic (:830-930): P =
// exp(s · sm_scale - lse) under the causal mask (the reference keeps m
// and l: exp(s - m) / l), dV += Pᵀ dO with P rounded to dO's type, dP =
// dO Vᵀ, dS = (dP - di) P · sm_scale with di = sum(O dO) from the
// caller, dK += dSᵀ Q and dQ += dS K with dS rounded first, f32
// accumulators. Bound: operations (4 causal-half products for K11, 3 for
// K12) against q, k, v, dO and the gradients once: at S = 2048, D = 128
// ~4x the bytes' time; at S = 512 near balance. Design, on K10's pieces
// (swizzled cp.async tiles, ldmatrix(.trans), mma.sync bf16, FFMA for
// f32; wgmma, TMA and warp specialisation are a later step):
//   - K11: a block per (64-key tile, kv head, batch row); dK and dV in
//     registers over the q tiles from the diagonal down and, under GQA,
//     over the kv head's query heads in order, so each kv head's gradient
//     is its query heads' sum without atomics. Q, dO and the rows' lse
//     and di are double-buffered. Per q tile, phase A scores the block's
//     keys against the tile (warps split the queries) and writes Pᵀ and
//     dSᵀ in bf16 to shared memory; phase B adds Pᵀ dO and dSᵀ Q (warps
//     split the output columns, so no warp holds more than 64 or, at
//     D = 256, 128 accumulator columns a matrix);
//   - K12: K10's block (64 q rows, four warps of 16, K/V tiles
//     double-buffered), dP beside S, dS rounded to bf16 in registers as
//     the A operand of dQ += dS K, K read through ldmatrix.trans; at
//     D = 256 the keys go 32 at a time to bound the registers;
//   - f32: K10's FFMA tiling (32-row tiles, a lane a key or query for the
//     scores, D / 32 columns a lane for the sums);
//   - only the diagonal tile and a ragged last tile are masked; rows and
//     keys past S load as zeros, are masked and not stored.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "planes.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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
};

// Element offset of 16-byte chunk c of row r in a [rows][D] tile of
// `per` elements a chunk: chunks XOR-swizzled by the row's low 3 bits.
template <int D, int per>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) * per);
}

// Rows [row0, row0 + ROWS) of a (S, D) slab with row stride ss into a
// swizzled tile by a block of NT threads; rows past S are zero-filled.
template <typename T, int D, int ROWS, int NT = kThreads>
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int D>
struct Bf16Tile {
  static constexpr int BM = 64, BN = 64;
  static constexpr bool kQRegs = D <= 128;
  static constexpr size_t kSmem =
      static_cast<size_t>(BM + 4 * BN) * D * sizeof(__nv_bfloat16);
};

// grid (ceil(S / 64), H, B), block kThreads.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const Args a) {
  using T = __nv_bfloat16;
  using C = Bf16Tile<D>;
  constexpr int BM = C::BM, BN = C::BN, NT = BN / 8, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + BM * D;       // [2][BN][D]
  T* sv = sk + 2 * BN * D;   // [2][BN][D]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.n_rep;
  const int S = a.S, q0 = qt * BM;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = min(qt + 1, n_all);  // BM == BN

  load_tile<T, D, BM>(sq, qg, a.qs[2], q0, S);
  load_tile<T, D, BN>(sk, kg, a.ks[2], 0, S);
  load_tile<T, D, BN>(sv, vg, a.vs[2], 0, S);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int wrow = warp * 16;  // the warp's first row in the tile
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[C::kQRegs ? D / 16 : 1][4];

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_tile<T, D, BN>(sk + (buf ^ 1) * BN * D, kg, a.ks[2], (j + 1) * BN,
                          S);
      load_tile<T, D, BN>(sv + (buf ^ 1) * BN * D, vg, a.vs[2], (j + 1) * BN,
                          S);
      sbt::cp_commit();
      sbt::cp_wait<1>();
    } else {
      sbt::cp_wait<0>();
    }
    __syncthreads();
    if (C::kQRegs && j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[C::kQRegs ? kk : 0],
                sq + swz<D, 8>(wrow + (lane & 15), 2 * kk + (lane >> 4)));
    }
    const T* kt = sk + buf * BN * D;
    const T* vt = sv + buf * BN * D;

    // S = Q Kᵀ: the warp's 16 rows x BN keys
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      if (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[C::kQRegs ? kk : 0][e];
      } else {
        ldsm_x4(af, sq + swz<D, 8>(wrow + (lane & 15), 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, kt + swz<D, 8>(nt * 8 + (mi >> 1) * 8 + (lane & 7),
                                   2 * kk + (mi & 1)));
        mma_bf16(s[nt], af, bf[0], bf[1]);
        mma_bf16(s[nt + 1], af, bf[2], bf[3]);
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp)
    const bool need_mask = j == qt || (j + 1) * BN > S;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.sm_scale;
        if (need_mask) {
          const int row = q0 + wrow + g + (e >> 1) * 8;
          const int col = j * BN + nt * 8 + 2 * t + (e & 1);
          if (col >= S || col > row) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sh[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      sh[r] = shift_of(mx[r]);
      alpha[r] = expf(m[r] - sh[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - sh[e >> 1]);
        rs[e >> 1] += p;
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vt + swz<D, 8>(kk * 16 + (mi & 1) * 8 + (lane & 7),
                                     dt + (mi >> 1)));
        mma_bf16(o[dt], pa, bf[0], bf[1]);
        mma_bf16(o[dt + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the buffer is refilled by the next iteration
  }

  // out = O / l (rows with l = 0 stay 0), staged through the warp's own
  // rows of the q tile, then stored 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
    const int row = q0 + wrow + g + 8 * r;
    if (kLse && t == 0 && row < S)
      a.lse[(static_cast<long long>(b) * gridDim.y + h) * S + row] =
          m[r] + logf(l[r]);
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      *reinterpret_cast<uint32_t*>(sq + swz<D, 8>(row, dt) + 2 * t) =
          pack_bf16(o[dt][2 * r] * inv[r], o[dt][2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
  T* og = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
  for (int i = lane; i < 16 * DT; i += 32) {
    const int r = wrow + i / DT, c = i % DT;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(og + static_cast<long long>(q0 + r) *
                                         a.os[2] + c * 8) =
          *reinterpret_cast<const uint4*>(sq + swz<D, 8>(r, c));
  }
}

template <int D>
struct F32Tile {
  static constexpr int BM = 32, BN = 32;
  static constexpr size_t kSmem =
      static_cast<size_t>(BM + 4 * BN) * D * sizeof(float);
};

// grid (ceil(S / 32), H, B), block kThreads: warp w owns q rows
// [8w, 8w + 8) of the tile; lane j scores key j, and owns output columns
// lane + 32c.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Args a) {
  using C = F32Tile<D>;
  constexpr int BM = C::BM, BN = C::BN, R = BM / kWarps, CH = D / 4,
                NC = D / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sk = sq + BM * D;
  float* sv = sk + 2 * BN * D;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.n_rep;
  const int S = a.S, q0 = qt * BM;
  const float* qg = static_cast<const float*>(a.q) + b * a.qs[0] +
                    h * a.qs[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.ks[0] +
                    hk * a.ks[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.vs[0] +
                    hk * a.vs[1];
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = min(qt + 1, n_all);

  load_tile<float, D, BM>(sq, qg, a.qs[2], q0, S);
  load_tile<float, D, BN>(sk, kg, a.ks[2], 0, S);
  load_tile<float, D, BN>(sv, vg, a.vs[2], 0, S);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * R;
  float o[R][NC], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_tile<float, D, BN>(sk + (buf ^ 1) * BN * D, kg, a.ks[2],
                              (j + 1) * BN, S);
      load_tile<float, D, BN>(sv + (buf ^ 1) * BN * D, vg, a.vs[2],
                              (j + 1) * BN, S);
      sbt::cp_commit();
      sbt::cp_wait<1>();
    } else {
      sbt::cp_wait<0>();
    }
    __syncthreads();
    const float* kt = sk + buf * BN * D;
    const float* vt = sv + buf * BN * D;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(kt + swz<D, 4>(lane,
                                                                        c));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sq + swz<D, 4>(wrow + r, c));
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const bool need_mask = j == qt || (j + 1) * BN > S;
    const int col = j * BN + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = s[r] * a.sm_scale;
      if (need_mask && (col >= S || col > q0 + wrow + r))
        x = -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      mx = fmaxf(mx, m[r]);
      const float sh = shift_of(mx);
      const float alpha = expf(m[r] - sh);
      const float p = expf(x - sh);
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = mx;
      s[r] = p;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= alpha;
    }

#pragma unroll 4
    for (int kj = 0; kj < BN; ++kj) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        vv[c] = vt[swz<D, 4>(kj, (lane >> 2) + 8 * c) + (lane & 3)];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = __shfl_sync(kFull, s[r], kj);
#pragma unroll
        for (int c = 0; c < NC; ++c) o[r][c] = fmaf(p, vv[c], o[r][c]);
      }
    }
    __syncthreads();
  }

  float* og = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + wrow + r;
    if (row >= S) continue;
    const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];
    if (kLse && lane == 0)
      a.lse[(static_cast<long long>(b) * gridDim.y + h) * S + row] =
          m[r] + logf(l[r]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      og[static_cast<long long>(row) * a.os[2] + lane + 32 * c] =
          o[r][c] * inv;
  }
}

template <auto Kernel, typename A>
cudaError_t launch(size_t smem, dim3 grid, const A& a, cudaStream_t st,
                   int threads = kThreads) {
  static bool configured = false;  // one flag per kernel instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  Kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, int B, int H, const Args& a,
                     cudaStream_t st) {
  if (dtype == 0) {
    const dim3 grid((a.S + Bf16Tile<D>::BM - 1) / Bf16Tile<D>::BM, H, B);
    return a.lse == nullptr
               ? launch<flash_bf16_kernel<D, false>>(Bf16Tile<D>::kSmem, grid,
                                                     a, st)
               : launch<flash_bf16_kernel<D, true>>(Bf16Tile<D>::kSmem, grid,
                                                    a, st);
  }
  const dim3 grid((a.S + F32Tile<D>::BM - 1) / F32Tile<D>::BM, H, B);
  return a.lse == nullptr
             ? launch<flash_f32_kernel<D, false>>(F32Tile<D>::kSmem, grid, a,
                                                  st)
             : launch<flash_f32_kernel<D, true>>(F32Tile<D>::kSmem, grid, a,
                                                 st);
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
};

// Per-row statistics of a q tile (lse, di) into shared memory; rows past S
// read as 0 (they are masked).
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst_l, float* dst_d,
                                          const float* l, const float* d,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const bool ok = row0 + i < S;
    dst_l[i] = ok ? l[row0 + i] : 0.f;
    dst_d[i] = ok ? d[row0 + i] : 0.f;
  }
}

// K11, bf16. A block per (64-key tile, kv head, batch row). Warp (kw, ds)
// of 4 x DS owns keys [16 kw, 16 kw + 16) of the tile; for each q tile
// (64 rows) it scores queries [QW ds, QW ds + QW) against its keys (phase
// A: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, P and dS rounded to bf16 into shared
// memory), then, after a barrier, adds Pᵀ dO and dSᵀ Q into its keys'
// output columns [DC ds, DC ds + DC) (phase B). dK and dV stay in
// registers over every q tile of every query head of the kv head.
template <int D>
struct DkvTile {
  static constexpr int BN = 64, BM = 64;
  static constexpr int DS = D == 64 ? 1 : 2;  // column groups
  static constexpr int DC = D / DS, QW = BM / DS;
  static constexpr int kThreadsB = 128 * DS;
  static constexpr size_t kSmem =
      static_cast<size_t>(2 * BN + 4 * BM) * D * sizeof(__nv_bfloat16) +
      static_cast<size_t>(2 * BN * BM) * sizeof(__nv_bfloat16) +
      4 * BM * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(DkvTile<D>::kThreadsB)
    flash_dkv_bf16_kernel(const BwdArgs a) {
  using T = __nv_bfloat16;
  using C = DkvTile<D>;
  constexpr int BN = C::BN, BM = C::BM, DC = C::DC, QW = C::QW,
                NT = C::kThreadsB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);  // [BN][D]
  T* sv = sk + BN * D;                     // [BN][D]
  T* sq = sv + BN * D;                     // [2][BM][D]
  T* sdo = sq + 2 * BM * D;                // [2][BM][D]
  T* sp = sdo + 2 * BM * D;                // [BN][BM]: Pᵀ
  T* sds = sp + BN * BM;                   // [BN][BM]: dSᵀ
  float* sl = reinterpret_cast<float*>(sds + BN * BM);  // [2][BM]
  float* sdi = sl + 2 * BM;                              // [2][BM]

  const int jt = blockIdx.x;  // the heaviest key tiles (most q tiles) first
  const int hk = blockIdx.y, b = blockIdx.z, H = gridDim.y * a.n_rep;
  const int S = a.S, j0 = jt * BN;
  const int n_qt = (S + BM - 1) / BM, per_head = n_qt - jt;
  const int n_it = a.n_rep * per_head;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  auto issue = [&](int it, int buf) {  // q tile `it` of the loop into buf
    const int h = hk * a.n_rep + it / per_head;
    const int q0 = (jt + it % per_head) * BM;
    const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const T* dg = static_cast<const T*>(a.dO) + b * a.dos[0] + h * a.dos[1];
    load_tile<T, D, BM, NT>(sq + buf * BM * D, qg, a.qs[2], q0, S);
    load_tile<T, D, BM, NT>(sdo + buf * BM * D, dg, a.dos[2], q0, S);
    const long long row = (static_cast<long long>(b) * H + h) * S;
    load_rows<BM, NT>(sl + buf * BM, sdi + buf * BM, a.lse + row,
                      a.di + row, q0, S);
  };

  load_tile<T, D, BN, NT>(sk, kg, a.ks[2], j0, S);
  load_tile<T, D, BN, NT>(sv, vg, a.vs[2], j0, S);
  issue(0, 0);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = warp & 3, ds = warp >> 2;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int krow = kw * 16;  // the warp's first key in the tile
  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

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
    const T* qt_s = sq + buf * BM * D;
    const T* dt_s = sdo + buf * BM * D;
    const float* lt = sl + buf * BM;
    const float* dit = sdi + buf * BM;

    // phase A: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for 16 keys x QW queries
    float s[QW / 8][4], dp[QW / 8][4];
#pragma unroll
    for (int i = 0; i < QW / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, sk + swz<D, 8>(krow + (lane & 15), 2 * kk + (lane >> 4)));
      ldsm_x4(va, sv + swz<D, 8>(krow + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < QW / 8; nt += 2) {
        const int r = ds * QW + nt * 8 + (mi >> 1) * 8 + (lane & 7);
        uint32_t bq[4], bd[4];
        ldsm_x4(bq, qt_s + swz<D, 8>(r, 2 * kk + (mi & 1)));
        ldsm_x4(bd, dt_s + swz<D, 8>(r, 2 * kk + (mi & 1)));
        mma_bf16(s[nt], ka, bq[0], bq[1]);
        mma_bf16(s[nt + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[nt], va, bd[0], bd[1]);
        mma_bf16(dp[nt + 1], va, bd[2], bd[3]);
      }
    }
    const bool need_mask = qt == jt || q0 + BM > S;
#pragma unroll
    for (int nt = 0; nt < QW / 8; ++nt) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + krow + g + (e >> 1) * 8;
        const int col = ds * QW + nt * 8 + 2 * t + (e & 1);
        const int qry = q0 + col;
        float p = 0.f;
        if (!need_mask || (key <= qry && qry < S))
          p = expf(s[nt][e] * a.sm_scale - lt[col]);
        pv[e] = p;
        dsv[e] = (dp[nt][e] - dit[col]) * p * a.sm_scale;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = krow + g + 8 * r;
        const int c8 = ds * (QW / 8) + nt;
        *reinterpret_cast<uint32_t*>(sp + swz<BM, 8>(row, c8) + 2 * t) =
            pack_bf16(pv[2 * r], pv[2 * r + 1]);
        *reinterpret_cast<uint32_t*>(sds + swz<BM, 8>(row, c8) + 2 * t) =
            pack_bf16(dsv[2 * r], dsv[2 * r + 1]);
      }
    }
    __syncthreads();

    // phase B: dV += Pᵀ dO, dK += dSᵀ Q on the warp's DC columns
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], sa[4];
      ldsm_x4(pa, sp + swz<BM, 8>(krow + (lane & 15), 2 * kk + (lane >> 4)));
      ldsm_x4(sa, sds + swz<BM, 8>(krow + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int dt = 0; dt < DC / 8; dt += 2) {
        const int r = kk * 16 + (mi & 1) * 8 + (lane & 7);
        const int c8 = ds * (DC / 8) + dt + (mi >> 1);
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, dt_s + swz<D, 8>(r, c8));
        ldsm_x4_t(bq, qt_s + swz<D, 8>(r, c8));
        mma_bf16(dv[dt], pa, bo[0], bo[1]);
        mma_bf16(dv[dt + 1], pa, bo[2], bo[3]);
        mma_bf16(dk[dt], sa, bq[0], bq[1]);
        mma_bf16(dk[dt + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // buf and the P/dS tiles are refilled next
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  T* dvg = static_cast<T*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = j0 + krow + g + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int dt = 0; dt < DC / 8; ++dt) {
      const int col = ds * DC + dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + key * a.dks[2] + col) =
          pack_bf16(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvg + key * a.dvs[2] + col) =
          pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// K12, bf16: K10's shape. A block per (64-row q tile, head, batch row),
// four warps of 16 q rows; K/V tiles double-buffered; per key chunk of KN
// keys S = Q Kᵀ and dP = dO Vᵀ, dS in registers rounded to bf16 as the A
// operand of dQ += dS K (K through ldmatrix.trans).
template <int D>
struct DqTile {
  static constexpr int BM = 64, BN = 64;
  static constexpr int KN = D == 256 ? 32 : 64;  // keys a register chunk
  static constexpr size_t kSmem =
      static_cast<size_t>(2 * BM + 4 * BN) * D * sizeof(__nv_bfloat16);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_bf16_kernel(const BwdArgs a) {
  using T = __nv_bfloat16;
  using C = DqTile<D>;
  constexpr int BM = C::BM, BN = C::BN, KN = C::KN, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [BM][D]
  T* sdo = sq + BM * D;                    // [BM][D]
  T* sk = sdo + BM * D;                    // [2][BN][D]
  T* sv = sk + 2 * BN * D;                 // [2][BN][D]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.n_rep;
  const int S = a.S, q0 = qt * BM;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* dg = static_cast<const T*>(a.dO) + b * a.dos[0] + h * a.dos[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = min(qt + 1, n_all);

  load_tile<T, D, BM>(sq, qg, a.qs[2], q0, S);
  load_tile<T, D, BM>(sdo, dg, a.dos[2], q0, S);
  load_tile<T, D, BN>(sk, kg, a.ks[2], 0, S);
  load_tile<T, D, BN>(sv, vg, a.vs[2], 0, S);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int wrow = warp * 16;
  const long long srow = (static_cast<long long>(b) * gridDim.y + h) * S;
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    lse[r] = row < S ? a.lse[srow + row] : 0.f;
    di[r] = row < S ? a.di[srow + row] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_tile<T, D, BN>(sk + (buf ^ 1) * BN * D, kg, a.ks[2], (j + 1) * BN,
                          S);
      load_tile<T, D, BN>(sv + (buf ^ 1) * BN * D, vg, a.vs[2], (j + 1) * BN,
                          S);
      sbt::cp_commit();
      sbt::cp_wait<1>();
    } else {
      sbt::cp_wait<0>();
    }
    __syncthreads();
    const T* kt = sk + buf * BN * D;
    const T* vt = sv + buf * BN * D;
    const bool need_mask = j == qt || (j + 1) * BN > S;

#pragma unroll
    for (int kc = 0; kc < BN; kc += KN) {
      float s[KN / 8][4], dp[KN / 8][4];
#pragma unroll
      for (int i = 0; i < KN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], oa[4];
        ldsm_x4(qa, sq + swz<D, 8>(wrow + (lane & 15), 2 * kk + (lane >> 4)));
        ldsm_x4(oa, sdo + swz<D, 8>(wrow + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < KN / 8; nt += 2) {
          const int r = kc + nt * 8 + (mi >> 1) * 8 + (lane & 7);
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, kt + swz<D, 8>(r, 2 * kk + (mi & 1)));
          ldsm_x4(bv, vt + swz<D, 8>(r, 2 * kk + (mi & 1)));
          mma_bf16(s[nt], qa, bk[0], bk[1]);
          mma_bf16(s[nt + 1], qa, bk[2], bk[3]);
          mma_bf16(dp[nt], oa, bv[0], bv[1]);
          mma_bf16(dp[nt + 1], oa, bv[2], bv[3]);
        }
      }
      // dS = (dP - di) P · sm_scale, P = exp(s · sm_scale - lse), masked
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + wrow + g + (e >> 1) * 8;
          const int col = j * BN + kc + nt * 8 + 2 * t + (e & 1);
          float p = 0.f;
          if (!need_mask || (col < S && col <= row))
            p = expf(s[nt][e] * a.sm_scale - lse[e >> 1]);
          s[nt][e] = (dp[nt][e] - di[e >> 1]) * p * a.sm_scale;
        }
      }
      // dQ += dS K_chunk
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        uint32_t sa[4];
        sa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        sa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        sa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        sa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bk[4];
          ldsm_x4_t(bk, kt + swz<D, 8>(kc + kk * 16 + (mi & 1) * 8 +
                                           (lane & 7),
                                       dt + (mi >> 1)));
          mma_bf16(dq[dt], sa, bk[0], bk[1]);
          mma_bf16(dq[dt + 1], sa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled by the next iteration
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dqg + row * a.dqs[2] + dt * 8 + 2 * t) =
          pack_bf16(dq[dt][2 * r], dq[dt][2 * r + 1]);
  }
}

// The f32 backward on FFMA, K10's f32 tiling: 32-row tiles, four warps of
// 8 rows (K11: keys, K12: q rows), one lane a row of the other side for
// the scores and D / 32 output columns a lane.
template <int D>
struct F32BwdTile {
  static constexpr int BM = 32, BN = 32;
  static constexpr size_t kSmem =
      static_cast<size_t>(2 * BN + 4 * BM) * D * sizeof(float) +
      4 * BM * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32_kernel(const BwdArgs a) {
  using C = F32BwdTile<D>;
  constexpr int BM = C::BM, BN = C::BN, R = BN / kWarps, CH = D / 4,
                NC = D / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // [BN][D]
  float* sv = sk + BN * D;
  float* sq = sv + BN * D;    // [2][BM][D]
  float* sdo = sq + 2 * BM * D;
  float* sl = sdo + 2 * BM * D;  // [2][BM]
  float* sdi = sl + 2 * BM;

  const int jt = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z, H = gridDim.y * a.n_rep;
  const int S = a.S, j0 = jt * BN;
  const int n_qt = (S + BM - 1) / BM, per_head = n_qt - jt;
  const int n_it = a.n_rep * per_head;
  const float* kg = static_cast<const float*>(a.k) + b * a.ks[0] +
                    hk * a.ks[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.vs[0] +
                    hk * a.vs[1];

  auto issue = [&](int it, int buf) {
    const int h = hk * a.n_rep + it / per_head;
    const int q0 = (jt + it % per_head) * BM;
    const float* qg = static_cast<const float*>(a.q) + b * a.qs[0] +
                      h * a.qs[1];
    const float* dg = static_cast<const float*>(a.dO) + b * a.dos[0] +
                      h * a.dos[1];
    load_tile<float, D, BM>(sq + buf * BM * D, qg, a.qs[2], q0, S);
    load_tile<float, D, BM>(sdo + buf * BM * D, dg, a.dos[2], q0, S);
    const long long row = (static_cast<long long>(b) * H + h) * S;
    load_rows<BM, kThreads>(sl + buf * BM, sdi + buf * BM, a.lse + row,
                            a.di + row, q0, S);
  };

  load_tile<float, D, BN>(sk, kg, a.ks[2], j0, S);
  load_tile<float, D, BN>(sv, vg, a.vs[2], j0, S);
  issue(0, 0);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * R;  // the warp's first key
  float dk[R][NC], dv[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

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

    // lane = query: scores and dP of the warp's R keys
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(qt_s +
                                                         swz<D, 4>(lane, c));
      const float4 ov = *reinterpret_cast<const float4*>(dt_s +
                                                         swz<D, 4>(lane, c));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 kv =
            *reinterpret_cast<const float4*>(sk + swz<D, 4>(wrow + r, c));
        const float4 vv =
            *reinterpret_cast<const float4*>(sv + swz<D, 4>(wrow + r, c));
        s[r] = fmaf(kv.x, qv.x, s[r]);
        s[r] = fmaf(kv.y, qv.y, s[r]);
        s[r] = fmaf(kv.z, qv.z, s[r]);
        s[r] = fmaf(kv.w, qv.w, s[r]);
        dp[r] = fmaf(vv.x, ov.x, dp[r]);
        dp[r] = fmaf(vv.y, ov.y, dp[r]);
        dp[r] = fmaf(vv.z, ov.z, dp[r]);
        dp[r] = fmaf(vv.w, ov.w, dp[r]);
      }
    }
    const bool need_mask = qt == jt || q0 + BM > S;
    const int qry = q0 + lane;
    const float l_q = sl[buf * BM + lane], d_q = sdi[buf * BM + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float p = 0.f;
      if (!need_mask || (j0 + wrow + r <= qry && qry < S))
        p = expf(s[r] * a.sm_scale - l_q);
      s[r] = p;
      dp[r] = (dp[r] - d_q) * p * a.sm_scale;
    }
    // lane = output column: dV += Pᵀ dO, dK += dSᵀ Q
#pragma unroll 4
    for (int qj = 0; qj < BM; ++qj) {
      float ov[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int at = swz<D, 4>(qj, (lane >> 2) + 8 * c) + (lane & 3);
        ov[c] = dt_s[at];
        qv[c] = qt_s[at];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = __shfl_sync(kFull, s[r], qj);
        const float d = __shfl_sync(kFull, dp[r], qj);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[r][c] = fmaf(p, ov[c], dv[r][c]);
          dk[r][c] = fmaf(d, qv[c], dk[r][c]);
        }
      }
    }
    __syncthreads();
  }

  float* dkg = static_cast<float*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  float* dvg = static_cast<float*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = j0 + wrow + r;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkg[static_cast<long long>(key) * a.dks[2] + lane + 32 * c] = dk[r][c];
      dvg[static_cast<long long>(key) * a.dvs[2] + lane + 32 * c] = dv[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_f32_kernel(const BwdArgs a) {
  using C = F32BwdTile<D>;
  constexpr int BM = C::BM, BN = C::BN, R = BM / kWarps, CH = D / 4,
                NC = D / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [BM][D]
  float* sdo = sq + BM * D;
  float* sk = sdo + BM * D;  // [2][BN][D]
  float* sv = sk + 2 * BN * D;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.n_rep;
  const int S = a.S, q0 = qt * BM;
  const float* qg = static_cast<const float*>(a.q) + b * a.qs[0] +
                    h * a.qs[1];
  const float* dg = static_cast<const float*>(a.dO) + b * a.dos[0] +
                    h * a.dos[1];
  const float* kg = static_cast<const float*>(a.k) + b * a.ks[0] +
                    hk * a.ks[1];
  const float* vg = static_cast<const float*>(a.v) + b * a.vs[0] +
                    hk * a.vs[1];
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = min(qt + 1, n_all);

  load_tile<float, D, BM>(sq, qg, a.qs[2], q0, S);
  load_tile<float, D, BM>(sdo, dg, a.dos[2], q0, S);
  load_tile<float, D, BN>(sk, kg, a.ks[2], 0, S);
  load_tile<float, D, BN>(sv, vg, a.vs[2], 0, S);
  sbt::cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = warp * R;
  const long long srow = (static_cast<long long>(b) * gridDim.y + h) * S;
  float lse[R], di[R], dq[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + wrow + r;
    lse[r] = row < S ? a.lse[srow + row] : 0.f;
    di[r] = row < S ? a.di[srow + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_tile<float, D, BN>(sk + (buf ^ 1) * BN * D, kg, a.ks[2],
                              (j + 1) * BN, S);
      load_tile<float, D, BN>(sv + (buf ^ 1) * BN * D, vg, a.vs[2],
                              (j + 1) * BN, S);
      sbt::cp_commit();
      sbt::cp_wait<1>();
    } else {
      sbt::cp_wait<0>();
    }
    __syncthreads();
    const float* kt = sk + buf * BN * D;
    const float* vt = sv + buf * BN * D;

    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(kt +
                                                         swz<D, 4>(lane, c));
      const float4 vv = *reinterpret_cast<const float4*>(vt +
                                                         swz<D, 4>(lane, c));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sq + swz<D, 4>(wrow + r, c));
        const float4 ov =
            *reinterpret_cast<const float4*>(sdo + swz<D, 4>(wrow + r, c));
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
        dp[r] = fmaf(ov.x, vv.x, dp[r]);
        dp[r] = fmaf(ov.y, vv.y, dp[r]);
        dp[r] = fmaf(ov.z, vv.z, dp[r]);
        dp[r] = fmaf(ov.w, vv.w, dp[r]);
      }
    }
    const bool need_mask = j == qt || (j + 1) * BN > S;
    const int col = j * BN + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float p = 0.f;
      if (!need_mask || (col < S && col <= q0 + wrow + r))
        p = expf(s[r] * a.sm_scale - lse[r]);
      s[r] = (dp[r] - di[r]) * p * a.sm_scale;
    }
#pragma unroll 4
    for (int kj = 0; kj < BN; ++kj) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kv[c] = kt[swz<D, 4>(kj, (lane >> 2) + 8 * c) + (lane & 3)];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = __shfl_sync(kFull, s[r], kj);
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[r][c] = fmaf(d, kv[c], dq[r][c]);
      }
    }
    __syncthreads();
  }

  float* dqg = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + wrow + r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dqg[static_cast<long long>(row) * a.dqs[2] + lane + 32 * c] = dq[r][c];
  }
}

template <int D>
cudaError_t launch_bwd_d(bool dkv, int dtype, int B, int H, int Hkv,
                         const BwdArgs& a, cudaStream_t st) {
  if (dtype == 0) {
    if (dkv) {
      const dim3 grid((a.S + 63) / 64, Hkv, B);
      return launch<flash_dkv_bf16_kernel<D>>(DkvTile<D>::kSmem, grid, a, st,
                                              DkvTile<D>::kThreadsB);
    }
    const dim3 grid((a.S + 63) / 64, H, B);
    return launch<flash_dq_bf16_kernel<D>>(DqTile<D>::kSmem, grid, a, st);
  }
  const dim3 grid((a.S + 31) / 32, dkv ? Hkv : H, B);
  if (dkv)
    return launch<flash_dkv_f32_kernel<D>>(F32BwdTile<D>::kSmem, grid, a,
                                           st);
  return launch<flash_dq_f32_kernel<D>>(F32BwdTile<D>::kSmem, grid, a, st);
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
  return true;
}

cudaError_t launch_bwd(bool dkv, int dtype, int B, int H, int Hkv, int D,
                       const BwdArgs& a, cudaStream_t st) {
  return D == 64    ? launch_bwd_d<64>(dkv, dtype, B, H, Hkv, a, st)
         : D == 128 ? launch_bwd_d<128>(dkv, dtype, B, H, Hkv, a, st)
                    : launch_bwd_d<256>(dkv, dtype, B, H, Hkv, a, st);
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
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = D == 64    ? launch_d<64>(dtype, B, H, a, st)
                        : D == 128 ? launch_d<128>(dtype, B, H, a, st)
                                   : launch_d<256>(dtype, B, H, a, st);
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
