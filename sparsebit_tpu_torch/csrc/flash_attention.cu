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
// first launch of each instantiation.
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
// swizzled tile; rows past S are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int row0, int S) {
  constexpr int per = 16 / sizeof(T);
  constexpr int CH = D / per;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
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
template <int D>
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
template <int D>
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
#pragma unroll
    for (int c = 0; c < NC; ++c)
      og[static_cast<long long>(row) * a.os[2] + lane + 32 * c] =
          o[r][c] * inv;
  }
}

template <auto Kernel>
cudaError_t launch(size_t smem, dim3 grid, const Args& a, cudaStream_t st) {
  static bool configured = false;  // one flag per kernel instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  Kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, int B, int H, const Args& a,
                     cudaStream_t st) {
  if (dtype == 0) {
    const dim3 grid((a.S + Bf16Tile<D>::BM - 1) / Bf16Tile<D>::BM, H, B);
    return launch<flash_bf16_kernel<D>>(Bf16Tile<D>::kSmem, grid, a, st);
  }
  const dim3 grid((a.S + F32Tile<D>::BM - 1) / F32Tile<D>::BM, H, B);
  return launch<flash_f32_kernel<D>>(F32Tile<D>::kSmem, grid, a, st);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype 0: bf16, 1: f32. q/out (B, H, S, D), k/v (B, Hkv, S, D), each
// through its element strides (batch, head, row) with the last dimension
// contiguous; every row 16-byte aligned.
extern "C" int sbt_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
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
