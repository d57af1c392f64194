// K5: single-token GQA decode attention over an int8 (per-row, per-head
// f32 scales) or a float (bf16, f16 or f32) KV cache, masked to rows
// [0, length[b]].
//
// Replaces sparsebit_tpu/ops/attention.py:499 _decode_attn_kernel
// (decode_attention, :557; decode_attention_stacked, :601): the
// "f32_dots" form of _group_attention (attention.py:46-96), whose math is
//     score[s] = (q . k[s]) * ks[s] * D^-1/2       (f32, s <= length)
//     p[s] = exp(score[s] - max), den = sum p
//     out = sum_s (p[s] * vs[s]) * v[s] / den
// with q and the cache values taken to f32 exactly (a float cache has
// unit scales). The layer-stacked form is the same kernel on a pointer offset.
//
// Bound on the H100: the cache bytes of rows [0, length[b]] (2 * D bytes
// a row and head for int8 plus 8 bytes of scales; 4 * D for bf16) over
// 3.35 TB/s (2 * D * elt bytes for a float cache). The f32 work is small, but each int8 code costs a byte
// permute and an add to become f32 and each row a few shuffles, so the
// issue rate matters as well as the bytes. Design (flash-decoding):
//   - the rows are split across blocks: grid (Hkv * groups, B, splits),
//     a fixed rows_per_split chosen by the wrapper so that even B = 1
//     fills the card. A split past length[b] returns before any load;
//   - one block serves all the query heads of its kv head (up to 8, a
//     "group"), so each K and V byte leaves HBM once for n_rep <= 8;
//   - each of the block's 4 warps is an independent worker over every
//     4th pass of the split's rows: a lane holds a 16-byte chunk of a row
//     (int8 D = 128 is 8 lanes a row and 4 rows a pass; narrower chunks
//     for groups of 4 or 8 heads keep the accumulators in registers; a
//     row of more than 32 chunks, up to D = 512, takes 2 or 4 a lane) and
//     copies its K and V chunks with cp.async into its own shared-memory
//     ring 8 passes ahead, reading back only what it copied: no barrier
//     in the loop, 32 KB of K and V in flight a block;
//   - per pass: the row's dot with q (registers) reduced across its
//     lanes by shuffles, an online softmax per query head (running max m,
//     rescaled sum l) and the value mix into the lane's accumulators,
//     rescaled by e^(m_old - m_new) only when the max moved. int8 codes
//     become f32 by a byte permute and a subtraction, not by the slow
//     int-to-float conversion;
//   - the warps' partials merge in warp order, each split writes (m, l,
//     acc[D]) per query head, and a second launch merges the splits in
//     split order:
//         m = max m_j,  l = sum e^(m_j - m) l_j,
//         out = sum e^(m_j - m) acc_j / l
//     over the splits that start at or before length[b]. Every sum has a
//     fixed order and nothing is atomic: two runs give the same bits.
// Shared memory is the lanes' rings, whatever S is.
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 512;  // head_dim: a row is at most 4 chunks a lane

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 16-byte chunk of cache values as f32, exactly: 16 int8 codes (each
// byte, offset to unsigned, spliced into the mantissa of 2^23 by one byte
// permute, then 2^23 + 128 subtracted: no int-to-float conversion, which
// runs at a sixteenth of the FMA rate), 8 bf16 values (a shift or a
// mask), 8 f16 values (a conversion each) or 4 f32 values (as they are).
template <class T>
__device__ __forceinline__ void chunk_f32(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = h.x;
      f[2 * i + 1] = h.y;
    }
  } else if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] =
            __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650 + j)) -
            8388736.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Query heads per group (a block) for n_rep query heads per kv head.
inline int group_of(int n_rep) {
  return n_rep == 1 ? 1 : n_rep == 2 ? 2 : n_rep <= 4 ? 4 : 8;
}

template <int CB>
struct ChunkT;  // a lane's CB bytes of a cache row
template <>
struct ChunkT<16> {
  using type = uint4;
};
template <>
struct ChunkT<8> {
  using type = uint2;
};
template <>
struct ChunkT<4> {
  using type = uint32_t;
};

template <int CB>
__device__ __forceinline__ void cp_async_chunk(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(CB)
                 : "memory");
}

// CB bytes of cache values as f32, exactly (chunk_f32 on 16 bytes).
template <class T, int CB>
__device__ __forceinline__ void chunk_to_f32(
    const typename ChunkT<CB>::type& u, float* f) {
  if constexpr (CB == 16) {
    chunk_f32<T>(u, f);
  } else {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (CB == 8) {
      w.x = u.x;
      w.y = u.y;
    } else {
      w.x = u;
    }
    float g[16 / sizeof(T)];
    chunk_f32<T>(w, g);
#pragma unroll
    for (int e = 0; e < CB / static_cast<int>(sizeof(T)); ++e) f[e] = g[e];
  }
}

// Per-lane chunk bytes: 16, narrowed for larger query groups so that a
// lane's accumulators (RG x CB / elt f32) stay at 32 registers or fewer.
template <class T, int RG>
__host__ __device__ constexpr int chunk_bytes() {
  return (RG * 16 / static_cast<int>(sizeof(T)) <= 32)
             ? 16
             : (RG * 8 / static_cast<int>(sizeof(T)) <= 32 ? 8 : 4);
}

// Ring depth in passes: 128 bytes of K (and of V) in flight a lane.
template <int CB, int NU>
__host__ __device__ constexpr int ring_depth() {
  return 128 / (CB * NU);
}

// Shared memory: the lanes' rings (depth x kThreads slots of NU K chunks,
// NU V chunks and one scale), reused at the end for the warps' partials
// (kWarps x (RG x D acc, RG m, RG l) f32).
template <class T, int RG, int NU>
__host__ __device__ inline size_t smem_bytes(int D) {
  constexpr int CB = chunk_bytes<T, RG>();
  const size_t ring = static_cast<size_t>(ring_depth<CB, NU>()) * kThreads *
                      (2 * CB * NU + 4);
  const size_t merge = static_cast<size_t>(kWarps) * RG * (D + 2) * 4;
  return ring > merge ? ring : merge;
}

// grid (Hkv * groups, B, splits), block kThreads. Each warp is its own
// flash-decoding worker over passes w, w + kWarps, ... of the block's
// split: a pass is rpp rows, lpr lanes a row, each lane with NU chunks of
// CB bytes of its row's K and V, copied by cp.async into the lane's own
// ring depth passes ahead (a lane reads back only what it copied: no
// barrier in the loop). Online softmax per query head with the warp's
// running (m, l) and the lane's accumulators; at the end the groups of a
// warp are summed by shuffles, and the block's warps merged in warp
// order into the split's partial.
template <class T, bool QUANT, int RG, int NU>
__global__ void __launch_bounds__(kThreads) decode_attn_split_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ length,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int S,
    int Hkv, int H, int D, float inv_sqrt_d, int rows_per_split,
    int n_splits) {
  constexpr int CB = chunk_bytes<T, RG>();
  constexpr int E = CB / sizeof(T);  // values a chunk
  constexpr int P = ring_depth<CB, NU>();
  using Chunk = typename ChunkT<CB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rep = H / Hkv;
  const int ng = (n_rep + RG - 1) / RG;
  const int h = blockIdx.x / ng, r0 = (blockIdx.x % ng) * RG;
  const int rn = min(RG, n_rep - r0);
  const int b = blockIdx.y, j = blockIdx.z;
  const int len = min(length[b], S - 1);
  const int s0 = j * rows_per_split;
  if (s0 > len) return;  // wholly past the length: the merge skips it
  const int s1 = min(s0 + rows_per_split, len + 1);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // lane map: lr lanes hold a row (lane sub: chunks sub * NU .. + NU - 1),
  // padded to lpr = a power of two; rpp rows a pass
  const int lr = D * static_cast<int>(sizeof(T)) / (CB * NU);
  int lpr = 1;
  while (lpr < lr) lpr <<= 1;
  const int rpp = 32 / lpr, grp = lane / lpr, sub = lane % lpr;
  const bool has_chunk = sub < lr;
  const int npass = (s1 - s0 + rpp - 1) / rpp;
  const int mine = npass > warp ? (npass - warp + kWarps - 1) / kWarps : 0;

  Chunk* ring_k = reinterpret_cast<Chunk*>(smem);  // (P, kThreads, NU)
  Chunk* ring_v = ring_k + P * kThreads * NU;
  float* ring_s = reinterpret_cast<float*>(ring_v + P * kThreads * NU);
  auto slot = [&](int i) { return (i % P) * kThreads + tid; };
  // this lane's row in the warp's i-th pass, or -1 past the split
  auto row_of = [&](int i) {
    const int s = s0 + (warp + kWarps * i) * rpp + grp;
    return s < s1 ? s : -1;
  };
  auto issue = [&](int i) {
    const int s = row_of(i);
    if (s < 0 || !has_chunk) return;
    const size_t row = (static_cast<size_t>(b) * S + s) * Hkv + h;
    const char* kr = reinterpret_cast<const char*>(k + row * D);
    const char* vr = reinterpret_cast<const char*>(v + row * D);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int off = (sub * NU + u) * CB;
      cp_async_chunk<CB>(ring_k + slot(i) * NU + u, kr + off);
      cp_async_chunk<CB>(ring_v + slot(i) * NU + u, vr + off);
    }
    if (QUANT && sub < 2)  // lane 0 of a row takes ks, lane 1 vs
      cp_async_chunk<4>(ring_s + slot(i), (sub ? vs : ks) + row);
  };

  for (int i = 0; i < P; ++i) {
    if (i < mine) issue(i);
    cp_commit();
  }
  // q of the group's heads for this lane's chunks, in registers
  float qr[RG][NU][E];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = (sub * NU + u) * E + e;
        qr[r][u][e] = r < rn && has_chunk && d < D
                          ? q[(static_cast<size_t>(b) * H + h * n_rep + r0 +
                               r) * D + d]
                          : 0.f;
      }
  float m[RG], l[RG], acc[RG][NU][E];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][u][e] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    cp_wait<P - 1>();  // pass i has landed (this lane's copies)
    const bool valid = row_of(i) >= 0;
    const int src = (lane & ~(lpr - 1));  // lane 0 of this row's group
    float kf[NU][E], vf[NU][E];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      Chunk kc = ring_k[slot(i) * NU + u], vc = ring_v[slot(i) * NU + u];
      if (!valid || !has_chunk) kc = vc = Chunk{};  // zeros are zeros
      chunk_to_f32<T, CB>(kc, kf[u]);
      chunk_to_f32<T, CB>(vc, vf[u]);
    }
    float sk = 1.f, sv = 1.f;
    if (QUANT) {
      const float own = ring_s[slot(i)];
      sk = __shfl_sync(0xffffffffu, own, src);
      sv = __shfl_sync(0xffffffffu, own, src + 1);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      if (r < rn) {  // uniform
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[r][u][e], kf[u][e], dot);
        for (int o = lpr / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float sc =
            valid ? (QUANT ? dot * sk : dot) * inv_sqrt_d : -INFINITY;
        float mx = sc;
        for (int o = lpr; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);  // finite: row 0 is valid
        const float pr = valid ? __expf(sc - m_new) : 0.f;
        float ps = pr;
        for (int o = lpr; o < 32; o <<= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        const float alpha = __expf(m[r] - m_new);  // 0 on the first pass
        l[r] = l[r] * alpha + ps;
        m[r] = m_new;
        const float pv = !valid ? 0.f : QUANT ? pr * sv : pr;
        if (alpha != 1.f) {  // uniform: the max moved
#pragma unroll
          for (int u = 0; u < NU; ++u)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][u][e] *= alpha;
        }
#pragma unroll
        for (int u = 0; u < NU; ++u)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][u][e] = fmaf(pv, vf[u][e], acc[r][u][e]);
      }
    }
    if (i + P < mine) issue(i + P);
    cp_commit();
  }
  cp_wait<0>();

  // the rows of a pass (lane groups) summed by shuffles, in a fixed order
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e)
        for (int o = lpr; o < 32; o <<= 1)
          acc[r][u][e] += __shfl_xor_sync(0xffffffffu, acc[r][u][e], o);
  __syncthreads();  // every lane is done with its ring
  float* w_acc = reinterpret_cast<float*>(smem);  // (kWarps, RG, D)
  float* w_m = w_acc + kWarps * RG * D;           // (kWarps, RG)
  float* w_l = w_m + kWarps * RG;
  if (grp == 0 && has_chunk) {
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e)
          w_acc[(warp * RG + r) * D + (sub * NU + u) * E + e] = acc[r][u][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      w_m[warp * RG + r] = m[r];  // -inf, l = 0: a warp with no rows
      w_l[warp * RG + r] = l[r];
    }
  }
  __syncthreads();
  // the warps merged in warp order: the split's (m, l, acc) per head
  for (int idx = tid; idx < rn * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, w_m[w * RG + r]);
    float o = 0.f, ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(w_m[w * RG + r] - mm);  // 0 for an empty warp
      o += wt * w_acc[(w * RG + r) * D + d];
      ll += wt * w_l[w * RG + r];
    }
    const size_t at =
        (static_cast<size_t>(b) * H + h * n_rep + r0 + r) * n_splits + j;
    part_acc[at * D + d] = o;
    if (d == 0) {
      part_ml[at * 2] = mm;
      part_ml[at * 2 + 1] = ll;
    }
  }
}

// grid (H, B), block D: out = sum_j e^(m_j - m) acc_j / sum_j e^(m_j - m) l_j
// over the splits j that start at or before length[b], in split order.
__global__ void decode_attn_merge_kernel(const float* __restrict__ part_acc,
                                         const float* __restrict__ part_ml,
                                         const int* __restrict__ length,
                                         float* __restrict__ out, int S,
                                         int H, int D, int rows_per_split,
                                         int n_splits) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(length[b], S - 1);
  const int nv = len < 0 ? 0 : len / rows_per_split + 1;
  const size_t base = (static_cast<size_t>(b) * H + hq) * n_splits;
  float m = -INFINITY;
#pragma unroll 8
  for (int jj = 0; jj < nv; ++jj) m = fmaxf(m, part_ml[(base + jj) * 2]);
  float l = 0.f, o = 0.f;
#pragma unroll 8
  for (int jj = 0; jj < nv; ++jj) {
    const float w = expf(part_ml[(base + jj) * 2] - m);
    l += w * part_ml[(base + jj) * 2 + 1];
    o += w * part_acc[(base + jj) * D + d];
  }
  out[(static_cast<size_t>(b) * H + hq) * D + d] = o / l;
}

template <class T, bool QUANT, int RG, int NU>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* length,
                   void* out, void* part_acc, void* part_ml, int B, int S,
                   int Hkv, int H, int D, float inv_sqrt_d,
                   int rows_per_split, cudaStream_t st) {
  const int n_rep = H / Hkv;
  const int ng = (n_rep + RG - 1) / RG;
  const int n_splits = (S + rows_per_split - 1) / rows_per_split;
  const size_t smem = smem_bytes<T, RG, NU>(D);
  auto kern = decode_attn_split_kernel<T, QUANT, RG, NU>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(Hkv * ng, B, n_splits), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), S, Hkv, H,
      D, inv_sqrt_d, rows_per_split, n_splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_attn_merge_kernel<<<dim3(H, B), D, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(length), static_cast<float*>(out), S, H, D,
      rows_per_split, n_splits);
  return cudaGetLastError();
}

// NU = 2 or 4 chunks a lane where one chunk a lane leaves a row wider
// than a warp (narrow chunks of larger groups, or D > 256); only the NU a
// row of up to kMaxD values can need are instantiated.
template <class T, bool QUANT, int RG>
cudaError_t launch_nu(int D, const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* length,
                      void* out, void* part_acc, void* part_ml, int B, int S,
                      int Hkv, int H, float inv_sqrt_d, int rows_per_split,
                      cudaStream_t st) {
  constexpr int CB = chunk_bytes<T, RG>();
  constexpr int kMaxChunks = kMaxD * static_cast<int>(sizeof(T)) / CB;
  const int chunks = D * static_cast<int>(sizeof(T)) / CB;  // a row's
#define SBT_NU(NU)                                                          \
  return launch<T, QUANT, RG, NU>(q, k, v, ks, vs, length, out, part_acc,   \
                                  part_ml, B, S, Hkv, H, D, inv_sqrt_d,     \
                                  rows_per_split, st)
  if constexpr (kMaxChunks > 64) {
    if (chunks > 64) {
      if (chunks % 4) return cudaErrorInvalidValue;
      SBT_NU(4);
    }
  }
  if constexpr (kMaxChunks > 32) {
    if (chunks > 32) {
      if (chunks % 2) return cudaErrorInvalidValue;
      SBT_NU(2);
    }
  }
  SBT_NU(1);
#undef SBT_NU
}

template <class T, bool QUANT>
cudaError_t launch_group(int n_rep, const void* q, const void* k,
                         const void* v, const void* ks, const void* vs,
                         const void* length, void* out, void* part_acc,
                         void* part_ml, int B, int S, int Hkv, int H, int D,
                         float inv_sqrt_d, int rows_per_split,
                         cudaStream_t st) {
#define SBT_LAUNCH(RG)                                                      \
  return launch_nu<T, QUANT, RG>(D, q, k, v, ks, vs, length, out, part_acc, \
                                 part_ml, B, S, Hkv, H, inv_sqrt_d,         \
                                 rows_per_split, st)
  switch (group_of(n_rep)) {
    case 1: SBT_LAUNCH(1);
    case 2: SBT_LAUNCH(2);
    case 4: SBT_LAUNCH(4);
    default: SBT_LAUNCH(8);
  }
#undef SBT_LAUNCH
}

}  // namespace

// q (B, H, D) f32; k, v (B, S, Hkv, D) int8 (ks, vs (B, S, Hkv) f32) or
// float (kv_type 1 bf16, 2 f16, 3 f32; ks, vs ignored; 0 is int8),
// already offset to a layer of a stack,
// 16-byte aligned; length (B,) int32, rows [0, length[b]] attend (clamped
// to S - 1); out (B, H, D) f32. D % 32 == 0, D <= 512, H % Hkv == 0.
// inv_sqrt_d is 1/sqrt(D) rounded once to f32, as the reference's Python
// scalar. Scratch: part_acc (B, H, splits, D) and part_ml (B, H, splits,
// 2) f32 with splits = ceil(S / rows_per_split).
extern "C" int sbt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* length,
                                    void* out, int kv_type, int B, int S,
                                    int Hkv, int H, int D, float inv_sqrt_d,
                                    void* part_acc, void* part_ml,
                                    int rows_per_split, void* stream) {
  if (D % 32 || D > kMaxD || H % Hkv || S < 1 || rows_per_split < 1 ||
      kv_type < 0 || kv_type > 3 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int n_rep = H / Hkv;
#define SBT_K5(T, QUANT)                                                    \
  launch_group<T, QUANT>(n_rep, q, k, v, ks, vs, length, out, part_acc,    \
                         part_ml, B, S, Hkv, H, D, inv_sqrt_d,              \
                         rows_per_split, st)
  cudaError_t e = kv_type == 0   ? SBT_K5(int8_t, true)
                  : kv_type == 1 ? SBT_K5(__nv_bfloat16, false)
                  : kv_type == 2 ? SBT_K5(__half, false)
                                 : SBT_K5(float, false);
#undef SBT_K5
  return static_cast<int>(e);
}
