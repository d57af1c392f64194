// K5: single-token GQA decode attention over an int8 (per-row, per-head
// f32 scales) or bf16 KV cache, masked to rows [0, length[b]].
//
// Replaces sparsebit_tpu/ops/attention.py:499 _decode_attn_kernel
// (decode_attention, :557; decode_attention_stacked, :601): the
// "f32_dots" form of _group_attention (attention.py:46-96), whose math is
//     score[s] = (q . k[s]) * ks[s] * D^-1/2       (f32, s <= length)
//     p[s] = exp(score[s] - max), den = sum p
//     out = sum_s (p[s] * vs[s]) * v[s] / den
// with q and the cache values taken to f32 exactly (a bf16 cache has unit
// scales). The layer-stacked form is the same kernel on a pointer offset.
//
// Bound on the H100: the cache bytes of rows [0, length[b]] (2 * D bytes
// a row and head for int8 plus 8 bytes of scales; 4 * D for bf16) over
// 3.35 TB/s. Design, simple first: one block per (kv head, batch row)
// reads only its head's rows, once for the scores (one warp per row, the
// row's values in registers shared by the n_rep query heads) and once per
// four query heads for the value mix (warps over rows, lanes over D, the
// warps' partial sums added in warp order through shared memory).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDL = 8;  // D / 32 values per lane, D <= 256
constexpr int kRChunk = 4;  // query heads per value-mix pass

__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < kWarps; ++i) t = fmaxf(t, red[i]);
  return t;
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

// Dynamic shared memory: q (n_rep, D), scores then p * vs (n_rep, S), the
// warps' value-mix partials (kWarps, kRChunk, D).
template <class T, bool QUANT>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ length,
    float* __restrict__ out, int S, int Hkv, int H, int D,
    float inv_sqrt_d) {
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  __shared__ float den_sm[kRChunk];
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / Hkv;
  const int dl = D / 32;
  float* q_sm = smem;
  float* p_sm = q_sm + n_rep * D;
  float* part = p_sm + static_cast<size_t>(n_rep) * S;
  const int len = min(length[b], S - 1);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int i = threadIdx.x; i < n_rep * D; i += kThreads)
    q_sm[i] = q[(static_cast<size_t>(b) * H + h * n_rep) * D + i];
  __syncthreads();

  // 1. scores: one warp per cache row, the row's values kept in registers
  for (int s = warp; s <= len; s += kWarps) {
    const size_t row = (static_cast<size_t>(b) * S + s) * Hkv + h;
    float kv[kMaxDL];
#pragma unroll
    for (int i = 0; i < kMaxDL; ++i)
      kv[i] = i < dl ? to_f32(k[row * D + lane + 32 * i]) : 0.f;
    const float sc = QUANT ? ks[row] : 1.f;
    for (int r = 0; r < n_rep; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDL; ++i)
        if (i < dl) dot = __fmaf_rn(q_sm[r * D + lane + 32 * i], kv[i], dot);
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0)
        p_sm[r * S + s] = __fmul_rn(QUANT ? __fmul_rn(dot, sc) : dot,
                                    inv_sqrt_d);
    }
  }
  __syncthreads();

  // 2. softmax statistics per query head; p * vs replaces the score
  for (int r0 = 0; r0 < n_rep; r0 += kRChunk) {
    const int rn = min(kRChunk, n_rep - r0);
    for (int rr = 0; rr < rn; ++rr) {
      float* pr = p_sm + (r0 + rr) * S;
      float m = -1e30f;
      for (int s = threadIdx.x; s <= len; s += kThreads) m = fmaxf(m, pr[s]);
      m = block_max(m, red);
      float den = 0.f;
      for (int s = threadIdx.x; s <= len; s += kThreads) {
        const float p = expf(pr[s] - m);
        den += p;
        pr[s] = QUANT ? __fmul_rn(p, vs[(static_cast<size_t>(b) * S + s) *
                                            Hkv + h])
                      : p;
      }
      den = block_sum(den, red);
      if (threadIdx.x == 0) den_sm[rr] = den;
    }
    __syncthreads();

    // 3. value mix of these query heads: warps over rows, lanes over D
    float acc[kRChunk][kMaxDL];
#pragma unroll
    for (int rr = 0; rr < kRChunk; ++rr)
#pragma unroll
      for (int i = 0; i < kMaxDL; ++i) acc[rr][i] = 0.f;
    for (int s = warp; s <= len; s += kWarps) {
      const size_t row = (static_cast<size_t>(b) * S + s) * Hkv + h;
      float vv[kMaxDL];
#pragma unroll
      for (int i = 0; i < kMaxDL; ++i)
        vv[i] = i < dl ? to_f32(v[row * D + lane + 32 * i]) : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRChunk; ++rr) {
        if (rr >= rn) break;
        const float p = p_sm[(r0 + rr) * S + s];
#pragma unroll
        for (int i = 0; i < kMaxDL; ++i)
          acc[rr][i] = __fmaf_rn(p, vv[i], acc[rr][i]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRChunk; ++rr)
#pragma unroll
      for (int i = 0; i < kMaxDL; ++i)
        if (rr < rn && i < dl)
          part[(warp * kRChunk + rr) * D + lane + 32 * i] = acc[rr][i];
    __syncthreads();
    for (int idx = threadIdx.x; idx < rn * D; idx += kThreads) {
      const int rr = idx / D, d = idx % D;
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w)
        t = __fadd_rn(t, part[(w * kRChunk + rr) * D + d]);
      out[(static_cast<size_t>(b) * H + h * n_rep + r0 + rr) * D + d] =
          __fdiv_rn(t, den_sm[rr]);
    }
    __syncthreads();  // part and den_sm are reused by the next chunk
  }
}

template <class T, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* length,
                   void* out, int B, int S, int Hkv, int H, int D,
                   float inv_sqrt_d, cudaStream_t st) {
  const int n_rep = H / Hkv;
  const size_t smem = (static_cast<size_t>(n_rep) * D +
                       static_cast<size_t>(n_rep) * S +
                       static_cast<size_t>(kWarps) * kRChunk * D) *
                      sizeof(float);
  auto kern = decode_attn_kernel<T, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(Hkv, B), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<float*>(out), S, Hkv, H, D, inv_sqrt_d);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, D) f32; k, v (B, S, Hkv, D) int8 (ks, vs (B, S, Hkv) f32) or
// bf16 (bf16_cache; ks, vs ignored), already offset to a layer of a stack;
// length (B,) int32, rows [0, length[b]] attend (clamped to S - 1); out
// (B, H, D) f32. D % 32 == 0, D <= 256, H % Hkv == 0. inv_sqrt_d is
// 1/sqrt(D) rounded once to f32, as the reference's Python scalar.
extern "C" int sbt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, const void* length,
                                    void* out, int bf16_cache, int B, int S,
                                    int Hkv, int H, int D, float inv_sqrt_d,
                                    void* stream) {
  if (D % 32 || D > 32 * kMaxDL || H % Hkv || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      bf16_cache
          ? launch<__nv_bfloat16, false>(q, k, v, ks, vs, length, out, B, S,
                                         Hkv, H, D, inv_sqrt_d, st)
          : launch<int8_t, true>(q, k, v, ks, vs, length, out, B, S, Hkv, H,
                                 D, inv_sqrt_d, st);
  return static_cast<int>(e);
}
