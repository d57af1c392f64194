// K2: fused per-head int8 quantization of the new K/V row, in-place cache
// row commit, and masked-softmax GQA decode attention over the cache.
//
// Replaces sparsebit_tpu/ops/attention.py:662 _attn_update_kernel
// (decode_attention_update).
//
// One block per (kv head, batch row); nothing carries over between
// blocks. The block quantizes the new rows of its head (scale rounded to
// bf16 before the codes are taken, kv_cache.py:82; rintf rounds half to
// even like jnp.round), writes codes and scales in place at position
// len_b of layer li, and keeps the fresh codes in shared memory: attention
// reads row len_b from there, as the TPU kernel patched its VMEM slab.
// It then attends for the n_rep query heads of the kv head over rows
// [0, len_b] with _group_attention's roundings (attention.py:46-96): q
// and p*vs in bf16, products and sums in f32. Scores go to shared memory
// (one warp per cache row), then one thread per head-dim lane mixes V.
// The cache layout is the port's own: k, v (L, B, S, Hkv, D) int8 and
// ks, vs (L, B, S, Hkv) f32 without lane padding.
// Bound on the H100: the cache bytes of rows [0, len_b] (2*D + 8 bytes a
// row and head) over 3.35 TB/s. Each block streams only its own head.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < kThreads / 32; ++i) t = fmaxf(t, red[i]);
  return t;
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ int8_t quant8(float v, float scale) {
  float r = fminf(fmaxf(rintf(v / scale), -128.f), 127.f);
  return static_cast<int8_t>(r);
}

__global__ void __launch_bounds__(kThreads) attn_update_kernel(
    const float* __restrict__ q, const float* __restrict__ kn,
    const float* __restrict__ vn, int8_t* __restrict__ kc,
    int8_t* __restrict__ vc, float* __restrict__ ks, float* __restrict__ vs,
    const int* __restrict__ length, float* __restrict__ out, int li, int B,
    int S, int Hkv, int H, int D, float inv_sqrt_d) {
  extern __shared__ float p_sm[];  // (n_rep, S) scores, then bf16(p*vs)
  __shared__ int8_t krow[kMaxD], vrow[kMaxD];
  __shared__ float red[kThreads / 32];
  __shared__ float stat_d[32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_rep = H / Hkv;
  const int len = length[b];
  const size_t lb = static_cast<size_t>(li) * B + b;  // (layer, row) index
  const float* knr = kn + (static_cast<size_t>(b) * Hkv + h) * D;
  const float* vnr = vn + (static_cast<size_t>(b) * Hkv + h) * D;

  // 1. quantize the new rows of this head and commit them in place
  float km = 0.f, vm = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    km = fmaxf(km, fabsf(knr[d]));
    vm = fmaxf(vm, fabsf(vnr[d]));
  }
  // max(absmax, 1e-8) * (1/127): XLA's form of the reference's / 127
  const float ksc =
      bf16_round(fmaxf(block_max(km, red), 1e-8f) * (1.0f / 127.0f));
  const float vsc =
      bf16_round(fmaxf(block_max(vm, red), 1e-8f) * (1.0f / 127.0f));
  const size_t new_row = (lb * S + len) * Hkv + h;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    int8_t kq = quant8(knr[d], ksc), vq = quant8(vnr[d], vsc);
    krow[d] = kq;
    vrow[d] = vq;
    kc[new_row * D + d] = kq;
    vc[new_row * D + d] = vq;
  }
  if (threadIdx.x == 0) {
    ks[new_row] = ksc;
    vs[new_row] = vsc;
  }
  __syncthreads();

  // 2. scores: one warp per cache row, lanes over D
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = 0; r < n_rep; ++r) {
    const float* qr = q + (static_cast<size_t>(b) * H + h * n_rep + r) * D;
    for (int s = warp; s <= len; s += kThreads / 32) {
      const size_t row = (lb * S + s) * Hkv + h;
      const int8_t* kr = (s == len) ? krow : kc + row * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot += bf16_round(qr[d]) * static_cast<float>(kr[d]);
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        float sc = (s == len) ? ksc : ks[row];
        p_sm[r * S + s] = __fmul_rn(__fmul_rn(dot, sc), inv_sqrt_d);
      }
    }
  }
  __syncthreads();

  // 3. softmax statistics, then p2 = bf16(exp(score - m) * vs) in place
  for (int r = 0; r < n_rep; ++r) {
    float m = -1e30f;
    for (int s = threadIdx.x; s <= len; s += kThreads)
      m = fmaxf(m, p_sm[r * S + s]);
    m = block_max(m, red);
    float den = 0.f;
    for (int s = threadIdx.x; s <= len; s += kThreads) {
      float p = expf(p_sm[r * S + s] - m);
      den += p;
      float sc = (s == len) ? vsc : vs[(lb * S + s) * Hkv + h];
      p_sm[r * S + s] = bf16_round(p * sc);
    }
    den = block_sum(den, red);
    if (threadIdx.x == 0) stat_d[r] = den;
  }
  __syncthreads();

  // 4. value mix: one thread per head-dim lane, V rows coalesced over d
  for (int d = threadIdx.x; d < D; d += kThreads) {
    for (int r = 0; r < n_rep; ++r) {
      float acc = 0.f;
      for (int s = 0; s < len; ++s)
        acc += p_sm[r * S + s] *
               static_cast<float>(vc[((lb * S + s) * Hkv + h) * D + d]);
      acc += p_sm[r * S + len] * static_cast<float>(vrow[d]);
      out[(static_cast<size_t>(b) * H + h * n_rep + r) * D + d] =
          acc / stat_d[r];
    }
  }
}

}  // namespace

// q (B, H, D) f32; kn, vn (B, Hkv, D) f32; k, v (L, B, S, Hkv, D) int8 and
// ks, vs (L, B, S, Hkv) f32 updated in place at [li, b, length[b]];
// length (B,) int32 < S; out (B, H, D) f32. D <= 256, n_rep <= 32.
// inv_sqrt_d is 1/sqrt(D) rounded once to f32, as the reference's scalar.
extern "C" int sbt_attn_update(const void* q, const void* kn, const void* vn,
                               void* k, void* v, void* ks, void* vs,
                               const void* length, void* out, int li, int B,
                               int S, int Hkv, int H, int D, float inv_sqrt_d,
                               void* stream) {
  const int n_rep = H / Hkv;
  const size_t smem = static_cast<size_t>(n_rep) * S * sizeof(float);
  if (smem > 40 * 1024) {  // with the static arrays, past the 48 KB default
    cudaError_t e = cudaFuncSetAttribute(
        attn_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(Hkv, B);
  attn_update_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<int8_t*>(k),
      static_cast<int8_t*>(v), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int*>(length),
      static_cast<float*>(out), li, B, S, Hkv, H, D, inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}
