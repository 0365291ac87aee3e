// Decode cross-attention over ONE layer of the int8 kernel-layout cross-KV
// cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel cross_attention_int8
// (audio_processor_tpu/ops/pallas/decode_attention.py:83; body _kernel :58).
// It computes the same function, not the TPU's block structure:
//
//   q (B,Tq,H,Dh) f32 with K's dequant scale folded in; K (B,H,Dh,Tpad) and
//   V (B,H,Tpad,Dh) int8 (init_cache's int8 kernel layout, zero-padded to
//   Tpad = ceil(Ta/128)*128).  scores[t] = q . K[:,t] / sqrt(Dh), masked to
//   -1e30 for t >= valid_len; softmax in f32; out = p . V in integer units
//   (the caller multiplies by V's scale).
//
// Bound on the H100: bytes.  One call streams K+V of one layer once
// (2*B*H*Dh*Tpad bytes: 302 MB at whisper-small, B=128, of which the
// 1500 valid positions are 295 MB) and does 4 FLOP per byte pair, far below
// the fp32 ridge point.  Design (kernel B's, without the nibble unpack): one
// CTA per (head, batch row) reads its 2*Dh*Tpad bytes once per query row as
// 4-byte words, neighbouring threads on neighbouring words (coalesced along
// time for K, along channels for V), sign-extends the bytes in registers,
// keeps the Tpad scores of one query row in shared memory (6 KB at
// Tpad=1536), and reduces PV per thread group in registers before one
// shared-memory reduction.  The layer is a view the host passes in place: no
// per-layer copy.  Query rows loop inside the CTA, so a prefill with Tq > 1
// (a prompted or conditioned one, up to ~55 rows) re-reads the layer's K and
// V once per row; a register tile of several q rows is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;

// byte i of a little-endian word, sign-extended
__device__ __forceinline__ float sbyte(uint32_t word, int i) {
  return (float)((int32_t)(word << (24 - 8 * i)) >> 24);
}

__global__ void __launch_bounds__(kThreads)
cross_attn_int8_kernel(const float* __restrict__ q,     // (B, Tq, H, Dh)
                       const int8_t* __restrict__ k8,   // (B, H, Dh, Tpad) of one layer
                       const int8_t* __restrict__ v8,   // (B, H, Tpad, Dh) of one layer
                       float* __restrict__ out,         // (B, Tq, H, Dh)
                       int tq, int n_head, int dh, int tpad, int valid_len,
                       float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t head = (size_t)b * n_head + h;
  const uint32_t* k_words = reinterpret_cast<const uint32_t*>(k8 + head * dh * tpad);
  const uint32_t* v_words = reinterpret_cast<const uint32_t*>(v8 + head * tpad * dh);
  const int words_k = tpad >> 2;  // 4-byte words per K row (over time)
  const int words_v = dh >> 2;    // 4-byte words per V row (over channels)
  const int groups = blockDim.x / words_v;

  extern __shared__ float smem[];
  float* s = smem;                  // [tpad] scores, then probs
  float* qs = s + tpad;             // [dh]
  float* part = qs + dh;            // [groups*dh] PV partial sums
  float* red = part + groups * dh;  // [32]

  for (int r = 0; r < tq; ++r) {
    const size_t row = ((size_t)b * tq + r) * n_head + h;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) qs[d] = q[row * dh + d];
    __syncthreads();

    // --- scores: each thread owns one word = 4 time positions
    for (int w = threadIdx.x; w < words_k; w += blockDim.x) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < dh; ++d) {
        const uint32_t word = __ldg(k_words + (size_t)d * words_k + w);
        const float qd = qs[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(qd, sbyte(word, i), acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * w + i;
        s[j] = j < valid_len ? acc[i] * scale : -1e30f;
      }
    }
    __syncthreads();

    // --- softmax over the row
    float m = -INFINITY;
    for (int j = threadIdx.x; j < tpad; j += blockDim.x) m = fmaxf(m, s[j]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int j = threadIdx.x; j < tpad; j += blockDim.x) {
      const float p = expf(s[j] - m);
      s[j] = p;
      sum += p;
    }
    const float denom = block_sum(sum, red);  // its barrier publishes s

    // --- PV: thread (g, c) owns channels 4c..4c+3 over rows g, g+groups, ...
    const int g = threadIdx.x / words_v, c = threadIdx.x % words_v;
    if (g < groups) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = g; j < valid_len; j += groups) {
        const uint32_t word = __ldg(v_words + (size_t)j * words_v + c);
        const float p = s[j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(p, sbyte(word, i), acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) part[g * dh + 4 * c + i] = acc[i];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      float tot = 0.f;
      for (int gg = 0; gg < groups; ++gg) tot += part[gg * dh + d];
      out[row * dh + d] = tot / denom;
    }
    __syncthreads();  // qs, s and part are rewritten by the next row
  }
}

}  // namespace

// k8_layer / v8_layer point at one layer of the cache.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int cross_attn_int8_launch(const void* q, const void* k8_layer,
                                      const void* v8_layer, void* out, int batch,
                                      int tq, int n_head, int dh, int tpad,
                                      int valid_len, float scale, void* stream) {
  // 4-byte word loads along time (K) and channels (V); one thread per
  // V word of a row
  if (dh % 4 != 0 || tpad % 4 != 0 || dh / 4 > kThreads || valid_len > tpad)
    return (int)cudaErrorInvalidValue;
  const int groups = kThreads / (dh / 4);
  const size_t smem = (size_t)(tpad + dh + groups * dh + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cross_attn_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_head, batch);
  cross_attn_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8_layer),
      static_cast<const int8_t*>(v8_layer), static_cast<float*>(out), tq, n_head, dh,
      tpad, valid_len, scale);
  return (int)cudaGetLastError();
}
