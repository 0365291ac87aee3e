// Decode cross-attention over ONE layer of the stacked, nibble-packed
// int4 cross-KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel cross_attention_int4_stacked
// (audio_processor_tpu/ops/pallas/decode_attention.py:411; body
// _kernel_int4_stacked :341, _int4_head_attention :211).  It computes the
// same function, not the TPU's block structure:
//
//   cache layout (init_cache + pack_int4_time): K (L,B,H,Dh,Tpad/2) and
//   V (L,B,H,Tpad/2,Dh) bytes; byte = u_even | u_odd << 4 with
//   u = x + 8 (offset binary, x in [-7,7]).  Low nibbles hold times
//   0,2,4,..., high nibbles 1,3,5,...  (time is stored de-interleaved).
//   scores_lo[j] = (q . u_lo[:,j] - 8 sum(q)) / sqrt(Dh), likewise hi;
//   joint softmax over both halves with n_even = ceil(valid/2) and
//   n_odd = floor(valid/2) valid columns; out = (p . u_v) / denom - 8,
//   in integer units (the caller multiplies by the V scale).
//
// Bound on the H100: bytes.  One call streams K+V of one layer once
// (B*H*Dh*Tpad bytes: 151 MB at whisper-small, B=128) and does ~2 FLOP per
// nibble, far below the fp32 ridge point.  Design: one CTA per (head,
// batch row) reads its 2*Dh*Tpad/2 bytes exactly once as 4-byte words,
// neighbouring threads on neighbouring words (coalesced), unpacks the
// nibbles in registers, keeps the Tpad scores of one query row in shared
// memory (6 KB at Tpad=1536), and reduces PV per thread group in registers
// before one shared-memory reduction.  The layer offset is applied by the
// host to the base pointers: no per-layer copy of the cache is made.  Query
// rows (Tq > 1 in the prefill) loop inside the CTA.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cross_attn_int4_kernel(const float* __restrict__ q,      // (B, Tq, H, Dh)
                       const uint8_t* __restrict__ k4,   // (B, H, Dh, half) of one layer
                       const uint8_t* __restrict__ v4,   // (B, H, half, Dh) of one layer
                       float* __restrict__ out,          // (B, Tq, H, Dh)
                       int tq, int n_head, int dh, int half, int valid_len,
                       float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t head = (size_t)b * n_head + h;
  const uint32_t* k_words = reinterpret_cast<const uint32_t*>(k4 + head * dh * half);
  const uint32_t* v_words = reinterpret_cast<const uint32_t*>(v4 + head * half * dh);
  const int words_k = half >> 2;  // 4-byte words per K row (over time)
  const int words_v = dh >> 2;    // 4-byte words per V row (over channels)
  const int groups = blockDim.x / words_v;
  const int n_even = (valid_len + 1) >> 1;
  const int n_odd = valid_len >> 1;

  extern __shared__ float smem[];
  float* s = smem;                  // [2*half] scores, then probs: [evens | odds]
  float* qs = s + 2 * half;         // [dh]
  float* part = qs + dh;            // [groups*dh] PV partial sums
  float* red = part + groups * dh;  // [32]

  for (int r = 0; r < tq; ++r) {
    const size_t row = ((size_t)b * tq + r) * n_head + h;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) qs[d] = q[row * dh + d];
    __syncthreads();
    float qsum = 0.f;
    for (int d = 0; d < dh; ++d) qsum += qs[d];
    const float corr = 8.f * qsum;  // q.(u-8) = q.u - 8 sum(q)

    // --- scores: each thread owns 4 packed columns = 8 time positions
    for (int w = threadIdx.x; w < words_k; w += blockDim.x) {
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < dh; ++d) {
        const uint32_t word = __ldg(k_words + (size_t)d * words_k + w);
        const float qd = qs[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t byte = (word >> (8 * i)) & 0xFFu;
          lo[i] = fmaf(qd, (float)(byte & 0xFu), lo[i]);
          hi[i] = fmaf(qd, (float)(byte >> 4), hi[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * w + i;
        s[j] = j < n_even ? (lo[i] - corr) * scale : -1e30f;
        s[half + j] = j < n_odd ? (hi[i] - corr) * scale : -1e30f;
      }
    }
    __syncthreads();

    // --- joint softmax over both halves
    float m = -INFINITY;
    for (int j = threadIdx.x; j < 2 * half; j += blockDim.x) m = fmaxf(m, s[j]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int j = threadIdx.x; j < 2 * half; j += blockDim.x) {
      const float p = expf(s[j] - m);
      s[j] = p;
      sum += p;
    }
    const float denom = block_sum(sum, red);  // its barrier publishes s

    // --- PV: thread (g, c) owns channels 4c..4c+3 over rows g, g+groups, ...
    const int g = threadIdx.x / words_v, c = threadIdx.x % words_v;
    if (g < groups) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = g; j < half; j += groups) {
        const uint32_t word = __ldg(v_words + (size_t)j * words_v + c);
        const float pl = s[j], ph = s[half + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t byte = (word >> (8 * i)) & 0xFFu;
          acc[i] = fmaf(pl, (float)(byte & 0xFu), acc[i]);
          acc[i] = fmaf(ph, (float)(byte >> 4), acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) part[g * dh + 4 * c + i] = acc[i];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      float tot = 0.f;
      for (int gg = 0; gg < groups; ++gg) tot += part[gg * dh + d];
      // p.(u-8) = p.u - 8 denom: a constant -8 shift after normalising
      out[row * dh + d] = tot / denom - 8.f;
    }
    __syncthreads();  // qs, s and part are rewritten by the next row
  }
}

}  // namespace

// k4_layer / v4_layer point at layer l of the stacked cache.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int cross_attn_int4_launch(const void* q, const void* k4_layer,
                                      const void* v4_layer, void* out, int batch,
                                      int tq, int n_head, int dh, int half,
                                      int valid_len, float scale, void* stream) {
  // 4-byte word loads along time (K) and channels (V); one thread per
  // V word of a row
  if (dh % 4 != 0 || half % 4 != 0 || dh / 4 > kThreads) return (int)cudaErrorInvalidValue;
  const int groups = kThreads / (dh / 4);
  const size_t smem = (size_t)(2 * half + dh + groups * dh + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cross_attn_int4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_head, batch);
  cross_attn_int4_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k4_layer),
      static_cast<const uint8_t*>(v4_layer), static_cast<float*>(out), tq, n_head,
      dh, half, valid_len, scale);
  return (int)cudaGetLastError();
}
