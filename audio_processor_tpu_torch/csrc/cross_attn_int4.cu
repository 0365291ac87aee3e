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
//   scores_lo[j] = q . (u_lo[:,j] - 8) / sqrt(Dh), likewise hi; joint
//   softmax over both halves with n_even = ceil(valid/2) and
//   n_odd = floor(valid/2) valid columns; out = (p . u_v) / denom - 8,
//   in integer units (the caller multiplies by the V scale).
//
// Bound on the H100: bytes.  One call streams K+V of one layer once
// (B*H*Dh*Tpad bytes: 151 MB at whisper-small, B=128: 44 us at 3.35 TB/s)
// and does ~2 FLOP per nibble, far below the fp32 ridge point.  What the
// design does about each limit of a one-block-per-(head, row) kernel:
//
//  1. Conversions.  A nibble becomes a float without an int-to-float
//     instruction: PRMT places it in the low byte of 0x4B000000 (2^23 + u,
//     exactly) and one FADD takes 2^23 away (2^23 + 8 for K, which folds
//     the offset into the scores).  Per nibble: 1 PRMT, 1 FADD, 1 FFMA and
//     3/8 of an AND/shift.
//  2. Parallelism.  Time is split across blocks: grid (chunk, head, row),
//     a chunk kChunk = 64 packed columns (128 time positions) whatever B,
//     H, tp or Dh, so a (row, head)'s arithmetic, and its output bit for
//     bit, does not depend on the grid.  Only chunks holding a valid column
//     are launched; whisper-small at B=8 is 1,152 blocks (was 96).
//  3. Loads.  A block stages its chunk's K (Dh x 64 B, rows a cache row
//     apart) and V (64 x Dh B, contiguous) in shared memory with 16-byte
//     cp.async copies, all issued before the first is used (the first
//     query row is read meanwhile); scores and PV then read shared memory.
//  4. Idle threads.  Scores: 16 column words x 8 channel groups = 128
//     threads, then a sum over the groups; PV: channel words x row groups.
//     Dh is a compile-time power of two (8..256), so loops unroll and every
//     index is a shift: a division by a run-time value would also compile
//     to an I2F.
//  5. Tq > 1 (the prefill).  The query rows loop on the resident chunk, so
//     K and V are read from device memory once per call whatever Tq is.
//
// One launch a call: each block writes its chunk's (max, sum, acc[Dh]) per
// query row to a workspace, fences, and takes a ticket from a per-(row,
// head) counter; the block that draws the last ticket combines the chunks
// in chunk order (a deterministic sum), loading every chunk's max and sum
// at once, and puts the counter back to 0.  The layer offset is applied by
// the host to the base pointers: no per-layer copy of the cache is made.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;                     // packed columns a block
constexpr int kTimes = 2 * kChunk;             // time positions a block
constexpr int kKWords = kChunk / 4;            // 32-bit words of a K row in a chunk
constexpr int kKGroups = kThreads / kKWords;   // channel groups of the score loop
constexpr int kMaxDh = 256;
constexpr float kTwo23 = 8388608.f;            // 2^23
static_assert(kThreads == 128, "the softmax reduces over 4 warps");

// Nibble i (0..3) of ``masked`` (one nibble a byte, 0x0F0F0F0F applied)
// as the float 2^23 + u: its byte is the mantissa's low byte.
template <int i>
__device__ __forceinline__ float magic(uint32_t masked) {
  return __uint_as_float(__byte_perm(masked, 0x4B000000u, 0x7650 | i));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Chunk c of one (row, head): its K (Dh rows of kChunk bytes, a cache
// row apart) and V (kChunk contiguous rows of Dh bytes) into shared memory
// as [K dh x kChunk | V kChunk x dh], with 16-byte cp.async copies,
// neighbouring threads on neighbouring 16 bytes.
template <int kLog2Dh>
__device__ __forceinline__ void stage_chunk(uint8_t* tile, const uint8_t* k_head,
                                            const uint8_t* v_head, int c, int half, int tid) {
  constexpr int dh = 1 << kLog2Dh;
  constexpr int kParts = kChunk / 16;  // 16-byte parts of a K row
  const uint8_t* kg = k_head + c * kChunk;
#pragma unroll
  for (int i = tid; i < dh * kParts; i += kThreads)
    cp_async16(tile + 16 * i, kg + (size_t)(i / kParts) * half + 16 * (i % kParts));
  const uint8_t* vg = v_head + (size_t)c * kChunk * dh;
#pragma unroll
  for (int i = tid; i < kChunk * dh / 16; i += kThreads)
    cp_async16(tile + dh * kChunk + 16 * i, vg + 16 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kLog2Dh>
__global__ void __launch_bounds__(kThreads)
cross_attn_int4_kernel(const float* __restrict__ q,      // (B, Tq, H, Dh)
                       const uint8_t* __restrict__ k4,   // (B, H, Dh, half) of one layer
                       const uint8_t* __restrict__ v4,   // (B, H, half, Dh) of one layer
                       float* __restrict__ out,          // (B, Tq, H, Dh)
                       float* __restrict__ work,         // (B*H, Tq, chunks, Dh + 2)
                       unsigned* __restrict__ counters,  // (B*H,), 0 between calls
                       int tq, int n_head, int half, int valid_len, float scale) {
  // Dh is a compile-time power of two (8..256): the loops over it unroll,
  // and no index needs a division by a run-time value (nvcc compiles one
  // with an I2F)
  constexpr int dh = 1 << kLog2Dh;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * n_head + h;
  const int n_even = (valid_len + 1) >> 1;
  const int n_odd = valid_len >> 1;
  const int n_chunks = gridDim.x;  // the chunks holding a valid column
  const int j0 = c * kChunk;

  extern __shared__ __align__(16) unsigned char smem[];
  // the chunk's tile [K dh x kChunk | V kChunk x dh], then the scratch
  float* red = reinterpret_cast<float*>(smem + 2 * dh * kChunk);  // [kKGroups][kTimes]
  float* ps = red + kKGroups * kTimes;                 // [kTimes] probabilities
  float* qs = ps + kTimes;                             // [dh]
  float* wred = qs + dh;                               // [8] warp partials
  unsigned* flag = reinterpret_cast<unsigned*>(wred + 8);

  stage_chunk<kLog2Dh>(smem, k4 + bh * dh * half, v4 + bh * half * dh, c, half, tid);
  constexpr int log2_words_v = kLog2Dh - 2;        // 32-bit words of a V row
  constexpr int log2_v_groups = 7 - log2_words_v;  // row groups of the PV loop (<= kChunk)
  constexpr int work_row = dh + 2;
  // the first query row is read while the copies fly
  for (int d = tid; d < dh; d += kThreads) qs[d] = q[((size_t)b * tq * n_head + h) * dh + d];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t* vs32 = ks32 + dh * kChunk / 4;

  for (int r = 0; r < tq; ++r) {
    if (r > 0) {
      const size_t qrow = ((size_t)b * tq + r) * n_head + h;
      for (int d = tid; d < dh; d += kThreads) qs[d] = q[qrow * dh + d];
    }
    __syncthreads();  // publishes qs, and every thread's copies of the chunk

    // --- scores: thread (group g, word w) sums channels g, g+8, ... of
    // packed columns 4w..4w+3, even and odd times
    {
      const int w = tid % kKWords, g = tid / kKWords;
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int it = 0; it < (dh >> 3); ++it) {
        const int d = g + it * kKGroups;
        const uint32_t word = ks32[d * kKWords + w];
        const uint32_t wl = word & 0x0F0F0F0Fu, wh = (word >> 4) & 0x0F0F0F0Fu;
        const float qd = qs[d];
        // (2^23 + u) - (2^23 + 8) = u - 8, exactly
        lo[0] = fmaf(qd, magic<0>(wl) - (kTwo23 + 8.f), lo[0]);
        lo[1] = fmaf(qd, magic<1>(wl) - (kTwo23 + 8.f), lo[1]);
        lo[2] = fmaf(qd, magic<2>(wl) - (kTwo23 + 8.f), lo[2]);
        lo[3] = fmaf(qd, magic<3>(wl) - (kTwo23 + 8.f), lo[3]);
        hi[0] = fmaf(qd, magic<0>(wh) - (kTwo23 + 8.f), hi[0]);
        hi[1] = fmaf(qd, magic<1>(wh) - (kTwo23 + 8.f), hi[1]);
        hi[2] = fmaf(qd, magic<2>(wh) - (kTwo23 + 8.f), hi[2]);
        hi[3] = fmaf(qd, magic<3>(wh) - (kTwo23 + 8.f), hi[3]);
      }
      // times [evens | odds] of the chunk: t = col, kChunk + col
      *reinterpret_cast<float4*>(red + g * kTimes + 4 * w) = make_float4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<float4*>(red + g * kTimes + kChunk + 4 * w) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
    }
    __syncthreads();

    // --- the chunk's softmax: thread t owns time position t
    const int col = j0 + (tid % kChunk);
    const bool valid = col < (tid < kChunk ? n_even : n_odd);
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kKGroups; ++g) s += red[g * kTimes + tid];
    s = valid ? s * scale : -INFINITY;
    float m = warp_max(s);
    if (lane == 0) wred[warp] = m;
    __syncthreads();
    m = fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3]));  // finite: column j0 is valid
    const float p = valid ? expf(s - m) : 0.f;
    ps[tid] = p;
    float l = warp_sum(p);
    if (lane == 0) wred[4 + warp] = l;
    __syncthreads();  // publishes ps; red is free again
    l = (wred[4] + wred[5]) + (wred[6] + wred[7]);

    // --- PV: thread (row group g, word cw) owns channels 4cw..4cw+3 of
    // packed rows g, g + groups, ...
    {
      const int cw = tid & ((1 << log2_words_v) - 1), g = tid >> log2_words_v;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int it = 0; it < (kChunk >> log2_v_groups); ++it) {
        const int j = g + (it << log2_v_groups);
        const uint32_t word = vs32[(j << log2_words_v) + cw];
        const uint32_t wl = word & 0x0F0F0F0Fu, wh = (word >> 4) & 0x0F0F0F0Fu;
        const float pl = ps[j], ph = ps[kChunk + j];
        acc[0] = fmaf(ph, magic<0>(wh) - kTwo23, fmaf(pl, magic<0>(wl) - kTwo23, acc[0]));
        acc[1] = fmaf(ph, magic<1>(wh) - kTwo23, fmaf(pl, magic<1>(wl) - kTwo23, acc[1]));
        acc[2] = fmaf(ph, magic<2>(wh) - kTwo23, fmaf(pl, magic<2>(wl) - kTwo23, acc[2]));
        acc[3] = fmaf(ph, magic<3>(wh) - kTwo23, fmaf(pl, magic<3>(wl) - kTwo23, acc[3]));
      }
      *reinterpret_cast<float4*>(red + g * dh + 4 * cw) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    float* part = work + ((bh * tq + r) * n_chunks + c) * work_row;  // (m, l, acc[dh])
    for (int d = tid; d < dh; d += kThreads) {
      float tot = 0.f;
#pragma unroll
      for (int g = 0; g < (kThreads >> log2_words_v); ++g) tot += red[g * dh + d];
      part[2 + d] = tot;
    }
    if (tid == 0) {
      part[0] = m;
      part[1] = l;
    }
    __syncthreads();  // qs, red and ps are rewritten next
  }

  // --- the last block of this (row, head) to finish combines the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(counters + bh, 1u) == (unsigned)(n_chunks - 1);
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  float* wgt = red;  // [n_chunks] e^(m_c - M), then [n_chunks] l_c
  float* lsum = red + kThreads;
  for (int r = 0; r < tq; ++r) {
    const float* parts = work + (bh * tq + r) * n_chunks * work_row;
    if (tid < n_chunks) {  // every chunk's (m, l) at once
      wgt[tid] = __ldcg(parts + tid * work_row);
      lsum[tid] = __ldcg(parts + tid * work_row + 1);
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int cc = 0; cc < n_chunks; ++cc) mx = fmaxf(mx, wgt[cc]);
    __syncthreads();
    if (tid < n_chunks) wgt[tid] = expf(wgt[tid] - mx);
    __syncthreads();
    float den = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) den = fmaf(wgt[cc], lsum[cc], den);  // chunk order
    for (int d = tid; d < dh; d += kThreads) {
      float num = 0.f;
#pragma unroll 4
      for (int cc = 0; cc < n_chunks; ++cc) num = fmaf(wgt[cc], __ldcg(parts + cc * work_row + 2 + d), num);
      // p.(u-8) = p.u - 8 denom: a constant -8 shift after normalising
      out[(((size_t)b * tq + r) * n_head + h) * dh + d] = num / den - 8.f;
    }
    __syncthreads();  // wgt and lsum are rewritten by the next row
  }
  if (tid == 0) counters[bh] = 0u;
}

template <int kLog2Dh>
int launch(const void* q, const void* k4_layer, const void* v4_layer, void* out, void* work,
           void* counters, int batch, int tq, int n_head, int half, int n_chunks, int valid_len,
           float scale, cudaStream_t stream) {
  constexpr int dh = 1 << kLog2Dh;
  const size_t smem = (size_t)2 * kChunk * dh +
                      (size_t)(kKGroups * kTimes + kTimes + dh + 8 + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(cross_attn_int4_kernel<kLog2Dh>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_chunks, n_head, batch);
  cross_attn_int4_kernel<kLog2Dh><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k4_layer),
      static_cast<const uint8_t*>(v4_layer), static_cast<float*>(out),
      static_cast<float*>(work), static_cast<unsigned*>(counters), tq, n_head, half, valid_len,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// k4_layer / v4_layer point at layer l of the stacked cache.  ``work``
// holds batch*n_head*tq*chunks*(dh + 2) floats, chunks = ceil(ceil(valid/2)
// / 64); ``counters`` batch*n_head zeroed unsigned ints, left zeroed.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int cross_attn_int4_launch(const void* q, const void* k4_layer,
                                      const void* v4_layer, void* out, void* work,
                                      void* counters, int batch, int tq, int n_head,
                                      int dh, int half, int valid_len, float scale,
                                      void* stream) {
  // 16-byte copies of 64-column K rows and 64-row V chunks; a V row's words
  // fit the block; every chunk lies inside the cache; a thread a chunk in
  // the combine
  int log2_dh = 3;
  while ((1 << log2_dh) < dh) ++log2_dh;
  if ((1 << log2_dh) != dh || dh > kMaxDh || half % kChunk != 0 || half > kThreads * kChunk ||
      valid_len < 1 || valid_len > 2 * half || tq < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = ((valid_len + 1) / 2 + kChunk - 1) / kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log2_dh) {
#define CROSS_ATTN_INT4_DH(L)                                                                   \
  case L:                                                                                       \
    return launch<L>(q, k4_layer, v4_layer, out, work, counters, batch, tq, n_head, half,        \
                     n_chunks, valid_len, scale, st);
    CROSS_ATTN_INT4_DH(3)
    CROSS_ATTN_INT4_DH(4)
    CROSS_ATTN_INT4_DH(5)
    CROSS_ATTN_INT4_DH(6)
    CROSS_ATTN_INT4_DH(7)
    CROSS_ATTN_INT4_DH(8)
#undef CROSS_ATTN_INT4_DH
  }
  return (int)cudaErrorInvalidValue;
}
