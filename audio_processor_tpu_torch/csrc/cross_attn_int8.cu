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
// Bound on the H100: bytes at Tq=1.  One call streams K+V of one layer once
// (2*B*H*Dh*valid bytes: 295 MB at whisper-small, B=128, 88 us at
// 3.35 TB/s) and does 4 FLOP a byte pair.  A prefill (Tq up to ~55) does
// Tq times the products on the same bytes and is bound by the fp32 rate.
// The products stay f32 FFMA against exact int8 values: the contract is f32
// q against the cache's integers, so q and P are not quantised for the
// tensor cores.  What the design does about each limit:
//
//  1. Conversions.  A byte becomes a float without an int-to-float
//     instruction (16 a clock an SM, which at B=128 would cost almost as
//     much as the bytes): one XOR with 0x80808080 a word makes the bytes
//     offset binary (u = x + 128), PRMT places a byte in the low byte of
//     0x4B000000 (the float 2^23 + u, exactly) and one FADD takes 2^23 + 128
//     away, giving x exactly, for K and for V alike.  Per byte: 1 PRMT,
//     1 FADD, 1 FFMA and a quarter of a LOP.
//  2. Parallelism.  Time is split across blocks: grid (chunk, head, row),
//     a chunk kChunk = 128 time positions whatever B, H, Tq or Dh, so a
//     (row, head)'s arithmetic, and its output bit for bit, does not depend
//     on the grid.  Only chunks holding a valid column are launched:
//     whisper-small at B=8 is 1,152 blocks for 132 SMs, where a block a
//     (row, head) would be 96.
//  3. Loads.  A block stages its chunk's K (Dh rows of 128 bytes, a cache
//     row apart) and V (128 contiguous rows of Dh bytes), 16 KB at Dh=64,
//     in shared memory with 16-byte cp.async copies, all issued before the
//     first is used (the first query rows are read meanwhile).
//  4. Tq > 1 (the prefill).  The query rows loop on the resident chunk, so
//     K and V are read from device memory once a call whatever Tq is, and
//     they are taken kRows = 4 at a time: each converted byte feeds four
//     rows' FFMAs and each barrier serves four rows.
//  5. Idle threads.  Scores: 32 column words x 4 channel groups = 128
//     threads, then a sum over the groups; PV: channel words x row groups.
//     Dh is a compile-time power of two (8..256), so loops unroll and every
//     index is a shift: a division by a run-time value would also compile
//     to an I2F.
//
// One launch a call: each block writes its chunk's (max, sum, acc[Dh]) per
// query row to a workspace, fences, and takes a ticket from a per-(row,
// head) counter; no block waits for another.  The block that draws the
// last ticket combines the chunks in chunk order (a deterministic sum) and
// puts the counter back to 0.  The layer is a view the host passes in
// place: no per-layer copy.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;                    // time positions a block
constexpr int kKWords = kChunk / 4;            // 32-bit words of a K row in a chunk
constexpr int kKGroups = kThreads / kKWords;   // channel groups of the score loop
constexpr int kMaxDh = 256;
constexpr float kMagicX = 8388608.f + 128.f;   // 2^23 + 128: (2^23 + u) - it = x
static_assert(kThreads == kChunk, "the softmax gives a thread a time position");
static_assert(kThreads == 128 && kKGroups == 4, "the softmax reduces over 4 warps");

// Byte i (0..3) of ``offset`` (a word of offset-binary bytes u = x + 128)
// as the float 2^23 + u: the byte is the mantissa's low byte.
template <int i>
__device__ __forceinline__ float magic(uint32_t offset) {
  return __uint_as_float(__byte_perm(offset, 0x4B000000u, 0x7650 | i));
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

// kRows floats at p (16-byte aligned when kRows == 4), one value a query row
template <int kRows>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[kRows]) {
  if constexpr (kRows == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) x[rr] = p[rr];
  }
}

template <int kRows>
__device__ __forceinline__ void store_rows(float* p, const float (&x)[kRows]) {
  if constexpr (kRows == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) p[rr] = x[rr];
  }
}

// The four bytes of a cache word as the exact floats x
__device__ __forceinline__ void bytes_of(uint32_t word, float (&x)[4]) {
  const uint32_t u = word ^ 0x80808080u;  // offset binary: u = x + 128
  x[0] = magic<0>(u) - kMagicX;
  x[1] = magic<1>(u) - kMagicX;
  x[2] = magic<2>(u) - kMagicX;
  x[3] = magic<3>(u) - kMagicX;
}

// Chunk c of one (row, head): its K (Dh rows of kChunk bytes, a cache row
// apart) and V (kChunk contiguous rows of Dh bytes) into shared memory as
// [K dh x kChunk | V kChunk x dh], with 16-byte cp.async copies,
// neighbouring threads on neighbouring 16 bytes.
template <int kLog2Dh>
__device__ __forceinline__ void stage_chunk(uint8_t* tile, const uint8_t* k_head,
                                            const uint8_t* v_head, int c, int tpad, int tid) {
  constexpr int dh = 1 << kLog2Dh;
  constexpr int kParts = kChunk / 16;  // 16-byte parts of a K row
  const uint8_t* kg = k_head + c * kChunk;
#pragma unroll
  for (int i = tid; i < dh * kParts; i += kThreads)
    cp_async16(tile + 16 * i, kg + (size_t)(i / kParts) * tpad + 16 * (i % kParts));
  const uint8_t* vg = v_head + (size_t)c * kChunk * dh;
#pragma unroll
  for (int i = tid; i < kChunk * dh / 16; i += kThreads)
    cp_async16(tile + dh * kChunk + 16 * i, vg + 16 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Query rows r0..r0+kRows-1 of one (row, head) into qs [dh][kRows]; rows
// past tq read as 0 (their results are never written)
template <int kLog2Dh, int kRows>
__device__ __forceinline__ void load_q(float* qs, const float* q, size_t b, int h, int r0, int tq,
                                       int n_head, int tid) {
  constexpr int dh = 1 << kLog2Dh;
  for (int i = tid; i < kRows * dh; i += kThreads) {
    const int rr = i >> kLog2Dh, d = i & (dh - 1), r = r0 + rr;
    qs[d * kRows + rr] = r < tq ? q[((b * tq + r) * n_head + h) * dh + d] : 0.f;
  }
}

template <int kLog2Dh, int kRows>
__global__ void __launch_bounds__(kThreads)
cross_attn_int8_kernel(const float* __restrict__ q,      // (B, Tq, H, Dh)
                       const uint8_t* __restrict__ k8,   // (B, H, Dh, Tpad) of one layer
                       const uint8_t* __restrict__ v8,   // (B, H, Tpad, Dh) of one layer
                       float* __restrict__ out,          // (B, Tq, H, Dh)
                       float* __restrict__ work,         // (B*H, Tq, chunks, Dh + 2)
                       unsigned* __restrict__ counters,  // (B*H,), 0 between calls
                       int tq, int n_head, int tpad, int valid_len, float scale) {
  constexpr int dh = 1 << kLog2Dh;
  constexpr int log2_words_v = kLog2Dh - 2;        // 32-bit words of a V row
  constexpr int log2_v_groups = 7 - log2_words_v;  // row groups of the PV loop
  constexpr int v_groups = 1 << log2_v_groups;     // (v_groups * dh = 4 * kChunk)
  constexpr int work_row = dh + 2;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * n_head + h;
  const int n_chunks = gridDim.x;  // the chunks holding a valid column

  extern __shared__ __align__(16) unsigned char smem[];
  // the chunk's tile [K dh x kChunk | V kChunk x dh], then the scratch
  float* red = reinterpret_cast<float*>(smem + 2 * dh * kChunk);  // [kRows][4][kChunk] partials
  float* ps = red + kRows * kKGroups * kChunk;                     // [kChunk][kRows] probabilities
  float* qs = ps + kChunk * kRows;                                 // [dh][kRows] query rows
  float* wred = qs + dh * kRows;                                   // [8][kRows] warp partials
  unsigned* flag = reinterpret_cast<unsigned*>(wred + 8 * kRows);

  stage_chunk<kLog2Dh>(smem, k8 + bh * dh * tpad, v8 + bh * tpad * dh, c, tpad, tid);
  // the first query rows are read while the copies fly
  load_q<kLog2Dh, kRows>(qs, q, b, h, 0, tq, n_head, tid);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t* vs32 = ks32 + dh * kChunk / 4;
  const bool valid = c * kChunk + tid < valid_len;  // the softmax's time position

  for (int r0 = 0; r0 < tq; r0 += kRows) {
    if (r0 > 0) load_q<kLog2Dh, kRows>(qs, q, b, h, r0, tq, n_head, tid);
    __syncthreads();  // publishes qs, and every thread's copies of the chunk

    // --- scores: thread (group g, word w) sums channels g, g+4, ... of
    // time positions 4w..4w+3, for kRows query rows
    {
      const int w = tid & (kKWords - 1), g = tid >> 5;
      float acc[kRows][4] = {};
#pragma unroll
      for (int it = 0; it < dh / kKGroups; ++it) {
        const int d = g + it * kKGroups;
        float x[4], qd[kRows];
        bytes_of(ks32[d * kKWords + w], x);
        load_rows<kRows>(qs + d * kRows, qd);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[rr][i] = fmaf(qd[rr], x[i], acc[rr][i]);
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        *reinterpret_cast<float4*>(red + (rr * kKGroups + g) * kChunk + 4 * w) =
            make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
    }
    __syncthreads();

    // --- the chunk's softmax: thread t owns time position t
    float s[kRows], m[kRows], p[kRows], l[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float t = 0.f;
#pragma unroll
      for (int g = 0; g < kKGroups; ++g) t += red[(rr * kKGroups + g) * kChunk + tid];
      s[rr] = valid ? t * scale : -INFINITY;
      const float mw = warp_max(s[rr]);
      if (lane == 0) wred[warp * kRows + rr] = mw;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      // finite: the chunk's first position is valid
      m[rr] = fmaxf(fmaxf(wred[rr], wred[kRows + rr]), fmaxf(wred[2 * kRows + rr], wred[3 * kRows + rr]));
      p[rr] = valid ? expf(s[rr] - m[rr]) : 0.f;
      const float lw = warp_sum(p[rr]);
      if (lane == 0) wred[(4 + warp) * kRows + rr] = lw;
    }
    store_rows<kRows>(ps + tid * kRows, p);
    __syncthreads();  // publishes ps; red is free again
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      l[rr] = (wred[4 * kRows + rr] + wred[5 * kRows + rr]) + (wred[6 * kRows + rr] + wred[7 * kRows + rr]);

    // --- PV: thread (row group g, word cw) owns channels 4cw..4cw+3 of
    // time rows g, g + v_groups, ...
    {
      const int cw = tid & ((1 << log2_words_v) - 1), g = tid >> log2_words_v;
      float acc[kRows][4] = {};
#pragma unroll
      for (int it = 0; it < (kChunk >> log2_v_groups); ++it) {
        const int j = g + (it << log2_v_groups);
        float x[4], pj[kRows];
        bytes_of(vs32[(j << log2_words_v) + cw], x);
        load_rows<kRows>(ps + j * kRows, pj);
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[rr][i] = fmaf(pj[rr], x[i], acc[rr][i]);
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        *reinterpret_cast<float4*>(red + (rr * v_groups + g) * dh + 4 * cw) =
            make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
    }
    __syncthreads();
    for (int i = tid; i < kRows * dh; i += kThreads) {
      const int rr = i >> kLog2Dh, d = i & (dh - 1), r = r0 + rr;
      float tot = 0.f;
#pragma unroll
      for (int g = 0; g < v_groups; ++g) tot += red[(rr * v_groups + g) * dh + d];
      if (r < tq) work[((bh * tq + r) * n_chunks + c) * work_row + 2 + d] = tot;
    }
    if (tid == 0) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (r0 + rr < tq) {
          float* part = work + ((bh * tq + r0 + rr) * n_chunks + c) * work_row;  // (m, l, acc[dh])
          part[0] = m[rr];
          part[1] = l[rr];
        }
      }
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
  float* wgt = red;                     // [kRows][kThreads]: m_c, then e^(m_c - M)
  float* lsum = red + kRows * kThreads;  // [kRows][kThreads]: l_c
  float* row_max = wred;                 // [kRows]
  float* row_den = wred + kRows;         // [kRows]
  for (int r0 = 0; r0 < tq; r0 += kRows) {
    if (tid < n_chunks) {  // every chunk's (m, l) at once
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        if (r0 + rr < tq) {
          const float* part = work + ((bh * tq + r0 + rr) * n_chunks + tid) * work_row;
          wgt[rr * kThreads + tid] = __ldcg(part);
          lsum[rr * kThreads + tid] = __ldcg(part + 1);
        }
      }
    }
    __syncthreads();
    if (tid < kRows && r0 + tid < tq) {
      float mx = -INFINITY;
      for (int cc = 0; cc < n_chunks; ++cc) mx = fmaxf(mx, wgt[tid * kThreads + cc]);
      row_max[tid] = mx;
    }
    __syncthreads();
    if (tid < n_chunks) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (r0 + rr < tq) wgt[rr * kThreads + tid] = expf(wgt[rr * kThreads + tid] - row_max[rr]);
    }
    __syncthreads();
    if (tid < kRows && r0 + tid < tq) {
      float den = 0.f;
      for (int cc = 0; cc < n_chunks; ++cc)  // chunk order
        den = fmaf(wgt[tid * kThreads + cc], lsum[tid * kThreads + cc], den);
      row_den[tid] = den;
    }
    __syncthreads();
    for (int i = tid; i < kRows * dh; i += kThreads) {
      const int rr = i >> kLog2Dh, d = i & (dh - 1), r = r0 + rr;
      if (r >= tq) continue;
      const float* parts = work + (bh * tq + r) * n_chunks * work_row + 2 + d;
      const float* w = wgt + rr * kThreads;
      float num = 0.f;
#pragma unroll 4
      for (int cc = 0; cc < n_chunks; ++cc) num = fmaf(w[cc], __ldcg(parts + cc * work_row), num);
      out[(((size_t)b * tq + r) * n_head + h) * dh + d] = num / row_den[rr];
    }
    __syncthreads();  // wgt, lsum and the row sums are rewritten by the next rows
  }
  if (tid == 0) counters[bh] = 0u;
}

template <int kLog2Dh, int kRows>
int launch(const void* q, const void* k8_layer, const void* v8_layer, void* out, void* work,
           void* counters, int batch, int tq, int n_head, int tpad, int n_chunks, int valid_len,
           float scale, cudaStream_t stream) {
  constexpr int dh = 1 << kLog2Dh;
  const size_t smem = (size_t)2 * kChunk * dh +
                      (size_t)(kRows * (kKGroups * kChunk + kChunk + dh + 8) + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(cross_attn_int8_kernel<kLog2Dh, kRows>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_chunks, n_head, batch);
  cross_attn_int8_kernel<kLog2Dh, kRows><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k8_layer),
      static_cast<const uint8_t*>(v8_layer), static_cast<float*>(out),
      static_cast<float*>(work), static_cast<unsigned*>(counters), tq, n_head, tpad, valid_len,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// k8_layer / v8_layer point at one layer of the cache.  ``work`` holds
// batch*n_head*tq*chunks*(dh + 2) floats, chunks = ceil(valid_len / 128);
// ``counters`` batch*n_head zeroed unsigned ints, left zeroed.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int cross_attn_int8_launch(const void* q, const void* k8_layer,
                                      const void* v8_layer, void* out, void* work,
                                      void* counters, int batch, int tq, int n_head, int dh,
                                      int tpad, int valid_len, float scale, void* stream) {
  // 16-byte copies of 128-position K rows and V chunks; every chunk lies
  // inside the cache; a thread a chunk in the combine
  int log2_dh = 3;
  while ((1 << log2_dh) < dh) ++log2_dh;
  if ((1 << log2_dh) != dh || dh > kMaxDh || tpad % kChunk != 0 || tpad > kThreads * kChunk ||
      valid_len < 1 || valid_len > tpad || tq < 1 || batch < 1 || n_head < 1 ||
      ((reinterpret_cast<uintptr_t>(k8_layer) | reinterpret_cast<uintptr_t>(v8_layer)) & 15))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (valid_len + kChunk - 1) / kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log2_dh) {
#define CROSS_ATTN_INT8_DH(L)                                                                  \
  case L:                                                                                      \
    return tq == 1 ? launch<L, 1>(q, k8_layer, v8_layer, out, work, counters, batch, tq,       \
                                  n_head, tpad, n_chunks, valid_len, scale, st)                \
                   : launch<L, 4>(q, k8_layer, v8_layer, out, work, counters, batch, tq,       \
                                  n_head, tpad, n_chunks, valid_len, scale, st);
    CROSS_ATTN_INT8_DH(3)
    CROSS_ATTN_INT8_DH(4)
    CROSS_ATTN_INT8_DH(5)
    CROSS_ATTN_INT8_DH(6)
    CROSS_ATTN_INT8_DH(7)
    CROSS_ATTN_INT8_DH(8)
#undef CROSS_ATTN_INT8_DH
  }
  return (int)cudaErrorInvalidValue;
}
