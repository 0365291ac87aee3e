// Fused non-causal self-attention for the Whisper encoder, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel fused_self_attention
// (audio_processor_tpu/ops/pallas/encoder_attention.py:80; body _kernel :59).
// It computes the same function, not the TPU's block structure:
//
//   q, k, v (B, T, H, Dh) in the compute dtype (bf16 on the serving path,
//   f32 in parity runs), read through their strides: no transposing copy.
//   Dh = 64, the head width of every Whisper config.  scores = q k^T / sqrt(Dh) in f32, softmax in f32, P normalised and THEN
//   rounded to the compute dtype (encoder_attention.py:72), P v accumulated
//   in f32, output (B, T, H, Dh) in the compute dtype.  Keys past T (the
//   tail of the last 64-key tile; 1500 is not a multiple of 64) are masked.
//
// No (B, H, T, T) buffer is written: the plain path's f32 scores are
// 13.8 GB a layer at whisper-small's default slab (B=128, H=12, T=1500).
//
// Bound on the H100: operations.  4*B*H*T^2*Dh = 0.885 TFLOP a layer at
// B=128 (0.894 ms at 989 TFLOP/s bf16 dense) against 1.18 GB of q, k, v
// and out (0.352 ms at 3.35 TB/s).  Design, bf16: one CTA of 4 warps per
// (query block of 64, head, batch row); each warp owns 16 query rows held
// as mma.sync A fragments for the whole call.  Key tiles of 64 stream
// through shared memory (K row-major, V transposed so both B fragments are
// 4-byte loads; rows padded to 72 elements so those loads are free of bank
// conflicts).  Two passes keep the reference's rounding point: pass 1 runs
// QK^T with an online row max and sum; pass 2 runs QK^T again, forms
// P = exp(s - m) / l, rounds it to bf16 in registers (the C fragment of two
// n-tiles is the A fragment of the next product) and accumulates P V with
// mma.sync m16n8k16 into f32.  The second QK^T is the price of the exact
// rounding point: 1.5x the MMA work of one online-softmax pass, a lever for
// a speed PR, as are cp.async/TMA pipelining and wgmma.  f32: scalar FMA,
// one thread per query row, the same two passes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // bf16: 16 query rows per warp
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // bf16 elements of row padding

struct Strides {
  long long b, t, h;  // elements; the Dh axis has stride 1
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// K tile (row-major, keys past T zeroed) into ks[kBlockK][DH + kPad]
template <int DH>
__device__ __forceinline__ void load_k_tile(__nv_bfloat16* ks, const __nv_bfloat16* k,
                                            Strides sk, int t, int k0) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int row = i / kChunks, c = i % kChunks;  // chunks of a row on neighbours
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k0 + row < t) val = *reinterpret_cast<const uint4*>(k + (k0 + row) * sk.t + 8 * c);
    *reinterpret_cast<uint4*>(ks + row * (DH + kPad) + 8 * c) = val;
  }
}

// V tile transposed into vt[DH][kBlockK + kPad] (keys past T zeroed: a
// zero probability times stale memory could be 0 * NaN)
template <int DH>
__device__ __forceinline__ void load_vt_tile(__nv_bfloat16* vt, const __nv_bfloat16* v,
                                             Strides sv, int t, int k0) {
  constexpr int kChunks = DH / 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    // keys on neighbouring threads: their transposed stores hit neighbouring
    // shared-memory halves
    const int row = i % kBlockK, c = i / kBlockK;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (k0 + row < t) val = *reinterpret_cast<const uint4*>(v + (k0 + row) * sv.t + 8 * c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(8 * c + j) * (kBlockK + kPad) + row] = e[j];
  }
}

// s[n] = (q k^T)[16 rows of this warp][keys 8n .. 8n+7 of the tile], scaled
// and masked past T
template <int DH>
__device__ __forceinline__ void tile_scores(float s[kBlockK / 8][4],
                                            const uint32_t qa[DH / 16][4],
                                            const __nv_bfloat16* ks, int lane, int t,
                                            int k0, float scale) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < kBlockK / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const __nv_bfloat16* krow = ks + (8 * n + gid) * (DH + kPad) + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      mma_bf16(s[n], qa[kk], ld32(krow + 16 * kk), ld32(krow + 16 * kk + 8));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 8 * n + 2 * tig + (i & 1);
      s[n][i] = key < t ? s[n][i] * scale : -INFINITY;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
encoder_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int t, Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * (DH + kPad)];
  __shared__ __align__(16) __nv_bfloat16 vt[DH * (kBlockK + kPad)];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBlockQ + 16 * warp;  // this warp's first row
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;

  // A fragments of the warp's 16 query rows (rows past T are zeros)
  uint32_t qa[DH / 16][4];
  const int r0 = q0 + gid, r1 = q0 + gid + 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = 16 * kk + 2 * tig;
    qa[kk][0] = r0 < t ? ld32(q + r0 * sq.t + c) : 0u;
    qa[kk][1] = r1 < t ? ld32(q + r1 * sq.t + c) : 0u;
    qa[kk][2] = r0 < t ? ld32(q + r0 * sq.t + c + 8) : 0u;
    qa[kk][3] = r1 < t ? ld32(q + r1 * sq.t + c + 8) : 0u;
  }

  // --- pass 1: row max and sum (rows r0 and r1 of this thread's quad)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kBlockK / 8][4];
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load_k_tile<DH>(ks, k, sk, t, k0);
    __syncthreads();
    tile_scores<DH>(s, qa, ks, lane, t, k0, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);  // finite: every tile has a key < T
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n)
        sum += __expf(s[n][2 * r] - m_new) + __expf(s[n][2 * r + 1] - m_new);
      l[r] = l[r] * __expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv_l[r] = 1.f / l[r];
  }

  // --- pass 2: P = exp(s - m) / l rounded to bf16, O += P V in f32
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load_k_tile<DH>(ks, k, sk, t, k0);
    load_vt_tile<DH>(vt, v, sv, t, k0);
    __syncthreads();
    tile_scores<DH>(s, qa, ks, lane, t, k0, scale);
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {  // 16 keys: n-tiles 2kc, 2kc+1
      uint32_t pa[4];
      const float* s0 = s[2 * kc];
      const float* s1 = s[2 * kc + 1];
      pa[0] = pack_bf16(__expf(s0[0] - m[0]) * inv_l[0], __expf(s0[1] - m[0]) * inv_l[0]);
      pa[1] = pack_bf16(__expf(s0[2] - m[1]) * inv_l[1], __expf(s0[3] - m[1]) * inv_l[1]);
      pa[2] = pack_bf16(__expf(s1[0] - m[0]) * inv_l[0], __expf(s1[1] - m[0]) * inv_l[0]);
      pa[3] = pack_bf16(__expf(s1[2] - m[1]) * inv_l[1], __expf(s1[3] - m[1]) * inv_l[1]);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const __nv_bfloat16* vrow = vt + (8 * n + gid) * (kBlockK + kPad) + 16 * kc + 2 * tig;
        mma_bf16(o[n], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

  // --- out: C fragment rows r0 (o[.][0..1]) and r1 (o[.][2..3])
  out += b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = 8 * n + 2 * tig;
    if (r0 < t)
      *reinterpret_cast<uint32_t*>(out + r0 * so.t + c) = pack_bf16(o[n][0], o[n][1]);
    if (r1 < t)
      *reinterpret_cast<uint32_t*>(out + r1 * so.t + c) = pack_bf16(o[n][2], o[n][3]);
  }
}

// f32: one thread per query row, K/V tiles in shared memory read by
// broadcast, the same two passes
template <int DH>
__global__ void __launch_bounds__(kThreads)
encoder_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, int t,
                        Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  __shared__ __align__(16) float ks[kBlockK * DH];
  __shared__ __align__(16) float vs[kBlockK * DH];
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < t;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = live ? q[row * sq.t + d] : 0.f;

  auto load = [&](float* dst, const float* src, Strides st, int k0) {
    for (int i = threadIdx.x; i < kBlockK * DH / 4; i += kThreads) {
      const int key = i / (DH / 4), c = i % (DH / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + key < t) val = *reinterpret_cast<const float4*>(src + (k0 + key) * st.t + 4 * c);
      *reinterpret_cast<float4*>(dst + key * DH + 4 * c) = val;
    }
  };
  auto score = [&](int j) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc = fmaf(qr[d], ks[j * DH + d], acc);
    return acc * scale;
  };

  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load(ks, k, sk, k0);
    __syncthreads();
    const int n = min(kBlockK, t - k0);
    for (int j = 0; j < n; ++j) {
      const float sj = score(j);
      if (sj > m) {
        l = l * expf(m - sj) + 1.f;
        m = sj;
      } else {
        l += expf(sj - m);
      }
    }
  }
  float o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] = 0.f;
  for (int k0 = 0; k0 < t; k0 += kBlockK) {
    __syncthreads();
    load(ks, k, sk, k0);
    load(vs, v, sv, k0);
    __syncthreads();
    const int n = min(kBlockK, t - k0);
    for (int j = 0; j < n; ++j) {
      const float p = expf(score(j) - m) / l;
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] = fmaf(p, vs[j * DH + d], o[d]);
    }
  }
  if (live) {
    out += b * so.b + h * so.h + row * so.t;
#pragma unroll
    for (int d = 0; d < DH; ++d) out[d] = o[d];
  }
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, int batch,
           int t, int n_head, Strides sq, Strides sk, Strides sv, Strides so, float scale,
           cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((t + kBlockQ - 1) / kBlockQ, n_head, batch);
    encoder_attn_bf16_kernel<DH><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), t, sq, sk,
        sv, so, scale);
  } else {
    const dim3 grid((t + kThreads - 1) / kThreads, n_head, batch);
    encoder_attn_f32_kernel<DH><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), t, sq, sk, sv, so, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch,
// time, head) for each tensor; the Dh axis is contiguous.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int encoder_attn_launch(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int batch, int t, int n_head, int dh,
                                   long long sq_b, long long sq_t, long long sq_h,
                                   long long sk_b, long long sk_t, long long sk_h,
                                   long long sv_b, long long sv_t, long long sv_h,
                                   long long so_b, long long so_t, long long so_h,
                                   float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch < 1 || batch > 65535 || t < 1 || n_head < 1 ||
      n_head > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_t, sq_h}, sk{sk_b, sk_t, sk_h}, sv{sv_b, sv_t, sv_h},
      so{so_b, so_t, so_h};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 64:
      return launch<64>(dtype, q, k, v, out, batch, t, n_head, sq, sk, sv, so, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
