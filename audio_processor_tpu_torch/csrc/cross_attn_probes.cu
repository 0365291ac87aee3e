// Design probes of kernel B (int4 decode cross-attention over one layer of
// the stacked, nibble-packed cache), for Hopper (sm_90a).
//
// Replaces the bodies of the TPU probes that do not compute kernel B's or
// kernel #3's function as those kernels already do:
//   benchmarks/kernel_v32_probe.py:117 _stacked_call (v3.1 byte-wise unpack,
//     and `mxu`, _kernel_int4_stacked_mxu :56);
//   benchmarks/kernel_v34_probe.py:264 _stacked_call_v34 (BB rows a grid
//     step: a :58, b :93, c :127, d :168, e :202, stream-only s :235);
//   benchmarks/kernel_v4_probe.py:230 _stacked_call (i8_mxu_k :85,
//     i8_mxu_kv :102, i4_bf16 :122, i4_mxu_kv :169).
// v3.2 / v32 and #9's v31 are kernel B itself (csrc/cross_attn_int4.cu) and
// i8_f32 is kernel #3 (csrc/cross_attn_int8.cu); they are not repeated here.
// This file is apart from kernel B's so that kernel B's SASS stays free of
// int-to-float instructions: the byte-wise unpack uses them on purpose.
//
// Cache layouts as in kernel B: int4 K (B,H,Dh,Tpad/2), V (B,H,Tpad/2,Dh),
// byte = u_even | u_odd << 4, u = x + 8; int8 K (B,H,Dh,Tpad), V (B,H,Tpad,Dh).
// Dh is 64 (every Whisper model's head width), a compile-time constant, so
// no index needs a division by a run-time value.  Tq is 1 (a decode step).
//
// Three kernels, each bound by bytes on the H100 (one layer's K and V read
// once, ~2 operations a nibble):
//
// P1 probe_stream (#8 s): the stream-only floor.  Grid (B/BB, H), 128*R
//   threads (R warp groups, R = 1 or BB).  Reads every K/V byte of its rows'
//   (row, head) blocks with P2's loads and reduces them to the JAX probe's
//   checksum: pltpu.bitcast packs four consecutive rows of the second-to-
//   last axis into an int32 word, so K byte (d, j) weighs 256^(d mod 4) and
//   V byte (j, d) 256^(j mod 4); the int32 sums wrap (order free), one dp4a
//   against 0x01010101 a word.  The f32 sum over heads in order is taken by
//   the last block of each row group to draw a ticket (as kernel B's
//   combine), so the output is bit-equal to the JAX probe's.
//
// P2 int4_rows (v3.1, a-e, i4_bf16): the exact function with f32 products on
//   CUDA cores, one warp group a row, no split of time.  Grid (B/BB, H).
//   Template: kByte (mask, shift and an int-to-float per nibble, v3.1) or
//   packed (PRMT into 0x4B000000 and one FADD, kernel B's conversion); R
//   warp groups (R = 1: the block walks its BB rows in turn and prefetches
//   the next row's K and V into L2 meanwhile, variant a; R = BB: a warp
//   group a row, the BB rows' max and sum sharing each barrier, variants
//   b-e, which compute one function and differ on the TPU only in how they
//   feed its matrix unit); kBf16 (q and P rounded to bf16 before the
//   products, f32 accumulation; nibbles are exact in bf16).
//
// P3 int8_dot (mxu, i8_mxu_k, i8_mxu_kv, i4_mxu_kv): q row-quantised to int8
//   (amax/127, round half to even), q.K as exact int32 sums by dp4a (4
//   multiply-adds an instruction against the f32 path's 3 instructions a
//   nibble), the int4 cache unpacked to offset-binary int8 with the 8*sum(q8)
//   correction; P.V either in f32 or in int8 with P at the static scale 127
//   and the 8*sum(p8) correction.  dp4a needs four bytes along the
//   contraction axis, and both layouts run the other way (K's bytes along
//   time, V's along channels): four 32-bit loads from four rows and eight
//   PRMTs transpose a 4x4 byte block.  Grid (B, H), 128 threads.
//
// int32 -> float without I2F: i2f_exact splits the integer into 16-bit
// halves, each placed in a float's mantissa, and sums them in one FMA
// (rounded once, as I2F.RN rounds).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;
constexpr int kGroup = 128;             // threads working on one row
constexpr int kWordsV = kDh / 4;        // 32-bit words of a V row
constexpr int kGroupsV = kGroup / kWordsV;  // row groups of the P.V loops
constexpr int kQWords = kDh / 4;        // int8 q words
constexpr float kTwo23 = 8388608.f;     // 2^23
static_assert(kGroupsV % 4 == 0, "a P.V thread's rows keep one residue mod 4");

template <int i>
__device__ __forceinline__ float magic(uint32_t masked) {
  return __uint_as_float(__byte_perm(masked, 0x4B000000u, 0x7650 | i));
}

// nibble i of a word, by mask, shift and an int-to-float (v3.1's unpack)
template <int i>
__device__ __forceinline__ float nib_lo_i2f(uint32_t w) {
  return __int2float_rn((int)((w >> (8 * i)) & 0xFu));
}
template <int i>
__device__ __forceinline__ float nib_hi_i2f(uint32_t w) {
  return __int2float_rn((int)((w >> (8 * i + 4)) & 0xFu));
}

__device__ __forceinline__ float i2f_exact(int x) {
  const float hi = __int_as_float(0x4B400000 + (x >> 16)) - 12582912.f;  // 1.5 * 2^23
  const float lo = __int_as_float(0x4B000000 | (x & 0xFFFF)) - kTwo23;
  return fmaf(hi, 65536.f, lo);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// 4x4 byte transpose: c[j] byte i = r[i] byte j
__device__ __forceinline__ void transpose4(const uint32_t r[4], uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// ---------------------------------------------------------------------------
// P1: stream-only floor
// ---------------------------------------------------------------------------

template <int R, int BB>
__global__ void __launch_bounds__(kGroup * R)
probe_stream_kernel(const uint32_t* __restrict__ k4,  // (B, H, Dh, half) bytes of one layer
                    const uint32_t* __restrict__ v4,  // (B, H, half, Dh) bytes of one layer
                    float* __restrict__ out,          // (B, 1, H, Dh)
                    int* __restrict__ work,           // (B, H) int32 sums
                    unsigned* __restrict__ counters,  // (B / BB,), 0 between calls
                    int n_head, int half) {
  const int rg = blockIdx.x, h = blockIdx.y;
  const int grp = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int lane = t & 31, warp = t >> 5;
  const int words_k = half >> 2;
  __shared__ unsigned wred[R][4];
  __shared__ float acc_row[BB];
  __shared__ unsigned flag;

#pragma unroll 1
  for (int rr = grp; rr < BB; rr += R) {
    const int b = rg * BB + rr;
    const size_t bh = (size_t)b * n_head + h;
    const uint32_t* kh = k4 + bh * kDh * words_k;
    const uint32_t* vh = v4 + bh * (size_t)half * kWordsV;
    // K: thread w reads word w of every channel row (P2's score loads)
    unsigned ak[4] = {0u, 0u, 0u, 0u};
    for (int w = t; w < words_k; w += kGroup) {
#pragma unroll 16
      for (int d = 0; d < kDh; ++d) ak[d & 3] = __dp4a(__ldg(kh + d * words_k + w), 0x01010101u, ak[d & 3]);
    }
    // V: thread (g, cw) reads word cw of rows g, g + 8, ... (P2's P.V loads)
    const int cw = t % kWordsV, g = t / kWordsV;
    unsigned av = 0u;
#pragma unroll 8
    for (int j = g; j < half; j += kGroupsV) av = __dp4a(__ldg(vh + j * kWordsV + cw), 0x01010101u, av);
    unsigned s = ak[0] + (ak[1] << 8) + (ak[2] << 16) + (ak[3] << 24) + (av << (8 * (g & 3)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) wred[grp][warp] = s;
    __syncthreads();
    if (t == 0) work[bh] = (int)(wred[grp][0] + wred[grp][1] + wred[grp][2] + wred[grp][3]);
    __syncthreads();
  }
  // the last block of this row group sums the heads in order, in f32
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) flag = atomicAdd(counters + rg, 1u) == (unsigned)(n_head - 1);
  __syncthreads();
  if (!flag) return;
  __threadfence();
  if (threadIdx.x < BB) {
    const int b = rg * BB + threadIdx.x;
    float a = 0.f;
    for (int hh = 0; hh < n_head; ++hh) a += i2f_exact(__ldcg(work + (size_t)b * n_head + hh));
    acc_row[threadIdx.x] = a;
  }
  __syncthreads();
  const int per_row = n_head * kDh;
#pragma unroll 1
  for (int rr = 0; rr < BB; ++rr)
    for (int i = threadIdx.x; i < per_row; i += kGroup * R)
      out[((size_t)rg * BB + rr) * per_row + i] = acc_row[rr];
  if (threadIdx.x == 0) counters[rg] = 0u;
}

// ---------------------------------------------------------------------------
// P2: the exact function, f32 products on CUDA cores, one warp group a row
// ---------------------------------------------------------------------------

template <bool kByte, int R, int BB, bool kBf16>
__global__ void __launch_bounds__(kGroup * R)
int4_rows_kernel(const float* __restrict__ q,       // (B, 1, H, Dh)
                 const uint32_t* __restrict__ k4,   // (B, H, Dh, half) bytes of one layer
                 const uint32_t* __restrict__ v4,   // (B, H, half, Dh) bytes of one layer
                 float* __restrict__ out,           // (B, 1, H, Dh)
                 int n_head, int half, int valid_len, float scale) {
  const int rg = blockIdx.x, h = blockIdx.y;
  const int grp = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int lane = t & 31, warp = t >> 5;
  const int words_k = half >> 2;
  const int n_even = (valid_len + 1) >> 1, n_odd = valid_len >> 1;
  const int nw = (n_even + 3) >> 2;  // K words holding a valid column

  extern __shared__ __align__(16) float smem[];
  // per warp group: s[2 half] (scores, then probabilities) | qs[Dh] | red[8 Dh] | wred[8]
  float* s = smem + (size_t)grp * (2 * half + kDh + kGroupsV * kDh + 8);
  float* qs = s + 2 * half;
  float* red = qs + kDh;
  float* wred = red + kGroupsV * kDh;

  for (int rr = grp; rr < BB; rr += R) {
    const int b = rg * BB + rr;
    const size_t bh = (size_t)b * n_head + h;
    const uint32_t* kh = k4 + bh * kDh * words_k;
    const uint32_t* vh = v4 + bh * (size_t)half * kWordsV;
    if (t < kDh) {
      const float x = q[bh * kDh + t];
      qs[t] = kBf16 ? bf16_round(x) : x;
    }
    if (R == 1 && rr + 1 < BB) {  // the next row's K and V, into L2 meanwhile
      const unsigned char* kn = reinterpret_cast<const unsigned char*>(kh + (size_t)n_head * kDh * words_k);
      const unsigned char* vn = reinterpret_cast<const unsigned char*>(vh + (size_t)n_head * half * kWordsV);
      const int lines = kDh * half / 128;
      for (int i = t; i < lines; i += kGroup) {
        prefetch_l2(kn + 128 * (size_t)i);
        prefetch_l2(vn + 128 * (size_t)i);
      }
    }
    __syncthreads();

    // --- scores: thread w owns packed columns 4w..4w+3, even and odd times
    float mloc = -INFINITY;
    for (int w = t; w < nw; w += kGroup) {
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
      for (int d = 0; d < kDh; ++d) {
        const uint32_t word = __ldg(kh + d * words_k + w);
        const float qd = qs[d];
        if (kByte) {
          lo[0] = fmaf(qd, nib_lo_i2f<0>(word) - 8.f, lo[0]);
          lo[1] = fmaf(qd, nib_lo_i2f<1>(word) - 8.f, lo[1]);
          lo[2] = fmaf(qd, nib_lo_i2f<2>(word) - 8.f, lo[2]);
          lo[3] = fmaf(qd, nib_lo_i2f<3>(word) - 8.f, lo[3]);
          hi[0] = fmaf(qd, nib_hi_i2f<0>(word) - 8.f, hi[0]);
          hi[1] = fmaf(qd, nib_hi_i2f<1>(word) - 8.f, hi[1]);
          hi[2] = fmaf(qd, nib_hi_i2f<2>(word) - 8.f, hi[2]);
          hi[3] = fmaf(qd, nib_hi_i2f<3>(word) - 8.f, hi[3]);
        } else {
          const uint32_t wl = word & 0x0F0F0F0Fu, wh = (word >> 4) & 0x0F0F0F0Fu;
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
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 4 * w + i;
        const float sl = col < n_even ? lo[i] * scale : -INFINITY;
        const float sh = col < n_odd ? hi[i] * scale : -INFINITY;
        s[col] = sl;
        s[half + col] = sh;
        mloc = fmaxf(mloc, fmaxf(sl, sh));
      }
    }
    mloc = warp_max(mloc);
    if (lane == 0) wred[warp] = mloc;
    __syncthreads();  // every row's max partials (one barrier for the R rows)
    const float m = fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3]));

    // --- probabilities over the valid packed columns (high halves past
    // n_odd are 0, as are the slots the P.V loop reads past n_even)
    float lsum = 0.f;
    for (int j = t; j < 4 * nw; j += kGroup) {
      const float pl = j < n_even ? expf(s[j] - m) : 0.f;
      const float ph = j < n_odd ? expf(s[half + j] - m) : 0.f;
      s[j] = pl;
      s[half + j] = ph;
      lsum += pl + ph;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) wred[4 + warp] = lsum;
    __syncthreads();  // publishes p; every row's sum partials
    const float l = (wred[4] + wred[5]) + (wred[6] + wred[7]);

    // --- P.V: thread (g, cw) owns channels 4cw..4cw+3 of packed rows g, g + 8, ...
    {
      const int cw = t % kWordsV, g = t / kWordsV;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = g; j < n_even; j += kGroupsV) {
        const uint32_t word = __ldg(vh + j * kWordsV + cw);
        float pl = s[j], ph = s[half + j];
        if (kBf16) {
          pl = bf16_round(pl);
          ph = bf16_round(ph);
        }
        if (kByte) {
          acc[0] = fmaf(ph, nib_hi_i2f<0>(word), fmaf(pl, nib_lo_i2f<0>(word), acc[0]));
          acc[1] = fmaf(ph, nib_hi_i2f<1>(word), fmaf(pl, nib_lo_i2f<1>(word), acc[1]));
          acc[2] = fmaf(ph, nib_hi_i2f<2>(word), fmaf(pl, nib_lo_i2f<2>(word), acc[2]));
          acc[3] = fmaf(ph, nib_hi_i2f<3>(word), fmaf(pl, nib_lo_i2f<3>(word), acc[3]));
        } else {
          const uint32_t wl = word & 0x0F0F0F0Fu, wh = (word >> 4) & 0x0F0F0F0Fu;
          acc[0] = fmaf(ph, magic<0>(wh) - kTwo23, fmaf(pl, magic<0>(wl) - kTwo23, acc[0]));
          acc[1] = fmaf(ph, magic<1>(wh) - kTwo23, fmaf(pl, magic<1>(wl) - kTwo23, acc[1]));
          acc[2] = fmaf(ph, magic<2>(wh) - kTwo23, fmaf(pl, magic<2>(wl) - kTwo23, acc[2]));
          acc[3] = fmaf(ph, magic<3>(wh) - kTwo23, fmaf(pl, magic<3>(wl) - kTwo23, acc[3]));
        }
      }
      *reinterpret_cast<float4*>(red + g * kDh + 4 * cw) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    if (t < kDh) {
      float tot = 0.f;
#pragma unroll
      for (int g = 0; g < kGroupsV; ++g) tot += red[g * kDh + t];
      // p.(u-8) = p.u - 8 l: a constant -8 shift after normalising
      out[bh * kDh + t] = tot / l - 8.f;
    }
    __syncthreads();  // qs, s, red and wred are rewritten by the next row
  }
}

// ---------------------------------------------------------------------------
// P3: int8 products by dp4a, exact int32 sums
// ---------------------------------------------------------------------------

template <bool kInt4, bool kPvInt8>
__global__ void __launch_bounds__(kGroup)
int8_dot_kernel(const float* __restrict__ q,       // (B, 1, H, Dh)
                const uint32_t* __restrict__ kc,   // int4 (B,H,Dh,half) / int8 (B,H,Dh,Tpad) bytes
                const uint32_t* __restrict__ vc,   // int4 (B,H,half,Dh) / int8 (B,H,Tpad,Dh) bytes
                float* __restrict__ out,           // (B, 1, H, Dh)
                int n_head, int cols, int valid_len, float scale) {
  // cols: K's byte columns, Tpad/2 packed (int4) or Tpad (int8)
  static_assert(kPvInt8 || !kInt4, "an f32 P.V is instantiated for the int8 cache only");
  const int b = blockIdx.x, h = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t bh = (size_t)b * n_head + h;
  const int words_k = cols >> 2;
  const uint32_t* kh = kc + bh * kDh * words_k;
  const uint32_t* vh = vc + bh * (size_t)cols * kWordsV;
  // valid columns of each half (int4: even / odd times; int8: one half)
  const int n_a = kInt4 ? (valid_len + 1) >> 1 : valid_len;
  const int n_b = kInt4 ? valid_len >> 1 : 0;
  const int nq = (n_a + 3) >> 2;  // 4-column quads holding a valid column
  constexpr int kHalves = kInt4 ? 2 : 1;

  extern __shared__ __align__(16) float smem[];
  float* s = smem;                                                  // [kHalves * cols]
  uint32_t* p8w = reinterpret_cast<uint32_t*>(s + kHalves * cols);  // [kHalves * cols / 4]
  int* red = reinterpret_cast<int*>(p8w + kHalves * cols / 4);      // [8 * Dh]
  uint32_t* q8w = reinterpret_cast<uint32_t*>(red + kGroupsV * kDh);  // [Dh / 4]
  float* wred = reinterpret_cast<float*>(q8w + kQWords);            // [16]
  int* ired = reinterpret_cast<int*>(wred + 16);                    // [8]

  // --- q row-quantised to int8: scale amax / 127, round half to even
  float x = 0.f;
  if (t < kDh) x = q[bh * kDh + t];
  float am = warp_max(fabsf(x));
  if (lane == 0) wred[warp] = am;
  __syncthreads();
  const float sq = fmaxf(fmaxf(wred[0], wred[1]), 1e-8f) / 127.f;  // Dh = 64: warps 0 and 1
  int q8 = 0;
  if (t < kDh) {
    q8 = (int)fminf(fmaxf(rintf(x / sq), -127.f), 127.f);
    reinterpret_cast<int8_t*>(q8w)[t] = (int8_t)q8;
  }
  const int qsum = warp_isum(q8);
  if (lane == 0) ired[warp] = qsum;
  __syncthreads();
  const int corr = kInt4 ? 8 * (ired[0] + ired[1]) : 0;  // q8.(u - 8) = q8.u - 8 sum(q8)
  const float s_scale = sq * scale;

  // --- scores: thread w owns byte columns 4w..4w+3; four channel rows at a
  // time, transposed so that each word holds four channels of one column
  float mloc = -INFINITY;
  for (int w = t; w < nq; w += kGroup) {
    int acc_a[4] = {0, 0, 0, 0}, acc_b[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int d4 = 0; d4 < kQWords; ++d4) {
      uint32_t r[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = __ldg(kh + (4 * d4 + i) * words_k + w);
      const int qw = (int)q8w[d4];
      if (kInt4) {
        uint32_t m4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) m4[i] = r[i] & 0x0F0F0F0Fu;
        transpose4(m4, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_a[j] = __dp4a(qw, (int)c[j], acc_a[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) m4[i] = (r[i] >> 4) & 0x0F0F0F0Fu;
        transpose4(m4, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_b[j] = __dp4a(qw, (int)c[j], acc_b[j]);
      } else {
        transpose4(r, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_a[j] = __dp4a(qw, (int)c[j], acc_a[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 4 * w + i;
      const float sa = col < n_a ? i2f_exact(acc_a[i] - corr) * s_scale : -INFINITY;
      s[col] = sa;
      mloc = fmaxf(mloc, sa);
      if (kInt4) {
        const float sb = col < n_b ? i2f_exact(acc_b[i] - corr) * s_scale : -INFINITY;
        s[cols + col] = sb;
        mloc = fmaxf(mloc, sb);
      }
    }
  }
  mloc = warp_max(mloc);
  if (lane == 0) wred[warp] = mloc;
  __syncthreads();
  const float m = fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3]));

  // --- probabilities; with an int8 P.V, p8 = rint(127 p) and its sum
  float lsum = 0.f;
  int psum = 0;
  for (int j = t; j < 4 * nq; j += kGroup) {
#pragma unroll
    for (int half_i = 0; half_i < kHalves; ++half_i) {
      const int n = half_i ? n_b : n_a;
      const int idx = half_i * cols + j;
      const float p = j < n ? expf(s[idx] - m) : 0.f;
      lsum += p;
      if (kPvInt8) {
        const int p8 = (int)rintf(p * 127.f);
        reinterpret_cast<int8_t*>(p8w)[idx] = (int8_t)p8;
        psum += p8;
      } else {
        s[idx] = p;
      }
    }
  }
  lsum = warp_sum(lsum);
  psum = warp_isum(psum);
  if (lane == 0) {
    wred[8 + warp] = lsum;
    ired[4 + warp] = psum;
  }
  __syncthreads();  // publishes p / p8
  const float l = (wred[8] + wred[9]) + (wred[10] + wred[11]);

  const int cw = t % kWordsV, g = t / kWordsV;
  if (kPvInt8) {
    // --- P.V by dp4a: four time rows at a time, transposed so that each
    // word holds four times of one channel, against four p8 of those times
    int acc[4] = {0, 0, 0, 0};
#pragma unroll 2
    for (int jq = g; jq < nq; jq += kGroupsV) {
      uint32_t r[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = __ldg(vh + (4 * jq + i) * kWordsV + cw);
      if (kInt4) {
        uint32_t m4[4];
        const int pa = (int)p8w[jq], pb = (int)p8w[cols / 4 + jq];
#pragma unroll
        for (int i = 0; i < 4; ++i) m4[i] = r[i] & 0x0F0F0F0Fu;
        transpose4(m4, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __dp4a(pa, (int)c[j], acc[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) m4[i] = (r[i] >> 4) & 0x0F0F0F0Fu;
        transpose4(m4, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __dp4a(pb, (int)c[j], acc[j]);
      } else {
        const int pa = (int)p8w[jq];
        transpose4(r, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __dp4a(pa, (int)c[j], acc[j]);
      }
    }
    *reinterpret_cast<int4*>(red + g * kDh + 4 * cw) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (t < kDh) {
      int tot = 0;
#pragma unroll
      for (int gg = 0; gg < kGroupsV; ++gg) tot += red[gg * kDh + t];
      if (kInt4) tot -= 8 * (ired[4] + ired[5] + ired[6] + ired[7]);  // p8.(u - 8)
      out[bh * kDh + t] = i2f_exact(tot) / (l * 127.f);
    }
  } else {
    // --- P.V in f32 over the int8 cache: byte ^ 0x80 is offset binary,
    // (2^23 + v + 128) - (2^23 + 128) = v exactly
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = g; j < n_a; j += kGroupsV) {
      const uint32_t word = __ldg(vh + j * kWordsV + cw) ^ 0x80808080u;
      const float p = s[j];
      acc[0] = fmaf(p, magic<0>(word) - (kTwo23 + 128.f), acc[0]);
      acc[1] = fmaf(p, magic<1>(word) - (kTwo23 + 128.f), acc[1]);
      acc[2] = fmaf(p, magic<2>(word) - (kTwo23 + 128.f), acc[2]);
      acc[3] = fmaf(p, magic<3>(word) - (kTwo23 + 128.f), acc[3]);
    }
    float* fred = reinterpret_cast<float*>(red);
    *reinterpret_cast<float4*>(fred + g * kDh + 4 * cw) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (t < kDh) {
      float tot = 0.f;
#pragma unroll
      for (int gg = 0; gg < kGroupsV; ++gg) tot += fred[gg * kDh + t];
      out[bh * kDh + t] = tot / l;
    }
  }
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <int R, int BB>
int launch_stream(const void* k, const void* v, void* out, void* work, void* counters, int batch,
                  int n_head, int half, cudaStream_t st) {
  const dim3 grid(batch / BB, n_head);
  probe_stream_kernel<R, BB><<<grid, kGroup * R, 0, st>>>(
      static_cast<const uint32_t*>(k), static_cast<const uint32_t*>(v), static_cast<float*>(out),
      static_cast<int*>(work), static_cast<unsigned*>(counters), n_head, half);
  return (int)cudaGetLastError();
}

template <bool kByte, int R, int BB, bool kBf16>
int launch_rows(const void* q, const void* k, const void* v, void* out, int batch, int n_head,
                int half, int valid_len, float scale, cudaStream_t st) {
  const size_t smem = (size_t)R * (2 * half + kDh + kGroupsV * kDh + 8) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int e = prepare(int4_rows_kernel<kByte, R, BB, kBf16>, smem);
  if (e) return e;
  const dim3 grid(batch / BB, n_head);
  int4_rows_kernel<kByte, R, BB, kBf16><<<grid, kGroup * R, smem, st>>>(
      static_cast<const float*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<float*>(out), n_head, half, valid_len, scale);
  return (int)cudaGetLastError();
}

template <bool kInt4, bool kPvInt8>
int launch_dot(const void* q, const void* k, const void* v, void* out, int batch, int n_head,
               int cols, int valid_len, float scale, cudaStream_t st) {
  constexpr int halves = kInt4 ? 2 : 1;
  const size_t smem = (size_t)halves * cols * (sizeof(float) + 1) + kGroupsV * kDh * sizeof(int) +
                      kQWords * 4 + 16 * sizeof(float) + 8 * sizeof(int);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int e = prepare(int8_dot_kernel<kInt4, kPvInt8>, smem);
  if (e) return e;
  const dim3 grid(batch, n_head);
  int8_dot_kernel<kInt4, kPvInt8><<<grid, kGroup, smem, st>>>(
      static_cast<const float*>(q), static_cast<const uint32_t*>(k),
      static_cast<const uint32_t*>(v), static_cast<float*>(out), n_head, cols, valid_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// k_layer / v_layer point at one layer of the stacked int4 cache.  ``work``
// holds batch*n_head ints, ``counters`` batch/bb zeroed unsigned ints, left
// zeroed.  rows_at_once is 1 or bb.  Returns cudaGetLastError() after the
// launch (0 = success), cudaErrorInvalidValue for a shape not instantiated.
extern "C" int probe_stream_launch(const void* k_layer, const void* v_layer, void* out, void* work,
                                   void* counters, int batch, int n_head, int dh, int half, int bb,
                                   int rows_at_once, void* stream) {
  if (dh != kDh || half % 64 || half < 64 || batch % bb) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PROBE_STREAM(R, BB)                                                                    \
  if (rows_at_once == R && bb == BB)                                                           \
    return launch_stream<R, BB>(k_layer, v_layer, out, work, counters, batch, n_head, half, st);
  PROBE_STREAM(1, 1)
  PROBE_STREAM(1, 2)
  PROBE_STREAM(1, 4)
  PROBE_STREAM(1, 8)
  PROBE_STREAM(2, 2)
  PROBE_STREAM(4, 4)
  PROBE_STREAM(8, 8)
#undef PROBE_STREAM
  return (int)cudaErrorInvalidValue;
}

// q (B, 1, H, 64) f32; k_layer / v_layer one layer of the stacked int4 cache.
extern "C" int int4_rows_launch(const void* q, const void* k_layer, const void* v_layer, void* out,
                                int batch, int n_head, int dh, int half, int valid_len, float scale,
                                int byte_unpack, int bb, int rows_at_once, int bf16, void* stream) {
  if (dh != kDh || half % 64 || half < 64 || batch % bb || valid_len < 1 || valid_len > 2 * half)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT4_ROWS(BYTE, R, BB, BF16)                                                            \
  if (byte_unpack == BYTE && rows_at_once == R && bb == BB && bf16 == BF16)                     \
    return launch_rows<BYTE, R, BB, BF16>(q, k_layer, v_layer, out, batch, n_head, half,         \
                                          valid_len, scale, st);
  INT4_ROWS(1, 1, 1, 0)  // v3.1
  INT4_ROWS(0, 1, 1, 0)  // a at BB=1 (and b-e at BB=1)
  INT4_ROWS(0, 1, 2, 0)  // a
  INT4_ROWS(0, 1, 4, 0)
  INT4_ROWS(0, 1, 8, 0)
  INT4_ROWS(0, 2, 2, 0)  // b-e
  INT4_ROWS(0, 4, 4, 0)
  INT4_ROWS(0, 8, 8, 0)
  INT4_ROWS(0, 1, 1, 1)  // i4_bf16
#undef INT4_ROWS
  return (int)cudaErrorInvalidValue;
}

// q (B, 1, H, 64) f32; k_layer / v_layer one layer of the stacked int4
// (cols = Tpad/2) or int8 (cols = Tpad) cache.
extern "C" int int8_dot_launch(const void* q, const void* k_layer, const void* v_layer, void* out,
                               int batch, int n_head, int dh, int cols, int valid_len, float scale,
                               int int4_cache, int pv_int8, void* stream) {
  const int max_valid = int4_cache ? 2 * cols : cols;
  if (dh != kDh || cols % 64 || cols < 64 || valid_len < 1 || valid_len > max_valid)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int4_cache && pv_int8)
    return launch_dot<true, true>(q, k_layer, v_layer, out, batch, n_head, cols, valid_len, scale, st);
  if (!int4_cache && pv_int8)
    return launch_dot<false, true>(q, k_layer, v_layer, out, batch, n_head, cols, valid_len, scale, st);
  if (!int4_cache && !pv_int8)
    return launch_dot<false, false>(q, k_layer, v_layer, out, batch, n_head, cols, valid_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
