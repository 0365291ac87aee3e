// Fused Whisper log-mel for Hopper (sm_90a): reflect pad -> framing ->
// windowed real FFT -> power -> mel -> log10, then the per-window peak-8
// clamp and (x+4)/4.
//
// Replaces the TPU kernel log_mel_pallas
// (audio_processor_tpu/ops/pallas/mel_kernel.py:61; body _kernel :44) and
// computes the same function as the JAX frontend
// (audio_processor_tpu/ops/frontend.py:139).  Precision: every product is
// an fp32 FMA on the CUDA cores.  TF32 or bf16 passes are catastrophic in
// log space at quiet mel bins, so the tensor cores stay out of it.
//
// Algorithm: a four-step DFT, 400 = 20 x 20, with n = 20*n1 + n2 and
// bin m = k1 + 20*k2.
//   stage 1  Z[n2][k1] = sum_n1 x[20 n1 + n2] * w[n] * W400^(n k1),
//            k1 = 0..10: for each n2 a real 20-point DFT over n1 with the
//            periodic hann window and the four-step twiddle W400^(n2 k1)
//            folded into that n2's 20 x 11 complex table (8,800 MACs a
//            frame).
//   stage 2  X[k1 + 20 k2] = sum_n2 Z[n2][k1] * W20^(n2 k2), a 20-point
//            complex DFT over n2 (16,080 MACs a frame for the kept bins).
// The input is real, so |X[400 - m]| = |X[m]|: the k1 = 0..10 columns give
// every bin 0..200 once (m > 200 folds to 400 - m; for k1 = 0 and 10 only
// m <= 200 is kept).  About 25 k MACs a frame against the 161 k of the
// DFT as two matmuls.  The mel projection is sparse: each filter is one
// contiguous run of at most 14 bins (391 non-zeros at 80 mels, 394 at
// 128), summed from a (start, count, offset) band table; the skipped
// weights are exact zeros, so every sum keeps its value.
//
// Bound on the H100: operations, ~0.02 ms at 8 windows for this algorithm
// (1.2 GFLOP against 23 MB moved); chip_smoke.py prints it.
//
// Design: persistent CTAs (one per SM, 10 warps) walk the (window, 32-frame
// tile) items.  Every table (the stage-1 tables, W20, the band table and
// its weights: ~43 KB) is copied to shared memory once per CTA.  Each
// item: the tile's reflect-padded samples are gathered into shared memory
// (the pad is an index map, never materialised) with one float of skew
// per 160-sample hop, so that lane f reading frame f hits bank f.  In all
// three steps a lane owns one frame and a warp owns a slice of the
// outputs, so table reads are warp-uniform broadcasts (float4) and the
// per-frame reads are free of bank conflicts (odd frame strides 441 and
// 201).  Stage 1: warp w computes n2 = w, w+10; stage 2: warp w >= 1 the
// column k1 = w (20 bins), warp 0 the columns k1 = 0 and 10 (11 + 10).
// Mel: warp w computes mels w, w+10, ..., stores frame-fastest (coalesced
// (B, n_mels, n_frames) rows) and keeps the tile's max log-mel, which goes
// to a small (B, n_tiles) buffer; a second launch applies the per-window
// clamp in place.
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

namespace {

constexpr int kWarps = 10;
constexpr int kThreads = 32 * kWarps;
constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kPad = kNFFT / 2;                  // reflect pad per side
constexpr int kNFreq = kNFFT / 2 + 1;            // 201
constexpr int kR = 20;                           // 400 = kR * kR
constexpr int kK1 = 11;                          // stage-1 columns kept
constexpr int kK1Pad = 12;                       // float4 rows
constexpr int kFT = 32;                          // frames per item: one per lane
constexpr int kSeg = kHop * (kFT - 1) + kNFFT;   // 5360 samples per item
constexpr int kSegSkewed = kSeg + kSeg / kHop + 1;
constexpr int kZStride = 2 * kR * kK1 + 1;       // 441 floats per frame
constexpr int kPowStride = kNFreq;               // 201 floats per frame
constexpr int kStage1 = kR * kR * 2 * kK1Pad;    // [n2][n1][cos|sin][k1]
constexpr int kW20 = kR * 2 * kR;                // [n2][cos|sin][k2]
constexpr int kRegionA = kSegSkewed > kFT * kPowStride ? kSegSkewed : kFT * kPowStride;
// float offsets in shared memory; tables first (float4-aligned rows)
constexpr int kOffW20 = kStage1;
constexpr int kOffA = kOffW20 + kW20;
constexpr int kOffZ = kOffA + kRegionA;
constexpr int kOffRed = kOffZ + kFT * kZStride;
constexpr int kOffBands = kOffRed + 32;

static_assert(kStage1 % 4 == 0 && kW20 % 4 == 0, "float4 tables");

__device__ __forceinline__ void load12(const float* p, float v[12]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 t = q[i];
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ void load20(const float* p, float v[20]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float4 t = q[i];
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
  }
}

// stage 2 for column k1 of one frame: NK2 bins m = k1 + 20*k2, k2 < NK2,
// their power stored at pw[bin]
template <int NK2>
__device__ __forceinline__ void stage2(const float* z, const float* w20, float* pw, int k1) {
  float xr[NK2], xi[NK2];
#pragma unroll
  for (int j = 0; j < NK2; ++j) xr[j] = xi[j] = 0.f;
#pragma unroll 4
  for (int n2 = 0; n2 < kR; ++n2) {
    const float zr = z[n2 * 2 * kK1 + 2 * k1], zi = z[n2 * 2 * kK1 + 2 * k1 + 1];
    float wr[20], wi[20];
    load20(w20 + n2 * 2 * kR, wr);
    load20(w20 + n2 * 2 * kR + kR, wi);
#pragma unroll
    for (int j = 0; j < NK2; ++j) {
      xr[j] = fmaf(zr, wr[j], fmaf(-zi, wi[j], xr[j]));
      xi[j] = fmaf(zr, wi[j], fmaf(zi, wr[j], xi[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < NK2; ++j) {
    const int m = k1 + kR * j;
    pw[m <= kNFFT / 2 ? m : kNFFT - m] = xr[j] * xr[j] + xi[j] * xi[j];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
log_mel_kernel(const float* __restrict__ audio,   // (B, n_samples)
               int batch, int n_samples, int n_frames, int n_tiles,
               const float* __restrict__ stage1,  // [20][20][2][12]
               const float* __restrict__ w20,     // [20][2][20]
               const int* __restrict__ bands,     // [n_mels][3]: start, count, offset
               const float* __restrict__ weights, // [n_weights]
               int n_mels, int n_weights,
               float* __restrict__ out,           // (B, n_mels, n_frames) log10 mel
               float* __restrict__ tile_max) {    // (B, n_tiles)
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  float* t1 = sm;
  float* tw = sm + kOffW20;
  float* seg = sm + kOffA;  // skewed samples; then pw [kFT][kPowStride]
  float* pw = seg;
  float* zbuf = sm + kOffZ;  // [kFT][kZStride]
  float* red = sm + kOffRed;
  int* bnd = reinterpret_cast<int*>(sm + kOffBands);
  float* wts = sm + kOffBands + 3 * n_mels;

  for (int i = threadIdx.x; i < kStage1; i += kThreads) t1[i] = stage1[i];
  for (int i = threadIdx.x; i < kW20; i += kThreads) tw[i] = w20[i];
  for (int i = threadIdx.x; i < 3 * n_mels; i += kThreads) bnd[i] = bands[i];
  for (int i = threadIdx.x; i < n_weights; i += kThreads) wts[i] = weights[i];

  const int warp = threadIdx.x >> 5, f = threadIdx.x & 31;
  for (int item = blockIdx.x; item < batch * n_tiles; item += gridDim.x) {
    const int b = item / n_tiles, tile = item % n_tiles;
    const int f0 = tile * kFT;
    const float* x = audio + (size_t)b * n_samples;
    __syncthreads();  // tables loaded / the previous item's pw consumed
    // samples [160*f0, 160*f0 + kSeg) of the reflect-padded signal
    for (int i = threadIdx.x; i < kSeg; i += kThreads) {
      int p = kHop * f0 + i - kPad;
      if (p < 0) p = -p;
      if (p >= n_samples) p = 2 * (n_samples - 1) - p;
      p = min(max(p, 0), n_samples - 1);  // frames past n_frames only
      seg[i + i / kHop] = x[p];
    }
    __syncthreads();

    // stage 1: sample 20*n1 + n2 of frame f sits at 161*f + 20*n1 + n2 +
    // (n1 >= 8) + (n1 >= 16) in the skewed segment
    for (int n2 = warp; n2 < kR; n2 += kWarps) {
      float zr[kK1Pad], zi[kK1Pad];
#pragma unroll
      for (int k = 0; k < kK1Pad; ++k) zr[k] = zi[k] = 0.f;
      const float* xs = seg + (kHop + 1) * f + n2;
      const float* tb = t1 + n2 * kR * 2 * kK1Pad;
#pragma unroll
      for (int n1 = 0; n1 < kR; ++n1) {
        const float a = xs[kR * n1 + (n1 >= 8) + (n1 >= 16)];
        float c[kK1Pad], s[kK1Pad];
        load12(tb + n1 * 2 * kK1Pad, c);
        load12(tb + n1 * 2 * kK1Pad + kK1Pad, s);
#pragma unroll
        for (int k = 0; k < kK1; ++k) {
          zr[k] = fmaf(a, c[k], zr[k]);
          zi[k] = fmaf(a, s[k], zi[k]);
        }
      }
      float* z = zbuf + f * kZStride + n2 * 2 * kK1;
#pragma unroll
      for (int k = 0; k < kK1; ++k) z[2 * k] = zr[k], z[2 * k + 1] = zi[k];
    }
    __syncthreads();  // Z complete; seg no longer read: pw may overwrite it

    // stage 2 -> power
    const float* z = zbuf + f * kZStride;
    float* prow = pw + f * kPowStride;
    if (warp == 0) {
      stage2<11>(z, tw, prow, 0);   // bins 0, 20, ..., 200
      stage2<10>(z, tw, prow, 10);  // bins 10, 30, ..., 190
    } else {
      stage2<20>(z, tw, prow, warp);
    }
    __syncthreads();

    // sparse mel + log10, frame-fastest for coalesced stores
    const bool live = f0 + f < n_frames;
    float tmax = -INFINITY;
    for (int m = warp; m < n_mels; m += kWarps) {
      const int start = bnd[3 * m], count = bnd[3 * m + 1], off = bnd[3 * m + 2];
      float acc = 0.f;
      for (int j = 0; j < count; ++j) acc = fmaf(prow[start + j], wts[off + j], acc);
      const float v = log10f(fmaxf(acc, 1e-10f));
      if (live) {
        out[((size_t)b * n_mels + m) * n_frames + f0 + f] = v;
        tmax = fmaxf(tmax, v);
      }
    }
    tmax = block_max(tmax, red);
    if (threadIdx.x == 0) tile_max[(size_t)b * n_tiles + tile] = tmax;
  }
}

// out = (max(out, peak - 8) + 4) / 4 per window, peak = max of its tiles
__global__ void __launch_bounds__(256)
log_mel_clamp_kernel(float* __restrict__ out, const float* __restrict__ tile_max,
                     int n_tiles, int per_window) {
  __shared__ float red[32];
  const int b = blockIdx.y;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x)
    m = fmaxf(m, tile_max[(size_t)b * n_tiles + i]);
  m = block_max(m, red);
  float* o = out + (size_t)b * per_window;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_window;
       i += gridDim.x * blockDim.x)
    o[i] = (fmaxf(o[i], m - 8.f) + 4.f) / 4.f;
}

}  // namespace

// Frame tiles per window: the caller sizes the tile_max scratch with it.
extern "C" int log_mel_tile_count(int n_samples) {
  return (n_samples / kHop + kFT - 1) / kFT;
}

// audio (B, n_samples) f32; stage1 [20][20][2][12] f32; w20 [20][2][20]
// f32; bands [n_mels][3] int32 (first bin, bin count, offset into
// weights); weights [n_weights] f32; out (B, n_mels, n_samples/160) f32;
// tile_max (B, log_mel_tile_count) f32 scratch.  Returns
// cudaGetLastError() after both launches.
extern "C" int log_mel_launch(const void* audio, int batch, int n_samples, const void* stage1,
                              const void* w20, const void* bands, const void* weights,
                              int n_mels, int n_weights, void* out, void* tile_max,
                              void* stream) {
  const int n_frames = n_samples / kHop;
  const int n_tiles = log_mel_tile_count(n_samples);
  const size_t smem = ((size_t)kOffBands + 3 * n_mels + n_weights) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(log_mel_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int device = 0, n_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)e;
  const int items = batch * n_tiles;
  cudaStream_t st = (cudaStream_t)stream;
  log_mel_kernel<<<items < n_sm ? items : n_sm, kThreads, smem, st>>>(
      static_cast<const float*>(audio), batch, n_samples, n_frames, n_tiles,
      static_cast<const float*>(stage1), static_cast<const float*>(w20),
      static_cast<const int*>(bands), static_cast<const float*>(weights), n_mels, n_weights,
      static_cast<float*>(out), static_cast<float*>(tile_max));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per_window = n_mels * n_frames;
  int blocks = (per_window + 255) / 256;
  blocks = blocks < 64 ? blocks : 64;
  log_mel_clamp_kernel<<<dim3(blocks, batch), 256, 0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(tile_max), n_tiles, per_window);
  return (int)cudaGetLastError();
}
