// Fused Whisper log-mel for Hopper (sm_90a): reflect pad -> framing ->
// windowed real DFT -> power -> mel -> log10, then the per-window
// peak-8 clamp and (x+4)/4.
//
// Replaces the TPU kernel log_mel_pallas
// (audio_processor_tpu/ops/pallas/mel_kernel.py:61; body _kernel :44) and
// computes the same function as the JAX frontend
// (audio_processor_tpu/ops/frontend.py:139).
//
// Bound on the H100: operations.  Per 30 s window the DFT is
// 3000 x 400 x 201 x 2 multiply-adds per basis (cos, sin), about 1 GFLOP,
// while only ~2.9 MB move (1.9 MB of audio in, 0.96-1.5 MB of log-mel out).
// Precision forbids the tensor cores: TF32 or bf16 passes are catastrophic
// in log space at quiet mel bins, so every product is an fp32 FMA on the
// CUDA cores (67 TFLOP/s peak).
//
// Design: one CTA per (32-frame tile, window).  The tile's reflect-padded
// samples (160*31 + 400 floats) are gathered into shared memory once — the
// reflect pad is an index map, never materialised.  The hann-folded
// cos/sin bases (400 x 201, zero-padded to 224 frequencies as they land)
// stream through shared memory 8 rows at a time; each thread keeps a
// 4-frame x 7-frequency register tile of re and im.  Power goes to shared memory
// (aliasing the samples and bases), then each thread computes mel outputs
// frame-fastest so the (B, n_mels, n_frames) stores are coalesced.  The
// tile's max log-mel goes to a small (B, n_tiles) buffer; a second launch
// applies the per-window clamp in place.
#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kPad = kNFFT / 2;                // reflect pad per side
constexpr int kNFreq = kNFFT / 2 + 1;          // 201
constexpr int kFreqPad = 224;                  // 32 threads x 7 frequencies
constexpr int kFreqPerThread = kFreqPad / 32;  // 7
constexpr int kFT = 32;                        // frames per CTA
constexpr int kFramesPerThread = kFT / (kThreads / 32);  // 4
constexpr int kKT = 8;                         // basis rows per smem stage
constexpr int kSeg = kHop * (kFT - 1) + kNFFT; // 5360 samples per tile
constexpr int kPowStride = kFreqPad + 1;       // conflict-free column reads
constexpr int kBasis = kKT * kFreqPad;         // floats per basis stage
constexpr int kStage1 = kSeg + 2 * kBasis;
constexpr int kStage2 = kFT * kPowStride;
constexpr int kSmemFloats = (kStage1 > kStage2 ? kStage1 : kStage2) + 32;

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio,  // (B, n_samples)
               int n_samples, int n_frames,
               const float* __restrict__ cos_b,  // (400, 201)
               const float* __restrict__ sin_b,  // (400, 201)
               const float* __restrict__ filt,   // (201, n_mels)
               int n_mels,
               float* __restrict__ out,          // (B, n_mels, n_frames) log10 mel
               float* __restrict__ tile_max) {   // (B, n_tiles)
  extern __shared__ float sm[];
  float* seg = sm;             // [kSeg]
  float* bas = sm + kSeg;      // [2][kKT][kFreqPad]: cos rows then sin rows
  float* pw = sm;              // [kFT][kPowStride], after the DFT
  float* red = sm + kSmemFloats - 32;

  const int tile = blockIdx.x, b = blockIdx.y;
  const int f0 = tile * kFT;
  const float* x = audio + (size_t)b * n_samples;

  // samples [160*f0, 160*f0 + kSeg) of the reflect-padded signal
  for (int i = threadIdx.x; i < kSeg; i += blockDim.x) {
    int p = kHop * f0 + i - kPad;
    if (p < 0) p = -p;
    if (p >= n_samples) p = 2 * (n_samples - 1) - p;
    p = min(max(p, 0), n_samples - 1);  // frames past n_frames only
    seg[i] = x[p];
  }

  const int tf = threadIdx.x >> 5;  // frames tf*4 .. tf*4+3
  const int tc = threadIdx.x & 31;  // frequencies tc + 32*j
  float re[kFramesPerThread][kFreqPerThread];
  float im[kFramesPerThread][kFreqPerThread];
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kFreqPerThread; ++j) re[i][j] = im[i][j] = 0.f;

  for (int k0 = 0; k0 < kNFFT; k0 += kKT) {
    __syncthreads();  // samples loaded / previous stage consumed
    for (int i = threadIdx.x; i < kBasis; i += blockDim.x) {
      const int kk = i / kFreqPad, fq = i % kFreqPad;
      const size_t src = (size_t)(k0 + kk) * kNFreq + fq;
      bas[i] = fq < kNFreq ? __ldg(cos_b + src) : 0.f;
      bas[kBasis + i] = fq < kNFreq ? __ldg(sin_b + src) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      float a[kFramesPerThread];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i)
        a[i] = seg[kHop * (tf * kFramesPerThread + i) + k0 + kk];
#pragma unroll
      for (int j = 0; j < kFreqPerThread; ++j) {
        const float c = bas[kk * kFreqPad + tc + 32 * j];
        const float s = bas[kBasis + kk * kFreqPad + tc + 32 * j];
#pragma unroll
        for (int i = 0; i < kFramesPerThread; ++i) {
          re[i][j] = fmaf(a[i], c, re[i][j]);
          im[i][j] = fmaf(a[i], s, im[i][j]);
        }
      }
    }
  }
  __syncthreads();  // every read of seg/bas done: pw aliases them
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kFreqPerThread; ++j)
      pw[(tf * kFramesPerThread + i) * kPowStride + tc + 32 * j] =
          re[i][j] * re[i][j] + im[i][j] * im[i][j];
  __syncthreads();

  // mel projection + log10, frame-fastest for coalesced stores
  float tmax = -INFINITY;
  for (int idx = threadIdx.x; idx < kFT * n_mels; idx += blockDim.x) {
    const int f = idx % kFT, m = idx / kFT;
    if (f0 + f >= n_frames) continue;
    const float* prow = pw + f * kPowStride;
    float acc = 0.f;
    for (int fr = 0; fr < kNFreq; ++fr) acc = fmaf(prow[fr], __ldg(filt + fr * n_mels + m), acc);
    const float v = log10f(fmaxf(acc, 1e-10f));
    out[((size_t)b * n_mels + m) * n_frames + f0 + f] = v;
    tmax = fmaxf(tmax, v);
  }
  tmax = block_max(tmax, red);
  if (threadIdx.x == 0) tile_max[(size_t)b * gridDim.x + tile] = tmax;
}

// out = (max(out, peak - 8) + 4) / 4 per window, peak = max of its tiles
__global__ void __launch_bounds__(kThreads)
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

// audio (B, n_samples) f32; bases (400, 201) f32; filt (201, n_mels) f32;
// out (B, n_mels, n_samples/160) f32; tile_max (B, log_mel_tile_count) f32
// scratch.  Returns cudaGetLastError() after both launches.
extern "C" int log_mel_launch(const void* audio, int batch, int n_samples,
                              const void* cos_b, const void* sin_b, const void* filt,
                              int n_mels, void* out, void* tile_max, void* stream) {
  const int n_frames = n_samples / kHop;
  const int n_tiles = log_mel_tile_count(n_samples);
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  log_mel_kernel<<<dim3(n_tiles, batch), kThreads, smem, st>>>(
      static_cast<const float*>(audio), n_samples, n_frames,
      static_cast<const float*>(cos_b), static_cast<const float*>(sin_b),
      static_cast<const float*>(filt), n_mels, static_cast<float*>(out),
      static_cast<float*>(tile_max));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int per_window = n_mels * n_frames;
  int blocks = (per_window + kThreads - 1) / kThreads;
  blocks = blocks < 64 ? blocks : 64;
  log_mel_clamp_kernel<<<dim3(blocks, batch), kThreads, 0, st>>>(
      static_cast<float*>(out), static_cast<const float*>(tile_max), n_tiles,
      per_window);
  return (int)cudaGetLastError();
}
