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
// once, ~2 operations a nibble; the byte-wise unpack by its int-to-float
// conversions, 16 a clock an SM).
//
// P1 and P2 split the packed time axis across blocks, as kernel B does:
// grid (chunk, H, B/BB), 128*R threads (R warp groups: R = 1 walks the
// block's BB rows in turn, R = BB gives each row a warp group).  A chunk is
// kStreamChunk = 128 packed columns in P1; in P2 kChunk = 256 with one row
// a block, kTurnChunk = 128 with BB rows in turn and kJointChunk = 64 with
// a warp group a row (each the fastest of 64, 128 and 256 on the H100), so
// the grid fills the card at every BB (576 blocks at B=64, BB=8).  Each
// block writes its chunk's partial per (row, head) to a workspace and
// counts it on its group's counter with a release add, which it does not
// wait for; the group's last block in launch order (its other blocks are
// running or done by then) waits for the count, loads every partial at
// once, combines the chunks in chunk order and puts the counter back to 0.
// (A ticket drawn with a returning atomic made every block wait for the
// round trip, and a combine that loaded one partial after another put a
// chain of round trips at the kernel's end.)
//
// P1 probe_stream (#8 s): the stream-only floor.  Each thread's 16-byte
//   loads of a row (neighbouring threads on neighbouring addresses) are all
//   issued before the first is used.  The bytes reduce to the JAX probe's
//   checksum: pltpu.bitcast packs four consecutive rows of the
//   second-to-last axis into an int32 word, so K byte (d, j) weighs
//   256^(d mod 4) and V byte (j, d) 256^(j mod 4); a thread's loads keep
//   one residue of d (and of j) mod 4, so one dp4a against 0x01010101 a
//   word and one shift a row.  The int32 sums wrap (order free); the row
//   group's combining block (a counter per row group; a warp a row, a lane
//   a head) adds the chunks, then the heads in order in f32, so the output
//   is bit-equal to the JAX probe's.
//
// P2 int4_rows (v3.1, a-e, i4_bf16): the exact function with f32 products on
//   CUDA cores.  Only the chunks holding a valid column are launched.  A
//   warp group stages its chunk's K (Dh rows of CH bytes, a cache row
//   apart) and V (CH rows of Dh bytes) in shared memory with 16-byte
//   cp.async copies, then computes the chunk's scores, max, exp-sum and P.V
//   partial (max, sum, acc[Dh]); a counter per (row group, head).  Template:
//   kByte (mask, shift and an int-to-float per nibble, v3.1) or packed (PRMT
//   into 0x4B000000 and one FADD, kernel B's conversion); R (R = 1: the
//   block walks its BB rows in turn, the next row's chunk copied into a
//   second buffer while the current one is computed, variant a; R = BB: a
//   warp group a row on barriers of its own, variants b-e, which compute
//   one function and differ on the TPU only in how they feed its matrix
//   unit); kBf16 (q and P rounded to bf16 before the products, f32
//   accumulation; nibbles are exact in bf16).  The plain version rounds
//   P = exp(s - m) with the row's global max m, so kBf16 launches the
//   chunks of a (row, head) as one thread-block cluster: each block
//   publishes its chunk's max in shared memory, one cluster barrier, and
//   every block reads the others' through distributed shared memory before
//   it exponentiates.
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
#include <cooperative_groups.h>
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

// P1's and P2's time split: packed columns a block (P2's by the rows a
// block takes: one, BB in turn, or a warp group each)
constexpr int kStreamChunk = 128;
constexpr int kChunk = 256;
constexpr int kTurnChunk = 128;
constexpr int kJointChunk = 64;
constexpr int kPart = kDh + 2;                 // a chunk's (max, sum, acc[Dh]) in the workspace
constexpr int kMaxCluster = 8;                 // portable cluster size: kBf16's chunks

__host__ __device__ constexpr int rows_chunk(int rows_at_once, int bb) {
  return bb == 1 ? kChunk : rows_at_once == 1 ? kTurnChunk : kJointChunk;
}

// A P2 chunk of CH packed columns (2*CH time positions) and its warp
// group's shared memory: tiles [K Dh x CH | V CH x Dh], then the scratch
// red [kKGroups][kTimes] (the score partials, then [kGroupsV][Dh] P.V
// partials) | ps [kTimes] | qs [Dh] | wred [8]
template <int CH>
struct Chunk {
  static constexpr int kKWords = CH / 4;          // 32-bit words of a K row in a chunk
  static constexpr int kKGroups = kGroup / kKWords;  // channel groups of the score loop
  static constexpr int kTimes = 2 * CH;           // times [evens | odds]
  static constexpr int kOwn = kTimes / kGroup;    // times a thread owns in the softmax
  static constexpr int kTile = 2 * kDh * CH;      // bytes of a chunk's K and V
  static constexpr int kScratch = (kKGroups * kTimes + kTimes + kDh + 8) * 4;
  static_assert(kKGroups >= 1 && kOwn >= 1, "a chunk spans 64 to 512 columns");
  static_assert(kGroupsV * kDh <= kKGroups * kTimes, "P.V partials fit the score partials");
  static_assert(kTile % 16 == 0 && kScratch % 16 == 0, "16-byte aligned tiles and partials");
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// One more finished partial on ``counter``, ordered after this thread's
// stores (and, through the barrier before it, its block's): no return value,
// so the block does not wait for the round trip.
__device__ __forceinline__ void count_done(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

// The combining block's wait until ``counter`` reaches ``target`` (every
// partial of its group published).  The group's other blocks precede it in
// launch order, so they are running or done; a wait past ~4 s traps, so a
// broken count fails the launch instead of hanging the card.
__device__ __forceinline__ void wait_count(const unsigned* counter, unsigned target) {
  for (long long spins = 0;; ++spins) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
    if (v >= target) return;
    if (spins > (1ll << 26)) __trap();
    __nanosleep(64);
  }
}

__device__ __forceinline__ unsigned dp4a_bytes(uint4 x, unsigned acc) {
  acc = __dp4a(x.x, 0x01010101u, acc);
  acc = __dp4a(x.y, 0x01010101u, acc);
  acc = __dp4a(x.z, 0x01010101u, acc);
  return __dp4a(x.w, 0x01010101u, acc);
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

// A warp group's barrier: the block's with one group, else a named barrier
// of the group's 128 threads (id 0 is __syncthreads')
template <int R>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (R == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kGroup) : "memory");
}

// One row's chunk into a warp group's tile [K Dh x CH | V CH x Dh]:
// the K parts and V rows up to the last valid column ``live`` (16-byte
// cp.async copies, neighbouring threads on neighbouring 16 bytes).
template <int CH>
__device__ __forceinline__ void stage_rows_chunk(unsigned char* tile, const uint8_t* kh,
                                                 const uint8_t* vh, int live, int half, int t) {
  constexpr int kParts = CH / 16;
#pragma unroll
  for (int i = 0; i < kDh * kParts / kGroup; ++i) {
    const int idx = t + i * kGroup, d = idx / kParts, p = idx % kParts;
    if (16 * p < live) cp_async16(tile + d * CH + 16 * p, kh + (size_t)d * half + 16 * p);
  }
#pragma unroll
  for (int i = 0; i < CH * kDh / 16 / kGroup; ++i) {
    const int idx = t + i * kGroup;
    if (idx < live * (kDh / 16)) cp_async16(tile + kDh * CH + 16 * idx, vh + 16 * idx);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ---------------------------------------------------------------------------
// P1: stream-only floor
// ---------------------------------------------------------------------------


template <int R, int BB>
__global__ void __launch_bounds__(kGroup * R)
probe_stream_kernel(const uint8_t* __restrict__ k4,  // (B, H, Dh, half) bytes of one layer
                    const uint8_t* __restrict__ v4,  // (B, H, half, Dh) bytes of one layer
                    float* __restrict__ out,         // (B, 1, H, Dh)
                    int* __restrict__ work,          // (B, H, chunks) int32 sums
                    unsigned* __restrict__ counters, // (B / BB,), 0 between calls
                    int n_head, int half) {
  constexpr int CH = kStreamChunk;
  constexpr int kRows = BB / R;                   // rows a warp group walks
  constexpr int kParts = CH / 16;                 // 16-byte parts of a K row in a chunk
  constexpr int kDStep = kGroup / kParts;         // channels apart of a thread's K loads
  constexpr int kKLoads = kDh / kDStep;
  constexpr int kVLoads = CH * kDh / 16 / kGroup;
  static_assert(kDStep % 4 == 0 && kGroup % 16 == 0, "a thread's loads keep one residue mod 4");
  const int c = blockIdx.x, h = blockIdx.y, rg = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int grp = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int lane = t & 31, warp = t >> 5;
  const int j0 = c * CH;
  const int width = min(CH, half - j0);  // a multiple of 64 columns
  const int p = t % kParts, d0 = t / kParts;
  __shared__ unsigned wred[R][kRows][4];
  __shared__ float acc_row[BB];

  // a row's loads, all issued before the first is used: K part p of
  // channels d0, d0 + kDStep, ... (one residue mod 4); V parts t, t + 128,
  // ... of the chunk's contiguous rows (4 parts a row: row t / 4 + 32 i, one
  // residue mod 4 since j0 % 4 == 0)
  unsigned s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t bh = (size_t)(rg * BB + grp + r * R) * n_head + h;
    const uint8_t* kh = k4 + bh * kDh * half + j0 + 16 * p;
    const uint8_t* vh = v4 + (bh * half + j0) * kDh;
    uint4 x[kKLoads + kVLoads];
#pragma unroll
    for (int i = 0; i < kKLoads; ++i)
      x[i] = 16 * p < width ? __ldg(reinterpret_cast<const uint4*>(kh + (size_t)(d0 + i * kDStep) * half))
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < kVLoads; ++i)
      x[kKLoads + i] = t + i * kGroup < width * (kDh / 16)
                           ? __ldg(reinterpret_cast<const uint4*>(vh + 16 * (t + i * kGroup)))
                           : make_uint4(0u, 0u, 0u, 0u);
    unsigned ak = 0u, av = 0u;
#pragma unroll
    for (int i = 0; i < kKLoads; ++i) ak = dp4a_bytes(x[i], ak);
#pragma unroll
    for (int i = 0; i < kVLoads; ++i) av = dp4a_bytes(x[kKLoads + i], av);
    s[r] = (ak << (8 * (d0 & 3))) + (av << (8 * ((t >> 2) & 3)));
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    unsigned v = s[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) wred[grp][r][warp] = v;
  }
  __syncthreads();
  if (t < kRows) {
    const size_t bh = (size_t)(rg * BB + grp + t * R) * n_head + h;
    work[bh * n_chunks + c] = (int)(wred[grp][t][0] + wred[grp][t][1] + wred[grp][t][2] + wred[grp][t][3]);
    count_done(counters + rg);
  }
  // the row group's last block in launch order sums the chunks, then the
  // heads in order, in f32, once every block's sums are in
  if (c != n_chunks - 1 || h != n_head - 1) return;
  if (threadIdx.x == 0) wait_count(counters + rg, (unsigned)(n_head * n_chunks * BB));
  __syncthreads();
  __threadfence();
  // a warp a row, a lane a head: every head's chunk sums loaded at once (the
  // combine is the kernel's tail, so it waits on one round trip, not one a
  // head), then lane 0 adds the heads in order
  for (int rr = threadIdx.x / 32; rr < BB; rr += kGroup * R / 32) {
    const int b = rg * BB + rr;
    unsigned sum = 0u;
    if (lane < n_head) {
      const int* wh = work + ((size_t)b * n_head + lane) * n_chunks;
#pragma unroll 4
      for (int cc = 0; cc < n_chunks; ++cc) sum += (unsigned)__ldcg(wh + cc);
    }
    const float head = i2f_exact((int)sum);
    float a = 0.f;
    for (int hh = 0; hh < n_head; ++hh) a += __shfl_sync(0xffffffffu, head, hh);
    if (lane == 0) acc_row[rr] = a;
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
// P2: the exact function, f32 products on CUDA cores
// ---------------------------------------------------------------------------

// with a warp group a row, two 128*BB-thread blocks an SM (32 registers a
// thread at BB=8), so that one block's loads overlap the other's arithmetic
template <bool kByte, int R, int BB, bool kBf16>
__global__ void __launch_bounds__(kGroup * R, R > 1 ? 2 : 1)
int4_rows_kernel(const float* __restrict__ q,       // (B, 1, H, Dh)
                 const uint8_t* __restrict__ k4,    // (B, H, Dh, half) bytes of one layer
                 const uint8_t* __restrict__ v4,    // (B, H, half, Dh) bytes of one layer
                 float* __restrict__ out,           // (B, 1, H, Dh)
                 float* __restrict__ work,          // (B, H, chunks, Dh + 2) partials
                 unsigned* __restrict__ counters,   // (B / BB, H), 0 between calls
                 int n_head, int half, int valid_len, float scale) {
  static_assert(!kBf16 || (R == 1 && BB == 1), "kBf16's cluster holds one row's chunks");
  constexpr int CH = rows_chunk(R, BB);
  using Ch = Chunk<CH>;
  constexpr int kBufs = R == 1 && BB > 1 ? 2 : 1;  // rows in turn: the next row's chunk in flight
  constexpr int kGroupBytes = kBufs * Ch::kTile + Ch::kScratch;
  const int c = blockIdx.x, h = blockIdx.y, rg = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int grp = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int lane = t & 31, warp = t >> 5;
  const int n_even = (valid_len + 1) >> 1, n_odd = valid_len >> 1;
  const int j0 = c * CH;
  const int live = min(CH, n_even - j0);  // >= 1: only chunks holding a valid column run

  extern __shared__ __align__(16) float smem[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(smem) + grp * kGroupBytes;
  float* red = reinterpret_cast<float*>(tiles + kBufs * Ch::kTile);
  float* ps = red + Ch::kKGroups * Ch::kTimes;
  float* qs = ps + Ch::kTimes;
  float* wred = qs + kDh;
  __shared__ float chunk_max;  // kBf16: this chunk's max, read by the cluster

  const size_t head_bytes = (size_t)kDh * half;
  auto row_bh = [&](int rr) { return (size_t)(rg * BB + rr) * n_head + h; };
  stage_rows_chunk<CH>(tiles, k4 + row_bh(grp) * head_bytes + j0,
                       v4 + row_bh(grp) * head_bytes + (size_t)j0 * kDh, live, half, t);

  int it = 0;
#pragma unroll 1
  for (int rr = grp; rr < BB; rr += R, ++it) {
    const size_t bh = row_bh(rr);
    const unsigned char* tile = tiles + (it & (kBufs - 1)) * Ch::kTile;
    if (kBufs == 2 && rr + R < BB) {
      const size_t nx = row_bh(rr + R);
      stage_rows_chunk<CH>(tiles + ((it + 1) & 1) * Ch::kTile, k4 + nx * head_bytes + j0,
                           v4 + nx * head_bytes + (size_t)j0 * kDh, live, half, t);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    if (t < kDh) {
      const float x = q[bh * kDh + t];
      qs[t] = kBf16 ? bf16_round(x) : x;
    }
    group_sync<R>(grp);  // publishes qs and every thread's copies of the chunk

    // --- scores: thread (group g, word w) sums channels g, g + kKGroups, ...
    // of packed columns 4w..4w+3, even and odd times
    {
      const int w = t % Ch::kKWords, g = t / Ch::kKWords;
      const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(tile);
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kDh / Ch::kKGroups; ++i) {
        const int d = g + i * Ch::kKGroups;
        const uint32_t word = ks32[d * Ch::kKWords + w];
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
      *reinterpret_cast<float4*>(red + g * Ch::kTimes + 4 * w) = make_float4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<float4*>(red + g * Ch::kTimes + CH + 4 * w) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
    }
    group_sync<R>(grp);

    // --- the chunk's softmax: thread t owns times t, t + 128, ... of the
    // chunk's [evens | odds]; past n_even / n_odd the score is -inf and P is 0
    float sv[Ch::kOwn];
    bool ok[Ch::kOwn];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < Ch::kOwn; ++k) {
      const int tt = t + k * kGroup;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < Ch::kKGroups; ++g) s += red[g * Ch::kTimes + tt];
      ok[k] = j0 + (tt % CH) < (tt < CH ? n_even : n_odd);
      sv[k] = ok[k] ? s * scale : -INFINITY;
      m = fmaxf(m, sv[k]);
    }
    m = warp_max(m);
    if (lane == 0) wred[warp] = m;
    group_sync<R>(grp);  // the group's max partials
    m = fmaxf(fmaxf(wred[0], wred[1]), fmaxf(wred[2], wred[3]));  // finite: column j0 is valid
    if constexpr (kBf16) {
      // the plain version rounds exp(s - m) to bf16 with the row's max: take
      // it over the cluster (this row's chunks) before exponentiating
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) chunk_max = m;
      cluster.sync();
      for (unsigned r = 0; r < cluster.num_blocks(); ++r)
        m = fmaxf(m, *cluster.map_shared_rank(&chunk_max, r));
      // done reading the others' maxima; the block waits for the cluster
      // only before it exits
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    }
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < Ch::kOwn; ++k) {
      const float p = ok[k] ? expf(sv[k] - m) : 0.f;
      ps[t + k * kGroup] = kBf16 ? bf16_round(p) : p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) wred[4 + warp] = l;
    group_sync<R>(grp);  // publishes ps and the group's sum partials; red is free again
    l = (wred[4] + wred[5]) + (wred[6] + wred[7]);

    // --- P.V: thread (g, cw) owns channels 4cw..4cw+3 of packed rows g,
    // g + 8, ... (P is 0 past the valid columns)
    {
      const int cw = t % kWordsV, g = t / kWordsV;
      const uint32_t* vs32 = reinterpret_cast<const uint32_t*>(tile + kDh * CH);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int i = 0; i < CH / kGroupsV; ++i) {
        const int j = g + i * kGroupsV;
        const uint32_t word = vs32[j * kWordsV + cw];
        const float pl = ps[j], ph = ps[CH + j];
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
    group_sync<R>(grp);
    float* part = work + (bh * n_chunks + c) * kPart;  // (max, sum, acc[Dh])
    if (t < kDh) {
      float tot = 0.f;
#pragma unroll
      for (int g = 0; g < kGroupsV; ++g) tot += red[g * kDh + t];
      part[2 + t] = tot;
    }
    if (t == 0) {
      part[0] = m;
      part[1] = l;
    }
    group_sync<R>(grp);  // qs, ps, red, wred and this tile are rewritten by the next row
  }

  if constexpr (kBf16)  // no block leaves while another may read its max
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  // --- the (row group, head)'s last chunk in launch order combines the
  // chunks once every block's partials are in
  if (t < kDh) __threadfence();  // the partials are seen before the count
  __syncthreads();
  const size_t ticket = (size_t)rg * n_head + h;
  if (threadIdx.x == 0) count_done(counters + ticket);
  if (c != n_chunks - 1) return;
  if (threadIdx.x == 0) wait_count(counters + ticket, (unsigned)n_chunks);
  __syncthreads();
  __threadfence();
  // the combine is the kernel's tail: every chunk's (max, sum) of the
  // block's rows loaded at once into the free tiles, each row's weights
  // e^(m_c - M) and denominator from there, then the P.V partials, their
  // loads unrolled across chunks
  float* wgt = smem;                   // [BB][n_chunks] chunk maxima, then weights
  float* lsum = smem + BB * n_chunks;  // [BB][n_chunks] chunk sums
  float* den = lsum + BB * n_chunks;   // [BB]
#pragma unroll
  for (int rr = 0; rr < BB; ++rr) {
    const float* parts = work + row_bh(rr) * n_chunks * kPart;
    for (int cc = threadIdx.x; cc < n_chunks; cc += kGroup * R) {
      wgt[rr * n_chunks + cc] = __ldcg(parts + cc * kPart);
      lsum[rr * n_chunks + cc] = __ldcg(parts + cc * kPart + 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < BB) {
    float* w = wgt + threadIdx.x * n_chunks;
    const float* l = lsum + threadIdx.x * n_chunks;
    float mx = -INFINITY;
    for (int cc = 0; cc < n_chunks; ++cc) mx = fmaxf(mx, w[cc]);
    float dn = 0.f;
    for (int cc = 0; cc < n_chunks; ++cc) {  // chunk order
      w[cc] = expf(w[cc] - mx);
      dn = fmaf(w[cc], l[cc], dn);
    }
    den[threadIdx.x] = dn;
  }
  __syncthreads();
#pragma unroll 1
  for (int i = threadIdx.x; i < BB * kDh; i += kGroup * R) {
    const int rr = i / kDh, d = i % kDh;
    const size_t bh = row_bh(rr);
    const float* parts = work + bh * n_chunks * kPart + 2 + d;
    const float* w = wgt + rr * n_chunks;
    float num = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < n_chunks; ++cc) num = fmaf(w[cc], __ldcg(parts + cc * kPart), num);
    // p.(u-8) = p.u - 8 denom: a constant -8 shift after normalising
    out[bh * kDh + d] = num / den[rr] - 8.f;
  }
  if (threadIdx.x == 0) counters[ticket] = 0u;
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
  const dim3 grid((half + kStreamChunk - 1) / kStreamChunk, n_head, batch / BB);
  probe_stream_kernel<R, BB><<<grid, kGroup * R, 0, st>>>(
      static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v), static_cast<float*>(out),
      static_cast<int*>(work), static_cast<unsigned*>(counters), n_head, half);
  return (int)cudaGetLastError();
}

template <bool kByte, int R, int BB, bool kBf16>
int launch_rows(const void* q, const void* k, const void* v, void* out, void* work, void* counters,
                int batch, int n_head, int half, int valid_len, float scale, cudaStream_t st) {
  constexpr int kBufs = R == 1 && BB > 1 ? 2 : 1;
  constexpr int CH = rows_chunk(R, BB);
  const size_t smem = (size_t)R * (kBufs * Chunk<CH>::kTile + Chunk<CH>::kScratch);
  const int n_chunks = ((valid_len + 1) / 2 + CH - 1) / CH;
  if (smem > 227 * 1024 || (kBf16 && n_chunks > kMaxCluster)) return (int)cudaErrorInvalidValue;
  auto kernel = int4_rows_kernel<kByte, R, BB, kBf16>;
  const int e = prepare(kernel, smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, n_head, batch / BB);
  cfg.blockDim = dim3(kGroup * R);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  if (kBf16) {  // a (row, head)'s chunks form one cluster
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = n_chunks;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<float*>(out), static_cast<float*>(work),
      static_cast<unsigned*>(counters), n_head, half, valid_len, scale);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
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

// Packed columns a chunk (a block along the grid's x) of P1 and P2 at bb
// rows a block, rows_at_once of them at once.
extern "C" int probe_chunk_columns(int stream, int bb, int rows_at_once) {
  return stream ? kStreamChunk : rows_chunk(rows_at_once, bb);
}

// k_layer / v_layer point at one layer of the stacked int4 cache.  ``work``
// holds batch*n_head*ceil(half/chunk) ints, ``counters`` batch/bb zeroed
// unsigned ints, left zeroed.  rows_at_once is 1 or bb; n_head at most 32
// (a lane a head in the combine).  Returns
// cudaGetLastError() after the launch (0 = success), cudaErrorInvalidValue
// for a shape not instantiated.
extern "C" int probe_stream_launch(const void* k_layer, const void* v_layer, void* out, void* work,
                                   void* counters, int batch, int n_head, int dh, int half, int bb,
                                   int rows_at_once, void* stream) {
  if (dh != kDh || half % 64 || half < 64 || batch % bb || batch / bb > 65535 || n_head > 32)
    return (int)cudaErrorInvalidValue;
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
// ``work`` holds batch*n_head*ceil(ceil(valid_len/2)/chunk)*66 floats,
// ``counters`` batch/bb*n_head zeroed unsigned ints, left zeroed.  bf16
// takes at most 8 chunks (one cluster a row and head).
extern "C" int int4_rows_launch(const void* q, const void* k_layer, const void* v_layer, void* out,
                                void* work, void* counters, int batch, int n_head, int dh, int half,
                                int valid_len, float scale, int byte_unpack, int bb,
                                int rows_at_once, int bf16, void* stream) {
  if (dh != kDh || half % 64 || half < 64 || batch % bb || batch / bb > 65535 || valid_len < 1 ||
      valid_len > 2 * half)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT4_ROWS(BYTE, R, BB, BF16)                                                            \
  if (byte_unpack == BYTE && rows_at_once == R && bb == BB && bf16 == BF16)                     \
    return launch_rows<BYTE, R, BB, BF16>(q, k_layer, v_layer, out, work, counters, batch,       \
                                          n_head, half, valid_len, scale, st);
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
