// Fused non-causal self-attention for the Whisper encoder, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel fused_self_attention
// (audio_processor_tpu/ops/pallas/encoder_attention.py:80; body _kernel :59).
// It computes the same function, not the TPU's block structure:
//
//   q, k, v (B, T, H, Dh) in the compute dtype (bf16 on the serving path,
//   f32 in parity runs), read through their strides: no transposing copy.
//   Dh = 64, the head width of every Whisper config.  scores = q k^T /
//   sqrt(Dh) in f32, softmax in f32, P V accumulated in f32, output
//   (B, T, H, Dh) in the compute dtype.  Keys past T are masked.
//
// No (B, H, T, T) buffer is written: the plain path's f32 scores are
// 13.8 GB a layer at whisper-small's default slab (B=128, H=12, T=1500).
//
// Bound on the H100: operations.  4*B*H*T^2*Dh = 0.885 TFLOP a layer at
// B=128 (0.895 ms at 989 TFLOP/s bf16 dense) against 1.18 GB of q, k, v
// and out (0.352 ms at 3.35 TB/s).
//
// bf16 design, FlashAttention-3-shaped, in two passes over the keys.
// Persistent CTAs (one per SM) walk the (128-row query tile, head, batch
// row) items, the query tile fastest so that the CTAs in flight share a
// head's K and V in L2.  A CTA is two consumer warpgroups (64 query rows
// each, 232 registers a thread) and one producer warpgroup (40 registers,
// rebalanced by setmaxnreg):
//   - one producer thread issues TMA loads through 4-D tensor maps over
//     the strided (B, T, H, Dh) views (built on the host each call, box
//     64 Dh x 1 H x 128 T x 1 B, 128-byte swizzle: a bf16 row of 64 is
//     128 bytes).  TMA zero-fills rows past T.  Q is loaded once per item;
//     K tiles of 128 keys (pass 1), then K and V tiles (pass 2), 16 KB
//     each, flow through a ring of kStages slots guarded by full/empty
//     mbarriers, so loads stay in flight during the math;
//   - each consumer warpgroup computes S = Q K^T with four
//     wgmma.m64n128k16 (both operands in shared memory, K-major) and masks
//     keys past T on the last tile.  Pass 1 keeps the running row max m
//     and sum l in f32 registers (base-2 exponent, the scale folded in)
//     and frees each K slot as soon as S is in registers.  Pass 2 forms
//     P = exp(s - m) / l, rounds it to bf16 in registers (the accumulator
//     layout of S is the A-operand layout of the next product) and
//     accumulates O += P V with eight wgmma.m64n64k16, A from registers
//     and V from shared memory MN-major (the transpose flag: no hand
//     transpose), issued together with the next tile's QK^T.  Each
//     warpgroup waits for all its products before it touches their
//     registers (any overlap made ptxas serialise every wgmma); the two
//     warpgroups interleave, one's exponentials running during the
//     other's products.
// Two passes keep the reference's rounding point (P normalised, then
// rounded; encoder_attention.py:72).  One pass, rounding exp(s - m_running)
// before 1/l, ran faster on the H100 but moved outputs near an ulp boundary
// by one bf16 ulp (2^-7 where |x| >= 1, as at T = 77), past the 4e-3 the
// kernel is held to.  The second QK^T costs 1.5x the MMA work and 2x the
// exponentials.
//
// f32 (a parity path, not serving): scalar FMA, one thread per query row,
// two passes (row max and sum, then P V) over 64-key tiles.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, t, h;  // elements; the Dh axis has stride 1
};

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                      // warpgroups of 64 query rows
constexpr int kWgThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg; 64K a block
constexpr int kQRows = 64 * kConsumers;             // query rows per item
constexpr int kKeys = 128;                          // keys per K or V tile
constexpr int kQBytes = kQRows * 64 * 2;
constexpr int kTileBytes = kKeys * 64 * 2;          // 16 KB: one K or V tile
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
              "registers");
constexpr int kStages = 3;
constexpr int kSmemBytes = 1024 + kQBytes + kTileBytes * 2 * kStages + 8 * (2 * kStages + 2);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that outlasts every legitimate one (a TMA that never lands, a
// broken phase) traps: the launch fails with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one (64 Dh, 1 H, rows T, 1 B) box at (0, h, t0, b) into 1024-aligned shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int t0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  Both byte offsets are
// the 1024-byte stride of 8-row groups: K-major tiles (Q, K) read it as the
// stride between 8-row groups; the MN-major V tile (one 64-wide atom along
// N) reads it as the stride between groups of 8 keys along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins a register after wgmma.wait_group: no read may move above the wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 128, f32) (+)= A (64 x 16, smem K-major) * B (16 x 128, smem K-major)
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem MN-major)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V for the V tile at smem address v (eight k-steps of 16 keys,
// 2,048 bytes apart)
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[8][4], uint32_t v) {
  const uint64_t dv = desc_sw128(v);
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) wgmma_pv(o, pa[kc], dv + (16 * 128 >> 4) * kc);
}

// after the wait: O and the P fragments the product read stay where the
// tensor cores left and found them
__device__ __forceinline__ void pin(float (&o)[32], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(o[i]);
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kc][e])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of a wgmma m64nN tile: warp w of the warpgroup owns
// rows 16w..16w+15; register i of lane l holds row 16w + l/4 (+8 when
// i%4 >= 2), column 8*(i/4) + 2*(l%4) + i%2.
__global__ void __launch_bounds__(kWgThreads, 1)
encoder_attn_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         __nv_bfloat16* __restrict__ out, int t, int n_head, int n_items,
                         Strides so, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_s = smem_u32(smem);
  auto k_s = [&](int s) { return q_s + kQBytes + kTileBytes * 2 * s; };
  auto v_s = [&](int s) { return q_s + kQBytes + kTileBytes * (2 * s + 1); };
  const uint32_t bars = q_s + kQBytes + kTileBytes * 2 * kStages;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t q_full = bars + 8 * (2 * kStages), q_empty = q_full + 8;
  const int n_qt = (t + kQRows - 1) / kQRows, n_tiles = (t + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every load; per item Q, then the K tiles
    // (pass 1), then the K and V tiles (pass 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x != 128 * kConsumers) return;
    int g = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int qt = item % n_qt, h = (item / n_qt) % n_head, b = item / (n_qt * n_head);
      mbar_wait(q_empty, (it & 1) ^ 1);
      mbar_expect_tx(q_full, kQBytes);
      tma_load(q_s, &tq, q_full, qt * kQRows, h, b);
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % kStages;
          mbar_wait(empty(s), ((g / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), (1 + pass) * kTileBytes);
          tma_load(k_s(s), &tk, full(s), j * kKeys, h, b);
          if (pass) tma_load(v_s(s), &tv, full(s), j * kKeys, h, b);
        }
      }
    }
  } else {
    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    const int quad = lane >> 2, col = 2 * (lane & 3);
    const uint64_t dq = desc_sw128(q_s + wg * (64 * 64 * 2));
    // S = Q K^T for the keys of slot s (raw scores), one committed group
    auto issue_scores = [&](float (&sc)[64], int s) {
      const uint64_t dk = desc_sw128(k_s(s));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_qk(sc, dq + 2 * kk, dk + 2 * kk, kk);  // +32 B a step
      wgmma_commit();
    };
    // after the wait: no read of the scores may move above it
    auto pin_scores = [&](float (&sc)[64]) {
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
    };
    // is score register i a key < T on the tile at k0?
    auto live = [&](int i, int k0) { return k0 + 8 * (i / 4) + col + (i & 1) < t; };
    auto slot = [&](int gg) { return gg % kStages; };
    auto wait_full = [&](int gg) { mbar_wait(full(slot(gg)), (gg / kStages) & 1); };

    int g = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int qt = item % n_qt, h = (item / n_qt) % n_head, b = item / (n_qt * n_head);
      mbar_wait(q_full, it & 1);

      // pass 1: row max m and sum l in the base-2 domain (l: this lane's
      // partial sums until the end)
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      for (int j = 0; j < n_tiles; ++j) {
        float sc[64];
        wait_full(g + j);
        issue_scores(sc, slot(g + j));
        wgmma_wait_all();
        pin_scores(sc);
        mbar_arrive(empty(slot(g + j)));  // the K tile is consumed
        const int k0 = j * kKeys;
        const bool tail = k0 + kKeys > t;
        auto x = [&](int i) { return tail && !live(i, k0) ? -INFINITY : sc[i]; };
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < 16; ++i) mx = fmaxf(mx, fmaxf(x(4 * i + 2 * r), x(4 * i + 2 * r + 1)));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx * scale_log2);  // finite: every tile has a key < T
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            sum += ex2(fmaf(x(4 * i + 2 * r), scale_log2, -m_new)) +
                   ex2(fmaf(x(4 * i + 2 * r + 1), scale_log2, -m_new));
          l[r] = l[r] * ex2(m[r] - m_new) + sum;
          m[r] = m_new;
        }
      }
      g += n_tiles;
      float inv_l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv_l[r] = 1.f / l[r];
      }

      // pass 2: P = exp(s - m) / l rounded to bf16, O += P V in f32.  The
      // product of tile j's P with V is issued with tile j+1's scores, so
      // the tensor cores take both at once.  (Reading or writing registers
      // of one product while another is in flight makes ptxas serialise
      // every product: each wait here is for all of them.)
      float o[32], sc[64];
      uint32_t pa[8][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      auto probs = [&](int j) {  // P of tile j from sc into pa
        pin_scores(sc);
        if (j == n_tiles - 1) mbar_arrive(q_empty);  // this item's Q is no longer read
        const int k0 = j * kKeys;
        const bool tail = k0 + kKeys > t;
#pragma unroll
        for (int kc = 0; kc < 8; ++kc) {  // keys 16kc..16kc+15: n8 chunks 2kc, 2kc+1
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kc + 2 * e, r = e & 1;
            float p0 = ex2(fmaf(sc[i], scale_log2, -m[r])) * inv_l[r];
            float p1 = ex2(fmaf(sc[i + 1], scale_log2, -m[r])) * inv_l[r];
            if (tail) {
              p0 = live(i, k0) ? p0 : 0.f;
              p1 = live(i + 1, k0) ? p1 : 0.f;
            }
            pa[kc][e] = pack_bf16(p0, p1);
          }
        }
      };
      wait_full(g);
      issue_scores(sc, slot(g));
      wgmma_wait_all();
      probs(0);
      for (int j = 0; j < n_tiles; ++j) {
        const bool next = j + 1 < n_tiles;
        if (next) {
          wait_full(g + j + 1);
          issue_scores(sc, slot(g + j + 1));
        }
        wgmma_fence();
        issue_pv(o, pa, v_s(slot(g + j)));
        wgmma_commit();
        wgmma_wait_all();
        pin(o, pa);
        mbar_arrive(empty(slot(g + j)));  // its K and V tiles are consumed
        if (next) probs(j + 1);
      }
      g += n_tiles;

      const int r0 = qt * kQRows + wg * 64 + warp * 16 + quad, r1 = r0 + 8;
      __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + col;
        if (r0 < t)
          *reinterpret_cast<uint32_t*>(ob + r0 * so.t + c) = pack_bf16(o[4 * n], o[4 * n + 1]);
        if (r1 < t)
          *reinterpret_cast<uint32_t*>(ob + r1 * so.t + c) =
              pack_bf16(o[4 * n + 2], o[4 * n + 3]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// links only cudart
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (Dh, H, T, B) map over a strided (B, T, H, 64) bf16 view, box (64, 1,
// rows, 1), 128-byte swizzle, rows past T read as zeros.  The axes go in
// the order of their strides in the encoder's views (split heads of one
// projection, or contiguous).  A stride of a length-1 axis is never
// followed; it is given a packed value, since the encoder checks every
// stride.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int t, int n_head, Strides s,
              int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)n_head, (cuuint64_t)t, (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.t * 2, (cuuint64_t)s.b * 2};
  if (n_head == 1) strides[0] = 128;
  if (t == 1) strides[1] = strides[0] * n_head;
  if (batch == 1) strides[2] = strides[1] * t;
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int batch, int t,
                int n_head, Strides sq, Strides sk, Strides sv, Strides so, float scale,
                cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, batch, t, n_head, sq, kQRows) ||
      !make_map(&mk, k, batch, t, n_head, sk, kKeys) || !make_map(&mv, v, batch, t, n_head, sv, kKeys))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(encoder_attn_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int device = 0, n_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)e;
  const long long items = (long long)((t + kQRows - 1) / kQRows) * n_head * batch;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < n_sm ? (int)items : n_sm;
  encoder_attn_bf16_kernel<<<grid, kWgThreads, kSmemBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), t, n_head, (int)items, so,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: scalar parity path
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBlockK = 64;  // keys per shared-memory tile

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch,
// time, head) for each tensor; the Dh axis is contiguous (bf16: 16-byte
// aligned base and strides, for TMA).  Returns cudaGetLastError() after
// the launch (0 = success), or cudaErrorInvalidValue for what the kernels
// do not take.
extern "C" int encoder_attn_launch(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int batch, int t, int n_head, int dh,
                                   long long sq_b, long long sq_t, long long sq_h,
                                   long long sk_b, long long sk_t, long long sk_h,
                                   long long sv_b, long long sv_t, long long sv_h,
                                   long long so_b, long long so_t, long long so_h,
                                   float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch < 1 || batch > 65535 || t < 1 || n_head < 1 ||
      n_head > 65535 || dh != 64)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_t, sq_h}, sk{sk_b, sk_t, sk_h}, sv{sv_b, sv_t, sv_h},
      so{so_b, so_t, so_h};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_bf16(q, k, v, out, batch, t, n_head, sq, sk, sv, so, scale, st);
  const dim3 grid((t + kThreads - 1) / kThreads, n_head, batch);
  encoder_attn_f32_kernel<64><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), t, sq, sk, sv, so, scale);
  return (int)cudaGetLastError();
}
