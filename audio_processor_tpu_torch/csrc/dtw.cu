// Dynamic time warping for word timestamps: a host function, not a device
// kernel.  The native DTW of the port's native/audio_io.cc (aptpu_dtw,
// itself a copy of the JAX package's), over a batch of rows; the
// word-timestamp path runs it on the host after the teacher-forced
// alignment pass (models/whisper/align.py).
//
//   cost (B, T, Ta) float32, row-major; row b uses its top-left
//   (t[b], ta[b]) sub-rectangle.  out (B, T) int64 receives, for each of the
//   row's t[b] text rows, the audio column where it starts (the rest of the
//   row is zero).
//
// The recurrence acc[i][j] = cost[i-1][j-1] + min(diagonal, down, right)
// reads only cells above and to the left, so a row's sub-rectangle of the
// padded batch is exactly its own DTW.  Decision rule and accumulator type
// replicate openai-whisper's dtw_cpu (whisper/timing.py): float32 sums,
// the diagonal or down step only when STRICTLY cheaper than both others,
// otherwise the right step (ties fall through to it).  The plain twin is
// ops/kernels/dtw.py's numpy wavefront, which makes the same decisions on
// the same float32 sums.
#include <stdint.h>

#include <limits>
#include <vector>

extern "C" int dtw_batch(const float* cost, int64_t b, int64_t t_max, int64_t ta_max,
                         const int64_t* t_rows, const int64_t* ta_rows, int64_t* out) try {
  if (b < 0 || t_max < 0 || ta_max < 0) return -1;
  const float INF = std::numeric_limits<float>::infinity();
  std::vector<float> prev, cur;
  std::vector<int8_t> trace;
  for (int64_t r = 0; r < b; ++r) {
    const int64_t t = t_rows[r], ta = ta_rows[r];
    int64_t* starts = out + r * t_max;
    for (int64_t i = 0; i < t_max; ++i) starts[i] = 0;
    if (t == 0 || ta == 0) continue;
    if (t < 0 || ta < 0 || t > t_max || ta > ta_max) return -1;
    const float* c = cost + r * t_max * ta_max;
    prev.assign(ta + 1, INF);
    cur.assign(ta + 1, INF);
    trace.assign((t + 1) * (ta + 1), 0);
    prev[0] = 0.0f;
    for (int64_t i = 1; i <= t; ++i) {
      cur[0] = INF;
      const float* row = c + (i - 1) * ta_max;
      for (int64_t j = 1; j <= ta; ++j) {
        const float c0 = prev[j - 1];  // diagonal
        const float c1 = prev[j];      // down (next token, same frame)
        const float c2 = cur[j - 1];   // right (same token, next frame)
        float best;
        int8_t step;
        if (c0 < c1 && c0 < c2) { best = c0; step = 0; }
        else if (c1 < c0 && c1 < c2) { best = c1; step = 1; }
        else { best = c2; step = 2; }
        cur[j] = row[j - 1] + best;
        trace[i * (ta + 1) + j] = step;
      }
      prev.swap(cur);
    }
    int64_t i = t, j = ta;
    while (i > 0 && j > 0) {
      starts[i - 1] = j - 1;
      const int8_t step = trace[i * (ta + 1) + j];
      if (step == 0) { --i; --j; }
      else if (step == 1) { --i; }
      else { --j; }
    }
  }
  return 0;
} catch (...) {
  return -1;
}
