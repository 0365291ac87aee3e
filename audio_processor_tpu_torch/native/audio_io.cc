// Native audio I/O: RIFF/WAVE decode + polyphase resample to 16 kHz mono.
//
// The reference delegates all decoding to an ffmpeg subprocess (reference:
// app/services/audio_processor.py:912-923 — fork/exec + temp files per
// job).  This module is the in-process equivalent for the PCM path: a
// zero-copy WAV parser handling PCM 8/16/24/32 and float32/64 (incl.
// WAVE_FORMAT_EXTENSIBLE), channel downmix, and a windowed-sinc polyphase
// resampler, exposed through a C ABI consumed via ctypes
// (native/audio_io.py, built by native/build.py).  Feeds the host->device
// ingest pipeline without subprocess overhead.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct WavFormat {
  uint16_t audio_format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
};

// Parse RIFF chunks; returns false on malformed input.
bool parse_wav(const uint8_t* data, int64_t size, WavFormat* fmt,
               const uint8_t** payload, int64_t* payload_size) {
  if (size < 44 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0) {
    return false;
  }
  int64_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= size) {
    const uint8_t* cid = data + pos;
    uint32_t csize;
    std::memcpy(&csize, data + pos + 4, 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + static_cast<int64_t>(csize) > size) {
      csize = static_cast<uint32_t>(size - pos - 8);  // tolerate truncation
    }
    if (std::memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      std::memcpy(&fmt->audio_format, body, 2);
      std::memcpy(&fmt->channels, body + 2, 2);
      std::memcpy(&fmt->sample_rate, body + 4, 4);
      std::memcpy(&fmt->bits, body + 14, 2);
      if (fmt->audio_format == 0xFFFE && csize >= 40) {
        std::memcpy(&fmt->audio_format, body + 24, 2);  // GUID leading code
      }
      have_fmt = true;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      *payload = body;
      *payload_size = csize;
      have_data = true;
    }
    pos += 8 + csize + (csize & 1);  // word alignment
  }
  // Reject degenerate/hostile headers: sample_rate = 0 would divide by zero
  // in the resampler (SIGFPE kills the whole process — a signal, not an
  // exception, so Python callers can't catch it) and an absurd rate would
  // size the polyphase kernel at 16*max(up,down) taps (tens of GB).
  return have_fmt && have_data && fmt->channels > 0 &&
         fmt->sample_rate > 0 && fmt->sample_rate <= 768000;
}

// Unaligned little-endian load: chunk bodies are only 2-byte aligned (RIFF
// word alignment), so reinterpret_cast reads of 32/64-bit samples would be
// UB on a body at offset 2 mod 4.  memcpy compiles to a plain load on x86.
template <typename T>
static inline T load_le(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

// Decode interleaved PCM to mono float32.
bool decode_payload(const WavFormat& fmt, const uint8_t* p, int64_t n,
                    std::vector<float>* out) {
  const int ch = fmt.channels;
  const double inv_ch = 1.0 / ch;
  switch (fmt.audio_format) {
    case 1: {  // integer PCM
      if (fmt.bits == 16) {
        int64_t frames = n / (2 * ch);
        out->resize(frames);
        for (int64_t i = 0; i < frames; ++i) {
          double acc = 0;
          for (int c = 0; c < ch; ++c)
            acc += load_le<int16_t>(p + (i * ch + c) * 2);
          (*out)[i] = static_cast<float>(acc * inv_ch / 32768.0);
        }
        return true;
      }
      if (fmt.bits == 24) {
        int64_t frames = n / (3 * ch);
        out->resize(frames);
        for (int64_t i = 0; i < frames; ++i) {
          double acc = 0;
          for (int c = 0; c < ch; ++c) {
            const uint8_t* b = p + (i * ch + c) * 3;
            int32_t v = b[0] | (b[1] << 8) | (b[2] << 16);
            v = (v ^ 0x800000) - 0x800000;
            acc += v;
          }
          (*out)[i] = static_cast<float>(acc * inv_ch / 8388608.0);
        }
        return true;
      }
      if (fmt.bits == 32) {
        int64_t frames = n / (4 * ch);
        out->resize(frames);
        for (int64_t i = 0; i < frames; ++i) {
          double acc = 0;
          for (int c = 0; c < ch; ++c)
            acc += load_le<int32_t>(p + (i * ch + c) * 4);
          (*out)[i] = static_cast<float>(acc * inv_ch / 2147483648.0);
        }
        return true;
      }
      if (fmt.bits == 8) {  // unsigned
        int64_t frames = n / ch;
        out->resize(frames);
        for (int64_t i = 0; i < frames; ++i) {
          double acc = 0;
          for (int c = 0; c < ch; ++c) acc += (int(p[i * ch + c]) - 128);
          (*out)[i] = static_cast<float>(acc * inv_ch / 128.0);
        }
        return true;
      }
      return false;
    }
    case 3: {  // IEEE float
      if (fmt.bits == 32) {
        int64_t frames = n / (4 * ch);
        out->resize(frames);
        for (int64_t i = 0; i < frames; ++i) {
          double acc = 0;
          for (int c = 0; c < ch; ++c)
            acc += load_le<float>(p + (i * ch + c) * 4);
          (*out)[i] = static_cast<float>(acc * inv_ch);
        }
        return true;
      }
      if (fmt.bits == 64) {
        int64_t frames = n / (8 * ch);
        out->resize(frames);
        for (int64_t i = 0; i < frames; ++i) {
          double acc = 0;
          for (int c = 0; c < ch; ++c)
            acc += load_le<double>(p + (i * ch + c) * 8);
          (*out)[i] = static_cast<float>(acc * inv_ch);
        }
        return true;
      }
      return false;
    }
    default:
      return false;
  }
}

int64_t gcd64(int64_t a, int64_t b) { return b == 0 ? a : gcd64(b, a % b); }

// Polyphase rational resampler: zero-stuff by `up`, windowed-sinc lowpass,
// take every `down`-th sample.  Filter taps are evaluated per output phase
// so the zero-stuffed signal is never materialised.
void resample_poly(const std::vector<float>& in, int64_t sr_in, int64_t sr_out,
                   std::vector<float>* out) {
  if (sr_in == sr_out || in.empty()) {
    *out = in;
    return;
  }
  const int64_t g = gcd64(sr_in, sr_out);
  const int64_t up = sr_out / g, down = sr_in / g;
  const int taps_per_phase = 16;
  const int64_t half = taps_per_phase * std::max(up, down) / 2;
  const double cutoff = 0.5 / static_cast<double>(std::max(up, down));

  // kaiser(beta=8.555) windowed sinc, gain `up`
  const int64_t klen = 2 * half + 1;
  std::vector<double> kernel(klen);
  const double beta = 8.555;
  auto bessel_i0 = [](double x) {
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 32; ++k) {
      term *= (x / (2.0 * k)) * (x / (2.0 * k));
      sum += term;
      if (term < 1e-16 * sum) break;
    }
    return sum;
  };
  const double i0b = bessel_i0(beta);
  for (int64_t i = 0; i < klen; ++i) {
    const double t = static_cast<double>(i - half);
    const double sinc =
        t == 0.0 ? 2 * cutoff : std::sin(2 * kPi * cutoff * t) / (kPi * t);
    const double r = t / half;
    const double win = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) / i0b;
    kernel[i] = sinc * win * up;
  }

  const int64_t n_in = static_cast<int64_t>(in.size());
  const int64_t n_out = (n_in * up + down - 1) / down;
  out->assign(n_out, 0.0f);
  for (int64_t m = 0; m < n_out; ++m) {
    // output m taps the zero-stuffed stream at position m*down; only input
    // samples (multiples of up) contribute
    const int64_t center = m * down;
    double acc = 0;
    // input index range covered by the kernel
    const int64_t lo = (center - half + up - 1) / up;
    const int64_t hi = (center + half) / up;
    for (int64_t i = std::max<int64_t>(lo, 0); i <= std::min(hi, n_in - 1); ++i) {
      const int64_t k = center - i * up + half;
      acc += static_cast<double>(in[i]) * kernel[k];
    }
    (*out)[m] = static_cast<float>(acc);
  }
}

}  // namespace

extern "C" {

// Decode a WAV byte buffer to mono float32 at target_sr.
// Returns the number of output samples, or -1 on failure.  Two-call
// protocol: pass out=nullptr to query the size, then fill.
int64_t aptpu_decode_wav(const uint8_t* data, int64_t size, int64_t target_sr,
                         float* out, int64_t out_capacity) try {
  if (target_sr <= 0 || target_sr > 768000) return -1;
  WavFormat fmt;
  const uint8_t* payload = nullptr;
  int64_t payload_size = 0;
  if (!parse_wav(data, size, &fmt, &payload, &payload_size)) return -1;
  std::vector<float> mono;
  if (!decode_payload(fmt, payload, payload_size, &mono)) return -1;
  std::vector<float> resampled;
  resample_poly(mono, fmt.sample_rate, target_sr, &resampled);
  const int64_t n = static_cast<int64_t>(resampled.size());
  if (out != nullptr) {
    if (out_capacity < n) return -1;
    std::memcpy(out, resampled.data(), n * sizeof(float));
  }
  return n;
} catch (...) {  // bad_alloc etc. must not cross the C ABI -> error return
  return -1;
}

// Header-only output-size query.  The two-call decode protocol previously
// paid the full decode+resample TWICE per file (the size call did all the
// work and discarded it); the output length is computable from the fmt
// and data chunk sizes alone.
int64_t aptpu_wav_out_size(const uint8_t* data, int64_t size,
                           int64_t target_sr) try {
  if (target_sr <= 0 || target_sr > 768000) return -1;
  WavFormat fmt;
  const uint8_t* payload = nullptr;
  int64_t payload_size = 0;
  if (!parse_wav(data, size, &fmt, &payload, &payload_size)) return -1;
  int64_t bytes_per = 0;
  if (fmt.audio_format == 1) {
    if (fmt.bits == 8 || fmt.bits == 16 || fmt.bits == 24 || fmt.bits == 32)
      bytes_per = fmt.bits / 8;
  } else if (fmt.audio_format == 3) {
    if (fmt.bits == 32 || fmt.bits == 64) bytes_per = fmt.bits / 8;
  }
  if (bytes_per == 0) return -1;
  const int64_t frames = payload_size / (bytes_per * fmt.channels);
  // must mirror resample_poly's length rule exactly
  if (fmt.sample_rate == target_sr || frames == 0) return frames;
  const int64_t g = gcd64(fmt.sample_rate, target_sr);
  const int64_t up = target_sr / g, down = fmt.sample_rate / g;
  return (frames * up + down - 1) / down;
} catch (...) {
  return -1;
}

// Query the source sample rate/channels of a WAV buffer (for diagnostics).
int aptpu_wav_info(const uint8_t* data, int64_t size, int64_t* sample_rate,
                   int* channels, int* bits) try {
  WavFormat fmt;
  const uint8_t* payload = nullptr;
  int64_t payload_size = 0;
  if (!parse_wav(data, size, &fmt, &payload, &payload_size)) return -1;
  *sample_rate = fmt.sample_rate;
  *channels = fmt.channels;
  *bits = fmt.bits;
  return 0;
} catch (...) {
  return -1;
}

// Standalone resampler for raw float32 mono buffers.
int64_t aptpu_resample(const float* in, int64_t n_in, int64_t sr_in,
                       int64_t sr_out, float* out, int64_t out_capacity) try {
  if (n_in < 0 || sr_in <= 0 || sr_out <= 0 || sr_in > 768000 ||
      sr_out > 768000) {
    return -1;
  }
  std::vector<float> input(in, in + n_in);
  std::vector<float> output;
  resample_poly(input, sr_in, sr_out, &output);
  const int64_t n = static_cast<int64_t>(output.size());
  if (out != nullptr) {
    if (out_capacity < n) return -1;
    std::memcpy(out, output.data(), n * sizeof(float));
  }
  return n;
} catch (...) {
  return -1;
}

// DTW backtrace for word-timestamp alignment: cost (t x ta) row-major,
// out (t) receives the audio column where each text row starts.
// Steps: diagonal / down (next row, same col) / right (same row, next col) —
// the same recurrence as models/whisper/align.dtw_path's python DP, which
// runs ~1 s per row on the host; this is ~1 ms.
//
// Decision rule and accumulator dtype replicate openai-whisper's dtw_cpu
// (whisper/timing.py) BIT-EXACTLY: float32 accumulation, diagonal/down only
// when STRICTLY smaller than both alternatives, otherwise right — on ties
// openai falls through to the right-step branch, and the word-timestamp
// parity gate (tests/test_parity_align.py) pins that exact path shape.
int aptpu_dtw(const float* cost, int64_t t, int64_t ta, int64_t* out) try {
  if (t <= 0 || ta <= 0) return -1;
  const float INF = std::numeric_limits<float>::infinity();
  std::vector<float> prev(ta + 1, INF), cur(ta + 1, INF);
  std::vector<int8_t> trace((t + 1) * (ta + 1), 0);
  prev[0] = 0.0f;
  for (int64_t i = 1; i <= t; ++i) {
    cur[0] = INF;
    const float* row = cost + (i - 1) * ta;
    for (int64_t j = 1; j <= ta; ++j) {
      const float c0 = prev[j - 1];  // diagonal
      const float c1 = prev[j];      // down
      const float c2 = cur[j - 1];   // right
      float best;
      int8_t tr;
      if (c0 < c1 && c0 < c2) { best = c0; tr = 0; }
      else if (c1 < c0 && c1 < c2) { best = c1; tr = 1; }
      else { best = c2; tr = 2; }
      cur[j] = row[j - 1] + best;
      trace[i * (ta + 1) + j] = tr;
    }
    std::swap(prev, cur);
  }
  int64_t i = t, j = ta;
  while (i > 0 && j > 0) {
    out[i - 1] = j - 1;
    const int8_t tr = trace[i * (ta + 1) + j];
    if (tr == 0) { --i; --j; }
    else if (tr == 1) { --i; }
    else { --j; }
  }
  return 0;
} catch (...) {
  return -1;
}

}  // extern "C"
