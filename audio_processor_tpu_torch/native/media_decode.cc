// In-process compressed-audio decode (m4a/aac/mp3/ogg/flac/...) + m4a
// encode, linking the system codec libraries directly.
//
// The reference fork/execs an `ffmpeg` BINARY per job and round-trips
// through temp WAV files (reference: app/services/audio_processor.py:
// 912-923); serving images often ship the libraries but not the CLI, and
// the subprocess costs fork/exec + pipe copies per job.  This module does
// the same work in-process: demux (libavformat) -> decode (libavcodec) ->
// resample/downmix to mono float at the target rate (libswresample), all
// behind the C ABI consumed by native/media.py.  The
// encoder entry point exists so tests can fabricate REAL .m4a fixtures
// hermetically (golden round-trip vs the WAV twin of the same signal).
//
// Wire format of the decode result: caller-owned malloc'd float32 buffer
// returned via out-pointer; free with aptpu_media_free (one decode pass,
// unlike the query-then-fill protocol in audio_io.cc, because compressed
// decode is too expensive to run twice).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Keep libav's chatty INFO lines (encoder Qavg etc.) off the server's
// stderr; real failures surface through our -1 returns.
struct LogQuieter {
  LogQuieter() { av_log_set_level(AV_LOG_ERROR); }
} quiet_logs;

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;

  ~DecodeCtx() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

bool open_input(DecodeCtx* c, const char* path, int64_t target_sr) {
  if (avformat_open_input(&c->fmt, path, nullptr, nullptr) < 0) return false;
  if (avformat_find_stream_info(c->fmt, nullptr) < 0) return false;
  const AVCodec* codec = nullptr;
  c->stream_index =
      av_find_best_stream(c->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (c->stream_index < 0 || codec == nullptr) return false;
  AVStream* st = c->fmt->streams[c->stream_index];
  c->dec = avcodec_alloc_context3(codec);
  if (!c->dec) return false;
  if (avcodec_parameters_to_context(c->dec, st->codecpar) < 0) return false;
  if (avcodec_open2(c->dec, codec, nullptr) < 0) return false;
  if (c->dec->sample_rate <= 0) return false;

  AVChannelLayout mono;
  av_channel_layout_default(&mono, 1);
  AVChannelLayout in_layout;
  if (c->dec->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &c->dec->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 1);
  }
  int rc = swr_alloc_set_opts2(&c->swr, &mono, AV_SAMPLE_FMT_FLT,
                               static_cast<int>(target_sr), &in_layout,
                               c->dec->sample_fmt, c->dec->sample_rate,
                               0, nullptr);
  av_channel_layout_uninit(&in_layout);
  if (rc < 0 || swr_init(c->swr) < 0) return false;
  c->pkt = av_packet_alloc();
  c->frame = av_frame_alloc();
  return c->pkt && c->frame;
}

// Drain every converted sample for one decoded frame (or flush when
// frame == nullptr) into out.
bool convert_frame(DecodeCtx* c, const AVFrame* frame, int64_t target_sr,
                   std::vector<float>* out) {
  const int in_count = frame ? frame->nb_samples : 0;
  // worst-case output count for this input burst
  const int64_t cap =
      swr_get_delay(c->swr, target_sr) + (frame ? (int64_t)in_count * target_sr / c->dec->sample_rate : 0) + 256;
  const size_t base = out->size();
  out->resize(base + cap);
  uint8_t* dst = reinterpret_cast<uint8_t*>(out->data() + base);
  const uint8_t** src =
      frame ? const_cast<const uint8_t**>(frame->extended_data) : nullptr;
  const int got = swr_convert(c->swr, &dst, static_cast<int>(cap), src, in_count);
  if (got < 0) return false;
  out->resize(base + got);
  return true;
}

// Shared decode loop.  max_samples == 0 decodes the full stream;
// max_samples > 0 stops demuxing as soon as that many output samples
// exist (a 30 s language-detect probe of a 3 h m4a decodes ~30 s, not
// the whole file) and truncates the result to exactly max_samples.
int64_t decode_media_impl(const char* path, int64_t target_sr,
                          int64_t max_samples, float** out) {
  if (!path || !out || target_sr <= 0 || target_sr > 768000) return -1;
  if (max_samples < 0) return -1;
  *out = nullptr;
  DecodeCtx c;
  if (!open_input(&c, path, target_sr)) return -1;

  std::vector<float> samples;
  samples.reserve(1 << 20);
  bool capped = false;
  for (;;) {
    if (max_samples > 0 &&
        static_cast<int64_t>(samples.size()) >= max_samples) {
      capped = true;
      break;
    }
    const int rd = av_read_frame(c.fmt, c.pkt);
    if (rd == AVERROR_EOF) break;
    // a mid-file demux error is NOT end-of-stream: returning the partial
    // decode as success would silently truncate the transcript of a
    // corrupt/partially-downloaded file
    if (rd < 0) return -1;
    if (c.pkt->stream_index == c.stream_index) {
      const int sent = avcodec_send_packet(c.dec, c.pkt);
      if (sent < 0 && sent != AVERROR(EAGAIN)) {
        av_packet_unref(c.pkt);
        return -1;
      }
      for (;;) {
        const int rc = avcodec_receive_frame(c.dec, c.frame);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) break;
        if (rc < 0) {
          av_packet_unref(c.pkt);
          return -1;
        }
        if (!convert_frame(&c, c.frame, target_sr, &samples)) {
          av_packet_unref(c.pkt);
          return -1;
        }
      }
    }
    av_packet_unref(c.pkt);
  }
  if (!capped) {
    // flush decoder, then the resampler's tail
    avcodec_send_packet(c.dec, nullptr);
    while (avcodec_receive_frame(c.dec, c.frame) == 0) {
      if (!convert_frame(&c, c.frame, target_sr, &samples)) return -1;
    }
    if (!convert_frame(&c, nullptr, target_sr, &samples)) return -1;
  }

  int64_t n = static_cast<int64_t>(samples.size());
  if (max_samples > 0 && n > max_samples) n = max_samples;
  if (n == 0) return -1;
  float* buf = static_cast<float*>(std::malloc(n * sizeof(float)));
  if (!buf) return -1;
  std::memcpy(buf, samples.data(), n * sizeof(float));
  *out = buf;
  return n;
}

}  // namespace

extern "C" {

// Decode any container/codec to mono float32 at target_sr.
// On success returns sample count and stores a malloc'd buffer in *out
// (free with aptpu_media_free); on failure returns -1.
int64_t aptpu_decode_media(const char* path, int64_t target_sr,
                           float** out) try {
  return decode_media_impl(path, target_sr, 0, out);
} catch (...) {
  return -1;
}

// Decode at most max_samples output samples (0 = unlimited) — the
// bounded-probe form used by detect_language(path).
int64_t aptpu_decode_media_prefix(const char* path, int64_t target_sr,
                                  int64_t max_samples, float** out) try {
  return decode_media_impl(path, target_sr, max_samples, out);
} catch (...) {
  return -1;
}

void aptpu_media_free(float* buf) { std::free(buf); }

// Source stream metadata: sample rate, channels, duration (ms), codec name
// (written into name_buf, NUL-terminated).  Returns 0 / -1.
int aptpu_media_info(const char* path, int64_t* sample_rate, int* channels,
                     int64_t* duration_ms, char* name_buf,
                     int64_t name_cap) try {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  const AVCodec* codec = nullptr;
  int idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (idx < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  const AVCodecParameters* par = fmt->streams[idx]->codecpar;
  if (sample_rate) *sample_rate = par->sample_rate;
  if (channels) *channels = par->ch_layout.nb_channels;
  if (duration_ms) {
    *duration_ms = fmt->duration > 0 ? fmt->duration / (AV_TIME_BASE / 1000) : -1;
  }
  if (name_buf && name_cap > 0) {
    const char* nm = codec ? codec->name : "unknown";
    std::snprintf(name_buf, static_cast<size_t>(name_cap), "%s", nm);
  }
  avformat_close_input(&fmt);
  return 0;
} catch (...) {
  return -1;
}

// Encode mono float32 PCM to an AAC-LC .m4a file (test-fixture generator
// and a convert-back path).  Returns 0 / -1.
int aptpu_encode_m4a(const float* samples, int64_t n, int64_t sr,
                     const char* path, int64_t bit_rate) try {
  if (!samples || n <= 0 || sr <= 0 || !path) return -1;
  AVFormatContext* oc = nullptr;
  if (avformat_alloc_output_context2(&oc, nullptr, nullptr, path) < 0 || !oc) {
    return -1;
  }
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  AVCodecContext* enc = codec ? avcodec_alloc_context3(codec) : nullptr;
  AVStream* st = enc ? avformat_new_stream(oc, nullptr) : nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int ret = -1;

  do {
    if (!st) break;
    enc->sample_fmt = AV_SAMPLE_FMT_FLTP;
    enc->sample_rate = static_cast<int>(sr);
    av_channel_layout_default(&enc->ch_layout, 1);
    enc->bit_rate = bit_rate > 0 ? bit_rate : 96000;
    enc->time_base = {1, enc->sample_rate};
    if (oc->oformat->flags & AVFMT_GLOBALHEADER) {
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    }
    if (avcodec_open2(enc, codec, nullptr) < 0) break;
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;
    if (!(oc->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0) {
      break;
    }
    if (avformat_write_header(oc, nullptr) < 0) break;

    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    if (!frame || !pkt) break;
    const int fsz = enc->frame_size > 0 ? enc->frame_size : 1024;
    frame->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_default(&frame->ch_layout, 1);
    frame->sample_rate = enc->sample_rate;
    frame->nb_samples = fsz;
    if (av_frame_get_buffer(frame, 0) < 0) break;

    bool fail = false;
    auto drain = [&](bool) {
      while (avcodec_receive_packet(enc, pkt) == 0) {
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(oc, pkt) < 0) fail = true;
      }
    };
    int64_t pts = 0;
    for (int64_t off = 0; off < n && !fail; off += fsz) {
      const int64_t take = std::min<int64_t>(fsz, n - off);
      if (av_frame_make_writable(frame) < 0) { fail = true; break; }
      float* dst = reinterpret_cast<float*>(frame->data[0]);
      std::memcpy(dst, samples + off, take * sizeof(float));
      if (take < fsz) std::memset(dst + take, 0, (fsz - take) * sizeof(float));
      frame->pts = pts;
      pts += fsz;
      if (avcodec_send_frame(enc, frame) < 0) { fail = true; break; }
      drain(false);
    }
    if (!fail) {
      avcodec_send_frame(enc, nullptr);  // flush
      drain(true);
      if (av_write_trailer(oc) < 0) fail = true;
    }
    ret = fail ? -1 : 0;
  } while (false);

  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (enc) avcodec_free_context(&enc);
  if (oc) {
    if (!(oc->oformat->flags & AVFMT_NOFILE) && oc->pb) avio_closep(&oc->pb);
    avformat_free_context(oc);
  }
  return ret;
} catch (...) {
  return -1;
}

}  // extern "C"
