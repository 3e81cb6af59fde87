// Native audio runtime for the data pipeline and serving I/O hot paths (the
// PyTorch port's own copy of native/audio_io.cc; same entry points, same
// arithmetic).
//
// Replaces the Python/scipy host-side audio path (wav decode -> mono mix ->
// amplitude trim -> resample) that the reference runs per utterance inside
// DataLoader workers (prompt_dataset.py:33-46; data recipes resample with
// librosa). Exposed through a plain C ABI consumed via ctypes
// (emotivoice_tpu_torch/utils/native.py, which builds it with g++ at first
// use); every entry point has a pure-Python fallback for hosts without a
// compiler.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct WavInfo {
  int sample_rate = 0;
  int channels = 0;
  int bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = 0;
  long data_bytes = 0;
};

bool parse_wav_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&sz, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;
  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt, ch;
      uint32_t sr, byte_rate;
      uint16_t block, bits;
      if (sz < 16) return false;
      if (fread(&fmt, 2, 1, f) != 1 || fread(&ch, 2, 1, f) != 1 ||
          fread(&sr, 4, 1, f) != 1 || fread(&byte_rate, 4, 1, f) != 1 ||
          fread(&block, 2, 1, f) != 1 || fread(&bits, 2, 1, f) != 1)
        return false;
      info->format = fmt == 0xFFFE ? 1 : fmt;  // extensible: assume PCM
      info->channels = ch;
      info->sample_rate = (int)sr;
      info->bits = bits;
      if (sz > 16) fseek(f, sz - 16, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = sz;
      return info->sample_rate > 0 && info->channels > 0;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);  // chunks are word-aligned
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Probe a wav file: sample rate, mono sample count, channels. 0 on success.
int ev_wav_info(const char* path, int* sr, long* n_samples, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_wav_header(f, &info);
  fclose(f);
  if (!ok || info.bits == 0) return -2;
  *sr = info.sample_rate;
  *channels = info.channels;
  *n_samples = info.data_bytes / (info.bits / 8) / info.channels;
  return 0;
}

// Read + mono-mix into caller-allocated float32 [-1, 1] buffer.
int ev_wav_read(const char* path, float* out, long n_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_wav_header(f, &info)) {
    fclose(f);
    return -2;
  }
  fseek(f, info.data_offset, SEEK_SET);
  const int ch = info.channels;
  const long frames = n_samples;
  std::vector<uint8_t> raw(info.bits / 8 * ch);
  int rc = 0;
  for (long i = 0; i < frames; ++i) {
    if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
      rc = -3;
      break;
    }
    double acc = 0.0;
    for (int c = 0; c < ch; ++c) {
      const uint8_t* p = raw.data() + c * (info.bits / 8);
      double v = 0.0;
      if (info.format == 3 && info.bits == 32) {
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else if (info.bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s / 32768.0;
      } else if (info.bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (info.bits == 24) {
        int32_t s = (p[0] << 8) | (p[1] << 16) | ((int32_t)(int8_t)p[2] << 24);
        v = (s >> 8) / 8388608.0;
      } else if (info.bits == 8) {
        v = (p[0] - 128) / 128.0;
      }
      acc += v;
    }
    out[i] = (float)(acc / ch);
  }
  fclose(f);
  return rc;
}

// Write float32 [-1, 1] as 16-bit PCM (x32768 clip, matching the reference
// inference_am_vocoder_joint.py:130-134). 0 on success.
int ev_wav_write(const char* path, const float* data, long n, int sr) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_bytes = (uint32_t)(n * 2);
  uint32_t riff = 36 + data_bytes;
  uint16_t fmt = 1, ch = 1, block = 2, bits = 16;
  uint32_t byte_rate = (uint32_t)sr * 2;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff, 4, 1, f);
  fwrite("WAVEfmt ", 1, 8, f);
  uint32_t fmt_sz = 16;
  fwrite(&fmt_sz, 4, 1, f);
  fwrite(&fmt, 2, 1, f);
  fwrite(&ch, 2, 1, f);
  fwrite(&sr, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);
  std::vector<int16_t> buf(4096);
  long i = 0;
  while (i < n) {
    long m = std::min((long)buf.size(), n - i);
    for (long j = 0; j < m; ++j) {
      double v = data[i + j] * 32768.0;
      if (v > 32767.0) v = 32767.0;
      if (v < -32768.0) v = -32768.0;
      // truncate toward zero, matching numpy .astype(int16) in the
      // reference (inference_am_vocoder_joint.py:130-134)
      buf[j] = (int16_t)v;
    }
    fwrite(buf.data(), 2, m, f);
    i += m;
  }
  fclose(f);
  return 0;
}

// Amplitude trim at threshold x peak, keeping pad_ms on each side
// (reference prompt_dataset.py:39-46). Writes [start, end) back.
void ev_trim_silence(const float* in, long n, int sr, float threshold,
                     float pad_ms, long* start, long* end) {
  float peak = 0.f;
  for (long i = 0; i < n; ++i) {
    float a = fabsf(in[i]);
    if (a > peak) peak = a;
  }
  *start = 0;
  *end = n;
  if (peak <= 0.f) return;
  const float th = threshold * peak;
  long first = -1, last = -1;
  for (long i = 0; i < n; ++i) {
    if (fabsf(in[i]) > th) {
      first = i;
      break;
    }
  }
  if (first < 0) return;
  for (long i = n - 1; i >= 0; --i) {
    if (fabsf(in[i]) > th) {
      last = i;
      break;
    }
  }
  const long pad = (long)(sr * pad_ms / 1000.0f);
  *start = first - pad > 0 ? first - pad : 0;
  *end = last + pad < n ? last + pad : n;
}

long ev_resample_len(long n_in, int sr_in, int sr_out) {
  return (long)((double)n_in * sr_out / sr_in);
}

// Windowed-sinc fractional resampler (Blackman window, 64 taps around each
// output point; cutoff at 0.45 x the lower Nyquist). Quality comparable to
// scipy resample_poly for speech.
int ev_resample(const float* in, long n_in, int sr_in, int sr_out, float* out,
                long n_out) {
  if (sr_in == sr_out) {
    long m = std::min(n_in, n_out);
    memcpy(out, in, m * sizeof(float));
    for (long i = m; i < n_out; ++i) out[i] = 0.f;
    return 0;
  }
  const double ratio = (double)sr_in / sr_out;       // input samples per output
  const double cutoff = 0.45 * std::min(1.0, 1.0 / ratio);  // x input Nyquist
  const int half = 32;
  const double scale = 2.0 * cutoff;
  for (long j = 0; j < n_out; ++j) {
    const double t = j * ratio;
    const long center = (long)floor(t);
    double acc = 0.0, wsum = 0.0;
    for (int k = -half + 1; k <= half; ++k) {
      const long i = center + k;
      if (i < 0 || i >= n_in) continue;
      const double x = t - (double)i;  // in [-half, half]
      const double sinc_arg = kPi * scale * x;
      const double sinc = sinc_arg == 0.0 ? 1.0 : sin(sinc_arg) / sinc_arg;
      const double u = 0.5 + x / (2.0 * half);  // window position [0, 1]
      const double win =
          0.42 - 0.5 * cos(2.0 * kPi * u) + 0.08 * cos(4.0 * kPi * u);
      const double w = scale * sinc * win;
      acc += in[i] * w;
      wsum += w;
    }
    // normalize by the truncated-window weight sum for exact unity DC gain
    out[j] = (float)(wsum > 1e-9 ? acc / wsum : 0.0);
  }
  return 0;
}

}  // extern "C"
