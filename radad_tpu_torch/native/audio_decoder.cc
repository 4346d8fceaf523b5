// Native audio decode runtime for the data loader of radad_tpu_torch.
//
// A copy of radad_tpu/native/audio_decoder.cc (the port imports and loads
// nothing of radad_tpu). It replaces librosa/audioread (Python) for every
// clip load (the reference's dataset.py:139-153): RIFF/WAVE parsing (PCM
// 8/16/24/32 and IEEE float32/64), mono mixdown, and windowed-sinc
// polyphase resampling, exposed through a C ABI consumed via ctypes
// (radad_tpu_torch/native/__init__.py). Calls release the GIL, so the
// Python thread-pool loader gets true parallel decode.
//
// Build: radad_tpu_torch/native/__init__.py runs the host g++ at first use
// (-O3 -fPIC -shared -std=c++17) into radad_tpu_torch/build/. No
// third-party deps.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct WavData {
  std::vector<float> samples;  // mono, [-1, 1]
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Parse a RIFF/WAVE file into mono float32. Returns false on any error.
bool parse_wav(const char* path, WavData* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 44 || size > (long)1 << 31) {
    fclose(f);
    return false;
  }
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return false;
  }
  fclose(f);

  const uint8_t* p = buf.data();
  if (memcmp(p, "RIFF", 4) != 0 || memcmp(p + 8, "WAVE", 4) != 0)
    return false;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t off = 12;
  while (off + 8 <= (size_t)size) {
    const uint8_t* chunk = p + off;
    uint32_t clen = rd_u32(chunk + 4);
    if (memcmp(chunk, "fmt ", 4) == 0 && clen >= 16 &&
        off + 8 + clen <= (size_t)size) {
      fmt = rd_u16(chunk + 8);
      channels = rd_u16(chunk + 10);
      rate = rd_u32(chunk + 12);
      bits = rd_u16(chunk + 22);
      if (fmt == 0xFFFE && clen >= 40)  // WAVE_FORMAT_EXTENSIBLE
        fmt = rd_u16(chunk + 32);
    } else if (memcmp(chunk, "data", 4) == 0) {
      data = chunk + 8;
      data_len = std::min<uint32_t>(clen, (uint32_t)(size - off - 8));
    }
    off += 8 + clen + (clen & 1);  // chunks are word-aligned
  }
  if (!data || !rate || !channels || !bits) return false;

  size_t bytes_per = bits / 8;
  size_t frames = data_len / (bytes_per * channels);
  out->samples.resize(frames);
  out->sample_rate = (int)rate;

  // Fast vectorizable paths for the overwhelmingly common formats.
  if (fmt == 1 && bits == 16 && channels == 1) {
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    float* dst = out->samples.data();
    constexpr float kScale = 1.0f / 32768.0f;
    for (size_t i = 0; i < frames; i++) dst[i] = s[i] * kScale;
    return true;
  }
  if (fmt == 1 && bits == 16 && channels == 2) {
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    float* dst = out->samples.data();
    constexpr float kScale = 0.5f / 32768.0f;
    for (size_t i = 0; i < frames; i++)
      dst[i] = ((float)s[2 * i] + (float)s[2 * i + 1]) * kScale;
    return true;
  }
  if (fmt == 3 && bits == 32 && channels == 1) {
    memcpy(out->samples.data(), data, frames * sizeof(float));
    return true;
  }

  const double inv_ch = 1.0 / channels;
  for (size_t i = 0; i < frames; i++) {
    double acc = 0.0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* s = data + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt == 1) {  // PCM
        switch (bits) {
          case 8:
            v = ((double)s[0] - 128.0) / 128.0;
            break;
          case 16:
            v = (double)(int16_t)rd_u16(s) / 32768.0;
            break;
          case 24: {
            int32_t x = (int32_t)s[0] | ((int32_t)s[1] << 8) |
                        ((int32_t)s[2] << 16);
            if (x >= (1 << 23)) x -= (1 << 24);
            v = (double)x / 8388608.0;
            break;
          }
          case 32:
            v = (double)(int32_t)rd_u32(s) / 2147483648.0;
            break;
          default:
            return false;
        }
      } else if (fmt == 3) {  // IEEE float
        if (bits == 32) {
          float fv;
          memcpy(&fv, s, 4);
          v = fv;
        } else if (bits == 64) {
          double dv;
          memcpy(&dv, s, 8);
          v = dv;
        } else {
          return false;
        }
      } else {
        return false;
      }
      acc += v;
    }
    out->samples[i] = (float)(acc * inv_ch);
  }
  return true;
}

// Windowed-sinc polyphase resampler (Hann window, 2*HALF taps per output).
void resample(const std::vector<float>& in, int sr_in, int sr_out,
              std::vector<float>* out) {
  if (sr_in == sr_out || in.empty()) {
    *out = in;
    return;
  }
  const double ratio = (double)sr_out / sr_in;
  const size_t n_out = (size_t)std::ceil(in.size() * ratio);
  out->resize(n_out);
  // Low-pass at min(sr_in, sr_out)/2; widen the kernel when downsampling.
  const double cutoff = std::min(1.0, ratio) * 0.97;
  const int HALF = 16;
  const double taps_scale = std::min(1.0, ratio);
  for (size_t j = 0; j < n_out; j++) {
    const double center = j / ratio;
    const long i0 = (long)std::floor(center) - (long)(HALF / taps_scale);
    const long i1 = (long)std::floor(center) + (long)(HALF / taps_scale) + 1;
    double acc = 0.0, wsum = 0.0;
    for (long i = std::max<long>(0, i0);
         i < std::min<long>((long)in.size(), i1); i++) {
      const double x = (i - center) * taps_scale;
      double sinc = (std::abs(x) < 1e-9)
                        ? 1.0
                        : std::sin(M_PI * cutoff * x) / (M_PI * cutoff * x);
      const double t = x / (HALF + 1.0);
      const double win = 0.5 * (1.0 + std::cos(M_PI * std::min(1.0, std::abs(t))));
      const double w = sinc * win * cutoff;
      acc += in[i] * w;
      wsum += w;
    }
    (void)wsum;
    (*out)[j] = (float)acc;
  }
}

}  // namespace

extern "C" {

// Decode + (optionally) resample + truncate/zero-pad to target_len samples
// at target_sr. Returns 0 on success, negative on failure (caller falls
// back to the Python decoder).
int radad_decode_fixed(const char* path, float* out, long target_len,
                       int target_sr) {
  WavData wav;
  if (!parse_wav(path, &wav)) return -1;
  std::vector<float> res;
  resample(wav.samples, wav.sample_rate, target_sr, &res);
  const long n = std::min<long>((long)res.size(), target_len);
  memcpy(out, res.data(), (size_t)n * sizeof(float));
  if (n < target_len)
    memset(out + n, 0, (size_t)(target_len - n) * sizeof(float));
  return 0;
}

// Full decode at native rate. Writes up to `capacity` samples into `out`,
// stores the sample rate in *sr, returns the total decoded length (which
// may exceed capacity — caller can retry with a larger buffer) or negative
// on failure.
long radad_decode_full(const char* path, float* out, long capacity,
                       int* sr) {
  WavData wav;
  if (!parse_wav(path, &wav)) return -1;
  *sr = wav.sample_rate;
  const long n = std::min<long>((long)wav.samples.size(), capacity);
  if (out && n > 0) memcpy(out, wav.samples.data(), (size_t)n * sizeof(float));
  return (long)wav.samples.size();
}

// Probe duration in seconds without decoding samples (catalog listings).
double radad_wav_duration(const char* path) {
  WavData wav;
  if (!parse_wav(path, &wav)) return -1.0;
  return wav.sample_rate > 0
             ? (double)wav.samples.size() / wav.sample_rate
             : -1.0;
}

}  // extern "C"
