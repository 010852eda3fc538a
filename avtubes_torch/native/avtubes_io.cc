// avtubes_torch native IO core: threaded WAV decode/preparation + JPEG decode.
//
// The port's own copy of the JAX package's host IO core (same entry points,
// same arithmetic, built with the same flags, so both libraries give
// bit-equal outputs on the same files).  The reference's input pipeline
// leans on native libraries behind Python (libsndfile via soundfile, libjpeg
// via PIL, ffmpeg via cv2) driven by torch DataLoader worker *processes*.
// Here the equivalent hot loop is a C++ thread pool exposed via ctypes:
// batch WAV read + fixed-length preparation (downmix/tile/clip/truncate,
// matching avtubes_torch.data.audio.prepare_waveform) writes straight into
// the caller's batch buffer, and JPEG frames decode straight to RGB without
// PIL object overhead.  No Python objects are touched off-thread, so the
// pool scales past the GIL.
//
// Built at first use by avtubes_torch/native/__init__.py
// (make -C avtubes_torch/native OUT=...: g++ -O3 -shared -fPIC -pthread -ljpeg)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

namespace {

struct WavData {
  std::vector<float> samples;  // downmixed mono
  int samplerate = 0;
};

// Shortest-side resize target dims from ORIGINAL geometry.  Rounding MUST
// be half-to-even (std::nearbyint under the default FP rounding mode) to
// match Python round() in host_resize_shortest and the ctypes wrapper's
// buffer allocation (`shortest_side_dims`) — lround (half away from zero)
// disagrees at exact .5 ties, which would overflow the caller's buffer by
// one row/column.  THE one copy on the C++ side; keep in lockstep with the
// one Python copy.
inline void shortest_dims(int oh, int ow, int target, int* rh, int* rw) {
  if (ow < oh) {
    *rw = target;
    *rh = std::max(1, static_cast<int>(std::nearbyint(
        static_cast<double>(oh) * target / ow)));
  } else {
    *rh = target;
    *rw = std::max(1, static_cast<int>(std::nearbyint(
        static_cast<double>(ow) * target / oh)));
  }
}

bool read_wav_file(const char* path, WavData* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return false;
  }
  // chunk sizes are UNTRUSTED 32-bit fields from the file: cap them by the
  // actual file size so a corrupt header can neither over-read a short
  // body nor drive a multi-GB allocation (bad_alloc from a std::thread
  // worker would std::terminate the whole process)
  fseek(f, 0, SEEK_END);
  const long file_size = ftell(f);
  fseek(f, 12, SEEK_SET);
  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t samplerate = 0;
  std::vector<uint8_t> data;
  uint8_t chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    // clamp (don't reject) a size field that overruns the file: streamed
    // writers (ffmpeg to a pipe) leave placeholder/overstated sizes, and
    // the short-read tolerance below uses whatever bytes are really there
    const long remaining = file_size - ftell(f);
    if (static_cast<long>(size) > remaining)
      size = remaining > 0 ? static_cast<uint32_t>(remaining) : 0;
    if (!memcmp(chunk, "fmt ", 4)) {
      if (size < 16) break;  // truncated fmt: fields below read 16 bytes
      std::vector<uint8_t> body(size);
      if (fread(body.data(), 1, size, f) != size) break;
      memcpy(&audio_format, body.data(), 2);
      memcpy(&channels, body.data() + 2, 2);
      memcpy(&samplerate, body.data() + 4, 4);
      memcpy(&bits, body.data() + 14, 2);
      if (audio_format == 0xFFFE && size >= 40)
        memcpy(&audio_format, body.data() + 24, 2);
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (!memcmp(chunk, "data", 4)) {
      data.resize(size);
      size_t got = fread(data.data(), 1, size, f);
      data.resize(got);
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  // samplerate is an untrusted uint32: a huge claim casts negative through
  // static_cast<int> below, and a negative rate makes prepare_into's fill
  // negative -> memset before the output buffer (fuzzer-found segfault).
  // 1 MHz is far beyond any audio source; reject instead of trusting.
  if (!samplerate || samplerate > 1'000'000u || !channels || data.empty())
    return false;

  size_t n_frames;
  std::vector<float> mono;
  const double inv_ch = 1.0 / channels;
  if (audio_format == 1 && bits == 16 && channels == 1) {
    // the common case: mono PCM16 — a straight vectorizable scale loop
    const int16_t* p = reinterpret_cast<const int16_t*>(data.data());
    n_frames = data.size() / 2;
    mono.resize(n_frames);
    constexpr float kInv = 1.0f / 32768.0f;
    for (size_t i = 0; i < n_frames; ++i) mono[i] = p[i] * kInv;
  } else if (audio_format == 1 && bits == 16) {
    const int16_t* p = reinterpret_cast<const int16_t*>(data.data());
    n_frames = data.size() / 2 / channels;
    mono.resize(n_frames);
    for (size_t i = 0; i < n_frames; ++i) {
      double acc = 0;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c] / 32768.0;
      mono[i] = static_cast<float>(acc * inv_ch);
    }
  } else if (audio_format == 1 && bits == 32) {
    const int32_t* p = reinterpret_cast<const int32_t*>(data.data());
    n_frames = data.size() / 4 / channels;
    mono.resize(n_frames);
    for (size_t i = 0; i < n_frames; ++i) {
      double acc = 0;
      for (int c = 0; c < channels; ++c)
        acc += p[i * channels + c] / 2147483648.0;
      mono[i] = static_cast<float>(acc * inv_ch);
    }
  } else if (audio_format == 3 && bits == 32) {
    const float* p = reinterpret_cast<const float*>(data.data());
    n_frames = data.size() / 4 / channels;
    mono.resize(n_frames);
    for (size_t i = 0; i < n_frames; ++i) {
      double acc = 0;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c];
      mono[i] = static_cast<float>(acc * inv_ch);
    }
  } else {
    return false;  // 8/24-bit stays on the numpy fallback path
  }
  out->samples = std::move(mono);
  out->samplerate = static_cast<int>(samplerate);
  return true;
}

// prepare_waveform semantics (avtubes_torch/data/audio.py): tile short audio,
// clip to [-1, 1], truncate to samplerate * seconds... but the *output*
// buffer is fixed at out_len samples (the caller sizes it for the dataset's
// nominal samplerate); shorter prepared signals zero-pad the tail.
void prepare_into(const WavData& wav, int seconds, float* out, int64_t out_len) {
  const int64_t target = static_cast<int64_t>(wav.samplerate) * seconds;
  const int64_t n = static_cast<int64_t>(wav.samples.size());
  // clamp below as well: a negative target (hostile samplerate, negative
  // seconds) must zero-fill, never index before the buffer
  const int64_t fill = std::max<int64_t>(0, std::min(target, out_len));
  if (n == 0) {
    memset(out, 0, out_len * sizeof(float));
    return;
  }
  // tiling as block copies (a per-sample modulo defeats vectorization)
  const float* src = wav.samples.data();
  int64_t pos = 0;
  while (pos < fill) {
    const int64_t chunk = std::min(n, fill - pos);
    float* dst = out + pos;
    for (int64_t i = 0; i < chunk; ++i) {
      float v = src[i];
      dst[i] = v > 1.f ? 1.f : (v < -1.f ? -1.f : v);
    }
    pos += chunk;
  }
  if (fill < out_len) memset(out + fill, 0, (out_len - fill) * sizeof(float));
}

// ------------------------------------------------------------- STFT
// Host log-spectrogram for the 'spec_int16' audio transport
// (avtubes_torch/data/spectrogram.py semantics: periodic tukey(0.25) window,
// per-frame constant detrend, hop = nperseg - noverlap, PSD density
// scaling with one-sided doubling, log(power + 1e-7)/12, int16 fixed
// point at scale 16000).  Real FFT via complex radix-2 of nperseg/2 +
// untangling; ~2x the throughput of the numpy f32 path per core and runs
// on the decode thread pool without the GIL.

struct Cpx {
  float re, im;
};

// iterative radix-2 complex FFT, n a power of two; tw = n/2 twiddles
void fft_inplace(Cpx* a, int n, const Cpx* tw) {
  for (int i = 1, j = 0; i < n; ++i) {  // bit-reversal permutation
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (int len = 2; len <= n; len <<= 1) {
    const int step = n / len;
    for (int i = 0; i < n; i += len) {
      for (int k = 0; k < len / 2; ++k) {
        const Cpx w = tw[k * step];
        Cpx& u = a[i + k];
        Cpx& v = a[i + k + len / 2];
        const float vr = v.re * w.re - v.im * w.im;
        const float vi = v.re * w.im + v.im * w.re;
        v.re = u.re - vr;
        v.im = u.im - vi;
        u.re += vr;
        u.im += vi;
      }
    }
  }
}

struct SpecPlan {
  int nperseg = 0, num_freqs = 0;
  std::vector<float> window;      // periodic tukey(0.25)
  std::vector<Cpx> tw;            // FFT twiddles (n/2 of size nperseg/2 FFT)
  std::vector<Cpx> untw;          // untangle twiddles e^{-i pi k / (n/2)}
  std::vector<float> scale;       // per-bin one-sided PSD scale
};

bool make_spec_plan(SpecPlan* p, int nperseg, int samplerate) {
  if (nperseg < 4 || (nperseg & (nperseg - 1))) return false;  // pow2 only
  const int half = nperseg / 2;
  p->nperseg = nperseg;
  p->num_freqs = half + 1;
  // periodic tukey(0.25): symmetric window of nperseg+1 points minus last
  p->window.resize(nperseg);
  {
    const int npts = nperseg + 1;
    const double alpha = 0.25;
    const double edge = alpha * (npts - 1) / 2.0;
    for (int i = 0; i < nperseg; ++i) {
      double w = 1.0;
      if (i < edge)
        w = 0.5 * (1.0 + std::cos(M_PI * (i / edge - 1.0)));
      else if (i > (npts - 1) - edge)
        w = 0.5 * (1.0 + std::cos(M_PI * ((i - (npts - 1) + edge) / edge)));
      p->window[i] = static_cast<float>(w);
    }
  }
  p->tw.resize(half / 2);
  for (int k = 0; k < half / 2; ++k) {
    const double ang = -2.0 * M_PI * k / half;
    p->tw[k] = {static_cast<float>(std::cos(ang)),
                static_cast<float>(std::sin(ang))};
  }
  p->untw.resize(p->num_freqs);
  for (int k = 0; k <= half; ++k) {
    const double ang = -M_PI * k / half;
    p->untw[k] = {static_cast<float>(std::cos(ang)),
                  static_cast<float>(std::sin(ang))};
  }
  double wsum2 = 0.0;
  for (int i = 0; i < nperseg; ++i)
    wsum2 += static_cast<double>(p->window[i]) * p->window[i];
  const double base = 1.0 / (static_cast<double>(samplerate) * wsum2);
  p->scale.assign(p->num_freqs, static_cast<float>(2.0 * base));
  p->scale[0] = static_cast<float>(base);
  p->scale[half] = static_cast<float>(base);  // Nyquist not doubled
  return true;
}

constexpr float kSpecScaleI16 = 16000.0f;  // data/spectrogram.py SPEC_INT16_SCALE

// fast ln(x) for normal positive floats: exponent via bit extraction,
// mantissa via the atanh series 2s(1 + s^2/3 + s^4/5 + s^6/7 + s^8/9),
// s = (m-1)/(m+1), |s| <= 1/3.  Max error ~1e-6 natural-log units — three
// orders under the int16 quantization step of the transport (1.5e-3).
// libm logf was ~40% of STFT time at 110k calls/clip.
inline float fast_log(float x) {
  uint32_t bits;
  memcpy(&bits, &x, 4);
  const int e = static_cast<int>(bits >> 23) - 127;
  bits = (bits & 0x007fffffu) | 0x3f800000u;  // mantissa in [1, 2)
  float m;
  memcpy(&m, &bits, 4);
  const float s = (m - 1.0f) / (m + 1.0f);
  const float s2 = s * s;
  const float lnm =
      2.0f * s *
      (1.0f + s2 * (0.33333333f + s2 * (0.2f + s2 * (0.14285715f + s2 * 0.11111111f))));
  return lnm + 0.69314718f * e;
}

// one frame: window+detrend+real FFT+power+log+quantize, written as column t
// of the (num_freqs, num_frames) int16 output
void spec_frame(const SpecPlan& p, const float* frame, Cpx* work, int16_t* out,
                int t, int num_frames) {
  const int n = p.nperseg, half = n / 2;
  double mean = 0.0;
  for (int i = 0; i < n; ++i) mean += frame[i];
  const float m = static_cast<float>(mean / n);
  // pack windowed, detrended reals into half complex points
  for (int i = 0; i < half; ++i) {
    work[i].re = (frame[2 * i] - m) * p.window[2 * i];
    work[i].im = (frame[2 * i + 1] - m) * p.window[2 * i + 1];
  }
  fft_inplace(work, half, p.tw.data());
  // untangle to one-sided spectrum bins 0..half and emit power directly
  constexpr float kOut = kSpecScaleI16 / 12.0f;
  for (int k = 0; k <= half; ++k) {
    const Cpx zk = work[k == half ? 0 : k];
    const Cpx zc = work[(half - k) & (half - 1)];  // conj index, k=0 -> 0
    const float er = 0.5f * (zk.re + zc.re);
    const float ei = 0.5f * (zk.im - zc.im);
    const float or_ = 0.5f * (zk.im + zc.im);
    const float oi = 0.5f * (zc.re - zk.re);
    const Cpx w = p.untw[k];
    const float xr = er + w.re * or_ - w.im * oi;
    const float xi = ei + w.re * oi + w.im * or_;
    const float power = (xr * xr + xi * xi) * p.scale[k];
    const float q = std::nearbyintf(fast_log(power + 1e-7f) * kOut);
    const float c = q < -32768.f ? -32768.f : (q > 32767.f ? 32767.f : q);
    out[static_cast<size_t>(k) * num_frames + t] = static_cast<int16_t>(c);
  }
}

// full prepared waveform -> (num_freqs, num_frames) int16 spectrogram
bool log_spec_i16(const SpecPlan& p, const float* wav, int64_t n_samples,
                  int noverlap, int16_t* out) {
  const int hop = p.nperseg - noverlap;
  if (hop <= 0) return false;
  const int num_frames = static_cast<int>((n_samples - p.nperseg) / hop + 1);
  if (num_frames <= 0) return false;
  std::vector<Cpx> work(p.nperseg / 2);
  for (int t = 0; t < num_frames; ++t)
    spec_frame(p, wav + static_cast<int64_t>(t) * hop, work.data(), out, t,
               num_frames);
  return true;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// ---------------------------------------------------------------- resize
// PIL-compatible separable bicubic resampling (Pillow Resample.c algorithm:
// Keys kernel a=-0.5, filter support scaled by the downscale factor for
// antialiasing, per-output-pixel normalized weights).  Replaces the PIL
// resize in the hot decode path — PIL's resize costs more than the JPEG
// decode itself and holds the GIL; this runs on the decode thread pool.

double cubic_kernel(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  std::vector<int> bounds;      // per output pixel: (first tap, tap count)
  std::vector<float> weights;   // (out, kmax) normalized taps
  int kmax = 0;
};

ResampleCoeffs precompute_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  rc.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  rc.bounds.resize(static_cast<size_t>(out_size) * 2);
  rc.weights.assign(static_cast<size_t>(out_size) * rc.kmax, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    float* w = &rc.weights[static_cast<size_t>(xx) * rc.kmax];
    double sum = 0.0;
    for (int j = xmin; j < xmax; ++j)
      sum += cubic_kernel((j - center + 0.5) / filterscale);
    for (int j = xmin; j < xmax; ++j)
      w[j - xmin] = static_cast<float>(
          sum != 0.0 ? cubic_kernel((j - center + 0.5) / filterscale) / sum : 0.0);
    rc.bounds[xx * 2] = xmin;
    rc.bounds[xx * 2 + 1] = xmax - xmin;
  }
  return rc;
}

void resize_cubic_hwc(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
                      int out_h, int out_w) {
  if (in_h == out_h && in_w == out_w) {  // DCT-scaled decode hit exactly
    memcpy(dst, src, static_cast<size_t>(in_h) * in_w * 3);
    return;
  }
  const ResampleCoeffs rx = precompute_coeffs(in_w, out_w);
  const ResampleCoeffs ry = precompute_coeffs(in_h, out_h);
  // horizontal pass: (in_h, in_w, 3) u8 -> (in_h, out_w, 3) f32.
  // One u8->f32 row conversion up front so the tap loop is pure float FMAs.
  std::vector<float> srowf(static_cast<size_t>(in_w) * 3);
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * in_w * 3;
    for (int x = 0; x < in_w * 3; ++x) srowf[x] = srow[x];
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = rx.bounds[x * 2], cnt = rx.bounds[x * 2 + 1];
      const float* w = &rx.weights[static_cast<size_t>(x) * rx.kmax];
      float a0 = 0, a1 = 0, a2 = 0;
      const float* p = srowf.data() + static_cast<size_t>(xmin) * 3;
      for (int k = 0; k < cnt; ++k, p += 3) {
        a0 += w[k] * p[0];
        a1 += w[k] * p[1];
        a2 += w[k] * p[2];
      }
      // Pillow stores the horizontal-pass result as a uint8 image before
      // the vertical pass; quantizing the intermediate the same way keeps
      // the two implementations within ~1 level even on noise
      trow[x * 3] = std::fmin(255.0f, std::fmax(0.0f, std::floor(a0 + 0.5f)));
      trow[x * 3 + 1] = std::fmin(255.0f, std::fmax(0.0f, std::floor(a1 + 0.5f)));
      trow[x * 3 + 2] = std::fmin(255.0f, std::fmax(0.0f, std::floor(a2 + 0.5f)));
    }
  }
  // vertical pass: accumulate whole rows (vectorizable inner loop)
  const int row_elems = out_w * 3;
  std::vector<float> acc(row_elems);
  for (int y = 0; y < out_h; ++y) {
    const int ymin = ry.bounds[y * 2], cnt = ry.bounds[y * 2 + 1];
    const float* w = &ry.weights[static_cast<size_t>(y) * ry.kmax];
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int k = 0; k < cnt; ++k) {
      const float wk = w[k];
      const float* trow = tmp.data() + static_cast<size_t>(ymin + k) * row_elems;
      for (int x = 0; x < row_elems; ++x) acc[x] += wk * trow[x];
    }
    uint8_t* drow = dst + static_cast<size_t>(y) * row_elems;
    for (int x = 0; x < row_elems; ++x) {
      const int v = static_cast<int>(acc[x] + 0.5f);
      drow[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// min_short_side > 0 turns on libjpeg DCT-domain scaling (scale_num/8, the
// PIL Image.draft trick): the smallest M/8 whose short side still covers the
// target, so the IDCT itself does most of the downscale and the cubic pass
// only cleans up the remainder.  0 = full-resolution decode.
// Source: path != nullptr reads the file; otherwise (mem, mem_len) is an
// in-memory JPEG (serving requests arrive as bytes, not files).
bool decode_jpeg_to(const char* path, std::vector<uint8_t>* buf, int* h, int* w,
                    int min_short_side = 0, int* orig_h = nullptr,
                    int* orig_w = nullptr, const uint8_t* mem = nullptr,
                    size_t mem_len = 0) {
  FILE* f = nullptr;
  if (path) {
    f = fopen(path, "rb");
    if (!f) return false;
  } else if (!mem || mem_len == 0) {
    return false;
  }
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    if (f) fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  if (f)
    jpeg_stdio_src(&cinfo, f);
  else
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(mem), mem_len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // untrusted SOF dims: a crafted 65500x65500 header claims ~12.8 GB of
  // pixels (bad_alloc in a std::thread worker -> std::terminate), and even
  // the M/8 scaled path would decode garbage filler from it.  100 MP is
  // far beyond any real dataset frame; decline and let the caller skip.
  // Checked on the PRE-scaling dims so the scaled and full-res paths agree.
  if (static_cast<size_t>(cinfo.image_height) * cinfo.image_width >
      100'000'000ull) {
    jpeg_destroy_decompress(&cinfo);
    if (f) fclose(f);
    return false;
  }
  if (orig_h) *orig_h = cinfo.image_height;
  if (orig_w) *orig_w = cinfo.image_width;
  if (min_short_side > 0) {
    const int short_in = std::min<int>(cinfo.image_height, cinfo.image_width);
    int m = 8;  // libjpeg output dims are ceil(dim * M / 8)
    while (m > 1 && (short_in * (m - 1) + 7) / 8 >= min_short_side) --m;
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    if (f) fclose(f);
    return false;
  }
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  buf->resize(static_cast<size_t>(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = buf->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (f) fclose(f);
  return true;
}

}  // namespace

extern "C" {

// Decode + prepare one WAV. Returns samplerate, or 0 on failure.
int avt_decode_wav(const char* path, int seconds, float* out, int64_t out_len) {
  try {
    WavData wav;
    if (!read_wav_file(path, &wav)) return 0;
    prepare_into(wav, seconds, out, out_len);
    return wav.samplerate;
  } catch (...) {  // e.g. bad_alloc on a huge-but-valid file: a per-item
    return 0;      // failure must not cross the ctypes FFI boundary
  }
}

// Batch decode+prepare: paths is n pointers; out is (n, out_len) row-major;
// rates receives per-item samplerate (0 = failed). Runs on `threads` threads.
void avt_decode_wav_batch(const char** paths, int n, int seconds, float* out,
                          int64_t out_len, int* rates, int threads) {
  std::atomic<int> next(0);
  auto work = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      try {
        rates[i] = avt_decode_wav(paths[i], seconds,
                                  out + (int64_t)i * out_len, out_len);
      } catch (...) {  // an escape from a std::thread would terminate()
        rates[i] = 0;  // the process; a bad file is a per-item failure
      }
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = std::max(1, std::min({threads, n, hw > 0 ? hw : 1}));
  if (t == 1) {  // single-core: run inline, no thread churn
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

// Host log-spectrogram of a prepared waveform -> (num_freqs, num_frames)
// int16 fixed point (scale 16000; spec_int16 transport).  nperseg must be a
// power of two (else returns 0 and the caller falls back to numpy).
// The plan (window/twiddles/scales) is cached per (nperseg, samplerate) —
// loaders call this once per sample from many threads.
int avt_log_spec_i16(const float* wav, int64_t n_samples, int samplerate,
                     int nperseg, int noverlap, int16_t* out) {
  static std::mutex mu;
  static SpecPlan cached;
  static int cached_sr = 0;
  SpecPlan local;  // ~7 KB copy; keeps readers safe if the config changes
  {                // mid-flight while another thread still computes
    std::lock_guard<std::mutex> lock(mu);
    if (cached.nperseg != nperseg || cached_sr != samplerate) {
      if (!make_spec_plan(&cached, nperseg, samplerate)) return 0;
      cached_sr = samplerate;
    }
    local = cached;
  }
  return log_spec_i16(local, wav, n_samples, noverlap, out) ? 1 : 0;
}

// Fused batch: WAV decode + fixed-length preparation + log-spectrogram,
// one thread-pool pass, no intermediate Python round trip.  out is
// (n, num_freqs, num_frames) int16; rates[i] = samplerate (0 = failed).
// wav_len is the prepared length (samplerate * seconds) each file is
// tiled/clipped/padded to before the STFT.
void avt_decode_wav_spec_batch(const char** paths, int n, int seconds,
                               int64_t wav_len, int samplerate, int nperseg,
                               int noverlap, int16_t* out, int* rates,
                               int threads) {
  SpecPlan plan;
  if (!make_spec_plan(&plan, nperseg, samplerate)) {
    for (int i = 0; i < n; ++i) rates[i] = 0;
    return;
  }
  const int hop = nperseg - noverlap;
  const int64_t num_frames = (wav_len - nperseg) / hop + 1;
  const int64_t spec_elems = static_cast<int64_t>(plan.num_freqs) * num_frames;
  std::atomic<int> next(0);
  auto work = [&]() {
    std::vector<float> wav(wav_len);
    int i;
    while ((i = next.fetch_add(1)) < n) {
      try {
        WavData wd;
        if (!read_wav_file(paths[i], &wd)) {
          rates[i] = 0;
          continue;
        }
        prepare_into(wd, seconds, wav.data(), wav_len);
        rates[i] = log_spec_i16(plan, wav.data(), wav_len, noverlap,
                                out + static_cast<int64_t>(i) * spec_elems)
                       ? wd.samplerate
                       : 0;
      } catch (...) {  // see avt_decode_wav_batch: never escape the thread
        rates[i] = 0;
      }
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = std::max(1, std::min({threads, n, hw > 0 ? hw : 1}));
  if (t == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

// Probe JPEG dimensions. Returns 1 on success.
int avt_jpeg_size(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 1;
}

// Decode a JPEG to RGB uint8 into out (must hold h*w*3). Returns 1 on success.
int avt_decode_jpeg(const char* path, uint8_t* out, int out_h, int out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_height != out_h || (int)cinfo.output_width != out_w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 0;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (int64_t)cinfo.output_scanline * out_w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 1;
}

// Fused decode + shortest-side bicubic resize (+ optional center crop).
// short_side: target for the image's shorter edge (PIL-compatible cubic).
// crop > 0: center-crop the resized image to (crop, crop) — out must hold
// crop*crop*3 and *out_h/*out_w return crop.  crop == 0: out must hold the
// full resized image (caller sizes it from avt_jpeg_size + the same dim
// math).  Returns 1 on success.
// scaled != 0 enables DCT-domain scaled decode (fast path; the cubic pass
// cleans up from the nearest M/8 scale).  scaled == 0 decodes at full
// resolution first — bit-comparable to the PIL fallback.
static int decode_jpeg_shortest_impl(const char* path, int short_side,
                                     int crop, uint8_t* out, int* out_h,
                                     int* out_w, int scaled,
                                     const uint8_t* mem = nullptr,
                                     size_t mem_len = 0) {
  std::vector<uint8_t> full;
  int h = 0, w = 0, oh = 0, ow = 0;
  if (!decode_jpeg_to(path, &full, &h, &w, scaled ? short_side : 0, &oh, &ow,
                      mem, mem_len))
    return 0;
  // target dims from the ORIGINAL geometry (the Python wrapper sizes the
  // crop==0 output buffer from jpeg_size, which reports original dims)
  int rh, rw;
  shortest_dims(oh, ow, short_side, &rh, &rw);
  // the resize target is also derived from untrusted header dims: an
  // extreme-aspect claim (2 x 30000 passes the 100 MP source cap) would
  // make rh*rw gigabytes here; same budget, applied to the target
  if (static_cast<size_t>(rh) * rw > 100'000'000ull) return 0;
  if (crop <= 0) {
    resize_cubic_hwc(full.data(), h, w, out, rh, rw);
    *out_h = rh;
    *out_w = rw;
    return 1;
  }
  std::vector<uint8_t> resized(static_cast<size_t>(rh) * rw * 3);
  resize_cubic_hwc(full.data(), h, w, resized.data(), rh, rw);
  const int top = std::max(0, (rh - crop) / 2);
  const int left = std::max(0, (rw - crop) / 2);
  const int ch = std::min(crop, rh), cw = std::min(crop, rw);
  if (ch < crop || cw < crop)  // crop larger than the resized image: the
    memset(out, 0, static_cast<size_t>(crop) * crop * 3);  // uncovered
    // border must be zeros, not whatever the caller's buffer held
  for (int y = 0; y < ch; ++y)
    memcpy(out + static_cast<size_t>(y) * crop * 3,
           resized.data() + (static_cast<size_t>(top + y) * rw + left) * 3,
           static_cast<size_t>(cw) * 3);
  *out_h = crop;
  *out_w = crop;
  return 1;
}

int avt_decode_jpeg_shortest(const char* path, int short_side, int crop,
                             uint8_t* out, int* out_h, int* out_w,
                             int scaled) {
  try {
    return decode_jpeg_shortest_impl(path, short_side, crop, out, out_h,
                                     out_w, scaled);
  } catch (...) {  // per-item failure must not cross the ctypes boundary
    return 0;
  }
}

// Same fused decode + shortest-side bicubic + center crop over an IN-MEMORY
// JPEG (serving requests arrive as bytes; the PIL path's decode+resize is
// the dominant per-request host cost on a saturated core).  Identical
// transform to avt_decode_jpeg_shortest — jpeg_mem_src instead of stdio.
int avt_decode_jpeg_shortest_mem(const uint8_t* data, int64_t len,
                                 int short_side, int crop, uint8_t* out,
                                 int* out_h, int* out_w, int scaled) {
  if (!data || len <= 0) return 0;
  try {
    return decode_jpeg_shortest_impl(nullptr, short_side, crop, out, out_h,
                                     out_w, scaled, data,
                                     static_cast<size_t>(len));
  } catch (...) {  // per-item failure must not cross the ctypes boundary
    return 0;
  }
}

// Fused TRAINING-CLIP decode: all frames of one clip through decode +
// shortest-side resize + ONE SHARED random crop (top, left chosen by the
// caller from the first frame's resized geometry, keeping the Python rng
// stream identical), written straight into the (n, crop, crop, 3) output —
// no per-frame Python round trip, no second header parse, no crop/stack
// copies.  A frame whose resized extent doesn't cover the crop window
// (aspect ratio changed mid-clip — corrupt source) counts as FAILED: the
// caller falls back to the per-frame path, which raises on the short slice
// and the sample is skip-and-counted, never silently zero-padded.
// Returns the number of successfully decoded frames (== n means clean).
int avt_decode_clip_train(const char** paths, int n, int short_side,
                          int crop, int top, int left, uint8_t* out,
                          int threads, int scaled) {
  if (crop <= 0 || n <= 0) return 0;
  std::atomic<int> next(0), good(0);
  auto work = [&]() {
    std::vector<uint8_t> full, resized;
    int i;
    while ((i = next.fetch_add(1)) < n) {
      try {
      uint8_t* dst = out + static_cast<size_t>(i) * crop * crop * 3;
      int h = 0, w = 0, oh = 0, ow = 0;
      if (!decode_jpeg_to(paths[i], &full, &h, &w,
                          scaled ? short_side : 0, &oh, &ow))
        continue;
      int rh, rw;  // target dims from ORIGINAL geometry
      shortest_dims(oh, ow, short_side, &rh, &rw);
      if (static_cast<size_t>(rh) * rw > 100'000'000ull)
        continue;  // extreme-aspect header claim (see avt_decode_jpeg_shortest)
      resized.resize(static_cast<size_t>(rh) * rw * 3);
      resize_cubic_hwc(full.data(), h, w, resized.data(), rh, rw);
      if (rh - top < crop || rw - left < crop) continue;  // geometry mismatch
      for (int y = 0; y < crop; ++y)
        memcpy(dst + static_cast<size_t>(y) * crop * 3,
               resized.data() + (static_cast<size_t>(top + y) * rw + left) * 3,
               static_cast<size_t>(crop) * 3);
      good.fetch_add(1);
      } catch (...) {  // per-frame failure, never escape the thread
      }
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = std::max(1, std::min({threads, n, hw > 0 ? hw : 1}));
  if (t == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(t);
    for (int k = 0; k < t; ++k) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return good.load();
}

// Batch fused decode+resize+center-crop to (crop, crop): out is
// (n, crop, crop, 3) row-major; ok[i] = 1 on success.
void avt_decode_jpeg_shortest_batch(const char** paths, int n, int short_side,
                                    int crop, uint8_t* out, int* ok,
                                    int threads, int scaled) {
  if (crop <= 0) {  // batch layout is (n, crop, crop, 3): crop==0 would make
    for (int i = 0; i < n; ++i) ok[i] = 0;  // every stride zero and all
    return;                                 // threads write through `out`
  }
  std::atomic<int> next(0);
  auto work = [&]() {
    int i, oh, ow;
    while ((i = next.fetch_add(1)) < n) {
      try {
        ok[i] = avt_decode_jpeg_shortest(
            paths[i], short_side, crop,
            out + static_cast<size_t>(i) * crop * crop * 3, &oh, &ow, scaled);
      } catch (...) {  // never escape the thread
        ok[i] = 0;
      }
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = std::max(1, std::min({threads, n, hw > 0 ? hw : 1}));
  if (t == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

// Batch JPEG decode on a thread pool: all images must share (h, w).
// ok[i] = 1 on success. out is (n, h, w, 3) row-major.
void avt_decode_jpeg_batch(const char** paths, int n, uint8_t* out, int h,
                           int w, int* ok, int threads) {
  std::atomic<int> next(0);
  auto work = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      try {
        ok[i] = avt_decode_jpeg(paths[i], out + (int64_t)i * h * w * 3, h, w);
      } catch (...) {  // never escape the thread
        ok[i] = 0;
      }
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = std::max(1, std::min({threads, n, hw > 0 ? hw : 1}));
  if (t == 1) {  // single-core: run inline, no thread churn
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // extern "C"
