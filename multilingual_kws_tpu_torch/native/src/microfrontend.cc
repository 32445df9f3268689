// Native (C++) micro audio frontend — bit-exact fixed-point pipeline.
//
// Host-side equivalent of the reference's TFLite microfrontend C++ op
// (reference input_data.py:25-33): framing -> quantized Hann window ->
// fixed-point kiss FFT(512) -> mel filterbank -> noise reduction -> PCAN ->
// integer log. The algorithm mirrors ops/micro_exact.py (which is validated
// bit-exactly against golden features captured from the real op); all
// float-derived lookup tables (window coefficients, filterbank weights,
// PCAN gain LUT, log LUT) are computed ONCE in Python and passed in, so this
// translation unit is pure integer arithmetic — no libm divergence risk.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment):
//   mf_create(...)            -> opaque handle holding the tables
//   mf_compute_batch(...)     -> featurize B independent clips (threaded)
//   mf_compute_stream(...)    -> featurize overlapping windows of one long
//                                stream, sharing the stateless per-hop
//                                prefix across windows (threaded)
//   mf_destroy(handle)
//
// The port's own copy of multilingual_kws_tpu/native/src/microfrontend.cc.
// Built by native/__init__.py: g++ -O3 -std=c++17 -shared -fPIC -pthread.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kWindowBits = 12;
constexpr int kNoiseReductionBits = 14;
constexpr int kPcanSnrBits = 12;
constexpr int kPcanOutputBits = 6;
constexpr int kLogScaleLog2 = 16;
constexpr int kLogSegmentsLog2 = 7;
constexpr int64_t kLogCoeff = 45426;

inline int msb32(uint64_t x) {  // bit length (0 for 0)
  int out = 0;
  for (int shift : {32, 16, 8, 4, 2, 1}) {
    if (x >= (uint64_t(1) << shift)) {
      out += shift;
      x >>= shift;
    }
  }
  return out + (x != 0 ? 1 : 0);
}

inline int64_t sround(int64_t x) { return (x + (1 << 14)) >> 15; }

struct Frontend {
  int window_size, window_step, fft_size, spectrum_size, num_channels;
  int smoothing_bits, snr_shift, correction_bits, scale_shift;
  int64_t even_smoothing, odd_smoothing, min_signal_remaining;
  bool enable_pcan, enable_log;

  std::vector<int64_t> window_coeffs;           // (window_size,)
  std::vector<int64_t> band_starts, band_widths; // (num_channels+1,)
  std::vector<std::vector<int64_t>> weights, unweights;
  std::vector<int64_t> pcan_lut;                // empty if !enable_pcan
  std::vector<int64_t> log_lut;                 // (2^7 + 2,)

  // kiss fftr(512) tables
  std::vector<int64_t> tw_r, tw_i;    // (256,)
  std::vector<int64_t> stw_r, stw_i;  // (128,)
  std::vector<int> perm;              // (256,)

  void init_fft_tables() {
    const int n = 256;
    tw_r.resize(n);
    tw_i.resize(n);
    for (int i = 0; i < n; ++i) {
      double phase = -2.0 * M_PI * i / n;
      tw_r[i] = (int64_t)std::floor(0.5 + 32767.0 * std::cos(phase));
      tw_i[i] = (int64_t)std::floor(0.5 + 32767.0 * std::sin(phase));
    }
    stw_r.resize(n / 2);
    stw_i.resize(n / 2);
    for (int k = 0; k < n / 2; ++k) {
      double sphase = -M_PI * ((k + 1.0) / n + 0.5);
      stw_r[k] = (int64_t)std::floor(0.5 + 32767.0 * std::cos(sphase));
      stw_i[k] = (int64_t)std::floor(0.5 + 32767.0 * std::sin(sphase));
    }
    perm.resize(n);
    for (int i = 0; i < n; ++i) {
      int v = i, r = 0;
      for (int d = 0; d < 4; ++d) {
        r = (r << 2) | (v & 3);
        v >>= 2;
      }
      perm[i] = r;
    }
  }
};

inline void fixdiv4(int64_t& r, int64_t& i) {
  r = sround(r * 8191);
  i = sround(i * 8191);
}

// 512-point fixed-point real FFT (kiss_fftr semantics) on one frame.
// in: 512 int16 values; out_r/out_i: 257 int64 bins.
void kiss_fftr512(const Frontend& fe, const int16_t* in, int64_t* out_r,
                  int64_t* out_i) {
  constexpr int N = 256;
  int64_t fr[N], fi[N];
  for (int k = 0; k < N; ++k) {
    fr[k] = in[2 * fe.perm[k]];
    fi[k] = in[2 * fe.perm[k] + 1];
  }
  // four radix-4 stages: (fstride, m) = (64,1),(16,4),(4,16),(1,64)
  static constexpr int kStages[4][2] = {{64, 1}, {16, 4}, {4, 16}, {1, 64}};
  int64_t gr[N], gi[N];
  for (auto& st : kStages) {
    const int fstride = st[0], m = st[1];
    const int groups = N / (4 * m);
    for (int g = 0; g < groups; ++g) {
      const int base = g * 4 * m;
      for (int k = 0; k < m; ++k) {
        int64_t x0r = fr[base + k], x0i = fi[base + k];
        int64_t x1r = fr[base + m + k], x1i = fi[base + m + k];
        int64_t x2r = fr[base + 2 * m + k], x2i = fi[base + 2 * m + k];
        int64_t x3r = fr[base + 3 * m + k], x3i = fi[base + 3 * m + k];
        fixdiv4(x0r, x0i);
        fixdiv4(x1r, x1i);
        fixdiv4(x2r, x2i);
        fixdiv4(x3r, x3i);
        const int64_t t1r = fe.tw_r[k * fstride], t1i = fe.tw_i[k * fstride];
        const int64_t t2r = fe.tw_r[2 * k * fstride], t2i = fe.tw_i[2 * k * fstride];
        const int64_t t3r = fe.tw_r[3 * k * fstride], t3i = fe.tw_i[3 * k * fstride];
        int64_t s0r = sround(x1r * t1r - x1i * t1i);
        int64_t s0i = sround(x1r * t1i + x1i * t1r);
        int64_t s1r = sround(x2r * t2r - x2i * t2i);
        int64_t s1i = sround(x2r * t2i + x2i * t2r);
        int64_t s2r = sround(x3r * t3r - x3i * t3i);
        int64_t s2i = sround(x3r * t3i + x3i * t3r);
        int64_t s5r = x0r - s1r, s5i = x0i - s1i;
        x0r += s1r;
        x0i += s1i;
        int64_t s3r = s0r + s2r, s3i = s0i + s2i;
        int64_t s4r = s0r - s2r, s4i = s0i - s2i;
        gr[base + k] = x0r + s3r;
        gi[base + k] = x0i + s3i;
        gr[base + m + k] = s5r + s4i;
        gi[base + m + k] = s5i - s4r;
        gr[base + 2 * m + k] = x0r - s3r;
        gi[base + 2 * m + k] = x0i - s3i;
        gr[base + 3 * m + k] = s5r - s4i;
        gi[base + 3 * m + k] = s5i + s4r;
      }
    }
    std::memcpy(fr, gr, sizeof(fr));
    std::memcpy(fi, gi, sizeof(fi));
  }
  // real post-processing
  auto fixdiv2 = [](int64_t& r, int64_t& i) {
    r = sround(r * 16383);
    i = sround(i * 16383);
  };
  int64_t tdc_r = fr[0], tdc_i = fi[0];
  fixdiv2(tdc_r, tdc_i);
  out_r[0] = tdc_r + tdc_i;
  out_i[0] = 0;
  out_r[N] = tdc_r - tdc_i;
  out_i[N] = 0;
  for (int k = 1; k <= N / 2; ++k) {
    int64_t fpk_r = fr[k], fpk_i = fi[k];
    int64_t fpnk_r = fr[N - k], fpnk_i = -fi[N - k];
    fixdiv2(fpk_r, fpk_i);
    fixdiv2(fpnk_r, fpnk_i);
    const int64_t f1k_r = fpk_r + fpnk_r, f1k_i = fpk_i + fpnk_i;
    const int64_t f2k_r = fpk_r - fpnk_r, f2k_i = fpk_i - fpnk_i;
    const int64_t twr = sround(f2k_r * fe.stw_r[k - 1] - f2k_i * fe.stw_i[k - 1]);
    const int64_t twi = sround(f2k_r * fe.stw_i[k - 1] + f2k_i * fe.stw_r[k - 1]);
    out_r[k] = (f1k_r + twr) >> 1;
    out_i[k] = (f1k_i + twi) >> 1;
    out_r[N - k] = (f1k_r - twr) >> 1;
    out_i[N - k] = (twi - f1k_i) >> 1;
  }
}

// Sqrt64 semantics: floor sqrt with +1 when remainder > result (capped).
inline int64_t isqrt_rounded(uint64_t num) {
  uint64_t res = (uint64_t)std::sqrt((double)num);
  while (res > 0 && res * res > num) --res;
  while ((res + 1) * (res + 1) <= num) ++res;
  const uint64_t rem = num - res * res;
  const uint64_t cap = (num >> 32) == 0 ? 0xFFFFull : 0xFFFFFFFFull;
  int64_t out = (int64_t)res;
  if ((int64_t)rem > out && res != cap) ++out;
  return out;
}

inline int64_t wide_dynamic_function(uint32_t x, const std::vector<int64_t>& lut) {
  if (x <= 2) return lut[x];
  const int interval = msb32(x);
  size_t base = (size_t)(4 * interval - 6);
  if (base > lut.size() - 3) base = lut.size() - 3;
  const int64_t l0 = lut[base], l1 = lut[base + 1], l2 = lut[base + 2];
  const int64_t frac =
      (interval < 11 ? ((int64_t)x << (11 - interval)) : ((int64_t)x >> (interval - 11))) &
      0x3FF;
  int64_t result = (l2 * frac) >> 5;
  result += (int64_t)(int32_t)(((uint64_t)l1 << 5) & 0xFFFFFFFFull);
  result *= frac;
  result = (result + (1 << 14)) >> 15;
  result += l0;
  return result;
}

inline int64_t pcan_shrink(int64_t x) {
  if (x >= (int64_t)(2 << kPcanSnrBits))
    return (x >> (kPcanSnrBits - kPcanOutputBits)) - (1 << kPcanOutputBits);
  return (x * x) >> (2 + 2 * kPcanSnrBits - kPcanOutputBits);
}

inline int64_t integer_log(int64_t x, const Frontend& fe) {
  // x > 0
  const int integer = msb32((uint64_t)x) - 1;
  int64_t frac = x - ((int64_t)1 << integer);
  frac = integer < kLogScaleLog2 ? frac << (kLogScaleLog2 - integer)
                                 : frac >> (integer - kLogScaleLog2);
  const int64_t base_seg = frac >> (kLogScaleLog2 - kLogSegmentsLog2);
  const int64_t seg_unit = ((int64_t)1 << kLogScaleLog2) >> kLogSegmentsLog2;
  const int64_t c0 = fe.log_lut[base_seg], c1 = fe.log_lut[base_seg + 1];
  const int64_t rel = ((c1 - c0) * (frac - seg_unit * base_seg)) >> kLogScaleLog2;
  const int64_t fraction = frac + c0 + rel;
  const int64_t log2v = ((int64_t)integer << kLogScaleLog2) + fraction;
  const int64_t rnd = (int64_t)1 << (kLogScaleLog2 - 1);
  const int64_t loge = (kLogCoeff * log2v + rnd) >> kLogScaleLog2;
  return ((loge << fe.scale_shift) + rnd) >> kLogScaleLog2;
}

// Stateless per-frame prefix: window+fft+filterbank+sqrt (>>shift applied).
// audio: pointer to the frame start (window_size samples).
// out: num_channels uint32-range values.
void frame_prefix(const Frontend& fe, const int16_t* audio, uint32_t* out,
                  int64_t* fft_r, int64_t* fft_i, int16_t* scratch) {
  const int win = fe.window_size;
  // quantized window, int16 wrap
  int64_t max_abs = 0;
  for (int i = 0; i < win; ++i) {
    const int16_t w16 = (int16_t)(((int64_t)audio[i] * fe.window_coeffs[i]) >> kWindowBits);
    scratch[i] = w16;
    const int16_t a = w16 < 0 ? (int16_t)(-w16) : w16;  // wraps at -32768
    if ((int64_t)a > max_abs) max_abs = a;
  }
  int shift = 15 - msb32((uint64_t)std::max<int64_t>(max_abs, 0));
  shift = std::min(std::max(shift, 0), 15);
  // scale with uint16 wrap then reinterpret int16
  std::vector<int16_t> fft_in(fe.fft_size, 0);
  for (int i = 0; i < win; ++i)
    fft_in[i] = (int16_t)(uint16_t)(((uint16_t)scratch[i]) << shift);
  kiss_fftr512(fe, fft_in.data(), fft_r, fft_i);

  const int nb = fe.num_channels + 1;
  std::vector<uint64_t> wacc(nb, 0), uacc(nb, 0);
  for (int band = 0; band < nb; ++band) {
    const int64_t s = fe.band_starts[band];
    const int64_t w = fe.band_widths[band];
    for (int64_t j = 0; j < w; ++j) {
      const int64_t e = fft_r[s + j] * fft_r[s + j] + fft_i[s + j] * fft_i[s + j];
      wacc[band] += (uint64_t)(e * fe.weights[band][j]);
      uacc[band] += (uint64_t)(e * fe.unweights[band][j]);
    }
  }
  for (int c = 0; c < fe.num_channels; ++c) {
    const uint64_t work = uacc[c] + wacc[c + 1];
    out[c] = (uint32_t)(isqrt_rounded(work) >> shift);
  }
}

// Stateful suffix over F frames of one clip/window: noise reduction + PCAN +
// log. in: (F, C) uint32 prefix values; out: (F, C) float (x 10/256).
void nr_pcan_log(const Frontend& fe, const uint32_t* in, int frames, float* out) {
  const int nch = fe.num_channels;
  std::vector<uint32_t> estimate(nch, 0);
  for (int t = 0; t < frames; ++t) {
    for (int c = 0; c < nch; ++c) {
      const uint32_t sig = in[t * nch + c];
      const int64_t smoothing = (c % 2 == 0) ? fe.even_smoothing : fe.odd_smoothing;
      const int64_t one_minus = ((int64_t)1 << kNoiseReductionBits) - smoothing;
      const uint32_t scaled_up = (uint32_t)((uint64_t)sig << fe.smoothing_bits);
      estimate[c] = (uint32_t)(((uint64_t)scaled_up * smoothing +
                                (uint64_t)estimate[c] * one_minus) >>
                               kNoiseReductionBits);
      const int64_t subtracted =
          (int64_t)(scaled_up > estimate[c] ? scaled_up - estimate[c] : 0) >>
          fe.smoothing_bits;
      const int64_t floor_ = ((int64_t)sig * fe.min_signal_remaining) >> kNoiseReductionBits;
      const int64_t nr = std::max(subtracted, floor_);
      int64_t val;
      if (fe.enable_pcan) {
        const int64_t gain = wide_dynamic_function(estimate[c], fe.pcan_lut);
        const int64_t snr = (nr * gain) >> fe.snr_shift;
        val = pcan_shrink(snr);
      } else {
        val = nr;
      }
      if (fe.enable_log) {
        const int64_t v = val << fe.correction_bits;
        val = v > 0 ? integer_log(v, fe) : 0;
      }
      if (val > 0xFFFF) val = 0xFFFF;
      out[t * nch + c] = (float)val * (10.0f / 256.0f);
    }
  }
}

void compute_clip(const Frontend& fe, const int16_t* audio, int num_samples,
                  float* out) {
  const int frames =
      num_samples < fe.window_size
          ? 0
          : 1 + (num_samples - fe.window_size) / fe.window_step;
  if (frames == 0) return;
  std::vector<uint32_t> prefix((size_t)frames * fe.num_channels);
  std::vector<int64_t> fr(fe.spectrum_size), fi(fe.spectrum_size);
  std::vector<int16_t> scratch(fe.window_size);
  for (int t = 0; t < frames; ++t)
    frame_prefix(fe, audio + (size_t)t * fe.window_step,
                 prefix.data() + (size_t)t * fe.num_channels, fr.data(),
                 fi.data(), scratch.data());
  nr_pcan_log(fe, prefix.data(), frames, out);
}

void parallel_for(int n, int num_threads, const std::function<void(int, int)>& fn) {
  if (num_threads <= 1 || n <= 1) {
    fn(0, n);
    return;
  }
  num_threads = std::min(num_threads, n);
  std::vector<std::thread> threads;
  const int chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void* mf_create(int window_size, int window_step, int fft_size,
                int spectrum_size, int num_channels, int smoothing_bits,
                long long even_smoothing, long long odd_smoothing,
                long long min_signal_remaining, int enable_pcan, int snr_shift,
                int correction_bits, int scale_shift, int enable_log,
                const long long* window_coeffs, const long long* band_starts,
                const long long* band_widths, const long long* weights_flat,
                const long long* unweights_flat, const long long* pcan_lut,
                int pcan_lut_len, const long long* log_lut, int log_lut_len) {
  auto* fe = new Frontend();
  fe->window_size = window_size;
  fe->window_step = window_step;
  fe->fft_size = fft_size;
  fe->spectrum_size = spectrum_size;
  fe->num_channels = num_channels;
  fe->smoothing_bits = smoothing_bits;
  fe->even_smoothing = even_smoothing;
  fe->odd_smoothing = odd_smoothing;
  fe->min_signal_remaining = min_signal_remaining;
  fe->enable_pcan = enable_pcan != 0;
  fe->snr_shift = snr_shift;
  fe->correction_bits = correction_bits;
  fe->scale_shift = scale_shift;
  fe->enable_log = enable_log != 0;
  fe->window_coeffs.assign(window_coeffs, window_coeffs + window_size);
  const int nb = num_channels + 1;
  fe->band_starts.assign(band_starts, band_starts + nb);
  fe->band_widths.assign(band_widths, band_widths + nb);
  fe->weights.resize(nb);
  fe->unweights.resize(nb);
  size_t off = 0;
  for (int b = 0; b < nb; ++b) {
    const size_t w = (size_t)band_widths[b];
    fe->weights[b].assign(weights_flat + off, weights_flat + off + w);
    fe->unweights[b].assign(unweights_flat + off, unweights_flat + off + w);
    off += w;
  }
  if (enable_pcan) fe->pcan_lut.assign(pcan_lut, pcan_lut + pcan_lut_len);
  fe->log_lut.assign(log_lut, log_lut + log_lut_len);
  fe->init_fft_tables();
  return fe;
}

void mf_destroy(void* handle) { delete (Frontend*)handle; }

// audio: (batch, num_samples) int16; out: (batch, frames, channels) float32.
void mf_compute_batch(void* handle, const int16_t* audio, int batch,
                      int num_samples, float* out, int num_threads) {
  const Frontend& fe = *(Frontend*)handle;
  const int frames =
      num_samples < fe.window_size
          ? 0
          : 1 + (num_samples - fe.window_size) / fe.window_step;
  parallel_for(batch, num_threads, [&](int lo, int hi) {
    for (int b = lo; b < hi; ++b)
      compute_clip(fe, audio + (size_t)b * num_samples,
                   num_samples, out + (size_t)b * frames * fe.num_channels);
  });
}

int mf_num_frames(void* handle, int num_samples) {
  const Frontend& fe = *(Frontend*)handle;
  return num_samples < fe.window_size
             ? 0
             : 1 + (num_samples - fe.window_size) / fe.window_step;
}

// Long stream -> per-window features. Windows start every `window_step`
// samples (hop == frame stride), each spanning `clip_frames` frames; the
// stateless per-hop prefix is computed once and shared (the reference
// recomputes the whole spectrogram per window, batch_streaming_analysis.py
// :99-116 — identical results, ~49x less FFT work).
// audio: (num_samples,) int16; out: (num_windows, clip_frames, channels).
void mf_compute_stream(void* handle, const int16_t* audio, long long num_samples,
                       int num_windows, int clip_frames, float* out,
                       int num_threads) {
  const Frontend& fe = *(Frontend*)handle;
  const int total_frames = num_windows - 1 + clip_frames;
  std::vector<uint32_t> prefix((size_t)total_frames * fe.num_channels);
  parallel_for(total_frames, num_threads, [&](int lo, int hi) {
    std::vector<int64_t> fr(fe.spectrum_size), fi(fe.spectrum_size);
    std::vector<int16_t> scratch(fe.window_size);
    for (int t = lo; t < hi; ++t)
      frame_prefix(fe, audio + (size_t)t * fe.window_step,
                   prefix.data() + (size_t)t * fe.num_channels, fr.data(),
                   fi.data(), scratch.data());
  });
  parallel_for(num_windows, num_threads, [&](int lo, int hi) {
    for (int w = lo; w < hi; ++w)
      nr_pcan_log(fe, prefix.data() + (size_t)w * fe.num_channels, clip_frames,
                  out + (size_t)w * clip_frames * fe.num_channels);
  });
}

}  // extern "C"
