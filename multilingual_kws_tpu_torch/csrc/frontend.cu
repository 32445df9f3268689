// The exact micro frontend's kernels for Hopper (sm_90a).
//
// All compute the TFLite microfrontend's fixed-point arithmetic bit for bit:
// uint32 values wrap where the C code's do, 64-bit intermediates are native
// uint64_t, and every result is == to the plain PyTorch versions in
// ops/cuda_fft.py, ops/cuda_frontend.py and ops/cuda_clip.py (and so to the
// JAX package and the golden features of the real op). The per-frame prefix
// (prefix_frame, and within it the FFT and energies, fft_energies) and the
// per-step suffix (suffix_step) are each written once and shared by the
// kernels below.
//
// stream_prefix  replaces multilingual_kws_tpu/ops/pallas_fft.py::window_fft_energy
//                (_window_fft_energy_kernel) and the filterbank + sqrt64_exact
//                epilogue of micro_jax.base_frames.
//   Per 20 ms hop: quantized-Hann window >>12, input_shift =
//   clip(15 - msb32(max|x|), 0, 15), the 512-point kiss FFT (four radix-4
//   stages over the 256-point complex substate, then the real post-stage),
//   uint32 energies, the exact 64-bit filterbank accumulate, Sqrt64, >>shift.
//   Bound: integer operations (~28k per frame against 960 bytes of audio
//   read and 160 bytes written). Design: 64 threads per frame, 4 frames per
//   block; a frame's 256-point substate and its energies stay in shared
//   memory, so nothing but the audio and the (F, 40) result touches device
//   memory. Each thread owns one radix-4 butterfly per stage. The TPU's
//   one-hot permutation matmuls and limb splits are gone: the digit-reversal
//   permutation is an index computed per thread, products are 64-bit.
//
// stream_suffix  replaces multilingual_kws_tpu/ops/pallas_frontend.py::noise_estimate_scan_u32
//                (_nr_kernel_u32), the pointwise stages of
//                micro_jax.nr_pcan_log_int after it and the (W, 49, 40) window
//                gather of micro_jax._stream_impl before it.
//   One thread per (window, channel) runs the 49-step noise-estimate
//   recurrence with its carry in a register, and at each step the noise
//   subtraction, PCAN gain, integer log and the 10/256 scale.
//   Bound: bytes or integer operations, about even (the (W, 49, 40) float32
//   output, ~1960 floats per window, dwarfs the base rows it reads; 52 ops
//   per output). Design: it reads the base rows of each window directly
//   (window w is rows w*stride .. w*stride+F-1), so the gathered windows
//   never exist in memory; neighbouring threads are neighbouring channels,
//   so reads and writes coalesce, and the base rows that 49 windows share
//   come from L1/L2.
//
// clip_features  replaces multilingual_kws_tpu/ops/pallas_fft.py::clip_frontend_features
//                (_clip_frontend_full_kernel): the whole frontend of a clip.
//   One block per clip. Phase 1 runs prefix_frame over the clip's frames,
//   four at a time, into a (frames, channels) uint32 array in shared memory
//   (7.8 KB at 49 frames); phase 2 gives one thread per channel, which runs
//   the frames-step suffix with its noise state in a register and writes the
//   features. One launch; the (B, 49, 40) sqrt-filterbank signal never
//   touches device memory. Bound: integer operations (~1.48 M per 1 s clip,
//   against 32 KB of audio in and 7.8 KB of features out). Phase 2 keeps
//   only 40 of the block's 256 threads busy; it is ~7 % of the work.
//
// fft_energy     replaces multilingual_kws_tpu/ops/pallas_fft.py::kiss_fft_energy
//                (_fft_energy_kernel): the FFT and energies alone, on rows that
//                already hold the input-permuted complex substate.
//   (N, 256) int32 x2 -> (N, 257) int32 holding the uint32 energies (C wrap;
//   bin 128 from the post-stage's second write). It runs fft_energies, the
//   same device code as stream_prefix and clip_features, so the three cannot
//   drift. Bound: integer operations (~23k per row against 2 KB read and 1 KB
//   written). Design: stream_prefix's, 64 threads per row, 4 rows per block,
//   the substate and energies in shared memory. The TPU kernel's lane-reversal
//   matmuls and 512-row padding are gone: a thread reads any index.
//
// Tables (window, twiddles, filterbank, LUTs) are small int32 device arrays
// owned by the Python frontend object and read through the read-only cache:
// their lookups differ from lane to lane, which __constant__ memory would
// serialize.
//
// Plain C interface for ctypes: device pointers and the stream as integers;
// each entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsPerFrame = 64;  // one radix-4 butterfly each per stage
constexpr int kFramesPerBlock = 4;
constexpr int kPrefixThreads = kThreadsPerFrame * kFramesPerBlock;
constexpr int kSub = 256;  // complex substate of the 512-point real FFT
constexpr int kSuffixThreads = 256;
// shared memory a clip_features block may hold for its (frames, channels)
// base rows, beside the prefix's own 12 KB: the sum stays below the 48 KB a
// block gets without an opt-in (ops/cuda_clip.py routes by the same bound)
constexpr int kClipMaxBaseBytes = 32768;

struct PrefixArgs {
  int win, step, channels, fb_width;
  const int* window;
  const int* tw_r;
  const int* tw_i;
  const int* stw_r;
  const int* stw_i;
  const int* fb_idx;
  const int* fb_wgt;
};

struct PrefixSmem {
  int re[kFramesPerBlock][kSub];
  int im[kFramesPerBlock][kSub];
  uint32_t en[kFramesPerBlock][kSub + 1];
  int max[kFramesPerBlock][kThreadsPerFrame / 32];
};

struct SuffixArgs {
  int smoothing_bits, min_signal_remaining, enable_pcan, snr_shift, enable_log, correction_bits,
      scale_shift;
  const int* sm;
  const int* om;
  const int* wdf_rows;
  const int* lut012;
  const int* log_lut;
};

__device__ __forceinline__ int sround(long long x) { return (int)((x + (1 << 14)) >> 15); }

// kiss C_MUL with sround on each component
__device__ __forceinline__ void cmul(int ar, int ai, int br, int bi, int& outr, int& outi) {
  outr = sround((long long)ar * br - (long long)ai * bi);
  outi = sround((long long)ar * bi + (long long)ai * br);
}

__device__ __forceinline__ uint32_t energy(int r, int i) {
  return (uint32_t)r * (uint32_t)r + (uint32_t)i * (uint32_t)i;  // wraps mod 2^32, as in C
}

// base-4 digit reversal of an 8-bit index (the kiss DIT input order)
__device__ __forceinline__ int digit_reverse4(int n) {
  return ((n & 3) << 6) | (((n >> 2) & 3) << 4) | (((n >> 4) & 3) << 2) | ((n >> 6) & 3);
}

// Sqrt64 of the microfrontend: floor sqrt, +1 when the remainder exceeds the
// root, except at the cap (0xFFFF for 32-bit inputs, else 0xFFFFFFFF).
// num < 2^52, so the double root is within one of the integer root.
__device__ __forceinline__ uint32_t sqrt64_exact(unsigned long long num) {
  unsigned long long r = (unsigned long long)sqrt((double)num);
  if (r * r > num) --r;
  if ((r + 1) * (r + 1) <= num) ++r;
  const unsigned long long rem = num - r * r;
  const unsigned long long cap = (num >> 32) == 0 ? 0xFFFFull : 0xFFFFFFFFull;
  return (uint32_t)(r + ((rem > r && r != cap) ? 1 : 0));
}

// The 512-point kiss FFT of one frame per group of kThreadsPerFrame threads,
// from its input-permuted 256-point complex substate in re/im (shared
// memory, written and synchronized by the caller): four radix-4 stages in
// place, then the real post-stage and the uint32 energies of bins 0..256
// into en. Thread t owns one butterfly per stage. Every thread of the block
// must call it: it synchronizes the block.
__device__ __forceinline__ void fft_energies(int* re, int* im, uint32_t* en, int t,
                                             const PrefixArgs& a) {
  // four radix-4 stages (fstride, m) = (64,1) (16,4) (4,16) (1,64)
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int m = 1 << (2 * s);
    const int fstride = 64 >> (2 * s);
    const int k = t % m;
    const int b0 = (t / m) * 4 * m + k;
    int xr[4], xi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // C_FIXDIV by 4
      xr[q] = sround((long long)re[b0 + q * m] * 8191);
      xi[q] = sround((long long)im[b0 + q * m] * 8191);
    }
    int s0r, s0i, s1r, s1i, s2r, s2i;
    cmul(xr[1], xi[1], __ldg(a.tw_r + k * fstride), __ldg(a.tw_i + k * fstride), s0r, s0i);
    cmul(xr[2], xi[2], __ldg(a.tw_r + 2 * k * fstride), __ldg(a.tw_i + 2 * k * fstride), s1r, s1i);
    cmul(xr[3], xi[3], __ldg(a.tw_r + 3 * k * fstride), __ldg(a.tw_i + 3 * k * fstride), s2r, s2i);
    const int s5r = xr[0] - s1r, s5i = xi[0] - s1i;
    const int x0r = xr[0] + s1r, x0i = xi[0] + s1i;
    const int s3r = s0r + s2r, s3i = s0i + s2i;
    const int s4r = s0r - s2r, s4i = s0i - s2i;
    re[b0] = x0r + s3r;
    im[b0] = x0i + s3i;
    re[b0 + m] = s5r + s4i;
    im[b0 + m] = s5i - s4r;
    re[b0 + 2 * m] = x0r - s3r;
    im[b0 + 2 * m] = x0i - s3i;
    re[b0 + 3 * m] = s5r - s4i;
    im[b0 + 3 * m] = s5i + s4r;
    __syncthreads();
  }

  // the real post-stage and uint32 energies: thread t takes k = t+1 and t+65
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = t + 1 + kThreadsPerFrame * h;
    const int fpk_r = sround((long long)re[k] * 16383), fpk_i = sround((long long)im[k] * 16383);
    const int fpnk_r = sround((long long)re[kSub - k] * 16383);
    const int fpnk_i = sround(-(long long)im[kSub - k] * 16383);
    const int f1k_r = fpk_r + fpnk_r, f1k_i = fpk_i + fpnk_i;
    const int f2k_r = fpk_r - fpnk_r, f2k_i = fpk_i - fpnk_i;
    int twr, twi;
    cmul(f2k_r, f2k_i, __ldg(a.stw_r + k - 1), __ldg(a.stw_i + k - 1), twr, twi);
    // bin 128 is written twice by the C loop; its second write wins
    if (k < kSub / 2) en[k] = energy((f1k_r + twr) >> 1, (f1k_i + twi) >> 1);
    en[kSub - k] = energy((f1k_r - twr) >> 1, (twi - f1k_i) >> 1);
  }
  if (t == 0) {
    const int tdc_r = sround((long long)re[0] * 16383), tdc_i = sround((long long)im[0] * 16383);
    en[0] = energy(tdc_r + tdc_i, 0);
    en[kSub] = energy(tdc_r - tdc_i, 0);
  }
  __syncthreads();
}

// The prefix of one frame per group of kThreadsPerFrame threads: group
// threadIdx.x / kThreadsPerFrame takes the frame whose first sample is x and,
// when valid, writes its channels to out[0 .. channels). Every thread of the
// block must call it: it synchronizes the block.
__device__ __forceinline__ void prefix_frame(const int16_t* __restrict__ x, bool valid,
                                             PrefixSmem& sm, const PrefixArgs& a,
                                             int* __restrict__ out) {
  const int lf = threadIdx.x / kThreadsPerFrame;
  const int t = threadIdx.x % kThreadsPerFrame;
  int* re = sm.re[lf];
  int* im = sm.im[lf];
  uint32_t* en = sm.en[lf];

  // 1. window (>>12, arithmetic) of complex points n = t + 64 j, i.e. samples
  //    2n and 2n+1; the FFT input beyond the window is zero.
  int wr[4], wi[4];
  int mx = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s0 = 2 * (t + kThreadsPerFrame * j);
    wr[j] = (valid && s0 < a.win) ? ((int)x[s0] * __ldg(a.window + s0)) >> 12 : 0;
    wi[j] = (valid && s0 + 1 < a.win) ? ((int)x[s0 + 1] * __ldg(a.window + s0 + 1)) >> 12 : 0;
    mx = max(mx, max(abs(wr[j]), abs(wi[j])));
  }
  // 2. input_shift from the frame's max |x| (two warps per frame)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((t & 31) == 0) sm.max[lf][t >> 5] = mx;
  __syncthreads();
  mx = max(sm.max[lf][0], sm.max[lf][1]);
  const int msb = mx ? 32 - __clz(mx) : 0;
  const int shift = min(max(15 - msb, 0), 15);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = digit_reverse4(t + kThreadsPerFrame * j);
    re[p] = (int)((uint32_t)wr[j] << shift);
    im[p] = (int)((uint32_t)wi[j] << shift);
  }
  __syncthreads();

  fft_energies(re, im, en, t, a);

  // 3. exact 64-bit filterbank accumulate, Sqrt64, >>shift
  if (valid) {
    for (int c = t; c < a.channels; c += kThreadsPerFrame) {
      unsigned long long acc = 0;
      for (int j = 0; j < a.fb_width; ++j) {
        const int e = c * a.fb_width + j;
        acc += (unsigned long long)en[__ldg(a.fb_idx + e)] * (unsigned long long)__ldg(a.fb_wgt + e);
      }
      out[c] = (int)(sqrt64_exact(acc) >> shift);
    }
  }
}

__global__ void __launch_bounds__(kPrefixThreads) stream_prefix_kernel(
    const int16_t* __restrict__ audio, int batch, long long samples, int frames, PrefixArgs a,
    int* __restrict__ out) {
  __shared__ PrefixSmem sm;
  const long long g = (long long)blockIdx.x * kFramesPerBlock + threadIdx.x / kThreadsPerFrame;
  const bool valid = g < (long long)batch * frames;  // frame over the batch
  const long long clip = valid ? g / frames : 0;
  const long long frame = valid ? g % frames : 0;
  prefix_frame(audio + clip * samples + frame * a.step, valid, sm, a, out + g * a.channels);
}

// WideDynamicFunction (pcan_gain_control.c) of a uint32 estimate
__device__ __forceinline__ long long wide_dynamic_function(uint32_t x, const int* __restrict__ rows,
                                                           const int* __restrict__ lut012) {
  if (x <= 2) return __ldg(lut012 + x);
  const int interval = 32 - __clz(x);
  const int* r = rows + 3 * min(interval - 1, 31);
  const long long frac =
      (interval < 11 ? (x << (11 - interval)) : (x >> (interval - 11))) & 0x3FF;
  long long res = ((long long)__ldg(r + 2) * frac) >> 5;
  res += (long long)__ldg(r + 1) * 32;
  res = (res * frac + (1 << 14)) >> 15;
  return res + __ldg(r);
}

// Log() of log_scale.c on value = x << correction_bits, capped at 0xFFFF
__device__ __forceinline__ uint32_t log_scale(uint32_t x, int correction_bits, int scale_shift,
                                              const int* __restrict__ log_lut) {
  const uint32_t value = x << correction_bits;
  if (value == 0) return 0;
  const int integer = 31 - __clz(value);
  uint32_t frac = value - (1u << integer);
  frac = integer < 16 ? frac << (16 - integer) : frac >> (integer - 16);
  const uint32_t seg = frac >> 9;  // 128 segments of 512
  const long long c0 = __ldg(log_lut + seg), c1 = __ldg(log_lut + seg + 1);
  const long long rel = ((c1 - c0) * (long long)(frac - (seg << 9))) >> 16;
  const long long log2v = ((long long)integer << 16) + frac + c0 + rel;
  const long long loge = (45426LL * log2v + 32768) >> 16;  // kLogCoeff = round(2^16 ln 2)
  const uint32_t logged = ((uint32_t)(loge << scale_shift) + 32768u) >> 16;
  return min(logged, 0xFFFFu);
}

// One step of the suffix for one channel: the noise estimate (carried in
// est), noise subtraction, PCAN gain and the integer log (or the 16-bit cap).
__device__ __forceinline__ uint32_t suffix_step(uint32_t sig, uint32_t& est,
                                                unsigned long long smc, unsigned long long omc,
                                                const SuffixArgs& a) {
  // noise estimate: est' = (u64(sig << sb) * sm + u64(est) * om) >> 14
  const uint32_t su = sig << a.smoothing_bits;
  est = (uint32_t)(((unsigned long long)su * smc + (unsigned long long)est * omc) >> 14);
  const uint32_t sub = (su - min(est, su)) >> a.smoothing_bits;
  const uint32_t floor_ =
      (uint32_t)(((unsigned long long)sig * (uint32_t)a.min_signal_remaining) >> 14);
  uint32_t v = max(sub, floor_);
  if (a.enable_pcan) {
    const uint32_t gain = (uint32_t)wide_dynamic_function(est, a.wdf_rows, a.lut012);
    const uint32_t snr = (uint32_t)(((unsigned long long)v * gain) >> a.snr_shift);
    if (snr >= (2u << 12)) {
      v = (snr >> 6) - 64;
    } else {
      v = (snr * snr) >> 20;
    }
  }
  return a.enable_log ? log_scale(v, a.correction_bits, a.scale_shift, a.log_lut) : min(v, 0xFFFFu);
}

__device__ __forceinline__ void store_feature(void* __restrict__ out, long long o, uint32_t v,
                                              int out_is_float) {
  if (out_is_float) {
    static_cast<float*>(out)[o] = (float)v * (10.0f / 256.0f);
  } else {
    static_cast<int*>(out)[o] = (int)v;
  }
}

__global__ void __launch_bounds__(kSuffixThreads) stream_suffix_kernel(
    const int* __restrict__ base, int windows, int stride, int frames, int channels, SuffixArgs a,
    void* __restrict__ out, int out_is_float) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)windows * channels) return;
  const int c = (int)(idx % channels);
  const long long w = idx / channels;
  const unsigned long long smc = (uint32_t)__ldg(a.sm + c), omc = (uint32_t)__ldg(a.om + c);
  const int* row = base + w * stride * channels + c;
  const long long out0 = w * frames * channels + c;
  uint32_t est = 0;
  for (int t = 0; t < frames; ++t) {
    const uint32_t sig = (uint32_t)__ldg(row + (long long)t * channels);
    store_feature(out, out0 + (long long)t * channels, suffix_step(sig, est, smc, omc, a),
                  out_is_float);
  }
}

// Rows of the input-permuted complex substate -> their uint32 energies.
__global__ void __launch_bounds__(kPrefixThreads) fft_energy_kernel(
    const int* __restrict__ xr, const int* __restrict__ xi, long long rows, PrefixArgs a,
    int* __restrict__ out) {
  __shared__ PrefixSmem sm;
  const int lf = threadIdx.x / kThreadsPerFrame;
  const int t = threadIdx.x % kThreadsPerFrame;
  const long long row = (long long)blockIdx.x * kFramesPerBlock + lf;
  const bool valid = row < rows;
#pragma unroll
  for (int j = 0; j < kSub / kThreadsPerFrame; ++j) {
    const int n = t + kThreadsPerFrame * j;
    sm.re[lf][n] = valid ? __ldg(xr + row * kSub + n) : 0;
    sm.im[lf][n] = valid ? __ldg(xi + row * kSub + n) : 0;
  }
  __syncthreads();
  fft_energies(sm.re[lf], sm.im[lf], sm.en[lf], t, a);
  if (valid) {
    for (int k = t; k <= kSub; k += kThreadsPerFrame) out[row * (kSub + 1) + k] = (int)sm.en[lf][k];
  }
}

__global__ void __launch_bounds__(kPrefixThreads) clip_features_kernel(
    const int16_t* __restrict__ audio, long long samples, int frames, PrefixArgs pa, SuffixArgs sa,
    void* __restrict__ out, int out_is_float) {
  __shared__ PrefixSmem sm;
  extern __shared__ int s_base[];  // (frames, channels) sqrt-filterbank signal of this clip
  const long long clip = blockIdx.x;
  const int16_t* x = audio + clip * samples;
  const int lf = threadIdx.x / kThreadsPerFrame;
  // phase 1: the prefix, four frames at a time, into shared memory
  for (int f0 = 0; f0 < frames; f0 += kFramesPerBlock) {
    const int f = min(f0 + lf, frames - 1);
    prefix_frame(x + (long long)f * pa.step, f0 + lf < frames, sm, pa, s_base + f * pa.channels);
  }
  __syncthreads();
  // phase 2: one thread per channel carries the noise state down the frames
  for (int c = threadIdx.x; c < pa.channels; c += blockDim.x) {
    const unsigned long long smc = (uint32_t)__ldg(sa.sm + c), omc = (uint32_t)__ldg(sa.om + c);
    const long long out0 = clip * frames * pa.channels + c;
    uint32_t est = 0;
    for (int t = 0; t < frames; ++t) {
      const uint32_t sig = (uint32_t)s_base[t * pa.channels + c];
      store_feature(out, out0 + (long long)t * pa.channels, suffix_step(sig, est, smc, omc, sa),
                    out_is_float);
    }
  }
}

PrefixArgs prefix_args(int win, int step, int channels, int fb_width, const int* window,
                       const int* tw_r, const int* tw_i, const int* stw_r, const int* stw_i,
                       const int* fb_idx, const int* fb_wgt) {
  return PrefixArgs{win, step, channels, fb_width, window, tw_r, tw_i, stw_r, stw_i, fb_idx, fb_wgt};
}

SuffixArgs suffix_args(int smoothing_bits, int min_signal_remaining, int enable_pcan,
                       int snr_shift, int enable_log, int correction_bits, int scale_shift,
                       const int* sm, const int* om, const int* wdf_rows, const int* lut012,
                       const int* log_lut) {
  return SuffixArgs{smoothing_bits, min_signal_remaining, enable_pcan, snr_shift, enable_log,
                    correction_bits, scale_shift, sm, om, wdf_rows, lut012, log_lut};
}

}  // namespace

extern "C" int kws_stream_prefix(const int16_t* audio, int batch, long long samples, int frames,
                                 int win, int step, int channels, int fb_width, const int* window,
                                 const int* tw_r, const int* tw_i, const int* stw_r,
                                 const int* stw_i, const int* fb_idx, const int* fb_wgt, int* out,
                                 void* stream) {
  const long long total = (long long)batch * frames;
  const dim3 grid((unsigned)((total + kFramesPerBlock - 1) / kFramesPerBlock));
  stream_prefix_kernel<<<grid, kPrefixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      audio, batch, samples, frames,
      prefix_args(win, step, channels, fb_width, window, tw_r, tw_i, stw_r, stw_i, fb_idx, fb_wgt),
      out);
  return (int)cudaGetLastError();
}

extern "C" int kws_stream_suffix(const int* base, int windows, int stride, int frames,
                                 int channels, int smoothing_bits, int min_signal_remaining,
                                 int enable_pcan, int snr_shift, int enable_log,
                                 int correction_bits, int scale_shift, const int* sm,
                                 const int* om, const int* wdf_rows, const int* lut012,
                                 const int* log_lut, void* out, int out_is_float, void* stream) {
  const long long total = (long long)windows * channels;
  const dim3 grid((unsigned)((total + kSuffixThreads - 1) / kSuffixThreads));
  stream_suffix_kernel<<<grid, kSuffixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, windows, stride, frames, channels,
      suffix_args(smoothing_bits, min_signal_remaining, enable_pcan, snr_shift, enable_log,
                  correction_bits, scale_shift, sm, om, wdf_rows, lut012, log_lut),
      out, out_is_float);
  return (int)cudaGetLastError();
}

extern "C" int kws_clip_features(const int16_t* audio, int batch, long long samples, int frames,
                                 int win, int step, int channels, int fb_width, const int* window,
                                 const int* tw_r, const int* tw_i, const int* stw_r,
                                 const int* stw_i, const int* fb_idx, const int* fb_wgt,
                                 int smoothing_bits, int min_signal_remaining, int enable_pcan,
                                 int snr_shift, int enable_log, int correction_bits,
                                 int scale_shift, const int* sm, const int* om,
                                 const int* wdf_rows, const int* lut012, const int* log_lut,
                                 void* out, int out_is_float, void* stream) {
  const size_t base_bytes = (size_t)frames * channels * sizeof(int);
  if (base_bytes > (size_t)kClipMaxBaseBytes) return (int)cudaErrorInvalidValue;
  clip_features_kernel<<<batch, kPrefixThreads, base_bytes, static_cast<cudaStream_t>(stream)>>>(
      audio, samples, frames,
      prefix_args(win, step, channels, fb_width, window, tw_r, tw_i, stw_r, stw_i, fb_idx, fb_wgt),
      suffix_args(smoothing_bits, min_signal_remaining, enable_pcan, snr_shift, enable_log,
                  correction_bits, scale_shift, sm, om, wdf_rows, lut012, log_lut),
      out, out_is_float);
  return (int)cudaGetLastError();
}

extern "C" int kws_fft_energy(const int* xr, const int* xi, long long rows, const int* tw_r,
                              const int* tw_i, const int* stw_r, const int* stw_i, int* out,
                              void* stream) {
  const dim3 grid((unsigned)((rows + kFramesPerBlock - 1) / kFramesPerBlock));
  fft_energy_kernel<<<grid, kPrefixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, rows,
      prefix_args(0, 0, 0, 0, nullptr, tw_r, tw_i, stw_r, stw_i, nullptr, nullptr), out);
  return (int)cudaGetLastError();
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
