// The exact micro frontend's kernels for Hopper (sm_90a).
//
// All compute the TFLite microfrontend's fixed-point arithmetic bit for bit:
// uint32 values wrap where the C code's do, 64-bit intermediates are native
// uint64_t, and every result is == to the plain PyTorch versions in
// ops/cuda_fft.py, ops/cuda_frontend.py and ops/cuda_clip.py (and so to the
// JAX package and the golden features of the real op). The per-frame prefix
// (prefix_frame, and within it the FFT and energies, fft_energies) and the
// suffix's two halves (noise_step, the serial noise estimate, and
// suffix_pointwise, everything after it) are each written once and shared by
// the kernels below.
//
// One warp per frame. prefix_frame and fft_energies run a frame's whole
// 512-point real FFT inside one warp, in a warp-private WarpFrame of shared
// memory: lanes exchange values through it between stages with __syncwarp,
// so no block-wide barrier sits inside the prefix, and warps of one block
// never wait for each other. The 256-point substate is stored padded (index
// i at i + i/8), and each radix-4 stage hands its 64 butterflies to the 32
// lanes in the order that keeps a stage's shared-memory accesses at one or
// two ways per bank (the unpadded layout at stride m had up to eight).
//
// stream_prefix  replaces multilingual_kws_tpu/ops/pallas_fft.py::window_fft_energy
//                (_window_fft_energy_kernel) and the filterbank + sqrt64_exact
//                epilogue of micro_jax.base_frames.
//   Per 20 ms hop: quantized-Hann window >>12, input_shift =
//   clip(15 - msb32(max|x|), 0, 15), the 512-point kiss FFT (four radix-4
//   stages over the 256-point complex substate, then the real post-stage),
//   uint32 energies, the exact 64-bit filterbank accumulate, Sqrt64, >>shift.
//   Bound: integer operations (~28k per frame against 960 bytes of audio
//   read and 160 bytes written). Design: one warp per frame, eight frames
//   per block, each warp on its own; a frame's substate and energies stay in
//   shared memory, so nothing but the audio and the (F, 40) result touches
//   device memory. The TPU's one-hot permutation matmuls and limb splits are
//   gone: the digit-reversal permutation is an index computed per lane,
//   products are 64-bit. The filterbank gives each channel four lanes (a
//   quarter of its terms each, summed by shuffles), so all 32 lanes work in
//   every round instead of 40 channels over 32 lanes in two rounds.
//
// stream_suffix  replaces multilingual_kws_tpu/ops/pallas_frontend.py::noise_estimate_scan_u32
//                (_nr_kernel_u32), the pointwise stages of
//                micro_jax.nr_pcan_log_int after it and the (W, 49, 40) window
//                gather of micro_jax._stream_impl before it.
//   Per (window, frame, channel): the noise-estimate step (the only serial
//   part, restarting at each window's first row), noise subtraction, PCAN
//   gain, the integer log and the 10/256 scale.
//   Bound: integer instructions. At the data sheet its 52 operations an
//   output outweigh its bytes (at the stream's 29,950 windows 0.0911 ms of
//   operations against 0.0716 ms of bytes), and the compiled loop issues
//   more than the algorithm counts: chip_smoke.py prints its SASS census
//   (probes/sass.py), 63.5 instructions an element at four channels a
//   thread, 40.5 of them on the ALU pipe, which bound the stream at about
//   0.16 ms at the rate the alu probe measures (NVIDIA H100 80GB HBM3,
//   700 W; PERF.md). The first design,
//   one thread per (window, channel) with 64-bit arithmetic and its tables
//   read through the read-only cache at lane-divergent addresses, issued 119
//   an element.
//   Design: a thread takes CPT (1 or 4) consecutive channels of one window:
//   CPT independent chains in registers, one load of CPT base-row values and
//   one store of CPT features a frame (16 bytes at CPT = 4). The launch plan
//   (ops/cuda_frontend.py) takes four from 640 of its threads an SM up (the
//   two layouts cross at about 8,200 windows, 620 an SM) and one below
//   (short streams, clip batches, one long clip: latency bound, so the most
//   threads win). Window w reads base rows w*stride ..
//   directly, so the gathered windows never exist in memory, and the rows
//   neighbouring windows share come from L1. The pointwise rest
//   (suffix_pointwise32) is 32-bit wherever the C semantics fit, with its
//   tables packed in shared memory (WideDynamicFunction's rows as int4,
//   lut012 appended as three rows; the log LUT as (c0, c1 - c0) pairs), and
//   the float conversion is an fma on the exponent-or'ed bits. Measured and
//   rejected (PERF.md): two channels a thread, never faster than both of
//   the others. chip_smoke.py phase d times the two kept layouts by stream
//   length, at clip batches and on one long window.
//   clip_features keeps suffix_pointwise (64-bit, tables from the read-only
//   cache): its suffix is a small share of its time, and phase e holds the
//   two == on every clip batch (clip_features == prefix + stream_suffix).
//
// clip_features  replaces multilingual_kws_tpu/ops/pallas_fft.py::clip_frontend_features
//                (_clip_frontend_full_kernel): the whole frontend of a clip.
//   Bound: integer operations (~1.48 M per 1 s clip, against 32 KB of audio
//   in and 7.8 KB of features out). What held the first design (one
//   256-thread block per clip) back was latency, not work: at the
//   fine-tune's 64 clips it filled 64 of 132 SMs; it walked the 49 frames
//   four at a time, with six block barriers per round; and 40 of its 256
//   threads ran the whole 49-step suffix serially, PCAN and log inside the
//   dependent chain. Design now:
//   - a thread block cluster of kClipCluster = 2 blocks per clip (128
//     blocks at 64 clips), each block one warp per frame over its half of
//     the frames (25 of 49; 13 warps, so two rounds), the (frames, channels)
//     signal in its own shared memory;
//   - after cluster.sync(), block r takes half of the channels: it reads
//     their rows from its peer's shared memory (distributed shared memory,
//     map_shared_rank), one thread per channel runs only the noise estimate
//     est' = (u64(sig << sb) * sm + u64(est) * om) >> 14 down the frames
//     into shared memory, loading each frame's signal a step ahead, and then
//     all threads compute subtraction, PCAN, log and scale over the
//     (frames, its channels) elements at once. The split is exact: each
//     pointwise step depends only on (sig_t, est_t).
//   The (B, 49, 40) sqrt-filterbank signal never touches device memory.
//   Clusters of 3, 4 and 8 blocks, one block per clip, and 16 or 25 warps
//   per block were measured too (PERF.md): larger clusters cost more in
//   cluster scheduling and registers than their extra SMs gain, one block
//   per clip leaves half the SMs idle at 64 clips, and wider blocks lower
//   the blocks an SM holds at 2048 clips. Budget (-Xptxas -v, printed by
//   chip_smoke.py at build): 48 registers (__launch_bounds__ with three
//   blocks per SM, no spills) and 47 KB of dynamic shared memory per block
//   at 49 frames (13 WarpFrames of 3.3 KB and the block's 25 x 40 rows;
//   the suffix's (49, 20) signal and estimates reuse the WarpFrames'
//   space). Longer clips, up to the 204 frames that take the kernel
//   (ops/cuda_clip.py routes by the same bound), need more rows, and above
//   48 KB the launch opts in to more shared memory.
//
// fft_energy     replaces multilingual_kws_tpu/ops/pallas_fft.py::kiss_fft_energy
//                (_fft_energy_kernel): the FFT and energies alone, on rows that
//                already hold the input-permuted complex substate.
//   (N, 256) int32 x2 -> (N, 257) int32 holding the uint32 energies (C wrap;
//   bin 128 from the post-stage's second write). It runs fft_energies, the
//   same device code as stream_prefix and clip_features, so the three cannot
//   drift. Bound: integer operations (~23k per row against 2 KB read and 1 KB
//   written). Design: stream_prefix's, one warp per row, eight rows per
//   block. The TPU kernel's lane-reversal matmuls and 512-row padding are
//   gone: a lane reads any index.
//
// Tables (window, twiddles, filterbank, LUTs) are small int32 device arrays
// owned by the Python frontend object and read through the read-only cache:
// their lookups differ from lane to lane, which __constant__ memory would
// serialize. stream_suffix stages its own, repacked, in shared memory.
//
// Plain C interface for ctypes: device pointers and the stream as integers;
// each entry point returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSub = 256;                  // complex substate of the 512-point real FFT
constexpr int kPadded = kSub + kSub / 8;   // the substate padded: index i lives at i + i/8
constexpr int kWarpsPerBlock = 8;          // stream_prefix and fft_energy: a frame (row) per warp
constexpr int kPrefixThreads = 32 * kWarpsPerBlock;
constexpr int kSuffixThreads = 256;
constexpr int kClipCluster = 2;            // clip_features: blocks per clip
constexpr int kClipMaxWarps = 13;
constexpr int kClipMinBlocks = 3;          // per SM: caps registers at 48 a thread
// bytes of (frames, channels) int32 signal a clip may have to take
// clip_features (ops/cuda_clip.py routes by the same bound)
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

// one warp's scratch for one frame's FFT
struct WarpFrame {
  int re[kPadded];
  int im[kPadded];
  uint32_t en[kSub + 1];
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

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

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

// The butterfly (0..63) that lane takes as its h-th (0, 1) of radix-4 stage
// s. Any assignment is right; these keep each stage's accesses to the padded
// substate at one or two ways per bank.
__device__ __forceinline__ int butterfly_of(int s, int lane, int h) {
  if (s == 1) return ((lane >> 1) << 2) | (h << 1) | (lane & 1);
  if (s == 3) return lane + 32 * h;
  return 2 * lane + h;
}

// The 512-point kiss FFT of one frame by one warp, from its input-permuted
// 256-point complex substate in w.re/w.im (padded; written by the caller,
// followed by __syncwarp): four radix-4 stages in place, then the real
// post-stage and the uint32 energies of bins 0..256 into w.en. Every lane of
// the warp must call it; it ends with __syncwarp.
__device__ __forceinline__ void fft_energies(WarpFrame& w, int lane, const PrefixArgs& a) {
  // four radix-4 stages (fstride, m) = (64,1) (16,4) (4,16) (1,64)
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int m = 1 << (2 * s);
    const int fstride = 64 >> (2 * s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = butterfly_of(s, lane, h);
      const int k = t & (m - 1);
      const int b0 = (t >> (2 * s)) * 4 * m + k;
      int xr[4], xi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // C_FIXDIV by 4
        xr[q] = sround((long long)w.re[pad(b0 + q * m)] * 8191);
        xi[q] = sround((long long)w.im[pad(b0 + q * m)] * 8191);
      }
      int s0r, s0i, s1r, s1i, s2r, s2i;
      cmul(xr[1], xi[1], __ldg(a.tw_r + k * fstride), __ldg(a.tw_i + k * fstride), s0r, s0i);
      cmul(xr[2], xi[2], __ldg(a.tw_r + 2 * k * fstride), __ldg(a.tw_i + 2 * k * fstride), s1r, s1i);
      cmul(xr[3], xi[3], __ldg(a.tw_r + 3 * k * fstride), __ldg(a.tw_i + 3 * k * fstride), s2r, s2i);
      const int s5r = xr[0] - s1r, s5i = xi[0] - s1i;
      const int x0r = xr[0] + s1r, x0i = xi[0] + s1i;
      const int s3r = s0r + s2r, s3i = s0i + s2i;
      const int s4r = s0r - s2r, s4i = s0i - s2i;
      w.re[pad(b0)] = x0r + s3r;
      w.im[pad(b0)] = x0i + s3i;
      w.re[pad(b0 + m)] = s5r + s4i;
      w.im[pad(b0 + m)] = s5i - s4r;
      w.re[pad(b0 + 2 * m)] = x0r - s3r;
      w.im[pad(b0 + 2 * m)] = x0i - s3i;
      w.re[pad(b0 + 3 * m)] = s5r - s4i;
      w.im[pad(b0 + 3 * m)] = s5i + s4r;
    }
    __syncwarp();
  }

  // the real post-stage and uint32 energies: lane takes k = lane+1+32h
#pragma unroll
  for (int h = 0; h < kSub / 2 / 32; ++h) {
    const int k = lane + 1 + 32 * h;
    const int fpk_r = sround((long long)w.re[pad(k)] * 16383);
    const int fpk_i = sround((long long)w.im[pad(k)] * 16383);
    const int fpnk_r = sround((long long)w.re[pad(kSub - k)] * 16383);
    const int fpnk_i = sround(-(long long)w.im[pad(kSub - k)] * 16383);
    const int f1k_r = fpk_r + fpnk_r, f1k_i = fpk_i + fpnk_i;
    const int f2k_r = fpk_r - fpnk_r, f2k_i = fpk_i - fpnk_i;
    int twr, twi;
    cmul(f2k_r, f2k_i, __ldg(a.stw_r + k - 1), __ldg(a.stw_i + k - 1), twr, twi);
    // bin 128 is written twice by the C loop; its second write wins
    if (k < kSub / 2) w.en[k] = energy((f1k_r + twr) >> 1, (f1k_i + twi) >> 1);
    w.en[kSub - k] = energy((f1k_r - twr) >> 1, (twi - f1k_i) >> 1);
  }
  if (lane == 0) {
    const int tdc_r = sround((long long)w.re[0] * 16383), tdc_i = sround((long long)w.im[0] * 16383);
    w.en[0] = energy(tdc_r + tdc_i, 0);
    w.en[kSub] = energy(tdc_r - tdc_i, 0);
  }
  __syncwarp();
}

// The prefix of one frame, whose first sample is x, by one warp, in its
// WarpFrame w: writes the frame's channels to out[0 .. channels). Every lane
// of the warp must call it.
__device__ __forceinline__ void prefix_frame(const int16_t* __restrict__ x, WarpFrame& w, int lane,
                                             const PrefixArgs& a, int* __restrict__ out) {
  // 1. window (>>12, arithmetic) of complex points n = lane + 32 j, i.e.
  //    samples 2n and 2n+1; the FFT input beyond the window is zero.
  int wr[kSub / 32], wi[kSub / 32];
  int mx = 0;
#pragma unroll
  for (int j = 0; j < kSub / 32; ++j) {
    const int s0 = 2 * (lane + 32 * j);
    wr[j] = s0 < a.win ? ((int)x[s0] * __ldg(a.window + s0)) >> 12 : 0;
    wi[j] = s0 + 1 < a.win ? ((int)x[s0 + 1] * __ldg(a.window + s0 + 1)) >> 12 : 0;
    mx = max(mx, max(abs(wr[j]), abs(wi[j])));
  }
  // 2. input_shift from the frame's max |x|
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const int msb = mx ? 32 - __clz(mx) : 0;
  const int shift = min(max(15 - msb, 0), 15);
#pragma unroll
  for (int j = 0; j < kSub / 32; ++j) {
    const int p = pad(digit_reverse4(lane + 32 * j));
    w.re[p] = (int)((uint32_t)wr[j] << shift);
    w.im[p] = (int)((uint32_t)wi[j] << shift);
  }
  __syncwarp();

  fft_energies(w, lane, a);

  // 3. exact 64-bit filterbank accumulate, Sqrt64, >>shift: four lanes per
  //    channel, each a quarter of its terms (integer sums: any order is exact)
  const int quarter = lane & 3;
  const int per = (a.fb_width + 3) / 4;
  const int j0 = quarter * per, j1 = min(j0 + per, a.fb_width);
  for (int c0 = 0; c0 < a.channels; c0 += 8) {
    const int c = c0 + (lane >> 2);
    unsigned long long acc = 0;
    if (c < a.channels) {
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const int e = c * a.fb_width + j;
        acc += (unsigned long long)w.en[__ldg(a.fb_idx + e)] * (unsigned long long)__ldg(a.fb_wgt + e);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (quarter == 0 && c < a.channels) out[c] = (int)(sqrt64_exact(acc) >> shift);
  }
}

__global__ void __launch_bounds__(kPrefixThreads) stream_prefix_kernel(
    const int16_t* __restrict__ audio, int batch, long long samples, int frames, PrefixArgs a,
    int* __restrict__ out) {
  __shared__ WarpFrame wf[kWarpsPerBlock];
  const int warp = threadIdx.x / 32;
  const long long g = (long long)blockIdx.x * kWarpsPerBlock + warp;  // frame over the batch
  if (g >= (long long)batch * frames) return;  // the whole warp: no block barrier follows
  const long long clip = g / frames, frame = g % frames;
  prefix_frame(audio + clip * samples + frame * a.step, wf[warp], threadIdx.x % 32, a,
               out + g * a.channels);
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

// One step of the noise estimate for one channel, carried in est:
// est' = (u64(sig << sb) * sm + u64(est) * om) >> 14. The suffix's only
// serial part.
__device__ __forceinline__ void noise_step(uint32_t sig, uint32_t& est, uint32_t smc, uint32_t omc,
                                           int smoothing_bits) {
  const uint32_t su = sig << smoothing_bits;
  est = (uint32_t)(((unsigned long long)su * smc + (unsigned long long)est * omc) >> 14);
}

// The rest of the suffix at one (frame, channel), from the signal and that
// frame's noise estimate alone: noise subtraction, PCAN gain and the integer
// log (or the 16-bit cap).
__device__ __forceinline__ uint32_t suffix_pointwise(uint32_t sig, uint32_t est,
                                                     const SuffixArgs& a) {
  const uint32_t su = sig << a.smoothing_bits;
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

// stream_suffix's tables, packed and staged in shared memory by each block:
// WideDynamicFunction's 32 interval rows (r0, r1, r2) followed by one row
// (lut012[x], 0, 0) for each x <= 2, whose general formula then gives
// lut012[x]; and the log LUT as (c0, c1 - c0) per segment.
constexpr int kWdfRows = 32 + 3;
constexpr int kLogSegs = 128;

struct SuffixSmem {
  int4 wdf[kWdfRows];
  int2 logp[kLogSegs];
};

__device__ __forceinline__ void stage_suffix_tables(SuffixSmem& tb, const SuffixArgs& a) {
  for (int i = threadIdx.x; i < kWdfRows + kLogSegs; i += blockDim.x) {
    if (i < 32) {
      tb.wdf[i] = make_int4(__ldg(a.wdf_rows + 3 * i), __ldg(a.wdf_rows + 3 * i + 1),
                            __ldg(a.wdf_rows + 3 * i + 2), 0);
    } else if (i < kWdfRows) {
      tb.wdf[i] = make_int4(__ldg(a.lut012 + i - 32), 0, 0, 0);
    } else {
      const int seg = i - kWdfRows, c0 = __ldg(a.log_lut + seg);
      tb.logp[seg] = make_int2(c0, __ldg(a.log_lut + seg + 1) - c0);
    }
  }
  __syncthreads();
}

// suffix_pointwise in 32-bit arithmetic, tables from shared memory; == it
// for every input. The C code's WideDynamicFunction is int32 arithmetic on
// int16 table rows (no intermediate reaches 2^31); the log's frac is the
// 16 bits under the leading one, (value << clz) >> 15; loge = (kLogCoeff *
// log2 + 2^15) >> 16 is the high word of log2 * (kLogCoeff << 16) + 2^31.
template <bool PCAN, bool LOG>
__device__ __forceinline__ uint32_t suffix_pointwise32(uint32_t sig, uint32_t est, const SuffixArgs& a,
                                                       const SuffixSmem& tb) {
  const uint32_t su = sig << a.smoothing_bits;
  const uint32_t sub = (su - min(est, su)) >> a.smoothing_bits;
  const uint32_t floor_ =
      (uint32_t)(((unsigned long long)sig * (uint32_t)a.min_signal_remaining) >> 14);
  uint32_t v = max(sub, floor_);
  if (PCAN) {
    const int n = __clz(est | 1u);  // est <= 2 takes its own row below
    const int4 r = tb.wdf[est <= 2 ? 32 + (int)est : 31 - n];
    const int frac = (int)(((est << n) >> 21) & 0x3FF);
    int res = ((r.z * frac) >> 5) + r.y * 32;
    res = ((res * frac + (1 << 14)) >> 15) + r.x;
    const uint32_t snr = (uint32_t)(((unsigned long long)v * (uint32_t)res) >> a.snr_shift);
    v = snr >= (2u << 12) ? (snr >> 6) - 64 : (snr * snr) >> 20;
  }
  if (!LOG) return min(v, 0xFFFFu);
  const uint32_t value = v << a.correction_bits;
  const int n = __clz(value | 1u);
  const uint32_t frac = ((value << n) >> 15) & 0xFFFF;
  const int2 p = tb.logp[frac >> 9];
  const int rel = (p.y * (int)(frac & 511)) >> 16;
  const uint32_t log2v = ((uint32_t)(31 - n) << 16) + frac + (uint32_t)(p.x + rel);
  const uint32_t loge =
      (uint32_t)(((unsigned long long)log2v * (45426u << 16) + (1ull << 31)) >> 32);
  const uint32_t logged = ((loge << a.scale_shift) + 32768u) >> 16;
  return value == 0 ? 0u : min(logged, 0xFFFFu);
}

// CPT (1 or 4) consecutive channels of one row: one 4- or 16-byte load
template <int CPT>
__device__ __forceinline__ void load_row(const int* __restrict__ p, uint32_t (&s)[CPT]) {
  if constexpr (CPT == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  } else {
    s[0] = __ldg(p);
  }
}

// CPT features at p: int32, or float32 on the 10/256 scale. v <= 0xFFFF,
// so float(v) is 2^23 + v with the exponent bits or'ed in, less 2^23, and
// the fma rounds v * 10/256 exactly once, as float(v) * 10/256 does.
template <int CPT, bool FLOAT>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ p, const uint32_t (&v)[CPT]) {
  uint32_t bits[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    bits[j] = FLOAT ? __float_as_uint(__fmaf_rn(__uint_as_float(0x4B000000u | v[j]), 10.0f / 256.0f,
                                                -8388608.0f * (10.0f / 256.0f)))
                    : v[j];
  }
  if constexpr (CPT == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bits[0], bits[1], bits[2], bits[3]);
  } else {
    *p = bits[0];
  }
}

// One thread per (window, CPT consecutive channels): CPT independent noise
// chains in registers down the window's frames, the pointwise rest of each
// element in the same step, one vector load and one vector store per frame.
template <int CPT, bool FLOAT, bool PCAN, bool LOG>
__global__ void __launch_bounds__(kSuffixThreads) stream_suffix_kernel(
    const int* __restrict__ base, int windows, int stride, int frames, int channels, SuffixArgs a,
    void* __restrict__ out) {
  __shared__ SuffixSmem tb;
  stage_suffix_tables(tb, a);
  const int groups = channels / CPT;
  const long long idx = (long long)blockIdx.x * kSuffixThreads + threadIdx.x;
  if (idx >= (long long)windows * groups) return;
  const int c = (int)(idx % groups) * CPT;
  const long long w = idx / groups;
  uint32_t smc[CPT], omc[CPT], est[CPT], next[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    smc[j] = (uint32_t)__ldg(a.sm + c + j);
    omc[j] = (uint32_t)__ldg(a.om + c + j);
    est[j] = 0;
  }
  const int* row = base + w * stride * channels + c;
  uint32_t* o = static_cast<uint32_t*>(out) + w * frames * channels + c;
  load_row<CPT>(row, next);
  for (int t = 0; t < frames; ++t, o += channels) {
    uint32_t sig[CPT], v[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) sig[j] = next[j];
    if (t + 1 < frames) {
      row += channels;
      load_row<CPT>(row, next);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      noise_step(sig[j], est[j], smc[j], omc[j], a.smoothing_bits);
      v[j] = suffix_pointwise32<PCAN, LOG>(sig[j], est[j], a, tb);
    }
    store_row<CPT, FLOAT>(o, v);
  }
}

template <int CPT, bool FLOAT, bool PCAN, bool LOG>
int launch_suffix(const int* base, int windows, int stride, int frames, int channels,
                  const SuffixArgs& a, void* out, cudaStream_t s) {
  const long long threads = (long long)windows * (channels / CPT);
  const dim3 grid((unsigned)((threads + kSuffixThreads - 1) / kSuffixThreads));
  stream_suffix_kernel<CPT, FLOAT, PCAN, LOG><<<grid, kSuffixThreads, 0, s>>>(
      base, windows, stride, frames, channels, a, out);
  return (int)cudaGetLastError();
}

template <int CPT, bool FLOAT>
int launch_suffix_for(const int* base, int windows, int stride, int frames, int channels,
                      const SuffixArgs& a, void* out, cudaStream_t s) {
  if (a.enable_pcan) {
    return a.enable_log
               ? launch_suffix<CPT, FLOAT, true, true>(base, windows, stride, frames, channels, a, out, s)
               : launch_suffix<CPT, FLOAT, true, false>(base, windows, stride, frames, channels, a, out, s);
  }
  return a.enable_log
             ? launch_suffix<CPT, FLOAT, false, true>(base, windows, stride, frames, channels, a, out, s)
             : launch_suffix<CPT, FLOAT, false, false>(base, windows, stride, frames, channels, a, out, s);
}

template <int CPT>
int launch_suffix_cpt(const int* base, int windows, int stride, int frames, int channels,
                      const SuffixArgs& a, void* out, int out_is_float, cudaStream_t s) {
  return out_is_float
             ? launch_suffix_for<CPT, true>(base, windows, stride, frames, channels, a, out, s)
             : launch_suffix_for<CPT, false>(base, windows, stride, frames, channels, a, out, s);
}

// Rows of the input-permuted complex substate -> their uint32 energies.
__global__ void __launch_bounds__(kPrefixThreads) fft_energy_kernel(
    const int* __restrict__ xr, const int* __restrict__ xi, long long rows, PrefixArgs a,
    int* __restrict__ out) {
  __shared__ WarpFrame wf[kWarpsPerBlock];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // the whole warp: no block barrier follows
  WarpFrame& w = wf[warp];
#pragma unroll
  for (int j = 0; j < kSub / 32; ++j) {
    const int n = lane + 32 * j;
    w.re[pad(n)] = __ldg(xr + row * kSub + n);
    w.im[pad(n)] = __ldg(xi + row * kSub + n);
  }
  __syncwarp();
  fft_energies(w, lane, a);
  for (int k = lane; k <= kSub; k += 32) out[row * (kSub + 1) + k] = (int)w.en[k];
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// shared-memory layout of a clip_features block: its frames' (per, channels)
// int32 rows, then either its warps' WarpFrames (the prefix) or, reusing
// that space, the suffix's (frames, q) signal and estimates
struct ClipLayout {
  int per, q, warps;
  size_t rows_bytes, bytes;
};

__host__ __device__ inline ClipLayout clip_layout(int frames, int channels) {
  ClipLayout l;
  l.per = (frames + kClipCluster - 1) / kClipCluster;
  l.q = (channels + kClipCluster - 1) / kClipCluster;
  l.warps = l.per < kClipMaxWarps ? l.per : kClipMaxWarps;
  l.rows_bytes = ((size_t)l.per * channels * sizeof(int) + 15) / 16 * 16;
  const size_t prefix = (size_t)l.warps * sizeof(WarpFrame);
  const size_t suffix = (size_t)frames * l.q * 2 * sizeof(uint32_t);
  l.bytes = l.rows_bytes + (prefix > suffix ? prefix : suffix);
  return l;
}

__global__ void __cluster_dims__(kClipCluster, 1, 1) __launch_bounds__(32 * kClipMaxWarps, kClipMinBlocks)
    clip_features_kernel(const int16_t* __restrict__ audio, long long samples, int frames,
                         PrefixArgs pa, SuffixArgs sa, void* __restrict__ out, int out_is_float) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long clip = blockIdx.x / kClipCluster;
  const int channels = pa.channels;
  const ClipLayout l = clip_layout(frames, channels);
  int* rows = reinterpret_cast<int*>(smem);  // (per, channels): frames rank*per ..
  WarpFrame* wf = reinterpret_cast<WarpFrame*>(smem + l.rows_bytes);

  // phase 1: the prefix of this block's frames, one warp per frame
  const int16_t* x = audio + clip * samples;
  const int f0 = rank * l.per, f1 = min(f0 + l.per, frames);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int f = f0 + warp; f < f1; f += l.warps) {
    prefix_frame(x + (long long)f * pa.step, wf[warp], lane, pa, rows + (f - f0) * channels);
  }
  cluster.sync();

  // phase 2: this block's channels c0 .. c0+nc-1 over all frames. Gather
  // their signal from the cluster's rows into the space the WarpFrames held.
  // Element (t, c) of the (frames, nc) slice is i = t * nc + c; a thread
  // steps i by blockDim.x with the carry written out, not divided.
  const int c0 = rank * l.q, nc = max(0, min(c0 + l.q, channels) - c0);
  uint32_t* sig = reinterpret_cast<uint32_t*>(wf);  // (frames, nc)
  uint32_t* est = sig + frames * l.q;
  const int dt = nc ? blockDim.x / nc : 0, dc = nc ? blockDim.x % nc : 0;
  if (nc) {
    int t = threadIdx.x / nc, c = threadIdx.x % nc;
    while (t < frames) {
      const int owner = t / l.per;
      const int* peer = cluster.map_shared_rank(rows, owner);
      sig[t * nc + c] = (uint32_t)peer[(t - owner * l.per) * channels + c0 + c];
      t += dt;
      c += dc;
      if (c >= nc) c -= nc, ++t;
    }
  }
  __syncthreads();
  cluster_arrive();  // done with the peers' rows; wait for theirs before leaving

  // the noise estimate: one thread per channel, the only serial chain (the
  // next frame's signal is loaded ahead of the step that needs it)
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const uint32_t smc = (uint32_t)__ldg(sa.sm + c0 + c);
    const uint32_t omc = (uint32_t)__ldg(sa.om + c0 + c);
    uint32_t e = 0, next = sig[c];
    for (int t = 0; t < frames; ++t) {
      const uint32_t cur = next;
      if (t + 1 < frames) next = sig[(t + 1) * nc + c];
      noise_step(cur, e, smc, omc, sa.smoothing_bits);
      est[t * nc + c] = e;
    }
  }
  __syncthreads();
  // subtraction, PCAN, log and scale, every element at once
  if (nc) {
    int t = threadIdx.x / nc, c = threadIdx.x % nc;
    while (t < frames) {
      const int i = t * nc + c;
      store_feature(out, (clip * frames + t) * channels + c0 + c,
                    suffix_pointwise(sig[i], est[i], sa), out_is_float);
      t += dt;
      c += dc;
      if (c >= nc) c -= nc, ++t;
    }
  }
  cluster_wait();
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
  const dim3 grid((unsigned)((total + kWarpsPerBlock - 1) / kWarpsPerBlock));
  stream_prefix_kernel<<<grid, kPrefixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      audio, batch, samples, frames,
      prefix_args(win, step, channels, fb_width, window, tw_r, tw_i, stw_r, stw_i, fb_idx, fb_wgt),
      out);
  return (int)cudaGetLastError();
}

// channels_per_thread: 1 or 4, a divisor of channels (the launch plan of
// ops/cuda_frontend.py)
extern "C" int kws_stream_suffix(const int* base, int windows, int stride, int frames,
                                 int channels, int smoothing_bits, int min_signal_remaining,
                                 int enable_pcan, int snr_shift, int enable_log,
                                 int correction_bits, int scale_shift, const int* sm,
                                 const int* om, const int* wdf_rows, const int* lut012,
                                 const int* log_lut, void* out, int out_is_float,
                                 int channels_per_thread, void* stream) {
  const SuffixArgs a = suffix_args(smoothing_bits, min_signal_remaining, enable_pcan, snr_shift,
                                   enable_log, correction_bits, scale_shift, sm, om, wdf_rows,
                                   lut012, log_lut);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels <= 0 || channels % channels_per_thread != 0) return (int)cudaErrorInvalidValue;
  switch (channels_per_thread) {
    case 1: return launch_suffix_cpt<1>(base, windows, stride, frames, channels, a, out, out_is_float, s);
    case 4: return launch_suffix_cpt<4>(base, windows, stride, frames, channels, a, out, out_is_float, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (frames <= 0 || (size_t)frames * channels * sizeof(int) > (size_t)kClipMaxBaseBytes) {
    return (int)cudaErrorInvalidValue;
  }
  const ClipLayout l = clip_layout(frames, channels);
  // above the 48 KB a block gets without it, opt in to more shared memory
  // (once per size: the attribute persists)
  static size_t opted = 48 * 1024;
  if (l.bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        clip_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
    if (err != cudaSuccess) return (int)err;
    opted = l.bytes;
  }
  const dim3 grid((unsigned)batch * kClipCluster);
  clip_features_kernel<<<grid, 32 * l.warps, l.bytes, static_cast<cudaStream_t>(stream)>>>(
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
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  fft_energy_kernel<<<grid, kPrefixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, rows,
      prefix_args(0, 0, 0, 0, nullptr, tw_r, tw_i, stw_r, stw_i, nullptr, nullptr), out);
  return (int)cudaGetLastError();
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
