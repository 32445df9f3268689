// The training pipeline's waveform augmentation and int16 quantization for
// Hopper (sm_90a), as one kernel.
//
// augment_quantize  replaces multilingual_kws_tpu/ops/pallas_augment.py::augment_kernel_call
//                   (_augment_quantize_kernel), and fuses the gather from the
//                   resident clip bank (dataset._resident_gather) before it and
//                   the background crop (pallas_augment.gather_bg_window plus the
//                   kernel's fine roll) into its reads.
//   Per clip: the time shift with zero fill, out[j] = fg[j - shift]; the
//   background crop bg[j] = bank[idx, off + j] (zero past the bank's width, as
//   the zero-padded bank gives); the RMS-equalized mix
//     rms = sqrt(sum(x*x) * (1/t)), scaling = bg_rms > 0 ? fg_rms / max(bg_rms, 1e-30) : 0,
//     wav = silence ? bg * sil_vol : clip(fg + bg * (scaling * volume), -1, 1);
//   and the saturating quantize clamp(trunc(wav * 32768), -32768, 32767) to int16.
//   Every float operation is the plain version's (ops/cuda_augment.py), one
//   rounding each (__fmul_rn / __fadd_rn: no contraction into FMA), so the
//   only difference left is the order of the two RMS sums: a mixed sample may
//   move by one int16 step, rarely; rows that are not mixed are ==.
//   Bound: bytes (per 1 s clip: 32 KB of int16 foreground, 64 KB of float32
//   background read, 32 KB of int16 written; 17 float ops per sample).
//   Design: one block per clip and two passes over it. Pass 1 reduces the
//   two sums of squares (warp shuffles, then shared memory); pass 2 reads the
//   same samples again, from L2, and writes the result. A GPU thread reads
//   any sample directly, so the TPU kernel's binary-decomposed lane rolls and
//   512-sample block gather are gone: the shift and the crop are index
//   arithmetic.
//
// Plain C interface for ctypes: device pointers and the stream as integers;
// the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct ClipSamples {
  const int16_t* fg;  // the clip's foreground row in the bank
  const float* bg;    // the background row, from the crop offset on
  long long t, bg_left;
  int shift;

  // foreground sample j after the shift, as a float in [-1, 1)
  __device__ __forceinline__ float fg_at(long long j) const {
    const long long k = j - shift;
    return (k >= 0 && k < t) ? __fmul_rn((float)fg[k], 1.0f / 32768.0f) : 0.0f;
  }
  __device__ __forceinline__ float bg_at(long long j) const { return j < bg_left ? bg[j] : 0.0f; }
};

__device__ __forceinline__ float block_sum(float v, float* s_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, s_red[w]);
  return total;
}

__global__ void __launch_bounds__(kThreads) augment_quantize_kernel(
    const int16_t* __restrict__ fg_bank, int n_rows, long long t, const int* __restrict__ rows,
    const int* __restrict__ shifts, const uint8_t* __restrict__ is_silence,
    const float* __restrict__ bg_bank, int n_bg, long long bg_width, const int* __restrict__ bg_idx,
    const int* __restrict__ bg_off, const float* __restrict__ sil_vol,
    const float* __restrict__ volume, float inv_t, int16_t* __restrict__ out) {
  __shared__ float s_red[2][kWarps];
  const int b = blockIdx.x;
  const int row = rows[b], bi = bg_idx[b], off = bg_off[b];
  // an index outside its bank stops the kernel with an error, as PyTorch's
  // device-side index checks do (the wrapper cannot check without a sync)
  if (row < 0 || row >= n_rows || bi < 0 || bi >= n_bg || off < 0 || off > bg_width) __trap();
  const ClipSamples x{fg_bank + (long long)row * t, bg_bank + (long long)bi * bg_width + off, t,
                      bg_width - off, shifts[b]};
  const bool silence = is_silence[b] != 0;

  // pass 1: the sums of squares of the shifted foreground and the crop
  float sf = 0.0f, sb = 0.0f;
  for (long long j = threadIdx.x; j < t; j += kThreads) {
    const float f = x.fg_at(j), g = x.bg_at(j);
    sf = __fadd_rn(sf, __fmul_rn(f, f));
    sb = __fadd_rn(sb, __fmul_rn(g, g));
  }
  sf = block_sum(sf, s_red[0]);
  sb = block_sum(sb, s_red[1]);
  const float fg_rms = __fsqrt_rn(__fmul_rn(sf, inv_t));
  const float bg_rms = __fsqrt_rn(__fmul_rn(sb, inv_t));
  const float scaling = bg_rms > 0.0f ? __fdiv_rn(fg_rms, fmaxf(bg_rms, 1e-30f)) : 0.0f;
  const float gain = __fmul_rn(scaling, volume[b]);
  const float sv = sil_vol[b];

  // pass 2: mix (or the silence crop) and the saturating int16 quantize
  int16_t* o = out + (long long)b * t;
  for (long long j = threadIdx.x; j < t; j += kThreads) {
    const float g = x.bg_at(j);
    const float w = silence ? __fmul_rn(g, sv)
                            : fminf(fmaxf(__fadd_rn(x.fg_at(j), __fmul_rn(g, gain)), -1.0f), 1.0f);
    const float q = fminf(fmaxf(truncf(__fmul_rn(w, 32768.0f)), -32768.0f), 32767.0f);
    o[j] = (int16_t)q;
  }
}

}  // namespace

extern "C" int kws_augment_quantize(const int16_t* fg_bank, int n_rows, int batch, long long t,
                                    const int* rows, const int* shifts, const uint8_t* is_silence,
                                    const float* bg_bank, int n_bg, long long bg_width,
                                    const int* bg_idx, const int* bg_off, const float* sil_vol,
                                    const float* volume, float inv_t, int16_t* out, void* stream) {
  augment_quantize_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fg_bank, n_rows, t, rows, shifts, is_silence, bg_bank, n_bg, bg_width, bg_idx, bg_off,
      sil_vol, volume, inv_t, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
