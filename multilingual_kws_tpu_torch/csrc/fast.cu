// The fast frontend mode's noise-estimate recurrence for Hopper (sm_90a).
//
// noise_scan_f32  replaces multilingual_kws_tpu/ops/pallas_frontend.py::noise_estimate_scan
//                 (_nr_kernel): the integer-valued float32 recurrence of the JAX
//                 package's mode="fast",
//                   est_t = floor((sig_t * sb * sm + est_{t-1} * om) / nrb),
//                 carried from 0 at each window's first row.
//   The float semantics are those XLA gives that expression: one fused
//   multiply-add, fma(sig * sb, sm, est * om), then an IEEE division and the
//   floor. Every operation is an __f*_rn intrinsic, which nvcc never
//   contracts or reorders, so the result is == to the plain version in
//   ops/cuda_fast.py (which rounds the sum once through float64).
//   Window w reads rows w*stride .. w*stride+frames-1 of the (rows, channels)
//   signal: streams use stride 1, clip batches stride = frames, so the
//   (windows, frames, channels) gather never exists in memory.
//   Bound: bytes (4 bytes written per (window, frame, channel) for 6 float
//   operations; the rows it reads are shared by up to 49 windows and come
//   from L1/L2). Design: one thread per (window, channel) carries the
//   estimate in a register down the frames; neighbouring threads are
//   neighbouring channels, so reads and writes coalesce.
//
// Plain C interface for ctypes: device pointers and the stream as integers;
// each entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) noise_scan_f32_kernel(
    const float* __restrict__ base, int windows, int stride, int frames, int channels,
    const float* __restrict__ sm, const float* __restrict__ om, float sb, float nrb,
    float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)windows * channels) return;
  const int c = (int)(idx % channels);
  const long long w = idx / channels;
  const float smc = __ldg(sm + c), omc = __ldg(om + c);
  const float* row = base + w * stride * channels + c;
  float* o = out + w * frames * channels + c;
  float est = 0.0f;
  for (int t = 0; t < frames; ++t) {
    const float sig = __ldg(row + (long long)t * channels);
    est = floorf(__fdiv_rn(__fmaf_rn(__fmul_rn(sig, sb), smc, __fmul_rn(est, omc)), nrb));
    o[(long long)t * channels] = est;
  }
}

}  // namespace

extern "C" int kws_noise_scan_f32(const float* base, int windows, int stride, int frames,
                                  int channels, const float* sm, const float* om, float sb,
                                  float nrb, float* out, void* stream) {
  const long long total = (long long)windows * channels;
  const dim3 grid((unsigned)((total + kThreads - 1) / kThreads));
  noise_scan_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      base, windows, stride, frames, channels, sm, om, sb, nrb, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
