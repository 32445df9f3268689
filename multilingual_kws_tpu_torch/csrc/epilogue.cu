// The B0 trunk's inference epilogue for Hopper (sm_90a): eval-mode BatchNorm,
// then optionally swish, then optionally a residual add, in one pass over a
// channels_last (NHWC) activation.
//
// bn_act  replaces no Pallas kernel (XLA fused these elementwise stages into
//         the TPU's convolutions); on the card it replaces cuDNN's BatchNorm
//         inference (bn_fw_inf_*), the swish (F.silu) after it and the
//         residual add, three passes over the activation, by one.
//   Per channel c, from the BatchNorm's statistics and affine parameters as
//   they are at the call (nothing is folded or cached, so a state loaded
//   later is read at the next call). float32:
//     s = weight[c] / sqrtf(var[c] + eps),  t = bias[c] - mean[c] * s
//   (PyTorch's CPU inference formula: sqrtf and an IEEE divide, not rsqrtf),
//   y = x * s + t (one FMA). bfloat16, in float32 by the formula of the
//   module path's kernel on the card (PyTorch's channels_last BatchNorm,
//   batch_norm_transform_input_channels_last_kernel), so that the two agree
//   bit for bit: y = weight[c] * (x - mean[c]) * rsqrtf(var[c] + eps) +
//   bias[c], the last product and the add one FMA. Then y = y / (1 +
//   expf(-y)) if act, y = y + r if a residual is given. bfloat16 rounds where
//   the module path rounds: the BatchNorm result is rounded to bfloat16
//   (Flax's BatchNorm(dtype=...)), the swish is taken in float32 on that
//   value and rounded again (F.silu on a bfloat16 tensor), and the add is a
//   float32 add of the two bfloat16 values, rounded (torch's bfloat16 add).
//   Bound: bytes. 2 float ops of BatchNorm and ~4 of swish per value against
//   8 bytes read and written in float32 (12 with the residual).
//   Design: a channels_last tensor is (rows = N*H*W, C) row-major. A thread
//   owns one group of V consecutive channels (16 bytes: 4 float32 or 8
//   bfloat16) and walks rows: it computes its V scales and shifts once, in
//   registers, then streams 16-byte vector loads and stores with four rows in
//   flight. The block is (groups of a row) x (rows), so a warp's accesses are
//   one contiguous span of memory; rows of the grid stride through the
//   tensor. Enough blocks to hold every SM's 2,048 thread slots, at any site
//   (the smallest in the scan is the top's 1280 x 2 x 2 at batch 8192: 32,768
//   rows of 320 float4 groups). A C that is not a multiple of V, or an
//   unaligned pointer, takes the same kernel with V = 1.
//
// Plain C interface for ctypes: device pointers and the stream as integers;
// the entry point returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kThreadsPerSm = 2048;

// V values of T at p, as float
__device__ __forceinline__ void load(const float* p, float* v, int V) {
  if (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v, int V) {
  if (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ void store(float* p, const float* v, int V) {
  if (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v, int V) {
  if (V == 8) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// y rounded to T's precision and back (the module path's rounding points)
__device__ __forceinline__ float rounded(float y, float*) { return y; }
__device__ __forceinline__ float rounded(float y, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(y));
}

// Channel c's BatchNorm for T (the note above): float32, PyTorch's CPU
// formula x * a + b (the module path's kernel on the card is cuDNN's, whose
// formula is not public); bfloat16, PyTorch's channels_last kernel's
// w * (x - m) * a + b
__device__ __forceinline__ void coefficients(float*, float mean, float var, float weight, float bias,
                                             float eps, float& a, float& b, float& m) {
  a = __fdiv_rn(weight, sqrtf(__fadd_rn(var, eps)));
  b = __fsub_rn(bias, __fmul_rn(mean, a));
  m = 0.0f;
}
__device__ __forceinline__ void coefficients(__nv_bfloat16*, float mean, float var, float weight,
                                             float bias, float eps, float& a, float& b, float& m) {
  a = rsqrtf(__fadd_rn(var, eps));
  b = bias;
  m = mean;
}
__device__ __forceinline__ float batchnorm(float*, float x, float a, float b, float, float) {
  return __fmaf_rn(x, a, b);
}
__device__ __forceinline__ float batchnorm(__nv_bfloat16*, float x, float a, float b, float m,
                                           float w) {
  return __fmaf_rn(__fmul_rn(w, __fsub_rn(x, m)), a, b);
}

template <typename T, int V, bool ACT, bool RES>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ weight,
    const float* __restrict__ bias, float eps, long long rows, int channels,
    T* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= channels / V) return;
  float s[V], t[V], m[V], w[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = g * V + k;
    coefficients(out, mean[c], var[c], weight[c], bias[c], eps, s[k], t[k], m[k]);
    w[k] = weight[c];
  }
  const long long stride = (long long)gridDim.y * blockDim.y;
  const long long col = (long long)g * V;
  for (long long r0 = (long long)blockIdx.y * blockDim.y + threadIdx.y; r0 < rows;
       r0 += stride * kUnroll) {
    float v[kUnroll][V], rv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * stride;
      if (r < rows) {
        load(x + r * channels + col, v[u], V);
        if (RES) load(res + r * channels + col, rv[u], V);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * stride;
      if (r < rows) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float y = rounded(batchnorm(out, v[u][k], s[k], t[k], m[k], w[k]), out);
          if (ACT) y = rounded(__fdiv_rn(y, __fadd_rn(1.0f, expf(-y))), out);
          if (RES) y = __fadd_rn(y, rv[u][k]);
          v[u][k] = y;
        }
        store(out + r * channels + col, v[u], V);
      }
    }
  }
}

template <typename T, int V>
cudaError_t launch_v(const T* x, const T* res, const float* mean, const float* var,
                     const float* weight, const float* bias, float eps, long long rows,
                     int channels, int act, T* out, int sms, cudaStream_t stream) {
  const int groups = channels / V;
  const int xblocks = (groups + kThreads - 1) / kThreads;
  const int bx = (groups + xblocks - 1) / xblocks;
  const int by = kThreads / bx;
  const long long fill = (long long)sms * (kThreadsPerSm / (bx * by)) / xblocks;
  const long long need = (rows + by - 1) / by;
  const dim3 grid(xblocks, (unsigned)(need < fill ? need : (fill > 0 ? fill : 1)));
  const dim3 block(bx, by);
#define KWS_LAUNCH(A, R)                                                                   \
  bn_act_kernel<T, V, A, R><<<grid, block, 0, stream>>>(x, res, mean, var, weight, bias, \
                                                        eps, rows, channels, out)
  if (act && res) KWS_LAUNCH(true, true);
  else if (act) KWS_LAUNCH(true, false);
  else if (res) KWS_LAUNCH(false, true);
  else KWS_LAUNCH(false, false);
#undef KWS_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const float* mean, const float* var,
                   const float* weight, const float* bias, float eps, long long rows,
                   int channels, int act, void* out, int sms, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x | (uintptr_t)res | (uintptr_t)out) % 16 == 0;
  if (channels % kVec == 0 && aligned)
    return launch_v<T, kVec>(static_cast<const T*>(x), static_cast<const T*>(res), mean, var,
                             weight, bias, eps, rows, channels, act, static_cast<T*>(out), sms,
                             stream);
  return launch_v<T, 1>(static_cast<const T*>(x), static_cast<const T*>(res), mean, var, weight,
                        bias, eps, rows, channels, act, static_cast<T*>(out), sms, stream);
}

}  // namespace

// x, res (null: no residual), out: (rows, channels) in dtype 0 (float32) or
// 1 (bfloat16); mean, var, weight, bias: float32 (channels,)
extern "C" int kws_bn_act(const void* x, const void* res, const float* mean, const float* var,
                          const float* weight, const float* bias, float eps, long long rows,
                          int channels, int dtype, int act, void* out, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, res, mean, var, weight, bias, eps, rows, channels, act, out, sms, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, res, mean, var, weight, bias, eps, rows, channels, act,
                                      out, sms, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
