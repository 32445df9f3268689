// Rate probes for Hopper (sm_90a): what the card achieves per operation
// class, to price the frontend kernels' bounds against measured rates as
// well as against the data sheet.
//
// rate_chain  replaces tools_dev/vpu_roofline.py::_rate_kernel:
//   k dependent passes of one operation class over int32 (rows, 256), k a
//   runtime argument so that nvcc cannot fold the chain (with k constant it
//   could reduce k multiplies to a power), each pass written as volatile
//   PTX so that it cannot reassociate one either (x * y * y = x * y^2).
//   Classes: alu (x + y) ^ y, mul
//   x * y, cmpsel ((x & 1) == 0 ? y : x), and the cross-lane class, a warp
//   rotation by __shfl_sync (lane i takes lane i+1's value), the counterpart
//   of the TPU's lane roll. op "copy" reads x and writes it: the achievable
//   copy bandwidth. Arithmetic is uint32 (wraps, as int32 does on the TPU).
//   Bound: operations for the chains (k * ops per pass per element), bytes
//   for the copy. Design: 256 threads, 4 independent chains each (elements
//   256 apart, so each warp holds 32 consecutive elements per chain and the
//   rotation stays inside aligned groups of 32), enough warps in flight to
//   cover each operation's latency.
//
// dot_chain   replaces tools_dev/vpu_roofline.py::_dot_rate_kernel:
//   k dependent bf16 (rows, 256) @ (256, 256) products with float32
//   accumulation: x <- float32(bf16(x) @ w). Bound: operations (2 * 256 *
//   256 per row per pass on the tensor cores). Design: mma.sync m16n8k16
//   (bf16 in, f32 accumulate; wgmma and TMA are later work). One block of
//   8 warps per 64 rows keeps w (transposed, 128 KB) and its rows' bf16
//   operand (32 KB) in shared memory, rows padded by 8 elements so that
//   fragment loads do not conflict on banks; warp (m, h) computes rows
//   16m..16m+15 and columns 128h..128h+127, 16 accumulator tiles in
//   registers. Between passes the block writes its results back into the
//   operand tile as bf16.
//
// Plain C interface for ctypes: device pointers and the stream as integers;
// each entry point returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum RateOp { kAlu = 0, kMul = 1, kCmpSel = 2, kShuffle = 3, kCopy = 4 };
constexpr int kRateThreads = 256;
constexpr int kRateItems = 4;  // independent chains per thread

template <int OP>
__global__ void __launch_bounds__(kRateThreads) rate_chain_kernel(const uint32_t* __restrict__ x,
                                                                  const uint32_t* __restrict__ y,
                                                                  int k,
                                                                  uint32_t* __restrict__ out) {
  const long long base = (long long)blockIdx.x * kRateItems * kRateThreads + threadIdx.x;
  uint32_t v[kRateItems], w[kRateItems];
#pragma unroll
  for (int j = 0; j < kRateItems; ++j) {
    v[j] = __ldg(x + base + j * kRateThreads);
    w[j] = (OP == kAlu || OP == kMul || OP == kCmpSel) ? __ldg(y + base + j * kRateThreads) : 0u;
  }
  if (OP != kCopy) {
    const int src = (threadIdx.x + 1) & 31;
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < kRateItems; ++j) {
        if (OP == kAlu) {
          asm volatile("add.u32 %0, %0, %1;\n\txor.b32 %0, %0, %1;" : "+r"(v[j]) : "r"(w[j]));
        }
        if (OP == kMul) asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(v[j]) : "r"(w[j]));
        if (OP == kCmpSel) {
          asm volatile(
              "{\n\t.reg .b32 lo;\n\t.reg .pred even;\n\tand.b32 lo, %0, 1;\n\t"
              "setp.eq.u32 even, lo, 0;\n\tselp.b32 %0, %1, %0, even;\n\t}"
              : "+r"(v[j]) : "r"(w[j]));
        }
        if (OP == kShuffle) {
          asm volatile("shfl.sync.idx.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(v[j]) : "r"(src));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRateItems; ++j) out[base + j * kRateThreads] = v[j];
}

constexpr int kN = 256;           // the product's width and depth
constexpr int kDotRows = 64;      // rows per block: 4 m-tiles of 16
constexpr int kDotThreads = 256;  // 8 warps: 4 m-tiles x 2 column halves
constexpr int kLd = kN + 8;       // padded row of the bf16 tiles in shared memory
constexpr int kNTiles = kN / 2 / 8;  // 8-column tiles per warp
constexpr size_t kDotSmem = (size_t)(kDotRows + kN) * kLd * sizeof(__nv_bfloat16);

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kDotThreads, 1) dot_chain_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w_t, int k,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // (kDotRows, kLd) operand
  __nv_bfloat16* wt = as + kDotRows * kLd;                        // (kN, kLd) w transposed
  const long long row0 = (long long)blockIdx.x * kDotRows;
  const float* xb = x + row0 * kN;
  float* ob = out + row0 * kN;
  for (int i = threadIdx.x; i < kDotRows * kN; i += kDotThreads) {
    as[(i / kN) * kLd + i % kN] = __float2bfloat16_rn(__ldg(xb + i));
  }
  for (int i = threadIdx.x; i < kN * kN; i += kDotThreads) wt[(i / kN) * kLd + i % kN] = w_t[i];
  __syncthreads();
  if (k == 0) {  // the control: the same loads, and x unchanged
    for (int i = threadIdx.x; i < kDotRows * kN; i += kDotThreads) ob[i] = __ldg(xb + i);
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;  // mma fragment coordinates
  const int m0 = (warp % 4) * 16;
  const int n0 = (warp / 4) * (kN / 2);
  float acc[kNTiles][4];
  for (int pass = 0; pass < k; ++pass) {
#pragma unroll
    for (int t = 0; t < kNTiles; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kN; kk += 16) {
      const __nv_bfloat16* ar = as + (m0 + g) * kLd + kk + 2 * q;
      const uint32_t a0 = lds32(ar), a1 = lds32(ar + 8 * kLd);
      const uint32_t a2 = lds32(ar + 8), a3 = lds32(ar + 8 * kLd + 8);
#pragma unroll
      for (int t = 0; t < kNTiles; ++t) {
        const __nv_bfloat16* br = wt + (n0 + 8 * t + g) * kLd + kk + 2 * q;
        mma_bf16(acc[t], a0, a1, a2, a3, lds32(br), lds32(br + 8));
      }
    }
    __syncthreads();  // every warp has read this pass's operand
#pragma unroll
    for (int t = 0; t < kNTiles; ++t) {
      const int c = n0 + 8 * t + 2 * q;
      if (pass + 1 < k) {
        *reinterpret_cast<__nv_bfloat162*>(as + (m0 + g) * kLd + c) =
            __floats2bfloat162_rn(acc[t][0], acc[t][1]);
        *reinterpret_cast<__nv_bfloat162*>(as + (m0 + g + 8) * kLd + c) =
            __floats2bfloat162_rn(acc[t][2], acc[t][3]);
      } else {
        *reinterpret_cast<float2*>(ob + (m0 + g) * kN + c) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(ob + (m0 + g + 8) * kN + c) = make_float2(acc[t][2], acc[t][3]);
      }
    }
    __syncthreads();  // the next pass's operand is written
  }
}

}  // namespace

extern "C" int kws_rate_chain(const uint32_t* x, const uint32_t* y, long long n, int k, int op,
                              uint32_t* out, void* stream) {
  if (n % (kRateItems * kRateThreads) != 0 || op < kAlu || op > kCopy || k < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(n / (kRateItems * kRateThreads)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAlu: rate_chain_kernel<kAlu><<<grid, kRateThreads, 0, s>>>(x, y, k, out); break;
    case kMul: rate_chain_kernel<kMul><<<grid, kRateThreads, 0, s>>>(x, y, k, out); break;
    case kCmpSel: rate_chain_kernel<kCmpSel><<<grid, kRateThreads, 0, s>>>(x, y, k, out); break;
    case kShuffle: rate_chain_kernel<kShuffle><<<grid, kRateThreads, 0, s>>>(x, y, k, out); break;
    default: rate_chain_kernel<kCopy><<<grid, kRateThreads, 0, s>>>(x, y, k, out); break;
  }
  return (int)cudaGetLastError();
}

// w_t: w transposed, (n, k) row-major bf16
extern "C" int kws_dot_chain(const float* x, const void* w_t, long long rows, int k, float* out,
                             void* stream) {
  if (rows % kDotRows != 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dot_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDotSmem);
  if (err != cudaSuccess) return (int)err;
  dot_chain_kernel<<<(unsigned)(rows / kDotRows), kDotThreads, kDotSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const __nv_bfloat16*>(w_t), k, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
