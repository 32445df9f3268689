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
//   256 per row per pass on the tensor cores; 0.2128 ms at k = 64 on 25,088
//   rows at the data sheet's 989 TFLOP/s). The first design (mma.sync
//   m16n8k16 fed by 32-bit shared loads, one 8-warp block per 64 rows, two
//   block barriers a pass) ran at 0.32 of that rate on an NVIDIA H100 80GB
//   HBM3 at 700 W (PERF.md): mma.sync does not reach Hopper's tensor rate.
//   Design: wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate, 128
//   registers a thread), both operands read from shared memory through
//   matrix descriptors, in the K-major layout with the 128-byte swizzle
//   (swz). A block stages w^T (128 KB) once, with bulk copies that complete
//   on an mbarrier, from the swizzled image the wrapper makes
//   (probes/rates.py::swizzled_w). Each of its warpgroups owns one 64-row
//   tile (32 KB): per pass 16 wgmmas over K = 256, commit, wait, then it
//   writes its bf16 results back into its own operand, fences them for the
//   async proxy and syncs on a named barrier of its 128 threads, never the
//   whole block, so one warpgroup's write-back overlaps the others'
//   products. Three warpgroups (3 x 32 KB + 128 KB of shared memory, 167
//   registers) put 392 tiles in 131 blocks, one wave on 132 SMs. Measured
//   and rejected (PERF.md): one warpgroup a block (392 blocks, one an SM:
//   three waves, no overlap) and two (196 blocks, a wave and a half).
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

constexpr int kN = 256;                       // the product's width and depth
constexpr int kTileRows = 64;                 // rows per warpgroup: one wgmma M
constexpr int kSlabBytes = 128;               // a swizzled row of one 64-column slab
constexpr int kTileBytes = kTileRows * kN * 2;  // a warpgroup's bf16 operand, 32 KB
constexpr int kWBytes = kN * kN * 2;          // w transposed, 128 KB
constexpr int kWChunk = 16384;                // bytes per bulk copy of w
constexpr int kDotWarpgroups = 3;             // 64-row tiles per block
// w, the warpgroups' operands, the mbarrier, and room to align to 1024
constexpr size_t kDotSmemBytes = (size_t)kWBytes + (size_t)kDotWarpgroups * kTileBytes + 16 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of element (r, c) of a (rows, 256) bf16 operand in the
// canonical K-major layout with the 128-byte swizzle: four slabs of 64
// columns, each rows x 128 bytes; in row r the 16-byte chunk j of a slab
// sits at chunk j ^ (r % 8). w's image in device memory
// (probes/rates.py::swizzled_w) uses the same layout, so its copy is linear.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * kSlabBytes + r * kSlabBytes +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// wgmma matrix descriptor: K-major, 128-byte swizzle, 8-row groups 1024
// bytes apart (SBO), leading offset unused by this layout (1)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 256 over the warpgroup, 128 floats a thread) = A @ B^T + scale_d * d
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void fence_operands(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Three warpgroups per block, each owning one 64-row tile of x; the block's
// warpgroups share w. Every pass: 16 wgmmas over K = 256, wait, write the
// bf16 results back into the warpgroup's own operand, make them visible to
// the next pass's wgmmas; the warpgroups never wait for each other, so one's
// epilogue overlaps another's products.
__global__ void __launch_bounds__(128 * kDotWarpgroups, 1) dot_chain_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w_img, long long tiles, int k,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ws = smem;  // w, swizzled
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  unsigned char* as = smem + kWBytes + wg * kTileBytes;  // this warpgroup's operand
  const uint32_t bar = smem_addr(smem + kWBytes + kDotWarpgroups * kTileBytes);
  const long long tile = (long long)blockIdx.x * kDotWarpgroups + wg;

  // one thread stages w with bulk copies that complete on an mbarrier
  if (k > 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (k > 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(kWBytes)
                 : "memory");
    for (int i = 0; i < kWBytes / kWChunk; ++i) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
              smem_addr(ws + i * kWChunk)),
          "l"(reinterpret_cast<const unsigned char*>(w_img) + i * kWChunk), "r"(kWChunk), "r"(bar)
          : "memory");
    }
  }
  if (tile >= tiles) return;  // a ragged last block: its warpgroup 0 always has a tile
  const float* xt = x + tile * kTileRows * kN;
  float* ot = out + tile * kTileRows * kN;
  if (k == 0) {  // the control: x unchanged, read and written once, nothing staged
    for (int i = t; i < kTileRows * kN / 4; i += 128) {
      reinterpret_cast<float4*>(ot)[i] = __ldg(reinterpret_cast<const float4*>(xt) + i);
    }
    return;
  }

  // x as bf16 into the swizzled operand: a 16-byte chunk (8 columns) each
  for (int i = t; i < kTileRows * kN / 8; i += 128) {
    const int r = i / (kN / 8), c = (i % (kN / 8)) * 8;
    const float4 lo = __ldg(reinterpret_cast<const float4*>(xt + r * kN + c));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(xt + r * kN + c + 4));
    *reinterpret_cast<uint4*>(as + swz(kTileRows, r, c)) =
        make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                   pack_bf16(hi.z, hi.w));
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  warpgroup_sync(1 + wg);
  asm volatile(
      "{\n.reg .pred done;\nw_wait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra w_wait;\n}" ::"r"(bar)
      : "memory");

  // accumulator element 4j + e: row 16 * warp + lane / 4 (+8 for e >= 2),
  // column 8j + 2 * (lane % 4) (+1 for odd e)
  const int warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const uint32_t a_base = smem_addr(as), b_base = smem_addr(ws);
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int pass = 0; pass < k; ++pass) {
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into a slab
      wgmma_m64n256k16(d, gmma_desc(a_base + (kk / 4) * kTileRows * kSlabBytes + off),
                       gmma_desc(b_base + (kk / 4) * kN * kSlabBytes + off), kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(d);
    if (pass + 1 == k) break;
    warpgroup_sync(1 + wg);  // every warp's products have read the operand
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int c = 8 * j + c0;
      *reinterpret_cast<uint32_t*>(as + swz(kTileRows, r0, c)) = pack_bf16(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(as + swz(kTileRows, r0 + 8, c)) =
          pack_bf16(d[4 * j + 2], d[4 * j + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // generic writes -> wgmma reads
    warpgroup_sync(1 + wg);
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int c = 8 * j + c0;
    *reinterpret_cast<float2*>(ot + r0 * kN + c) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(ot + (r0 + 8) * kN + c) = make_float2(d[4 * j + 2], d[4 * j + 3]);
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

// w_img: w transposed, (n, k) bf16, in the swizzled layout of swz(256, n, k)
extern "C" int kws_dot_chain(const float* x, const void* w_img, long long rows, int k, float* out,
                             void* stream) {
  if (rows % kTileRows != 0 || k < 0) return (int)cudaErrorInvalidValue;
  static bool opted = false;  // the attribute persists: set it once
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        dot_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDotSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const long long tiles = rows / kTileRows;
  dot_chain_kernel<<<(unsigned)((tiles + kDotWarpgroups - 1) / kDotWarpgroups), 128 * kDotWarpgroups,
                     kDotSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const __nv_bfloat16*>(w_img), tiles, k, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
