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
//   The first design (one 512-thread block per clip, two passes: the RMS
//   sums, then the mix reading every sample again from L2) reached 0.91 of
//   that bound at 2048 clips. At the fine-tune's 64 clips it ran 64 blocks
//   on 132 SMs, each thread walking ~31 samples twice with two block
//   reductions between the passes.
//   Design now, by batch (the launch picks; same arithmetic, same results):
//   - small batches (below half a block per SM: < 66 clips on an H100): a
//     thread block cluster of 2 to 8 blocks of 1024 threads per clip (two at
//     64 clips: 128 blocks), one pass over device memory. Block r of n takes
//     the r-th contiguous n-th of the clip; each thread loads its samples
//     (strided by the block, so a warp's loads are contiguous) once into
//     registers, eight at most, and sums their squares. The block reduces
//     its two partial sums; every block then reads the cluster's partials
//     from its peers' shared memory (distributed shared memory, after
//     cluster.sync()) and adds them in rank order, so all blocks of a clip
//     compute the same gain bit for bit. Then each thread mixes and
//     quantizes from its registers and stores.
//   - larger batches fill the card with one block per clip, and the first
//     design's two passes are the faster way there (no cluster launch, 36
//     registers instead of 62, so more blocks per SM): one 512-thread block
//     per clip, the second pass from L2.
//   Both sum in a fixed order (a shuffle tree in each warp, the warps in
//   order, then the blocks in order): no float atomics, so two launches on
//   the same inputs give the same bits. A GPU thread reads any sample
//   directly, so the TPU kernel's binary-decomposed lane rolls and
//   512-sample block gather are gone: the shift and the crop are index
//   arithmetic. The shift and the crop offset are random per clip, so a
//   row's samples are rarely 16-byte aligned with its output; loads stay 2-
//   and 4-byte, coalesced across the warp, which fills whole 128-byte
//   lines. Budget (-Xptxas -v, printed by chip_smoke.py at build): the
//   cluster kernel 62 registers and 264 bytes of shared memory per thread
//   block of 1024, the one-block kernel 36 registers and 128 bytes.
//   Measured at 64 clips (PERF.md), the cluster launch gains little over one
//   block per clip: most of the kernel's 7 us there is the latency of the
//   index loads, the data loads and the barriers in series.

// Plain C interface for ctypes: device pointers and the stream as integers;
// the entry point returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // blocks per clip at most (the portable cluster size)

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

// the sum over the block, in a fixed order: a shuffle tree in each warp,
// then the warps in order (thread 0's value is the block's)
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, s_warp[w]);
  return total;
}

__device__ __forceinline__ float mix_quantize(float f, float g, bool silence, float sv, float gain) {
  const float w =
      silence ? __fmul_rn(g, sv) : fminf(fmaxf(__fadd_rn(f, __fmul_rn(g, gain)), -1.0f), 1.0f);
  return fminf(fmaxf(truncf(__fmul_rn(w, 32768.0f)), -32768.0f), 32767.0f);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One clip per cluster of blocks (kCluster) or per block. Each thread keeps
// its first kPerThread samples (strided by the block) in registers and reads
// the rest, if any, again for the mix.
template <int kThreads, int kPerThread, bool kCluster>
__global__ void __launch_bounds__(kThreads) augment_quantize_kernel(
    const int16_t* __restrict__ fg_bank, int n_rows, long long t, const int* __restrict__ rows,
    const int* __restrict__ shifts, const uint8_t* __restrict__ is_silence,
    const float* __restrict__ bg_bank, int n_bg, long long bg_width, const int* __restrict__ bg_idx,
    const int* __restrict__ bg_off, const float* __restrict__ sil_vol,
    const float* __restrict__ volume, float inv_t, int16_t* __restrict__ out) {
  __shared__ float s_warp[2][kThreads / 32];
  __shared__ float s_block[2];  // this block's two partial sums, read by the cluster
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int blocks = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int b = blockIdx.x / blocks;
  const int row = rows[b], bi = bg_idx[b], off = bg_off[b];
  // an index outside its bank stops the kernel with an error, as PyTorch's
  // device-side index checks do (the wrapper cannot check without a sync)
  if (row < 0 || row >= n_rows || bi < 0 || bi >= n_bg || off < 0 || off > bg_width) __trap();
  const ClipSamples x{fg_bank + (long long)row * t, bg_bank + (long long)bi * bg_width + off, t,
                      bg_width - off, shifts[b]};
  const bool silence = is_silence[b] != 0;
  const long long span = (t + blocks - 1) / blocks;
  const long long j0 = rank * span + threadIdx.x, j1 = min((rank + 1) * span, t);
  const long long tail = j0 + (long long)kPerThread * kThreads;  // beyond the registers

  // the two sums of squares, each sample read once into registers (the
  // tail, if any, is read again below)
  float f[kPerThread > 0 ? kPerThread : 1], g[kPerThread > 0 ? kPerThread : 1];
  float sf = 0.0f, sb = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = j0 + (long long)k * kThreads;
    f[k] = j < j1 ? x.fg_at(j) : 0.0f;
    g[k] = j < j1 ? x.bg_at(j) : 0.0f;
    sf = __fadd_rn(sf, __fmul_rn(f[k], f[k]));
    sb = __fadd_rn(sb, __fmul_rn(g[k], g[k]));
  }
  for (long long j = tail; j < j1; j += kThreads) {
    const float fj = x.fg_at(j), gj = x.bg_at(j);
    sf = __fadd_rn(sf, __fmul_rn(fj, fj));
    sb = __fadd_rn(sb, __fmul_rn(gj, gj));
  }
  float tf = block_sum<kThreads>(sf, s_warp[0]);
  float tb = block_sum<kThreads>(sb, s_warp[1]);
  if (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      s_block[0] = tf;
      s_block[1] = tb;
    }
    cluster.sync();
    // the clip's sums: the cluster's partials in rank order, in every block
    tf = tb = 0.0f;
    for (int r = 0; r < blocks; ++r) {
      const float* p = cluster.map_shared_rank(s_block, r);
      tf = __fadd_rn(tf, p[0]);
      tb = __fadd_rn(tb, p[1]);
    }
    cluster_arrive();  // done with the peers' partials; wait for theirs before leaving
  }
  const float fg_rms = __fsqrt_rn(__fmul_rn(tf, inv_t));
  const float bg_rms = __fsqrt_rn(__fmul_rn(tb, inv_t));
  const float scaling = bg_rms > 0.0f ? __fdiv_rn(fg_rms, fmaxf(bg_rms, 1e-30f)) : 0.0f;
  const float gain = __fmul_rn(scaling, volume[b]);
  const float sv = sil_vol[b];

  // mix (or the silence crop) and the saturating int16 quantize
  int16_t* o = out + (long long)b * t;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long j = j0 + (long long)k * kThreads;
    if (j < j1) o[j] = (int16_t)mix_quantize(f[k], g[k], silence, sv, gain);
  }
  for (long long j = tail; j < j1; j += kThreads) {
    o[j] = (int16_t)mix_quantize(x.fg_at(j), x.bg_at(j), silence, sv, gain);
  }
  if (kCluster) cluster_wait();
}

}  // namespace

extern "C" int kws_augment_quantize(const int16_t* fg_bank, int n_rows, int batch, long long t,
                                    const int* rows, const int* shifts, const uint8_t* is_silence,
                                    const float* bg_bank, int n_bg, long long bg_width,
                                    const int* bg_idx, const int* bg_off, const float* sil_vol,
                                    const float* volume, float inv_t, int16_t* out, void* stream) {
  // blocks per clip: as many as give each SM about half a block (at 64
  // clips: two), up to kMaxCluster; one where the batch alone fills the card
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = std::min(kMaxCluster, std::max(1, (sms / 2 + batch - 1) / batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks == 1) {  // two passes, the second from L2
    augment_quantize_kernel<512, 0, false><<<batch, 512, 0, s>>>(
        fg_bank, n_rows, t, rows, shifts, is_silence, bg_bank, n_bg, bg_width, bg_idx, bg_off,
        sil_vol, volume, inv_t, out);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * blocks);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, augment_quantize_kernel<1024, 8, true>, fg_bank,
                                             n_rows, t, rows, shifts, is_silence, bg_bank, n_bg,
                                             bg_width, bg_idx, bg_off, sil_vol, volume, inv_t, out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
