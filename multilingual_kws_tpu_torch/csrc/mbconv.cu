// The middle of the B0 trunk's MBConv block for Hopper (sm_90a), float32 inference:
// everything between the expand product and the project product, in one pass over a
// channels_last (NHWC) activation.
//
// mbconv_middle  replaces no Pallas kernel (XLA fused these stages into the TPU's
//         convolutions). On the card it replaces, per block, what the inference path
//         launched between the two 1x1 products: the expand BatchNorm + swish (bn_act),
//         the stride-2 pad, cuDNN's depthwise convolution, its BatchNorm + swish
//         (bn_act), the squeeze-excitation mean, its two small products with silu and
//         sigmoid, and the gate multiply: seven passes over the expanded tensor, by one
//         read of the block's input and one write of its gated output (and a re-read
//         and re-write of that output in L2).
//   Per sample, channel c, from the statistics and parameters as they are at the call
//   (nothing folded or cached):
//     a = swish(BN_expand(x))           on load (no expand: a = x), the halo zeros of a
//                                       (swish(BN(0)) is not 0, so the halo is not
//                                       loaded: it is the activated tensor's padding)
//     d = swish(BN_dw(depthwise(a)))    K = 3 or 5; stride 1: SAME (K / 2 each side);
//                                       stride 2: Keras' correct_pad, then VALID
//     m = mean of d over H' x W'
//     h = silu(W_reduce m + b_reduce),  g = sigmoid(W_expand h + b_expand)
//     out = d * g
//   BatchNorm is PyTorch's CPU inference formula, as bn_act's float32 (s = w /
//   sqrtf(var + eps), t = b - mean * s, y = x * s + t in one FMA); swish y / (1 +
//   exp(-y)) and sigmoid 1 / (1 + exp(-y)) by the fast float32 intrinsics (__expf,
//   __fdividef: a few ulps); float32 FFMA throughout, no TF32. The sums run in other
//   orders than cuDNN's and cuBLAS's, so the result differs from the module path by
//   float32 rounding.
//   Bound: bytes. The scan's 16 blocks read 178,144 and write 118,048 float32 values a
//   window: 2.90 ms at 8,192 windows and 3.35 TB/s. The work is ~1.9 M taps (FMAs) a
//   window and ~0.3 M activations, the SE products ~1.4 M FMAs: far from the card's
//   float32 rate, but the phases below are short, dependent and separated by
//   barriers, so on an H100 the kernel is bound by latency and instruction issue (its
//   device time is ~5x the bytes bound; the copies' waits are ~1 % of a block's time).
//   Design. A block of 256 threads takes `group` whole samples (the SE gate needs every
//   channel's mean before any output is final). It works in rounds, a chunk of
//   channels a round (about 4,096 input values): the round's input is copied into
//   shared memory [channel][pixel] by cp.async while the previous round computes
//   (double-buffered), then activated there in place (expand BatchNorm + swish); the
//   large planes of the first blocks carry an explicit zero halo there, so that the
//   taps test no bounds. A thread owns one channel of the chunk (its K x K taps and
//   coefficients in registers, loaded before the round waits for its input) and
//   computes 4 output rows of one column at a time, each input row's K values read
//   once for the 4 rows; then BatchNorm + swish, the channel's sum reduced over its
//   lanes with shuffles in a fixed order, and the round's activated output stored to
//   the output tensor through a small shared tile (a warp writes whole sectors). After
//   the last round the SE products run in the block (a warp a se_reduce row, a thread a
//   se_expand row, 16-byte loads of the weights from L2), and the gate pass multiplies
//   the block's own output in place: written moments before, it is read back from L2,
//   so device memory sees one read of the input and one write of the output. Where the
//   parameters outweigh a sample's activations (the blocks with 2 x 2 outputs, whose SE
//   weights are 221-442 KB) a block of threads takes up to 8 samples, so that each
//   weight read serves each of them.
//   Small batches (fewer samples than SMs: the fine-tune's 64, the live feed's 1-5)
//   take the split form: a block of threads a (sample, chunk of channels) runs one
//   round and writes its means, and a second launch computes a sample's SE and gates
//   its output in place. With the same lanes (threads a channel) both forms sum in the
//   same order and agree bit for bit.
//
// Plain C interface for ctypes: device pointers and the stream as integers; the entry
// point returns the first launch error (cudaError_t).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;      // output rows a thread computes at once (one column)
constexpr int kMaxGroup = 8;  // samples a block of threads takes at most
constexpr int kGateUnroll = 8;  // loads in flight a thread in the gate pass

struct Params {
  const float* x;  // (n, hin, win, e): the expand product's raw output, or the block input
  float* out;      // (n, hout, wout, e)
  float* means;    // (n, e): the split form's SE means
  const float *e_mean, *e_var, *e_weight, *e_bias;  // expand BatchNorm (null: no expand)
  const float* dw;                                  // (e, k, k)
  const float *d_mean, *d_var, *d_weight, *d_bias;  // depthwise BatchNorm
  const float *r_w, *r_b;                           // se_reduce (se, e), (se,)
  const float *x_w, *x_b;                           // se_expand (e, se), (e,)
  float e_eps, d_eps;
  int n, e, se, hin, win, hout, wout, pt, pl;
  int lanes;  // threads a channel in the taps (a power of two, at most 32)
  int group;  // samples a block of threads (the per-sample form)
  int pad;    // whether the input planes in shared memory carry their zero halo
  int wp;     // width of a sample's input plane in shared memory (win, or with the halo)
  int pp;     // its size (hin x win, or rows covering every tap of every item x wp)
  int psg;    // stride of a channel's input planes: the samples a round loads x pp, odd
  int osg;    // stride of a channel's output planes: the samples x hout x wout, odd
};

// swish and sigmoid by the fast float32 intrinsics (ex2.approx, rcp.approx: a few ulps;
// the IEEE expf and division cost ~20 more instructions a value, and the kernel is
// bound by instruction issue)
__device__ __forceinline__ float swish(float y) { return __fdividef(y, 1.0f + __expf(-y)); }

__device__ __forceinline__ float sigmoid(float y) { return __fdividef(1.0f, 1.0f + __expf(-y)); }

// channel c's BatchNorm as y = x * s + t (PyTorch's CPU inference formula)
__device__ __forceinline__ void coefficients(const float* mean, const float* var, const float* weight,
                                             const float* bias, float eps, int c, float& s,
                                             float& t) {
  s = __fdiv_rn(weight[c], sqrtf(__fadd_rn(var[c], eps)));
  t = __fsub_rn(bias[c], __fmul_rn(mean[c], s));
}

// n rounded up to a multiple of 4 (16 bytes of float32)
__host__ __device__ __forceinline__ size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Start the copy of channels c0 .. c0 + chunk of gn samples from x (channels_last rows
// of e values) into the interiors of their zero-padded planes in in_s[channel of the
// chunk], without waiting (cp.async). A thread keeps one channel and copies whole rows.
template <bool PAD>
__device__ __forceinline__ void issue_chunk(const Params& p, const float* __restrict__ x, int gn,
                                            int c0, int chunk, float* in_s) {
  const int cc = threadIdx.x % chunk, c = c0 + cc;
  if (c >= p.e) return;
  const int step = kThreads / chunk, rows = gn * p.hin;
  float* dst = in_s + cc * p.psg + (PAD ? p.pt * p.wp + p.pl : 0);
  for (int r = threadIdx.x / chunk; r < rows; r += step) {
    const int g = r / p.hin, ih = r - g * p.hin;
    const float* src = x + ((long long)r * p.win) * p.e + c;
    float* row = dst + g * p.pp + ih * p.wp;
    for (int iw = 0; iw < p.win; ++iw)
      __pipeline_memcpy_async(row + iw, src + (long long)iw * p.e, sizeof(float));
  }
}

// After the copy has landed: the expand BatchNorm (s, t: this thread's channel's
// coefficients) and swish, in place, on the values this thread copied (issue_chunk's
// pattern), so no barrier comes between. The halo stays zero: the activated tensor's
// padding.
template <bool PAD>
__device__ __forceinline__ void activate_chunk(const Params& p, int gn, int c0, int chunk,
                                               float* in_s, float s, float t) {
  const int cc = threadIdx.x % chunk, c = c0 + cc;
  if (c >= p.e) return;
  const int step = kThreads / chunk, rows = gn * p.hin;
  float* dst = in_s + cc * p.psg + (PAD ? p.pt * p.wp + p.pl : 0);
  for (int r = threadIdx.x / chunk; r < rows; r += step) {
    const int g = r / p.hin, ih = r - g * p.hin;
    float* row = dst + g * p.pp + ih * p.wp;
    for (int iw = 0; iw < p.win; ++iw) row[iw] = swish(__fmaf_rn(row[iw], s, t));
  }
}

// One channel plane of one sample: the depthwise taps on the activated input plane
// `in` (wp wide), the BatchNorm and swish, stored into `out` (hout x wout); returns
// this thread's share of the plane's sum. Lane l of the channel's `lanes` takes items
// l, l + lanes, ...: an item is 4 output rows of one column (rows past hout are
// computed and dropped). PAD: the plane carries its zero halo and covers every tap of
// every item, so the taps test no bounds; otherwise it is the bare hin x win and taps
// outside it read zero.
template <int K, int S, bool PAD>
__device__ __forceinline__ float dw_plane(const Params& p, const float* in, float* out,
                                          const float (&w)[K * K], float s, float t, int l) {
  constexpr int kIn = (kRows - 1) * S + K;  // input rows under an item
  const int items = (p.hout + kRows - 1) / kRows * p.wout;
  const int dband = p.lanes / p.wout, dow = p.lanes % p.wout;
  int band = l / p.wout, ow = l % p.wout;
  float sum = 0.0f;
  for (int j = l; j < items; j += p.lanes) {
    const int oh0 = band * kRows;
    const int ih0 = PAD ? oh0 * S : oh0 * S - p.pt, iw0 = PAD ? ow * S : ow * S - p.pl;
    const float* base = in + ih0 * p.wp + iw0;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      if (!PAD && (ih0 + i < 0 || ih0 + i >= p.hin)) continue;  // a halo row: zeros add nothing
      float v[K];
#pragma unroll
      for (int kw = 0; kw < K; ++kw)
        v[kw] = PAD || (iw0 + kw >= 0 && iw0 + kw < p.win) ? base[i * p.wp + kw] : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kh = i - r * S;  // a constant: the loops are unrolled
        if (kh >= 0 && kh < K) {
#pragma unroll
          for (int kw = 0; kw < K; ++kw) acc[r] = __fmaf_rn(w[kh * K + kw], v[kw], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int oh = oh0 + r;
      if (oh < p.hout) {
        const float y = swish(__fmaf_rn(acc[r], s, t));
        out[oh * p.wout + ow] = y;
        sum = __fadd_rn(sum, y);
      }
    }
    band += dband;
    ow += dow;
    if (ow >= p.wout) {
      ow -= p.wout;
      ++band;
    }
  }
  return sum;
}

// What a round's threads need of their channels' parameters, loaded before the round
// waits for its input: the expand BatchNorm's coefficients of the channel a thread
// loads (tid % chunk), the taps and the depthwise BatchNorm's coefficients of the
// channel it computes (tid / lanes).
template <int K>
struct RoundConsts {
  float es, et, w[K * K], ds, dt;
};

// Every load is issued before any is used (channels past e read channel e - 1's, and
// are never used), so a round waits for one L2 round trip, not one a parameter set.
template <int K, bool EXPAND>
__device__ __forceinline__ void round_consts(const Params& p, int c0, int chunk, RoundConsts<K>& r) {
  const int lc = min(c0 + (int)threadIdx.x % chunk, p.e - 1), dc = min(c0 + (int)threadIdx.x / p.lanes, p.e - 1);
  float em = 0.0f, ev = 0.0f, ew = 0.0f, eb = 0.0f;
  if (EXPAND) em = __ldg(p.e_mean + lc), ev = __ldg(p.e_var + lc), ew = __ldg(p.e_weight + lc), eb = __ldg(p.e_bias + lc);
  const float dm = __ldg(p.d_mean + dc), dv = __ldg(p.d_var + dc), dwt = __ldg(p.d_weight + dc), db = __ldg(p.d_bias + dc);
#pragma unroll
  for (int i = 0; i < K * K; ++i) r.w[i] = __ldg(p.dw + (size_t)dc * K * K + i);
  r.es = 1.0f, r.et = 0.0f;
  if (EXPAND) coefficients(&em, &ev, &ew, &eb, p.e_eps, 0, r.es, r.et);
  coefficients(&dm, &dv, &dwt, &db, p.d_eps, 0, r.ds, r.dt);
}

// The taps of channels c0 .. c0 + chunk for gn samples whose activated input planes lie
// in in_s (plane stride psg, sample g at g * pp): thread (cc = tid / lanes, lane) owns
// channel c0 + cc, with its taps and coefficients in r. Channel c's output plane of
// sample g goes to out_s[(c - out_c0) * ostride + g * hout * wout], its mean to
// means[g * mstride + c].
template <int K, int S, bool PAD>
__device__ __forceinline__ void dw_chunk(const Params& p, int c0, int gn, const float* in_s,
                                         float* out_s, int out_c0, int ostride, float* means,
                                         int mstride, const RoundConsts<K>& r) {
  const int cc = threadIdx.x / p.lanes, l = threadIdx.x % p.lanes, c = c0 + cc;
  const bool live = c < p.e;
  const int hw_out = p.hout * p.wout;
  for (int g = 0; g < gn; ++g) {
    float sum = 0.0f;
    if (live)
      sum = dw_plane<K, S, PAD>(p, in_s + cc * p.psg + g * p.pp,
                                out_s + (size_t)(c - out_c0) * ostride + g * hw_out, r.w, r.ds, r.dt, l);
    for (int off = p.lanes / 2; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    if (live && l == 0) means[(size_t)g * mstride + c] = __fdiv_rn(sum, (float)hw_out);
  }
}

// The SE of gn samples: vec holds their means [g][e] and receives their gates; hid
// [g][se] is scratch (both 16-byte aligned). se_reduce: a warp an output, its lanes over
// the weight row, read coalesced; se_expand: a thread a channel over its row. Where e
// (se_reduce) or se (se_expand) is a multiple of 4, a load takes 4 weights (16 bytes):
// the weights come from L2, whose latency the loads in flight hide. Every thread of the
// block reaches both barriers.
__device__ void se_gate(const Params& p, float* vec, float* hid, int gn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool rows4 = (p.e & 3) == 0 && ((uintptr_t)p.r_w & 15) == 0;
  for (int j = warp; j < p.se; j += kWarps) {
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;
    if (rows4) {
      const float4* row = reinterpret_cast<const float4*>(p.r_w + (size_t)j * p.e);
#pragma unroll 4
      for (int c4 = lane; c4 < p.e / 4; c4 += 32) {
        const float4 wv = __ldg(row + c4);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < gn) {
            const float4 m = *reinterpret_cast<const float4*>(vec + g * p.e + 4 * c4);
            acc[g] = __fmaf_rn(wv.x, m.x, acc[g]);
            acc[g] = __fmaf_rn(wv.y, m.y, acc[g]);
            acc[g] = __fmaf_rn(wv.z, m.z, acc[g]);
            acc[g] = __fmaf_rn(wv.w, m.w, acc[g]);
          }
        }
      }
    } else {
      const float* row = p.r_w + (size_t)j * p.e;
#pragma unroll 8
      for (int c = lane; c < p.e; c += 32) {
        const float wv = __ldg(row + c);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < gn) acc[g] = __fmaf_rn(wv, vec[g * p.e + c], acc[g]);
      }
    }
    const float b = __ldg(p.r_b + j);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < gn) {
        const float a = warp_sum(acc[g]);
        if (lane == 0) hid[g * p.se + j] = swish(__fadd_rn(a, b));
      }
    }
  }
  __syncthreads();
  const bool cols4 = (p.se & 3) == 0 && ((uintptr_t)p.x_w & 15) == 0;
  for (int c = threadIdx.x; c < p.e; c += kThreads) {
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;
    const float b = __ldg(p.x_b + c);
    if (cols4) {
      const float4* row = reinterpret_cast<const float4*>(p.x_w + (size_t)c * p.se);
#pragma unroll 4
      for (int j4 = 0; j4 < p.se / 4; ++j4) {
        const float4 wv = __ldg(row + j4);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < gn) {
            const float4 h = *reinterpret_cast<const float4*>(hid + g * p.se + 4 * j4);
            acc[g] = __fmaf_rn(wv.x, h.x, acc[g]);
            acc[g] = __fmaf_rn(wv.y, h.y, acc[g]);
            acc[g] = __fmaf_rn(wv.z, h.z, acc[g]);
            acc[g] = __fmaf_rn(wv.w, h.w, acc[g]);
          }
        }
      }
    } else {
      const float* row = p.x_w + (size_t)c * p.se;
#pragma unroll 8
      for (int j = 0; j < p.se; ++j) {
        const float wv = __ldg(row + j);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < gn) acc[g] = __fmaf_rn(wv, hid[g * p.se + j], acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < gn) vec[g * p.e + c] = sigmoid(__fadd_rn(acc[g], b));
  }
  __syncthreads();
}

// dst[q * e + c0 + c] = src[c * stride + q] for the hw pixels q and the nc channels c:
// a warp stores consecutive channels of a pixel
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src, int stride,
                                           int hw, int e, int c0, int nc) {
  const int dq = kThreads / nc, dc = kThreads % nc;
  int q = threadIdx.x / nc, c = threadIdx.x % nc;
  while (q < hw) {
    dst[(size_t)q * e + c0 + c] = src[c * stride + q];
    c += dc;
    q += dq;
    if (c >= nc) {
      c -= nc;
      ++q;
    }
  }
}

// Rounds k_begin .. k_end - 1 (a round: a chunk of channels of the gn samples from n0):
// the copy of the next round's input is in flight while a round computes. Each round
// writes its channels' activated depthwise output to p.out (staged in ob_s so that a
// warp stores whole sectors) and their means to means[g * mstride + c].
template <int K, int S, bool EXPAND, bool PAD>
__device__ __forceinline__ void rounds(const Params& p, long long n0, int gn, int k_begin, int k_end,
                                       float* smem, float* means, int mstride) {
  const int chunk = kThreads / p.lanes;
  const int hw_in = p.hin * p.win, hw_out = p.hout * p.wout;
  float* in_s = smem;                               // 2 x [chunk][psg]
  float* ob_s = in_s + 2 * (size_t)chunk * p.psg;   // [chunk][osg]
  const float* x = p.x + n0 * hw_in * p.e;
  if (PAD) {
    for (int i = threadIdx.x; i < 2 * chunk * p.psg; i += kThreads) in_s[i] = 0.0f;  // the halos
    __syncthreads();
  }
  issue_chunk<PAD>(p, x, gn, k_begin * chunk, chunk, in_s);
  __pipeline_commit();
  for (int k = k_begin; k < k_end; ++k) {
    const int c0 = k * chunk, nc = min(chunk, p.e - c0);
    float* buf = in_s + ((k - k_begin) & 1) * (size_t)chunk * p.psg;
    if (k + 1 < k_end)
      issue_chunk<PAD>(p, x, gn, c0 + chunk, chunk, in_s + ((k + 1 - k_begin) & 1) * (size_t)chunk * p.psg);
    __pipeline_commit();
    RoundConsts<K> rc;
    round_consts<K, EXPAND>(p, c0, chunk, rc);
    __pipeline_wait_prior(1);
    if (EXPAND) activate_chunk<PAD>(p, gn, c0, chunk, buf, rc.es, rc.et);
    __syncthreads();
    dw_chunk<K, S, PAD>(p, c0, gn, buf, ob_s, c0, p.osg, means, mstride, rc);
    __syncthreads();
    for (int g = 0; g < gn; ++g)
      store_rows(p.out + (n0 + g) * hw_out * p.e, ob_s + g * hw_out, p.osg, hw_out, p.e, c0, nc);
  }
  __syncthreads();
}

// The SE of the gn samples from n0, whose means are in vec_s, and their gates applied
// in place to their output (written by this grid's rounds; in the per-sample form by
// this block of threads just before, so still in L2), kGateUnroll loads in flight a
// thread.
__device__ __forceinline__ void se_and_gate(const Params& p, long long n0, int gn, float* vec_s,
                                            float* hid_s) {
  se_gate(p, vec_s, hid_s, gn);
  const int total = p.hout * p.wout * p.e;
  if ((p.e & 3) == 0) {  // four channels a thread a load: 16-byte accesses
    const int e4 = p.e / 4, total4 = total / 4, dc = kThreads % e4;
    for (int g = 0; g < gn; ++g) {
      float4* out = reinterpret_cast<float4*>(p.out + (n0 + g) * total);
      const float4* gate = reinterpret_cast<const float4*>(vec_s + g * p.e);
      int c = threadIdx.x % e4;  // the channel quad of element i = q * e / 4 + c
      for (int i = threadIdx.x; i < total4; i += kThreads * kGateUnroll) {
        float4 v[kGateUnroll];
        int ch[kGateUnroll];
#pragma unroll
        for (int u = 0; u < kGateUnroll; ++u) {
          const int iu = i + u * kThreads;
          ch[u] = c;
          if (iu < total4) v[u] = out[iu];
          c += dc;
          if (c >= e4) c -= e4;
        }
#pragma unroll
        for (int u = 0; u < kGateUnroll; ++u) {
          const int iu = i + u * kThreads;
          if (iu < total4) {
            const float4 gv = gate[ch[u]];
            out[iu] = make_float4(__fmul_rn(v[u].x, gv.x), __fmul_rn(v[u].y, gv.y), __fmul_rn(v[u].z, gv.z),
                                  __fmul_rn(v[u].w, gv.w));
          }
        }
      }
    }
    return;
  }
  const int dc = kThreads % p.e;
  for (int g = 0; g < gn; ++g) {
    float* out = p.out + (n0 + g) * total;
    const float* gate = vec_s + g * p.e;
    int c = threadIdx.x % p.e;  // the channel of element i = q * e + c
    for (int i = threadIdx.x; i < total; i += kThreads * kGateUnroll) {
      float v[kGateUnroll];
      int ch[kGateUnroll];
#pragma unroll
      for (int u = 0; u < kGateUnroll; ++u) {
        const int iu = i + u * kThreads;
        ch[u] = c;
        v[u] = iu < total ? out[iu] : 0.0f;
        c += dc;
        if (c >= p.e) c -= p.e;
      }
#pragma unroll
      for (int u = 0; u < kGateUnroll; ++u) {
        const int iu = i + u * kThreads;
        if (iu < total) out[iu] = __fmul_rn(v[u], gate[ch[u]]);
      }
    }
  }
}

// The per-sample form: a block of threads takes `group` whole samples.
template <int K, int S, bool EXPAND, bool PAD>
__global__ void __launch_bounds__(kThreads, 3) mbconv_fused_kernel(const Params p) {
  extern __shared__ float smem[];
  const int chunk = kThreads / p.lanes, chunks = (p.e + chunk - 1) / chunk;
  const long long n0 = (long long)blockIdx.x * p.group;
  const int gn = (int)min((long long)p.group, (long long)p.n - n0);
  float* vec_s = smem + (size_t)chunk * (2 * p.psg + p.osg);  // [group][e]: means, then gates
  float* hid_s = vec_s + round4(p.group * p.e);                // [group][se]
  rounds<K, S, EXPAND, PAD>(p, n0, gn, 0, chunks, smem, vec_s, p.e);
  se_and_gate(p, n0, gn, vec_s, hid_s);
}

// The split form, first launch: block (sample, chunk of channels) writes the activated
// depthwise output of its channels and their means.
template <int K, int S, bool EXPAND, bool PAD>
__global__ void __launch_bounds__(kThreads, 3) mbconv_chunk_kernel(const Params p) {
  extern __shared__ float smem[];
  const long long n = blockIdx.x;
  rounds<K, S, EXPAND, PAD>(p, n, 1, blockIdx.y, blockIdx.y + 1, smem, p.means + n * p.e, 0);
}

// The split form, second launch: the SE of `group` samples from their means, and their
// gates applied in place.
__global__ void __launch_bounds__(kThreads) mbconv_gate_kernel(const Params p) {
  extern __shared__ float smem[];
  const long long n0 = (long long)blockIdx.x * p.group;
  const int gn = (int)min((long long)p.group, (long long)p.n - n0);
  float* vec_s = smem;                        // [group][e]
  float* hid_s = smem + round4(p.group * p.e);  // [group][se]
  for (int i = threadIdx.x; i < gn * p.e; i += kThreads) vec_s[i] = p.means[n0 * p.e + i];
  __syncthreads();
  se_and_gate(p, n0, gn, vec_s, hid_s);
}

int max_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

// allow a kernel the opt-in shared memory (always the device's largest, so that a
// graph captured with one launch's size replays under the same setting)
template <typename Kernel>
cudaError_t allow(Kernel kernel, size_t smem) {
  if (smem > (size_t)max_smem()) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem());
}

template <int K, int S, bool EXPAND, bool PAD>
cudaError_t run(const Params& p, int split, cudaStream_t stream) {
  const size_t chunk = kThreads / p.lanes, chunks = (p.e + chunk - 1) / chunk;
  const size_t rounds_smem = sizeof(float) * chunk * (2 * (size_t)p.psg + p.osg);
  const size_t se_smem = sizeof(float) * (round4(p.group * p.e) + (size_t)p.group * p.se);
  const unsigned groups = (unsigned)((p.n + p.group - 1) / p.group);
  if (!split) {
    const auto kernel = mbconv_fused_kernel<K, S, EXPAND, PAD>;
    cudaError_t err = allow(kernel, rounds_smem + se_smem);
    if (err != cudaSuccess) return err;
    kernel<<<groups, kThreads, rounds_smem + se_smem, stream>>>(p);
    return cudaGetLastError();
  }
  const auto kernel = mbconv_chunk_kernel<K, S, EXPAND, PAD>;
  cudaError_t err = allow(kernel, rounds_smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)p.n, (unsigned)chunks), kThreads, rounds_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow(mbconv_gate_kernel, se_smem);
  if (err != cudaSuccess) return err;
  mbconv_gate_kernel<<<groups, kThreads, se_smem, stream>>>(p);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t run_k_s(const Params& p, int split, cudaStream_t stream) {
  if (p.e_mean) return p.pad ? run<K, S, true, true>(p, split, stream) : run<K, S, true, false>(p, split, stream);
  return p.pad ? run<K, S, false, true>(p, split, stream) : run<K, S, false, false>(p, split, stream);
}

}  // namespace

// x, out: (n, hin, win, e) and (n, hout, wout, e) float32 channels_last; means (n, e)
// scratch for the split form (null otherwise); e_*: the expand BatchNorm's running
// mean, var, weight, bias (all null: no expand); dw (e, k, k); d_*: the depthwise
// BatchNorm's; r_w (se, e), r_b (se,), x_w (e, se), x_b (e,): the SE products; k 3 or
// 5, s 1 or 2, pt and pl the top and left zero padding; lanes, group, pad, wp, pp, psg,
// osg and split from the wrapper's launch plan.
extern "C" int kws_mbconv_middle(const float* x, float* out, float* means, const float* e_mean,
                                 const float* e_var, const float* e_weight, const float* e_bias,
                                 float e_eps, const float* dw, const float* d_mean,
                                 const float* d_var, const float* d_weight, const float* d_bias,
                                 float d_eps, const float* r_w, const float* r_b, const float* x_w,
                                 const float* x_b, int n, int e, int se, int hin, int win,
                                 int hout, int wout, int k, int s, int pt, int pl, int lanes,
                                 int group, int pad, int wp, int pp, int psg, int osg,
                                 int split, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || group < 1 || group > kMaxGroup ||
      (split && !means))
    return (int)cudaErrorInvalidValue;
  const Params p{x,     out,   means, e_mean, e_var, e_weight, e_bias, dw,    d_mean,
                 d_var, d_weight, d_bias, r_w, r_b, x_w,    x_b,      e_eps, d_eps,
                 n,     e,     se,    hin,    win,   hout,     wout,   pt,    pl,
                 lanes, group, pad,   wp,    pp,  psg, osg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && s == 1) return (int)run_k_s<3, 1>(p, split, st);
  if (k == 3 && s == 2) return (int)run_k_s<3, 2>(p, split, st);
  if (k == 5 && s == 1) return (int)run_k_s<5, 1>(p, split, st);
  if (k == 5 && s == 2) return (int)run_k_s<5, 2>(p, split, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
