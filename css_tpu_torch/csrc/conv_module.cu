// KC: the Conformer block's conv module, eval forward, with the block's
// residual add, in one launch for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the module's chain inside
// the jitted forward (css_tpu/models/conformer.py, ConvModule). On the card
// the same chain ran as ~25-30 PyTorch kernels a block (casts, a LayerNorm,
// four broadcast affine ops, a sigmoid, a transposed depthwise conv,
// BatchNorm's casts and affine ops, ReLU, the residual add), each a node of
// the separator's captured graph. This kernel computes, for x (B, T, C),
//
//   u      = LayerNorm(x)                       (over C, eps ln_eps)
//   g      = (w1[0] u + b1[0]) * sigmoid(w1[1] u + b1[1])
//   v[t,c] = dw_b[c] + sum_j dw_w[c, j] g[t - pad_left + j, c]
//            (g zero outside [0, T): pad_left frames before, K-1-pad_left
//            after)
//   y      = x + w2 relu((v - mean) * (rsqrt(var + bn_eps) * bn_w) + bn_b) + b2
//
// with every intermediate in float32 and one rounding, at the store, to x's
// dtype (float32 or bf16). Every parameter is read through a device pointer
// in float32: no host read, no cast kernel.
//
// Design. A block owns one batch row and kFrames consecutive output frames,
// all C channels (C <= kThreads, a multiple of 4), one thread per channel in
// the tap stage:
//   1. the depthwise taps, staged through shared memory (float4 loads of the
//      [C][33] weight as it lies in memory, every load issued before any
//      store), land in each thread's registers (kMaxTaps of them, zero past
//      K: rows of 33 words put a warp's 32 channels in 32 banks);
//   2. the x rows of the kFrames + K - 1 frames the tile's taps read go to
//      shared memory in float32 over the taps' staging space (4 channels a
//      vector load, kLoads loads in flight a thread), the tile's own rows
//      also apart for the residual; then each warp normalises kPair rows at
//      once in place, a lane holding 4 consecutive channels a chunk in
//      registers (the mean, then the centred variance, then the GLU with
//      __expf and a fast divide: sigmoid(z) = 1 / (1 + e^-z));
//   3. each thread reads its channel's column of g once and accumulates the
//      kFrames outputs in registers (a compile-time unrolled sliding sum);
//   4. conv bias, BatchNorm on the running statistics, ReLU, the scalar
//      affine and the residual in registers, one coalesced store a frame.
//
// Bound on this card: bytes. At the separator's shape (32, 150, 256) bf16,
// x is read and y written once: 4.9 MB, 1.47 us at 3.35 TB/s. The taps are
// 2 B T C K = 80 MFLOP, far below that. What the kernel spends above the
// bound (15.9 us at that shape, bf16 or float32, NVIDIA H100 80GB HBM3 at
// 700 W; phases timed by cutting the kernel short): ~3 us the launch and
// the taps' staging, ~8.6 us the x rows and LayerNorm/GLU (each block
// stages K - 1 halo frames beyond its tile: 3x the tile's LayerNorm and GLU,
// whose exp and divide run on the special-function units, and 3x its x
// reads from L2), ~4 us the sums and the stores (528 FMAs a thread on the
// CUDA cores). 320 blocks of 8 warps, three resident on an SM (80
// registers, 64 KB of shared memory), one wave. Sharing the halo's g
// between the blocks of a cluster (distributed shared memory) is the next
// step down.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread per channel in the tap stage
constexpr int kMaxTaps = 33;   // taps kept in registers (zero past K)
constexpr int kFrames = 16;    // output frames per block
constexpr int kRows = kFrames + kMaxTaps - 1;  // g rows a block stages
constexpr int kChunks = kThreads / 128;  // 4-channel chunks a lane holds
constexpr int kLoads = 4;  // x loads in flight a thread while staging
constexpr int kPair = 2;   // rows a warp normalises at once
constexpr int kShapeRefused = -1;

struct Params {
  const float* ln_w;
  const float* ln_b;
  const float* pw1_w;  // [2]: the GLU's value and gate scales
  const float* pw1_b;  // [2]
  const float* dw_w;   // [C][K]
  const float* dw_b;   // [C]
  const float* bn_mean;
  const float* bn_var;
  const float* bn_w;
  const float* bn_b;
  const float* pw2_w;  // [1]
  const float* pw2_b;  // [1]
  float ln_eps;
  float bn_eps;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four consecutive values of x in one vector load (x 16-byte aligned,
// C a multiple of 4)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
conv_module_kernel(const T* __restrict__ x, T* __restrict__ y, Params p,
                   int frames, int channels, int taps, int pad_left) {
  // taps [C][kMaxTaps] first, then g [kRows][C]; x's rows of the tile's
  // own frames [kFrames][C] after them (the residual)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* res = smem + kRows * channels;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int c = threadIdx.x;
  const int quads = channels >> 2;

  // 1. taps into registers: every staging load issued before any store
  if (taps == kMaxTaps && reinterpret_cast<size_t>(p.dw_w) % 16 == 0) {
    // [C][33] as it lies in memory: float4 loads
    constexpr int kVec = (kThreads * kMaxTaps / 4 + kThreads - 1) / kThreads;
    const float4* src = reinterpret_cast<const float4*>(p.dw_w);
    float4 tap[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = threadIdx.x + k * kThreads;
      tap[k] = i < quads * kMaxTaps ? __ldg(src + i)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < quads * kMaxTaps) smem4[i] = tap[k];
    }
  } else {
    float tap[kMaxTaps];
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int ch = i / kMaxTaps, j = i - ch * kMaxTaps;
      tap[k] = ch < channels && j < taps ? __ldg(p.dw_w + ch * taps + j)
                                         : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < channels * kMaxTaps) smem[i] = tap[k];
    }
  }
  __syncthreads();
  float w[kMaxTaps];
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j)
    w[j] = c < channels ? smem[c * kMaxTaps + j] : 0.f;
  __syncthreads();  // the taps' space becomes g's

  // 2a. the x rows of frames t0 - pad_left + s into shared memory in
  // float32, 4 channels a vector load, a thread on one column of chunks
  // and kLoads rows in flight; rows outside [0, T) (and rows past those
  // the taps read) are the zero padding of g. The tile's own frames are
  // kept apart as well, for the residual.
  const int rows = kFrames + taps - 1;
  float4* g4 = smem4;
  float4* res4 = reinterpret_cast<float4*>(res);
  const int step = kThreads / quads;  // rows a pass
  const int q = threadIdx.x % quads;
  for (int s0 = threadIdx.x / quads; s0 < kRows; s0 += kLoads * step) {
    float v[kLoads][4];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int s = s0 + k * step;
      const int f = t0 - pad_left + s;
      if (step * quads > threadIdx.x && s < rows && f >= 0 && f < frames)
        load4(x + ((size_t)b * frames + f) * channels + 4 * q, v[k]);
      else
        v[k][0] = v[k][1] = v[k][2] = v[k][3] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int s = s0 + k * step;
      if (step * quads > threadIdx.x && s < kRows) {
        const float4 r = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
        g4[s * quads + q] = r;
        if (s >= pad_left && s < pad_left + kFrames)
          res4[(s - pad_left) * quads + q] = r;
      }
    }
  }
  __syncthreads();

  // 2b. LayerNorm and GLU in place, each warp on kPair rows at once: lane
  // l holds channels 4q..4q+3 for q = l + 32 i (kChunks chunks) of each,
  // the mean and then the centred variance taken from registers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float lw[kChunks][4], lb[kChunks][4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int qi = lane + 32 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lw[i][k] = qi < quads ? p.ln_w[4 * qi + k] : 0.f;
      lb[i][k] = qi < quads ? p.ln_b[4 * qi + k] : 0.f;
    }
  }
  const float a0 = p.pw1_w[0], a1 = p.pw1_w[1];
  const float c0 = p.pw1_b[0], c1 = p.pw1_b[1];
  const float inv_c = 1.f / (float)channels;
  constexpr int kWarps = kThreads / 32;
  for (int s0 = warp; s0 < rows; s0 += kPair * kWarps) {
    float v[kPair][kChunks][4];
    float sum[kPair], sq[kPair], mean[kPair], rstd[kPair];
#pragma unroll
    for (int r = 0; r < kPair; ++r) {
      const int s = s0 + r * kWarps;
      sum[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int qi = lane + 32 * i;
        const float4 x4 = s < rows && qi < quads
                              ? g4[s * quads + qi]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        v[r][i][0] = x4.x, v[r][i][1] = x4.y, v[r][i][2] = x4.z;
        v[r][i][3] = x4.w;
        sum[r] += (x4.x + x4.y) + (x4.z + x4.w);
      }
    }
#pragma unroll
    for (int r = 0; r < kPair; ++r) mean[r] = warp_sum(sum[r]) * inv_c;
#pragma unroll
    for (int r = 0; r < kPair; ++r) {
      sq[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        if (lane + 32 * i < quads) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float d = v[r][i][k] - mean[r];
            sq[r] = fmaf(d, d, sq[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPair; ++r)
      rstd[r] = rsqrtf(warp_sum(sq[r]) * inv_c + p.ln_eps);
#pragma unroll
    for (int r = 0; r < kPair; ++r) {
      const int s = s0 + r * kWarps;
      const int f = t0 - pad_left + s;
      if (s >= rows || f < 0 || f >= frames) continue;  // a zero row stays
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int qi = lane + 32 * i;
        if (qi < quads) {
          float g[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float u = fmaf((v[r][i][k] - mean[r]) * rstd[r], lw[i][k],
                                 lb[i][k]);
            // sigmoid as 1 / (1 + e^-z): 0 where e^-z overflows
            const float e = __expf(-fmaf(a1, u, c1));
            g[k] = __fdividef(fmaf(a0, u, c0), 1.f + e);
          }
          g4[s * quads + qi] = make_float4(g[0], g[1], g[2], g[3]);
        }
      }
    }
  }
  __syncthreads();
  if (c >= channels) return;

  // 3. the taps: g's column read once, kFrames sums in registers
  float acc[kFrames];
#pragma unroll
  for (int t = 0; t < kFrames; ++t) acc[t] = 0.f;
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const float g = smem[s * channels + c];
#pragma unroll
    for (int t = 0; t < kFrames; ++t) {
      const int j = s - t;
      if (j >= 0 && j < kMaxTaps) acc[t] = fmaf(w[j], g, acc[t]);
    }
  }

  // 4. bias, BatchNorm, ReLU, the scalar affine, the residual from shared
  // memory; one store a frame
  const float bias = p.dw_b[c];
  const float mean = p.bn_mean[c];
  const float scale = rsqrtf(p.bn_var[c] + p.bn_eps) * p.bn_w[c];
  const float shift = p.bn_b[c];
  const float a2 = p.pw2_w[0], c2 = p.pw2_b[0];
  T* out = y + ((size_t)b * frames + t0) * channels + c;
#pragma unroll
  for (int t = 0; t < kFrames; ++t) {
    if (t0 + t < frames) {
      float v = ((acc[t] + bias) - mean) * scale + shift;
      v = v < 0.f ? 0.f : v;  // ReLU that keeps a NaN, as F.relu
      store(out + (size_t)t * channels, res[t * channels + c] + (a2 * v + c2));
    }
  }
}

}  // namespace

// x (batch, frames, channels) in float32 (bf16 == 0) or bf16 -> y, same
// shape and dtype; every parameter float32 on the device. Returns 0, a
// cudaError_t, or kShapeRefused for channels or taps the plan does not take.
extern "C" int css_conv_module(
    const void* x, void* y, const float* ln_w, const float* ln_b,
    const float* pw1_w, const float* pw1_b, const float* dw_w,
    const float* dw_b, const float* bn_mean, const float* bn_var,
    const float* bn_w, const float* bn_b, const float* pw2_w,
    const float* pw2_b, int batch, int frames, int channels, int taps,
    int pad_left, float ln_eps, float bn_eps, int bf16, int device,
    void* stream) {
  if (channels < 4 || channels > kThreads || channels % 4 || taps < 1 ||
      taps > kMaxTaps || pad_left < 0 || pad_left > taps - 1 ||
      reinterpret_cast<size_t>(x) % 16)
    return kShapeRefused;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || frames == 0) return 0;
  const Params p{ln_w, ln_b, pw1_w, pw1_b, dw_w, dw_b, bn_mean, bn_var,
                 bn_w, bn_b, pw2_w, pw2_b, ln_eps, bn_eps};
  const dim3 grid((frames + kFrames - 1) / kFrames, batch);
  // 64 KB at 256 channels: three blocks an SM
  const size_t smem = (size_t)(kRows + kFrames) * channels * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    err = cudaFuncSetAttribute(conv_module_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_module_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        p, frames, channels, taps, pad_left);
  } else {
    err = cudaFuncSetAttribute(conv_module_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_module_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), p, frames,
        channels, taps, pad_left);
  }
  return (int)cudaGetLastError();
}
