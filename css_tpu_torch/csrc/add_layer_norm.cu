// KN: a Conformer block's residual add and the LayerNorm after it, in one
// launch for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses each residual add, the
// casts and the LayerNorm into the ops beside them inside the jitted
// forward (css_tpu/models/conformer.py, EncoderLayer). On the card each
// LayerNorm site of a block ran as four to five PyTorch kernels: the
// residual's multiply and add, a copy of the sum to float32, PyTorch's
// LayerNorm on float32, a copy back to the compute dtype. This kernel
// computes, for x (and y) of rows of C values,
//
//   r = round(x + alpha * y)              (r = x without y)
//   n = round((r - mean(r)) * rsqrt(var(r) + eps) * w + b)
//
// with the sum formed in float32 and rounded once to x's dtype (float32 or
// bf16), as PyTorch's x + alpha * y does, and the statistics (biased
// variance, as F.layer_norm) of the rounded r in float32; w and b are read
// in float32 through device pointers. It writes n, and r where the caller
// keeps it.
//
// Bound on this card: bytes. At the separator's (32, 150, 256) bf16 with
// y and r, x and y are read and r and n written once: 9.8 MB, 2.9 us at
// 3.35 TB/s; without y and r, 4.9 MB. The work is ~10 operations a value.
//
// Design. One warp a row, every value in registers: a lane holds kVecs
// 16-byte vectors of the row (8 bf16 or 4 float32 values each), vector k of
// lane l at channel V (l + 32 k), so each load instruction of a warp
// covers 512 consecutive bytes; x and y are loaded before any use, so the
// two loads are in flight together. The mean, then the sum of squared
// deviations from the registers, each by warp shuffles: no shared memory,
// no second read of the row. kWarps rows a block; the separator batch's
// 4,800 rows are 1,200 blocks, one wave on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // rows a block, one warp each
constexpr int kMaxChannels = 1024;  // the plan: C a multiple of 8, <= 1024
constexpr int kShapeRefused = -1;

struct Args {
  const void* x;
  const void* y;  // null: no residual, r = x
  void* r;        // null: the sum is not kept
  void* n;
  const float* w;
  const float* b;
  int rows;
  int channels;
  float alpha;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one 16-byte vector of values <-> float32
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // round to nearest even, as .to(bfloat16)
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// v rounded to T and back: the value a T store of v holds
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int kVecs>
__global__ void __launch_bounds__(kWarps * 32)
add_layer_norm_kernel(Args a) {
  constexpr int kV = 16 / sizeof(T);  // values a vector
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  const size_t base = (size_t)row * a.channels;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* y = a.y ? static_cast<const T*>(a.y) + base : nullptr;

  float v[kVecs][kV], u[kVecs][kV];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = kV * (lane + 32 * k);
    if (c < a.channels) {
      load16(x + c, v[k]);
      if (y) load16(y + c, u[k]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = kV * (lane + 32 * k);
    if (c >= a.channels) continue;
    if (y) {
      // x + alpha * y with each step rounded as PyTorch's two ops round
      // in float32 (no contraction into one fma), then once to T
#pragma unroll
      for (int i = 0; i < kV; ++i)
        v[k][i] =
            rounded<T>(__fadd_rn(v[k][i], __fmul_rn(a.alpha, u[k][i])));
      if (a.r) store16(static_cast<T*>(a.r) + base + c, v[k]);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) sum += v[k][i];
  }
  const float inv_c = 1.f / (float)a.channels;
  const float mean = warp_sum(sum) * inv_c;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (kV * (lane + 32 * k) >= a.channels) continue;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float d = v[k][i] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_c + a.eps);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = kV * (lane + 32 * k);
    if (c >= a.channels) continue;
#pragma unroll
    for (int i = 0; i < kV; i += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(a.w + c + i));
      const float4 b = __ldg(reinterpret_cast<const float4*>(a.b + c + i));
      v[k][i] = fmaf((v[k][i] - mean) * rstd, w.x, b.x);
      v[k][i + 1] = fmaf((v[k][i + 1] - mean) * rstd, w.y, b.y);
      v[k][i + 2] = fmaf((v[k][i + 2] - mean) * rstd, w.z, b.z);
      v[k][i + 3] = fmaf((v[k][i + 3] - mean) * rstd, w.w, b.w);
    }
    store16(static_cast<T*>(a.n) + base + c, v[k]);
  }
}

template <typename T>
void launch(const Args& a, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kMaxVecs = kMaxChannels / (32 * kV);
  const int vecs = (a.channels + 32 * kV - 1) / (32 * kV);
  const int blocks = (a.rows + kWarps - 1) / kWarps;
  if (vecs <= 1)
    add_layer_norm_kernel<T, 1><<<blocks, kWarps * 32, 0, s>>>(a);
  else if (vecs <= 2)
    add_layer_norm_kernel<T, 2><<<blocks, kWarps * 32, 0, s>>>(a);
  else if (vecs <= 4)
    add_layer_norm_kernel<T, 4><<<blocks, kWarps * 32, 0, s>>>(a);
  else
    add_layer_norm_kernel<T, kMaxVecs><<<blocks, kWarps * 32, 0, s>>>(a);
}

bool aligned(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

// x and y (rows, channels) in float32 (bf16 == 0) or bf16, y may be null;
// r (null: not written) and n the same shape and dtype; w and b float32
// (channels). Returns 0, a cudaError_t, or kShapeRefused for channels the
// plan does not take or an operand not 16-byte aligned.
extern "C" int css_add_layer_norm(const void* x, const void* y, void* r,
                                  void* n, const float* w, const float* b,
                                  int rows, int channels, float alpha,
                                  float eps, int bf16, int device,
                                  void* stream) {
  if (channels < 8 || channels > kMaxChannels || channels % 8 || rows < 0 ||
      !aligned(x) || !aligned(y) || !aligned(r) || !aligned(n) ||
      !aligned(w) || !aligned(b) || (r && !y))
    return kShapeRefused;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const Args a{x, y, r, n, w, b, rows, channels, alpha, eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch<__nv_bfloat16>(a, s);
  else
    launch<float>(a, s);
  return (int)cudaGetLastError();
}
