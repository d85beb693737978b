// K2: the fused LSTM recurrence for Hopper (sm_90a): the whole time loop of
// one (layer, direction) in one persistent, cooperative launch.
//
// Replaces the Pallas kernel css_tpu/ops/lstm_pallas.py:lstm_fused (body
// _lstm_kernel), which runs the loop as a sequential grid=(T,) with h, c
// and W_hh resident in VMEM. With xw (B, T, 4h) the input projections plus
// biases and W_hh (h, 4h), gate order i, f, g, o, each step computes
//
//   gates = xw[:, t] + h_{t-1} @ W_hh                    (float32)
//   c_t   = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)  (float32)
//   h_t   = sigmoid(o) * tanh(c_t)   rounded to the input type, which is
//           both the output out[:, t] and the next step's product input
//
// with h_{-1} = c_{-1} = 0 and t running backward when `reverse` is set.
// float32 inputs are multiplied in full FP32 FMAs on the CUDA cores (never
// TF32), matching the JAX package's Precision.HIGHEST; bf16 inputs are
// widened to float32, whose products are exact, and summed in float32,
// matching DEFAULT-precision bf16 x bf16 -> f32.
//
// Design. Blocks run in parallel and carry nothing from one launch to the
// next, so the time loop lives inside the kernel and a grid-wide barrier
// (cooperative_groups::this_grid().sync()) separates the steps; the launch
// is cooperative and refused unless every block is co-resident, which the
// host side checks first (a block that never starts would hang the barrier).
//   * Block j owns `units` hidden units across all four gates, so its gate
//     math and cell state are local: c stays in registers for the whole
//     loop and never reaches device memory.
//   * Its W_hh columns (h x 4*units, widened to float32, the four gates of
//     a unit side by side as one float4) are loaded into shared memory once
//     and stay there for all T steps: 32 KB at h = 512, units = 4; 128 KB at
//     the causal h = 1024, units = 8 (dynamic shared memory above 48 KB).
//   * Each step every block stages the full h_{t-1} (B x h) from L2 into
//     shared memory, row-major, in column chunks when it does not fit beside
//     W_hh. h_{t-1} is read straight from out[:, t-1] (out[:, t+1] when
//     reversed), which the previous step wrote: no separate state buffer.
//     Those loads bypass L1 (ld.global.cg), since other blocks wrote them;
//     a warp reads consecutive 16-byte quads of one row, so every sector it
//     fetches is used whole.
//   * The (B x h) @ (h x 4*units) product: each thread owns a tile of 4
//     batch rows x one unit's 4 gates (16 accumulators) over a slice of k;
//     per 4 k it reads one float4 of h per row and one float4 of weights
//     per k (all broadcast or conflict-free across lanes) for 64 FMAs. The
//     k slices are summed through shared memory, then one thread per
//     (row, unit) adds xw, applies the gates and writes h_t.
//   * xw is read in place with its (B, T, 4h) strides, and the time index
//     T-1-s of a reversed run is computed here: no transposed copy (the TPU
//     wrapper swaps xw to time-major). A step's xw loads are issued before
//     its product and first used after it, which hides their latency.
//
// Bound on this card. One launch at the BLSTM's main shape (B 32, T 150,
// h 512, float32): the product is 2 * 32 * 150 * 512 * 2048 = 10.07 GFLOP,
// 0.150 ms at the 67 TFLOP/s FP32 CUDA-core peak; the bytes are xw 39.3 MB
// + W_hh 4.2 MB + out 9.8 MB = 53.3 MB, 0.016 ms at 3.35 TB/s. So
// operations bound it (at the causal h = 1024: 40.3 GFLOP, 0.60 ms). The
// serial chain of T - 1 grid barriers and the per-step L2 -> SM broadcast
// of h_{t-1} to every block are a latency floor that the bound does not
// count. Tensor cores (mma.sync / wgmma) for the per-step product, and
// thread-block clusters multicasting h_{t-1}, are later work.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;   // batch rows of a thread's product tile
constexpr int kItems = 4;  // (row, unit) cells a thread updates, at most
constexpr int kInFlight = 8;  // h quads a thread loads before storing any

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype/.to do
}

// Four consecutive values of h, loaded raw from L2 only (other blocks wrote
// them last step, so L1 may hold stale lines) and widened later, so that a
// thread can have several loads in flight before it waits on the first.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = __ldcg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void widen(float (&v)[4]) const {
    v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  uint2 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldcg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void widen(float (&v)[4]) const {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_kernel(const T* __restrict__ xw, const T* __restrict__ w_hh, T* out,
            int batch, int steps, int hidden, int units, int chunk,
            int hstride, int reverse) {
  extern __shared__ float4 smem4[];
  // a product tile's kRows batch rows are bt, bt + nbt, bt + 2*nbt, ...:
  // the lanes of a warp then read consecutive rows of h_s, whose stride
  // (hstride = 4 mod 32 words) puts them in distinct banks
  const int nbt = (batch + kRows - 1) / kRows;
  const int bpad = nbt * kRows;
  const int tiles = nbt * units;
  const int ksplit = kThreads / tiles;  // >= 1: the host checks it
  const int hq = (hidden + 3) / 4;
  float4* w_s = smem4;                            // [4*hq][units] (i,f,g,o)
  float4* part = w_s + (size_t)4 * hq * units;    // [ksplit*tiles][kRows]
  float* h_s = reinterpret_cast<float*>(part + kThreads * kRows);
                                                  // [bpad][hstride]
  const int tid = threadIdx.x;
  const int unit0 = blockIdx.x * units;
  const int h4 = 4 * hidden;

  for (int idx = tid; idx < 4 * hq * units; idx += kThreads) {
    const int k = idx / units;
    const int unit = unit0 + idx % units;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < hidden && unit < hidden) {  // padding rows and units stay zero
      const T* row = w_hh + (size_t)k * h4 + unit;
      w = make_float4(to_f32(row[0]), to_f32(row[hidden]),
                      to_f32(row[2 * hidden]), to_f32(row[3 * hidden]));
    }
    w_s[idx] = w;
  }
  for (int idx = tid; idx < bpad * hstride; idx += kThreads) h_s[idx] = 0.f;

  // the product tile this thread owns: rows bt + r*nbt, unit uu_t, and
  // the ks-th slice of each chunk's k quads
  const int tile = tid % tiles;
  const int ks = tid / tiles;
  const bool in_product = ks < ksplit;
  const int bt = tile / units;
  const int uu_t = tile % units;
  const bool vec4 = hidden % 4 == 0;
  const int n_items = batch * units;

  float c_reg[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) c_reg[i] = 0.f;
  cg::grid_group grid = cg::this_grid();
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;

    T x_reg[kItems][4];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      const int unit = unit0 + item % units;
#pragma unroll
      for (int g = 0; g < 4; ++g) x_reg[i][g] = from_f32<T>(0.f);
      if (item < n_items && unit < hidden) {
        const T* src = xw + ((size_t)(item / units) * steps + t) * h4 + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g) x_reg[i][g] = src[g * hidden];
      }
    }

    if (s > 0) {
      const int tp = reverse ? t + 1 : t - 1;
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;

      for (int k0 = 0; k0 < hidden; k0 += chunk) {
        const int kc = min(chunk, hidden - k0);
        const int quads = (kc + 3) / 4;
        const int total = batch * quads;
        if (k0 > 0) __syncthreads();  // the last chunk is consumed
        // stage h_{t-1}[:, k0:k0+kc] as [row][k]: the lanes of a warp read
        // consecutive quads of one row (whole sectors, coalesced) and store
        // them as consecutive float4s; kInFlight loads per thread are
        // issued before the first store waits on one
        for (int base = tid; base < total; base += kThreads * kInFlight) {
          Quad<T> q[kInFlight];
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            const int idx = base + j * kThreads;
            const int kk = (idx % quads) * 4;
            if (idx < total && vec4 && kk + 4 <= kc)
              q[j].load(out + ((size_t)(idx / quads) * steps + tp) * hidden +
                        k0 + kk);
          }
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            const int idx = base + j * kThreads;
            if (idx >= total) break;
            const int b = idx / quads;
            const int kk = (idx % quads) * 4;
            float v[4];
            if (vec4 && kk + 4 <= kc) {
              q[j].widen(v);
            } else {  // a ragged quad: the columns past kc are zero
              const T* src = out + ((size_t)b * steps + tp) * hidden + k0 + kk;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = kk + e < kc ? to_f32(__ldcg(src + e)) : 0.f;
            }
            *reinterpret_cast<float4*>(h_s + b * hstride + kk) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
        __syncthreads();
        if (in_product) {
          const int lo = quads * ks / ksplit;
          const int hi = quads * (ks + 1) / ksplit;
          const float* hrow = h_s + bt * hstride + 4 * lo;
          const float4* wk = w_s + (size_t)(k0 + 4 * lo) * units + uu_t;
#pragma unroll 2
          for (int qd = lo; qd < hi; ++qd, hrow += 4, wk += 4 * units) {
            float hr[kRows][4];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 v = *reinterpret_cast<const float4*>(
                  hrow + r * nbt * hstride);
              hr[r][0] = v.x; hr[r][1] = v.y; hr[r][2] = v.z; hr[r][3] = v.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 w = wk[e * units];
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                acc[r][0] = fmaf(hr[r][e], w.x, acc[r][0]);
                acc[r][1] = fmaf(hr[r][e], w.y, acc[r][1]);
                acc[r][2] = fmaf(hr[r][e], w.z, acc[r][2]);
                acc[r][3] = fmaf(hr[r][e], w.w, acc[r][3]);
              }
            }
          }
        }
      }
      if (in_product) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          part[(ks * tiles + tile) * kRows + r] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      const int b = item / units;
      const int uu = item % units;
      const int unit = unit0 + uu;
      if (item >= n_items || unit >= hidden) continue;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      if (s > 0) {
        const float4* p =
            part + ((b % nbt) * units + uu) * kRows + b / nbt;
        for (int q = 0; q < ksplit; ++q, p += tiles * kRows) {
          const float4 v = *p;
          dot[0] += v.x; dot[1] += v.y; dot[2] += v.z; dot[3] += v.w;
        }
      }
      const float ig = sigmoid(to_f32(x_reg[i][0]) + dot[0]);
      const float fg = sigmoid(to_f32(x_reg[i][1]) + dot[1]);
      const float gg = tanhf(to_f32(x_reg[i][2]) + dot[2]);
      const float og = sigmoid(to_f32(x_reg[i][3]) + dot[3]);
      const float c = fg * c_reg[i] + ig * gg;
      c_reg[i] = c;
      out[((size_t)b * steps + t) * hidden + unit] =
          from_f32<T>(og * tanhf(c));
    }
    if (s + 1 < steps) grid.sync();  // h_t complete in every block
  }
}

template <typename T>
int launch(const void* xw_v, const void* w_hh_v, void* out_v, int batch,
           int steps, int hidden, int reverse, int device,
           cudaStream_t stream) {
  int nsm = 0, smem_max = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  // one block per SM at most: `units` hidden units each
  int units = (hidden + nsm - 1) / nsm;
  const int blocks = (hidden + units - 1) / units;
  const int bpad = (batch + kRows - 1) / kRows * kRows;
  if (bpad / kRows * units > kThreads) return -1;  // too many product tiles
  // shared memory: W_hh's slice (rows padded to a multiple of 4), the
  // product's partial sums, and h_{t-1} in chunks of `chunk` columns (a
  // multiple of 32, or all of h) with rows `hstride` = 4 mod 32 floats apart
  const int hq = (hidden + 3) / 4;
  const size_t fixed = (size_t)4 * hq * units * sizeof(float4) +
                       (size_t)kThreads * kRows * sizeof(float4);
  if (fixed >= (size_t)smem_max) return -1;  // W_hh's slice won't fit
  const int cap = ((int)((smem_max - fixed) / (bpad * sizeof(float))) - 4) /
                  32 * 32;
  if (cap < 32) return -1;
  int chunk = std::min(cap, 4 * hq);
  int hstride = (chunk + 31) / 32 * 32 + 4;
  const size_t smem = fixed + (size_t)bpad * hstride * sizeof(float);

  auto kern = lstm_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * nsm < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;

  const T* xw = static_cast<const T*>(xw_v);
  const T* w_hh = static_cast<const T*>(w_hh_v);
  T* out = static_cast<T*>(out_v);
  void* args[] = {&xw, &w_hh, &out,   &batch,   &steps,
                  &hidden, &units, &chunk, &hstride, &reverse};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// xw (B, T, 4h), w_hh (h, 4h), out (B, T, h): contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1). Returns 0 when launched, -1 for a
// shape the kernel does not take, else the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be
// co-resident).
extern "C" int css_lstm(const void* xw, const void* w_hh, void* out,
                        int batch, int steps, int hidden, int reverse,
                        int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || steps == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(xw, w_hh, out, batch, steps, hidden,
                                      reverse, device, s)
              : launch<float>(xw, w_hh, out, batch, steps, hidden, reverse,
                              device, s);
}
