// K2: the fused LSTM recurrence for Hopper (sm_90a): the whole time loop of
// one (layer, direction) in one persistent launch of thread-block clusters.
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
// with h_{-1} = c_{-1} = 0 and t running backward when `reverse` is set;
// or, for a chunk of a stream, from a carried state: h_{-1} = h0 (in the
// input type, placed by the wrapper where step 0 reads h_{t-1}) and c_{-1}
// = c0 (float32), with the final c written to c_out (the final h is
// out[:, T-1]). The c carry stays float32, as inside one launch, so
// launches chained over chunks compute what one launch over the whole
// sequence computes.
// The product runs on the tensor cores with mma.sync and float32 sums:
// bf16 operands in one m16n8k16 bf16 product each (bf16 x bf16 products
// are exact in float32, as DEFAULT-precision bf16 x bf16 -> f32); float32
// operands in 3xTF32 (m16n8k8: each operand split into a TF32 high part
// and its remainder, a_hi b_hi + a_hi b_lo + a_lo b_hi), which keeps ~21
// of float32's 24 bits per product against the JAX package's
// Precision.HIGHEST, and never rounds an operand to TF32 alone. (The
// split is a mask and a subtraction: with cvt.rna.tf32.f32 the product
// took about twice as long on the H100, and FP32 FMAs on the CUDA cores
// were slower than 3xTF32; PERF.md has the measurements.)
//
// Design. Blocks run in parallel and carry nothing from one launch to the
// next, so the time loop lives inside the kernel and a grid-wide barrier
// separates the steps: every block needs all of h_{t-1}.
//   * Block j owns `units` hidden units across all four gates (columns
//     n = 4u + gate of its slice), so its gate math and cell state are
//     local: c stays in registers for the whole loop.
//   * Its W_hh columns (hpad x 4*units, padded to `wstride` columns, = 8
//     or 24 mod 32 words, so the B-fragment reads are conflict-free)
//     are loaded into shared memory once and stay there for all T steps:
//     as float32, or in the bf16 path as bf16 pairs along k.
//   * h_t goes to out[:, t] and to a double-buffered state (2, B, hpad),
//     whose rows are padded to 32 bytes, so that a row is one bulk copy.
//   * The grid is launched as clusters of 8 blocks. Each step, block r of
//     a cluster copies rows [B*r/C, B*(r+1)/C) of h_{t-1} from L2 with TMA
//     bulk copies multicast to all blocks of the cluster
//     (.multicast::cluster), which land at the same shared-memory offset
//     in each and complete on each one's mbarrier. So a cluster reads h_{t-1} from L2 once, not once per
//     block: ~1 MB of L2 reads a step at the main shape instead of 8 MB.
//     When h_{t-1} does not fit beside W_hh it is staged in column chunks,
//     with a cluster barrier before each later chunk (every peer has
//     consumed the last one). Rows of h_s are `hstride` elements apart, 16
//     mod 128 bytes, so the A-fragment reads are conflict-free.
//   * The grid barrier is an arrival counter: after writing its h_t slice
//     (and a __syncthreads) one thread of each block does a release-add;
//     before staging, one thread per block spins on an acquire load until
//     every block has arrived. A block arrives only after it has read
//     everything of the step, so the next step's copies never overwrite
//     shared memory that a peer still reads. There is no cooperative
//     launch, so the host checks first that all clusters can be
//     co-resident (cudaOccupancyMaxActiveClusters) and refuses the launch
//     otherwise (-2: the wrapper raises); and a wait that never ends traps
//     after ~10 s rather than hanging the card.
//   * The (B x hpad) @ (hpad x 4*units) product: each of the 8 warps takes
//     an eighth of each chunk's k steps and all (16-row, 8-column) output
//     tiles of the block (at most 2 x 6: B <= 32 per launch, units <= 12),
//     so its sums stay in registers; the 8 partial products meet in shared
//     memory (over h_s, which is free by then), and one thread per (row,
//     unit) adds them and xw, applies the gates and writes h_t.
//   * xw is read in place with its (B, T, 4h) strides, and the time index
//     T-1-s of a reversed run is computed here: no transposed copy (the TPU
//     wrapper swaps xw to time-major). A step's xw loads are issued before
//     the barrier wait and first used after the product.
//   * With a non-null `phases`, thread 0 of each block adds up clock64()
//     cycles of four phases over steps 1..T-1 (barrier wait; staging, i.e.
//     the copies and chunk barriers; the product; the rest: partial sums,
//     gates, stores and the arrival) and writes them to phases[block][4]
//     at the end.
//   * With a carried state (`h0` set) step 0 runs the product as every
//     later step does, on the h0 rows in state slot 1; its grid barrier
//     (target 0) is met at once. Without one, step 0 skips the product.
//
// Bound on this card. One launch at the BLSTM's main shape (B 32, T 150,
// h 512, float32): the product is 2 * 32 * 150 * 512 * 2048 = 10.07 GFLOP,
// 0.150 ms at the 67 TFLOP/s FP32 CUDA-core peak; the bytes are xw 39.3 MB
// + W_hh 4.2 MB + out 9.8 MB = 53.3 MB, 0.016 ms at 3.35 TB/s. So
// operations bound it (at the causal h = 1024: 40.3 GFLOP, 0.60 ms). The
// serial chain of T - 1 grid barriers and the per-step broadcast of
// h_{t-1} to every block are a latency floor that the bound does not
// count.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;    // blocks a cluster
constexpr int kWarps = kThreads / 32;
constexpr int kRowsS = 32;     // rows of h_s: at most 32 batch rows a launch
constexpr int kMaxCols = 48;   // gate columns of a block: at most 12 units
constexpr int kMaxMTiles = kRowsS / 16;  // mma tiles of 16 rows
constexpr int kMaxNTiles = kMaxCols / 8;  // and of 8 gate columns
constexpr int kItems = 2;      // (row, unit) cells a thread updates, at most
static_assert(kRowsS * kMaxCols / 4 <= kThreads * kItems,
              "every (row, unit) cell of a launch has a thread");

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's share of the block's product C (rows x gate columns) = h_s
// (rows hstride elements apart) @ W_s (rows wstride words apart), over the
// k steps it is given; then its partial C into shared memory, row stride
// npad floats.
template <typename T>
struct Product;

// The product's fragments, as in the PTX ISA's mma layouts, with g = lane
// / 4 and q = lane % 4: A (16 x k) rows g and g + 8, B (k x 8) column g;
// the accumulators rows g and g + 8, columns 2q and 2q + 1. Both fragment
// reads are conflict-free (hstride = 16 mod 128 bytes, wstride = 8 or 24
// mod 32 words). A warp owns all (16-row, 8-column) tiles of the block.
template <int kTerms>
struct Tiles {
  float acc[kTerms][kMaxMTiles][kMaxNTiles][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int m = 0; m < kMaxMTiles; ++m)
#pragma unroll
        for (int n = 0; n < kMaxNTiles; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][m][n][q] = 0.f;
  }
  // the sum of the terms' accumulators, to part (row stride npad floats)
  __device__ __forceinline__ void store(float* part, int npad) const {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
    for (int m = 0; m < kMaxMTiles; ++m)
#pragma unroll
      for (int n = 0; n < kMaxNTiles; ++n)
        if (8 * n < npad) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = acc[kTerms - 1][m][n][e];
#pragma unroll
            for (int i = kTerms - 2; i >= 0; --i) v[e] += acc[i][m][n][e];
          }
          float* p = part + (m * 16 + g) * npad + n * 8 + 2 * q;
          *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(p + 8 * npad) = make_float2(v[2], v[3]);
        }
  }
};

// x = hi + lo exactly, hi with TF32's 10 mantissa bits (x truncated); the
// tensor core reads lo's top 10 mantissa bits, so hi + lo keeps 21 of x's
// 24 bits and a product of two splits is good to ~2^-21 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float32: 3xTF32 on the tensor cores, mma.sync m16n8k8: a b = a_hi b_hi +
// (a_hi b_lo + a_lo b_hi), the small cross terms in their own accumulators
// (independent mma chains), summed at the end in float32.
template <>
struct Product<float> : Tiles<2> {
  static constexpr int kStep = 8;
  __device__ __forceinline__ void step(const float* h_s, const float* w_s,
                                       int hstride, int wstride, int kk,
                                       int kw, int npad) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    const int nt = npad / 8;
    uint32_t a_hi[kMaxMTiles][4], a_lo[kMaxMTiles][4];
#pragma unroll
    for (int m = 0; m < kMaxMTiles; ++m) {
      const float* p = h_s + (m * 16 + g) * hstride + kk + q;
      split_tf32(p[0], a_hi[m][0], a_lo[m][0]);
      split_tf32(p[8 * hstride], a_hi[m][1], a_lo[m][1]);
      split_tf32(p[4], a_hi[m][2], a_lo[m][2]);
      split_tf32(p[8 * hstride + 4], a_hi[m][3], a_lo[m][3]);
    }
#pragma unroll
    for (int n = 0; n < kMaxNTiles; ++n) {
      if (n < nt) {
        const float* p = w_s + (kw + q) * wstride + n * 8 + g;
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        split_tf32(p[0], b0_hi, b0_lo);
        split_tf32(p[4 * wstride], b1_hi, b1_lo);
#pragma unroll
        for (int m = 0; m < kMaxMTiles; ++m) {
          mma_tf32(acc[0][m][n], a_lo[m], b0_hi, b1_hi);
          mma_tf32(acc[0][m][n], a_hi[m], b0_lo, b1_lo);
          mma_tf32(acc[1][m][n], a_hi[m], b0_hi, b1_hi);
        }
      }
    }
  }
};

// bf16: mma.sync m16n8k16 with float32 sums (each bf16 x bf16 product is
// exact in float32). W_s holds bf16 pairs along k: word (kp, n) =
// W[2kp][n], W[2kp+1][n].
template <>
struct Product<__nv_bfloat16> : Tiles<1> {
  static constexpr int kStep = 16;
  __device__ __forceinline__ void step(const __nv_bfloat16* h_s,
                                       const uint32_t* w_s, int hstride,
                                       int wstride, int kk, int kw,
                                       int npad) {
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    const int nt = npad / 8;
    uint32_t a[kMaxMTiles][4];
#pragma unroll
    for (int m = 0; m < kMaxMTiles; ++m) {
      const __nv_bfloat16* p = h_s + (m * 16 + g) * hstride + kk + 2 * q;
      a[m][0] = *reinterpret_cast<const uint32_t*>(p);
      a[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * hstride);
      a[m][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * hstride + 8);
    }
#pragma unroll
    for (int n = 0; n < kMaxNTiles; ++n) {
      if (n < nt) {
        const uint32_t* p = w_s + (kw / 2 + q) * wstride + n * 8 + g;
        const uint32_t b0 = p[0], b1 = p[4 * wstride];
#pragma unroll
        for (int m = 0; m < kMaxMTiles; ++m)
          mma_bf16(acc[0][m][n], a[m], b0, b1);
      }
    }
  }
};

// W_s's element type: float32 values, or bf16 pairs along k in 32 bits
template <typename T>
struct WType { using type = float; };
template <>
struct WType<__nv_bfloat16> { using type = uint32_t; };

__device__ __forceinline__ uint32_t w_pair(const __nv_bfloat16* w_hh,
                                           size_t idx, size_t next, bool lo_ok,
                                           bool hi_ok) {
  const uint16_t lo =
      lo_ok ? __bfloat16_as_ushort(w_hh[idx]) : (uint16_t)0;
  const uint16_t hi =
      hi_ok ? __bfloat16_as_ushort(w_hh[next]) : (uint16_t)0;
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// A wait that has not ended after this many cycles (~10 s) never will (a
// block that never started, a copy that never landed): trap, so that the
// launch fails with an error instead of hanging the card.
constexpr long long kWatchdogCycles = 20000000000LL;

__device__ __forceinline__ void watchdog(long long start) {
  if (clock64() - start > kWatchdogCycles) __trap();
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, P1;\n\t"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) watchdog(start);
}

// bytes from global src to shared dst in every block of `mask`, at the same
// offset in each, completing on each one's mbarrier at offset `bar`
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// one arrival at the grid barrier, after (release) every write of the block
// that the barrier made visible to this thread
__device__ __forceinline__ void arrive_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// order this thread's generic-proxy global accesses with the async proxy
// (the TMA copies that read the state)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lstm_kernel(const T* __restrict__ xw, const T* __restrict__ w_hh, T* out,
            T* state, unsigned* counter, long long* phases,
            const float* __restrict__ c0, float* c_out, int h0, int batch,
            int steps, int hidden, int hpad, int units, int wstride,
            int chunk, int hstride, int reverse) {
  using W = typename WType<T>::type;
  constexpr int kStep = Product<T>::kStep;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  extern __shared__ float4 smem4[];
  const int npad = (4 * units + 7) / 8 * 8;  // gate columns, padded
  W* w_s = reinterpret_cast<W*>(smem4);  // [w_rows][wstride]
  const int w_rows = hpad * (int)sizeof(T) / 4;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(w_s + (size_t)w_rows * wstride);
  T* h_s = reinterpret_cast<T*>(mbar + 2);  // [kRowsS][hstride]
  // the warps' partial products, over h_s once the last chunk is read
  float* part = reinterpret_cast<float*>(h_s);  // [kWarps][kRowsS][npad]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int unit0 = blockIdx.x * units;
  const int h4 = 4 * hidden;
  const uint32_t bar = smem_addr(mbar);

  // W_hh's slice: column n = 4u + gate is W_hh[:, gate * h + unit0 + u]
#pragma unroll 8
  for (int idx = tid; idx < w_rows * wstride; idx += kThreads) {
    const int r = idx / wstride;
    const int n = idx - r * wstride;
    const int unit = unit0 + n / 4;
    const bool col_ok = n < 4 * units && unit < hidden;
    const size_t col = (size_t)(n % 4) * hidden + unit;
    if constexpr (sizeof(T) == 4) {
      w_s[idx] = col_ok && r < hidden ? w_hh[(size_t)r * h4 + col] : 0.f;
    } else {
      const int k = 2 * r;
      w_s[idx] = col_ok ? w_pair(w_hh, (size_t)k * h4 + col,
                                 (size_t)(k + 1) * h4 + col, k < hidden,
                                 k + 1 < hidden)
                        : 0u;
    }
  }
  for (int idx = tid; idx < kRowsS * hstride; idx += kThreads)
    h_s[idx] = from_f32<T>(0.f);
  // the copies (async proxy) land after these zeros (generic proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's mbarrier is initialised before any copy can reach it
  cluster.sync();

  const int n_items = batch * units;
  // the rows of h_{t-1} this block copies for its cluster
  const int r_lo = batch * rank / csize;
  const int r_hi = batch * (rank + 1) / csize;
  const uint16_t mask = (uint16_t)((1u << csize) - 1);
  const unsigned nblocks = gridDim.x;

  // this thread's cells' c: c0's rows, or zero
  float c_reg[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int item = tid + i * kThreads;
    const int unit = unit0 + item % units;
    c_reg[i] = c0 != nullptr && item < n_items && unit < hidden
                   ? c0[(size_t)(item / units) * hidden + unit]
                   : 0.f;
  }
  uint32_t parity = 0;
  long long cyc_wait = 0, cyc_stage = 0, cyc_prod = 0, cyc_gates = 0;

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;

    T x_reg[kItems][4];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      const int unit = unit0 + item % units;
#pragma unroll
      for (int q = 0; q < 4; ++q) x_reg[i][q] = from_f32<T>(0.f);
      if (item < n_items && unit < hidden) {
        const T* src = xw + ((size_t)(item / units) * steps + t) * h4 + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) x_reg[i][q] = src[q * hidden];
      }
    }

    long long c_mark = clock64();
    if (s > 0 || h0) {
      // grid barrier: every block has written h_{s-1}
      if (tid == 0) {
        const unsigned target = nblocks * (unsigned)s;
        while (ld_acquire(counter) < target) watchdog(c_mark);
      }
      __syncthreads();
      long long c_now = clock64();
      cyc_wait += c_now - c_mark;
      c_mark = c_now;

      // h_{s-1}: slot 1 at step 0 (h0), then the slots alternate
      const T* hsrc = state + (size_t)((s + 1) & 1) * batch * hpad;
      Product<T> prod;
      prod.zero();

      for (int k0 = 0; k0 < hpad; k0 += chunk) {
        const int kc = min(chunk, hpad - k0);
        if (k0 > 0) cluster.sync();  // every peer has consumed the last chunk
        if (tid < 32) {
          fence_proxy_async_global();
          if (tid == 0)
            mbar_expect_tx(bar, (uint32_t)(batch * kc * sizeof(T)));
          for (int b = r_lo + tid; b < r_hi; b += 32)
            bulk_multicast(smem_addr(h_s + (size_t)b * hstride),
                           hsrc + (size_t)b * hpad + k0,
                           (uint32_t)(kc * sizeof(T)), bar, mask);
        }
        mbar_wait(bar, parity);
        parity ^= 1;
        c_now = clock64();
        cyc_stage += c_now - c_mark;
        c_mark = c_now;
        // this warp's share of the chunk's k steps
        const int ksteps = kc / kStep;
        const int lo = ksteps * warp / kWarps;
        const int hi = ksteps * (warp + 1) / kWarps;
        for (int kq = lo; kq < hi; ++kq)
          prod.step(h_s, w_s, hstride, wstride, kq * kStep, k0 + kq * kStep,
                    npad);
        c_now = clock64();
        cyc_prod += c_now - c_mark;
        c_mark = c_now;
      }
      __syncthreads();  // every warp is done with h_s: part goes over it
      prod.store(part + (size_t)warp * kRowsS * npad, npad);
      __syncthreads();
    }

    T* h_out = state + (size_t)(s & 1) * batch * hpad;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      const int b = item / units;
      const int uu = item % units;
      const int unit = unit0 + uu;
      if (item >= n_items || unit >= hidden) continue;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      if (s > 0 || h0) {
        const float* p = part + b * npad + 4 * uu;
        for (int w = 0; w < kWarps; ++w, p += kRowsS * npad) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          dot[0] += v.x; dot[1] += v.y; dot[2] += v.z; dot[3] += v.w;
        }
      }
      const float ig = sigmoid(to_f32(x_reg[i][0]) + dot[0]);
      const float fg = sigmoid(to_f32(x_reg[i][1]) + dot[1]);
      const float gg = tanhf(to_f32(x_reg[i][2]) + dot[2]);
      const float og = sigmoid(to_f32(x_reg[i][3]) + dot[3]);
      const float c = fg * c_reg[i] + ig * gg;
      c_reg[i] = c;
      const T hv = from_f32<T>(og * tanhf(c));
      out[((size_t)b * steps + t) * hidden + unit] = hv;
      h_out[(size_t)b * hpad + unit] = hv;
    }
    // h_t of this block is written and part is read: arrive at the grid
    // barrier (release); the next copies (async proxy) follow these
    fence_proxy_async_global();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) arrive_release(counter);
    if (s > 0) cyc_gates += clock64() - c_mark;
  }
  if (c_out != nullptr) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = tid + i * kThreads;
      const int unit = unit0 + item % units;
      if (item < n_items && unit < hidden)
        c_out[(size_t)(item / units) * hidden + unit] = c_reg[i];
    }
  }
  // no block leaves while a copy of its cluster may still be in flight
  cluster.sync();
  if (phases != nullptr && tid == 0) {
    long long* ph = phases + 4 * blockIdx.x;
    ph[0] = cyc_wait;
    ph[1] = cyc_stage;
    ph[2] = cyc_prod;
    ph[3] = cyc_gates;
  }
}

template <typename T>
int launch(const void* xw_v, const void* w_hh_v, void* out_v, void* state_v,
           unsigned* counter, long long* phases, const float* c0,
           float* c_out, int h0, int batch, int steps, int hidden, int hpad,
           int units, int wstride, int chunk, int hstride, int blocks,
           int reverse, int device, cudaStream_t stream) {
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int k_step = Product<T>::kStep;
  const int npad = (4 * units + 7) / 8 * 8;
  const size_t h_bytes = (size_t)kRowsS * hstride * sizeof(T);
  const size_t part_bytes = (size_t)kWarps * kRowsS * npad * sizeof(float);
  const size_t smem = (size_t)hpad * wstride * sizeof(T) +
                      2 * sizeof(uint64_t) +
                      (h_bytes > part_bytes ? h_bytes : part_bytes);
  // the plan the wrapper made must fit this card and this kernel
  if (batch > kRowsS || npad > kMaxCols || wstride < npad ||
      (wstride % 32 != 8 && wstride % 32 != 24) ||
      smem > (size_t)smem_max || hpad % k_step != 0 || hpad < hidden ||
      (hstride * (int)sizeof(T)) % 128 != 16 || hstride < min(chunk, hpad) ||
      chunk % k_step != 0 || (chunk % 32 != 0 && chunk < hpad) ||
      blocks % kCluster != 0 || (size_t)blocks * units < (size_t)hidden)
    return -1;

  auto kern = lstm_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &config);
  if (err != cudaSuccess) return (int)err;
  if (active * kCluster < blocks) return -2;  // not all co-resident
  err = cudaLaunchKernelEx(&config, kern, static_cast<const T*>(xw_v),
                           static_cast<const T*>(w_hh_v), static_cast<T*>(out_v),
                           static_cast<T*>(state_v), counter, phases, c0,
                           c_out, h0, batch, steps, hidden, hpad, units,
                           wstride, chunk, hstride, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// xw (B, T, 4h), w_hh (h, 4h), out (B, T, h): contiguous, float32 (bf16 =
// 0) or bfloat16 (bf16 = 1); state (2, B, hpad) zeroed scratch of the same
// type; counter one zeroed unsigned; phases null or (blocks, 4) int64. A
// carried state: h0 = 1 when the wrapper has put h_{-1} in state slot 1
// (rows (B, hpad) at state + B*hpad, padding zero); c0 null or (B, h)
// float32; c_out null or (B, h) float32, written with the final c. The
// layout (hpad, units, wstride, chunk, hstride, blocks in clusters of
// kCluster) is the wrapper's plan.
// Returns 0 when launched, -1 for a plan this kernel or card does not take,
// -2 when the clusters cannot all be co-resident, else the cudaError_t of
// the launch.
extern "C" int css_lstm(const void* xw, const void* w_hh, void* out,
                        void* state, void* counter, void* phases,
                        const void* c0, void* c_out, int h0, int batch,
                        int steps, int hidden, int hpad, int units,
                        int wstride, int chunk, int hstride, int blocks,
                        int reverse, int bf16, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch == 0 || steps == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* cnt = static_cast<unsigned*>(counter);
  long long* ph = static_cast<long long*>(phases);
  const float* c_in = static_cast<const float*>(c0);
  float* c_fin = static_cast<float*>(c_out);
  return bf16 ? launch<__nv_bfloat16>(xw, w_hh, out, state, cnt, ph, c_in,
                                      c_fin, h0, batch, steps, hidden, hpad,
                                      units, wstride, chunk, hstride, blocks,
                                      reverse, device, s)
              : launch<float>(xw, w_hh, out, state, cnt, ph, c_in, c_fin, h0,
                              batch, steps, hidden, hpad, units, wstride,
                              chunk, hstride, blocks, reverse, device, s);
}
