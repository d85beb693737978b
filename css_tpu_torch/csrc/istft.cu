// K1: masked iSTFT (uncentered, frame_len == 2 * hop) for Hopper (sm_90a).
//
// Replaces the Pallas kernel css_tpu/ops/istft_pallas.py:istft_pallas
// (body _istft_kernel): complex (rows, T, bins) -> real (rows, (T+1)*hop),
// n_fft = 2 * (bins - 1),
//
//   frame_i = irfft_{n_fft}(X_i)[:frame_len] * w      (Im X_i[0] and
//             Im X_i[n_fft/2] ignored, as by irfft and the TPU kernel's
//             synthesis matrix, whose sine rows are 0 there)
//   out[n]  = (frame_i[j] + frame_{i-1}[hop + j]) * env_recip[n]
//             with n = i*hop + j, frames outside [0, T) counted as 0,
//             env_recip = 1/envelope where the squared-window envelope is
//             >= 1e-2, else 0.
//
// The TPU kernel does each frame as one matrix product against a
// (2*bins, frame_len) synthesis matrix, what its matrix unit wants. Here
// that product cost 8.5x the function's bound in FP32 FMAs alone, and
// every block re-read the 1 MB matrix from L2 (~2.9 GB of L2 reads a
// call at the main shape). This kernel reads no matrix: it is K3's FFT
// (stft_mag.cu) run backwards.
//
// Design. A block owns one batch row and kSlots consecutive hop-slots
// (slot s covers samples [s*hop, (s+1)*hop)). Each output sample takes
// exactly two frames, so the block stages the kSlots+1 spectra that feed
// its slots, frames slot0-1 .. slot0+kSlots-1, in shared memory with
// 16-byte loads (consecutive frames are adjacent in device memory; the
// boundary frame is also computed by the neighbouring block, 1/kSlots
// extra FFT work, so nothing is accumulated across blocks: no atomics
// and no frame matrix in device memory, as on the TPU). Then each of its
// kSlots+1 warps computes one frame's inverse real FFT of length N =
// n_fft through an M = N/2-point complex FFT:
//   * split: Z[k] = (X[k] + conj X[M-k]) + i W^{-k} (X[k] - conj X[M-k]),
//     W = e^{-2 pi i / N}, k < M, after zeroing Im X[0] and Im X[M],
//     stored at the bit-reversed index;
//   * an in-place radix-2 decimation-in-time inverse FFT of Z, log2(M)
//     stages, __syncwarp between; z[n] lives at n + n/32, a pad that
//     spreads the bit-reversed stores over the banks; the frame is then
//     x[2n] = Re z[n] / N, x[2n+1] = Im z[n] / N in place.
// After one block-wide barrier the block's threads overlap-add: sample j
// of slot s is (x_s[j] w[j] + x_{s-1}[hop+j] w[hop+j]) / N times the
// envelope reciprocal, written coalesced. The envelope reciprocal is the
// same for every inner slot, so it comes as a (3, hop) table (slot 0,
// inner slots, slot T). The twiddles are K3's table (W^k, then each
// stage's own, side by side, built on the host in float64 and stored in
// float32), conjugated here.
//
// Bound on this card: bytes. At the main shape (146 rows x 150 frames x
// 257 bins in, 146 x 38656 samples out) the spectrum in and the signal
// out are 67.6 MB, 0.020 ms at 3.35 TB/s; the inverse FFTs need ~12k
// operations a frame (0.27 GFLOP, 0.004 ms at the FP32 peak), ~40x fewer
// than the synthesis matrix product. What remains above the bound is
// latency: each warp is a chain of log2(M) dependent stages through
// shared memory, and a block waits at one barrier before its stores.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8;           // hop-slots per block
constexpr int kWarps = kSlots + 1;  // one frame each
constexpr int kThreads = 32 * kWarps;

// Staged spectra (float2 entries): kWarps frames of `bins`, one entry of
// pad in front for alignment, rounded up to an even count so that what
// follows stays 16-byte aligned.
__host__ __device__ inline int staged_len(int bins) {
  return (kWarps * bins + 2) & ~1;
}

__device__ __forceinline__ float frame_sample(const float2* z, int m) {
  const int i = m >> 1;
  return reinterpret_cast<const float*>(z)[2 * (i + (i >> 5)) + (m & 1)];
}

__global__ void __launch_bounds__(kThreads)
istft_kernel(const float2* __restrict__ spec, const float2* __restrict__ twid,
             const float* __restrict__ window,
             const float* __restrict__ env_recip, float* __restrict__ out,
             int num_frames, int hop, int log_m) {
  const int m_pts = 1 << log_m;  // M: complex points, n_fft / 2
  const int bins = m_pts + 1;
  const int z_len = m_pts + (m_pts >> 5);  // z with one pad per 32
  extern __shared__ float4 smem4[];
  float2* xs = reinterpret_cast<float2*>(smem4);  // [staged_len(bins)]
  float2* tw_s = xs + staged_len(bins);            // [2M - 1]
  float2* z_all = tw_s + 2 * m_pts;                // [kWarps][z_len]

  const int row = blockIdx.y;
  const int slot0 = blockIdx.x * kSlots;
  const float2* src = spec + (size_t)row * num_frames * bins;
  // warp q's frame is slot0 - 1 + q; those in [0, T) are q_lo <= q < q_hi
  const int q_lo = slot0 == 0 ? 1 : 0;
  const int q_hi = min(kWarps, num_frames + 1 - slot0);
  // frame q's bins sit at src + first + q*bins and at xs + par + q*bins,
  // par chosen so that a 16-byte aligned pair of entries in device memory
  // is a 16-byte aligned pair in shared memory
  const long long first = (long long)(slot0 - 1) * bins;
  const int par = (int)(((reinterpret_cast<uintptr_t>(src) >> 3) +
                         (uintptr_t)first) & 1);
  const int e_lo = q_lo * bins, e_hi = q_hi * bins;
  if (e_hi > e_lo) {
    const int e_a = e_lo + ((e_lo + par) & 1);  // first aligned pair
    const int pairs = (e_hi - e_a) >> 1;
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int e = e_a + 2 * p;
      *reinterpret_cast<float4*>(xs + par + e) =
          __ldcs(reinterpret_cast<const float4*>(src + (first + e)));
    }
    if (threadIdx.x == 0 && e_a > e_lo) xs[par + e_lo] = src[first + e_lo];
    if (threadIdx.x == kThreads - 1 && e_a + 2 * pairs < e_hi)
      xs[par + e_hi - 1] = src[first + e_hi - 1];
  }
  for (int idx = threadIdx.x; idx < 2 * m_pts - 1; idx += kThreads)
    tw_s[idx] = twid[idx];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float2* z = z_all + warp * z_len;
  if (warp >= q_lo && warp < q_hi) {
    const float2* x = xs + par + warp * bins;
    // split into the M-point spectrum Z, at bit-reversed positions
    for (int k = lane; k < m_pts; k += 32) {
      float2 a = x[k];
      float2 c = x[m_pts - k];
      if (k == 0) a.y = c.y = 0.f;  // Im X[0], Im X[M]: not in the signal
      // S = a + conj c, D = a - conj c, Z = S + i conj(W^k) D
      const float sr = a.x + c.x, si = a.y - c.y;
      const float dr = a.x - c.x, di = a.y + c.y;
      const float2 w = tw_s[k];
      const float tr = w.x * dr + w.y * di;
      const float ti = w.x * di - w.y * dr;
      const int n_rev = __brev(k) >> (32 - log_m);
      z[n_rev + (n_rev >> 5)] = make_float2(sr - ti, si + tr);
    }
    __syncwarp();

    // radix-2 DIT inverse FFT: at span `half`, butterfly b pairs i0 = (b /
    // half) * 2 * half + b % half with i1 = i0 + half, twiddle
    // conj(W_M^{b % half * M / (2 * half)}), the stage table's entry
    // b % half conjugated
    for (int s = 0; s < log_m; ++s) {
      const int half = 1 << s;
      const float2* tw_stage = tw_s + m_pts + half - 1;
      for (int b = lane; b < m_pts / 2; b += 32) {
        const int pos = b & (half - 1);
        const int i0 = ((b >> s) << (s + 1)) + pos;
        const int i1 = i0 + half;
        const int p0 = i0 + (i0 >> 5), p1 = i1 + (i1 >> 5);
        const float2 w = tw_stage[pos];
        const float2 u = z[p0];
        const float2 v = z[p1];
        const float vr = v.x * w.x + v.y * w.y;
        const float vi = v.y * w.x - v.x * w.y;
        z[p0] = make_float2(u.x + vr, u.y + vi);
        z[p1] = make_float2(u.x - vr, u.y - vi);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // overlap-add the block's slots: slot0 + q takes the head of warp q+1's
  // frame and the tail of warp q's
  const float inv_n = 1.f / (float)(2 * m_pts);  // a power of two: exact
  const int n_out = min(kSlots, num_frames + 1 - slot0) * hop;
  float* dst = out + (size_t)row * (num_frames + 1) * hop +
               (size_t)slot0 * hop;
  for (int idx = threadIdx.x; idx < n_out; idx += kThreads) {
    const int q = idx / hop;
    const int j = idx - q * hop;
    const int slot = slot0 + q;
    float acc = 0.f;
    if (slot < num_frames)
      acc = frame_sample(z_all + (q + 1) * z_len, j) * __ldg(window + j);
    if (slot > 0)
      acc = fmaf(frame_sample(z_all + q * z_len, hop + j),
                 __ldg(window + hop + j), acc);
    const int kind = slot == 0 ? 0 : (slot == num_frames ? 2 : 1);
    __stcs(dst + idx, acc * inv_n * __ldg(env_recip + kind * hop + j));
  }
}

}  // namespace

// spec (rows, num_frames, M + 1) complex64 as float2, M = 1 << log_m;
// twid (2M - 1) float2: K3's table, W^k for k < M, then stage s's
// W^{pos * M >> s} for pos < 2^s, s < log_m, W = e^{-2 pi i / (2M)};
// window (2 * hop) float32; env_recip (3, hop) float32: slot 0, inner
// slots, slot num_frames; out (rows, (num_frames + 1) * hop) float32.
// Needs 2 * hop <= 2M. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int css_istft(const void* spec, const void* twid,
                         const float* window, const float* env_recip,
                         float* out, int rows, int num_frames, int hop,
                         int log_m, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const int m_pts = 1 << log_m;
  const int z_len = m_pts + (m_pts >> 5);
  const size_t smem = ((size_t)staged_len(m_pts + 1) + 2 * m_pts +
                       (size_t)kWarps * z_len) * sizeof(float2);
  err = cudaFuncSetAttribute(istft_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_frames + 1 + kSlots - 1) / kSlots, rows);
  istft_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(spec), static_cast<const float2*>(twid),
      window, env_recip, out, num_frames, hop, log_m);
  return (int)cudaGetLastError();
}
