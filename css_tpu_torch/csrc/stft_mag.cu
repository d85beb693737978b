// K3: fused framing + Hann window + real FFT + magnitude (uncentered,
// frame_len == 2 * hop) for Hopper (sm_90a).
//
// Replaces the Pallas kernel css_tpu/ops/_stft_pallas_r01.py:stft_mag_pallas
// (body _stft_mag_kernel): real (rows, N) -> (rows, T, bins) magnitudes,
// T = (N - frame) / hop + 1, bins = n_fft / 2 + 1,
//
//   X_t[k]    = sum_m w[m] x[t*hop + m] e^{-2 pi i m k / n_fft}
//   out[t, k] = |X_t[k]|        (frame samples past frame_len are zero)
//
// Design. A block owns one batch row and kFrames consecutive frames: it
// stages the (kFrames+1)*hop samples those frames cover in shared memory
// once (the overlapping frame matrix never exists, as on the TPU), and
// each of its kFrames warps computes one frame's real FFT in shared memory:
//   * load: z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], n < M = n_fft/2, the
//     window applied here, stored at the bit-reversed index;
//   * an in-place radix-2 decimation-in-time FFT of z, log2(M) stages,
//     each lane doing M/64 butterflies per stage, __syncwarp between;
//     z[n] lives at n + n/32, a pad that spreads the bit-reversed stores
//     over the banks;
//   * the split step that turns the M-point complex FFT of the packed
//     frame into the 257 bins of the real one:
//       X[k] = (Z[k] + conj Z[M-k]) / 2 - i W^k (Z[k] - conj Z[M-k]) / 2,
//     W = e^{-2 pi i / n_fft}, lanes on consecutive k, and |X[k]| written
//     coalesced.
// The twiddles come from a table the host builds in float64 and stores in
// float32 (no fast-math sin/cos), staged in shared memory once per block
// with the window: W^k, k < M, for the split step, then each FFT stage's
// own twiddles side by side (stage s at [M + 2^s - 1, M + 2^{s+1} - 1)),
// so that the lanes of a stage read consecutive entries. No frame x bins
// analysis matrix is read: a block reads its samples, 4 KB of twiddles and
// 2 KB of window, and writes its magnitudes.
//
// Bound on this card: bytes. At the main shape (32 rows x 38656 samples,
// 150 frames of 512) the signal in and magnitudes out are 9.9 MB, 0.003 ms
// at 3.35 TB/s; the FFT needs ~11.5k operations a frame (55 MFLOP for the
// batch, 0.0008 ms at the FP32 peak), ~45x fewer than the DFT-as-matrix-
// product of the kernel this one replaced. What remains above the bound is
// latency: 608 blocks of 8 warps, each warp a chain of 8 dependent stages
// through shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 8;  // frames per block, one per warp
constexpr int kThreads = 32 * kFrames;

__global__ void __launch_bounds__(kThreads)
stft_mag_kernel(const float* __restrict__ x, const float2* __restrict__ twid,
                const float* __restrict__ window, float* __restrict__ out,
                int n, int num_frames, int hop, int frame_len, int log_m) {
  const int m_pts = 1 << log_m;  // M: complex points, n_fft / 2
  const int n_fft = 2 * m_pts;
  const int bins = m_pts + 1;
  const int z_len = m_pts + (m_pts >> 5);  // z with one pad per 32
  extern __shared__ float4 smem4[];
  float2* tw_s = reinterpret_cast<float2*>(smem4);  // [2M]: split, stages
  float* win_s = reinterpret_cast<float*>(tw_s + 2 * m_pts);  // [n_fft]
  float2* z_all = reinterpret_cast<float2*>(win_s + n_fft);
                                                  // [kFrames][z_len]
  float* xs = reinterpret_cast<float*>(z_all + kFrames * z_len);
                                                  // [(kFrames + 1) * hop]
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const float* src = x + (size_t)row * n + (size_t)t0 * hop;
  // hop-segments t0 .. t0+kFrames that exist ((T+1)*hop <= N)
  const int avail = min(kFrames + 1, num_frames + 1 - t0) * hop;
  for (int idx = threadIdx.x; idx < (kFrames + 1) * hop; idx += kThreads)
    xs[idx] = idx < avail ? src[idx] : 0.f;
  for (int idx = threadIdx.x; idx < 2 * m_pts - 1; idx += kThreads)
    tw_s[idx] = twid[idx];
  for (int idx = threadIdx.x; idx < n_fft; idx += kThreads)
    win_s[idx] = idx < frame_len ? window[idx] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = t0 + warp;
  if (t >= num_frames) return;  // no block-wide barrier follows
  float2* z = z_all + warp * z_len;
  const float* frame = xs + warp * hop;

  // packed, windowed frame at bit-reversed positions
  for (int i = lane; i < m_pts; i += 32) {
    const int m = 2 * i;
    const float re = m < frame_len ? frame[m] * win_s[m] : 0.f;
    const float im = m + 1 < frame_len ? frame[m + 1] * win_s[m + 1] : 0.f;
    const int n_rev = __brev(i) >> (32 - log_m);
    z[n_rev + (n_rev >> 5)] = make_float2(re, im);
  }
  __syncwarp();

  // radix-2 DIT: at span `half`, butterfly b pairs i0 = (b / half) * 2 *
  // half + b % half with i1 = i0 + half, twiddle W_M^{b % half * M / (2 *
  // half)}, the stage table's entry b % half
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
      const float vr = v.x * w.x - v.y * w.y;
      const float vi = v.x * w.y + v.y * w.x;
      z[p0] = make_float2(u.x + vr, u.y + vi);
      z[p1] = make_float2(u.x - vr, u.y - vi);
    }
    __syncwarp();
  }

  // split into the real FFT's bins, magnitudes out
  float* dst = out + ((size_t)row * num_frames + t) * bins;
  for (int k = lane; k < bins; k += 32) {
    const int ka = k & (m_pts - 1), kc = (m_pts - k) & (m_pts - 1);
    const float2 a = z[ka + (ka >> 5)];
    const float2 c = z[kc + (kc >> 5)];
    // E = (a + conj c) / 2, D = (a - conj c) / 2, X = E - i W^k D
    const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
    const float dr = 0.5f * (a.x - c.x), di = 0.5f * (a.y + c.y);
    const float2 w = k < m_pts ? tw_s[k] : make_float2(-1.f, 0.f);
    // -i * (w * D) = (Im(wD), -Re(wD))
    const float wdr = w.x * dr - w.y * di;
    const float wdi = w.x * di + w.y * dr;
    const float xr = er + wdi;
    const float xi = ei - wdr;
    dst[k] = sqrtf(xr * xr + xi * xi);
  }
}

}  // namespace

// x (rows, n) float32; twid (2M - 1) float2: W^k for k < M = n_fft/2, then
// stage s's W^{pos * M >> s} for pos < 2^s, s < log_m; window (frame_len)
// float32;
// out (rows, num_frames, n_fft/2 + 1) float32; n_fft = 2 << log_m, with
// frame_len <= n_fft and frame_len == 2 * hop. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int css_stft_mag(const float* x, const void* twid,
                            const float* window, float* out, int rows, int n,
                            int num_frames, int hop, int frame_len, int log_m,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const int m_pts = 1 << log_m;
  const int z_len = m_pts + (m_pts >> 5);
  const size_t smem = (size_t)2 * m_pts * sizeof(float2) +
                      (size_t)2 * m_pts * sizeof(float) +
                      (size_t)kFrames * z_len * sizeof(float2) +
                      (size_t)(kFrames + 1) * hop * sizeof(float);
  err = cudaFuncSetAttribute(stft_mag_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_frames + kFrames - 1) / kFrames, rows);
  stft_mag_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, static_cast<const float2*>(twid), window, out, n, num_frames, hop,
      frame_len, log_m);
  return (int)cudaGetLastError();
}
