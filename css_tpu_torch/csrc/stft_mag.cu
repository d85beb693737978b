// K3: fused framing + Hann-windowed rDFT + magnitude (uncentered,
// frame_len == 2 * hop) for Hopper (sm_90a).
//
// Replaces the Pallas kernel css_tpu/ops/_stft_pallas_r01.py:stft_mag_pallas
// (body _stft_mag_kernel): real (rows, N) -> (rows, T, bins) magnitudes,
// T = (N - frame) / hop + 1,
//
//   spec[t, f] = sum_m x[t*hop + m] * K[m, f]   (K: (frame, 2*bins),
//                                               [re | im] column halves)
//   out[t, f]  = sqrt(re^2 + im^2)
//
// A block owns one batch row and FT consecutive frames: it stages the
// (FT+1)*hop samples those frames cover in shared memory once (the
// overlapping frame matrix never exists, as on the TPU), and thread f
// computes bin f of all FT frames, reading each pair K[m, f], K[m, bins+f]
// once from L2 (coalesced across f) and reusing it FT times from a
// register, against broadcast shared-memory reads of the samples.
//
// Bound on this card: the function is bound by bytes (~10 MB in and out
// per separator batch of 32 windows of 150 frames; an FFT needs ~40x
// fewer operations than the DFT below). This kernel does the DFT as a
// matrix product, 2 * T * frame * 2*bins FLOPs per row (2.53 GFLOP per
// batch), ~13x the bytes-bound time at the FP32 peak, so its own FLOPs
// bound it. The inner loop is FP32 FMAs; an FFT or tensor cores (wgmma)
// are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 8;  // FT: frames per block

__global__ void stft_mag_kernel(const float* __restrict__ x,
                                const float* __restrict__ kern,
                                float* __restrict__ out, int n,
                                int num_frames, int bins, int hop) {
  extern __shared__ float xs[];  // (kFrames + 1) * hop samples
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const float* src = x + (size_t)row * n + (size_t)t0 * hop;
  // hop-segments t0 .. t0+kFrames that exist ((T+1)*hop <= N)
  const int avail = min(kFrames + 1, num_frames + 1 - t0) * hop;
  for (int idx = threadIdx.x; idx < (kFrames + 1) * hop; idx += blockDim.x) {
    xs[idx] = idx < avail ? src[idx] : 0.f;
  }
  __syncthreads();

  const int f = threadIdx.x;
  if (f >= bins) return;
  const int frame_len = 2 * hop;
  const int two_bins = 2 * bins;
  float re[kFrames], im[kFrames];
#pragma unroll
  for (int q = 0; q < kFrames; ++q) re[q] = im[q] = 0.f;

  for (int m = 0; m < frame_len; ++m) {
    const float kr = kern[(size_t)m * two_bins + f];
    const float ki = kern[(size_t)m * two_bins + bins + f];
#pragma unroll
    for (int q = 0; q < kFrames; ++q) {
      const float v = xs[q * hop + m];
      re[q] = fmaf(v, kr, re[q]);
      im[q] = fmaf(v, ki, im[q]);
    }
  }

  float* dst = out + (size_t)row * num_frames * bins;
#pragma unroll
  for (int q = 0; q < kFrames; ++q) {
    const int t = t0 + q;
    if (t < num_frames) {
      dst[(size_t)t * bins + f] = sqrtf(re[q] * re[q] + im[q] * im[q]);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int css_stft_mag(const float* x, const float* kern, float* out,
                            int rows, int n, int num_frames, int bins,
                            int hop, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const dim3 grid((num_frames + kFrames - 1) / kFrames, rows);
  const int threads = (bins + 31) / 32 * 32;
  const size_t smem = (size_t)(kFrames + 1) * hop * sizeof(float);
  stft_mag_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, kern, out, n, num_frames, bins, hop);
  return (int)cudaGetLastError();
}
