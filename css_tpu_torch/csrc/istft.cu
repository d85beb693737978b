// K1: masked iSTFT (uncentered, frame_len == 2 * hop) for Hopper (sm_90a).
//
// Replaces the Pallas kernel css_tpu/ops/istft_pallas.py:istft_pallas
// (body _istft_kernel): complex (rows, T, bins) -> real (rows, (T+1)*hop).
//
//   frame_i = [re|im]_i @ S        S: (2*bins, frame) Hann-windowed irfft
//   out[n]  = (frame_i[j] + frame_{i-1}[hop + j]) * env_recip[n]
//             with n = i*hop + j, frames outside [0, T) counted as 0,
//             env_recip = 1/envelope where the squared-window envelope is
//             >= 1e-2, else 0 (precomputed on the host, as on the TPU).
//
// Each output sample takes exactly two frames, so a block owns one batch
// row and FT consecutive hop-slots: it stages the FT+1 contributing
// spectra in shared memory (k-major, so the FT+1 values a thread needs
// for one k sit side by side and every read is a broadcast) and each of
// its `hop` threads produces sample j of each of the FT slots. Nothing
// is accumulated across blocks: no atomics and no frame matrix in device
// memory, as in the TPU kernel.
//
// Bound on this card: the function is bound by bytes (~0.46 MB per row;
// an inverse FFT needs ~40x fewer operations than the DFT below). This
// kernel does the DFT as a matrix product, 2 * T * 2*bins * frame FLOPs
// per row (79 MFLOP at T=150, bins=257), ~8x the bytes-bound time at the
// FP32 CUDA-core peak, so its own FLOPs bound it. The design keeps the synthesis matrix (1 MB) in L2 and reuses each of
// its values for FT slots from a register, so the inner loop is FMAs fed
// by broadcast shared-memory reads. Tensor cores (wgmma) are later work.
//
// The spectrum arrives as torch.view_as_real of a contiguous complex64
// tensor: [re, im] interleaved per bin; S's rows are interleaved to match.

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8;  // FT: hop-slots per block

__global__ void istft_kernel(const float* __restrict__ ri,
                             const float* __restrict__ synth,
                             const float* __restrict__ env_recip,
                             float* __restrict__ out,
                             int num_frames, int two_bins, int hop) {
  extern __shared__ float xs[];  // [two_bins][kSlots + 1]
  const int row = blockIdx.y;
  const int slot0 = blockIdx.x * kSlots;
  const float* src = ri + (size_t)row * num_frames * two_bins;

  // stage frames slot0-1 .. slot0+kSlots-1 (zero outside [0, T))
  for (int idx = threadIdx.x; idx < (kSlots + 1) * two_bins;
       idx += blockDim.x) {
    const int q = idx / two_bins;
    const int k = idx - q * two_bins;
    const int f = slot0 - 1 + q;
    xs[k * (kSlots + 1) + q] =
        (f >= 0 && f < num_frames) ? src[(size_t)f * two_bins + k] : 0.f;
  }
  __syncthreads();

  const int j = threadIdx.x;  // sample within the hop-slot
  const int frame_len = 2 * hop;
  float acc[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) acc[q] = 0.f;

  for (int k = 0; k < two_bins; ++k) {
    const float s_head = synth[(size_t)k * frame_len + j];        // frame i
    const float s_tail = synth[(size_t)k * frame_len + hop + j];  // frame i-1
    const float* xk = xs + k * (kSlots + 1);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      acc[q] = fmaf(xk[q + 1], s_head, acc[q]);
      acc[q] = fmaf(xk[q], s_tail, acc[q]);
    }
  }

  const int total = (num_frames + 1) * hop;
  float* dst = out + (size_t)row * total;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int slot = slot0 + q;
    if (slot <= num_frames) {
      const int n = slot * hop + j;
      dst[n] = acc[q] * env_recip[n];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int css_istft(const float* ri, const float* synth,
                         const float* env_recip, float* out, int rows,
                         int num_frames, int two_bins, int hop, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const dim3 grid((num_frames + 1 + kSlots - 1) / kSlots, rows);
  const size_t smem = (size_t)(kSlots + 1) * two_bins * sizeof(float);
  istft_kernel<<<grid, hop, smem, (cudaStream_t)stream>>>(
      ri, synth, env_recip, out, num_frames, two_bins, hop);
  return (int)cudaGetLastError();
}

