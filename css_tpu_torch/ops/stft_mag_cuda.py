"""K3: STFT magnitude — the CUDA kernel ``csrc/stft_mag.cu`` and its plain
version.

Replaces the TPU kernel ``css_tpu/ops/_stft_pallas_r01.py:stft_mag_pallas``
(body ``_stft_mag_kernel``): real (rows, N) -> (rows, T, bins) float32
magnitudes of the uncentered Hann-windowed STFT, frame_len == 2*hop,
T = (N - frame_len)//hop + 1. On the main path it computes the 1ch
feature magnitude of every separator batch (``ops/features.py``).

What bounds the function on the H100: bytes — ~10 MB in and out per batch
of 32 windows of 150 frames, 0.003 ms at 3.35 TB/s; an FFT needs ~40x
fewer operations than that takes. This kernel computes the DFT as a
matrix product instead (2*T*frame_len*2*bins FLOPs per row, 2.53 GFLOP
per batch, 0.038 ms at the FP32 peak), so its own operation count bounds
it well above the function's bound; a radix-FFT design is what closes
that gap. The kernel stages each block's samples in shared memory once,
so the overlapping frame matrix never reaches device memory, and reuses
each analysis-matrix value for 8 frames from a register; see the source
for the layout.

``stft_mag(x)`` on a CPU tensor returns the plain version; on a CUDA tensor
it launches the kernel or raises (no fallback). ``stft_mag.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from css_tpu_torch.ops import _build
from css_tpu_torch.ops import stft as stft_ops


def stft_mag_plain(x: torch.Tensor, frame_len: int = 512,
                   hop: int = 256) -> torch.Tensor:
    """The plain PyTorch version: ``|ops.stft.stft(center=False)|``."""
    return torch.abs(stft_ops.stft(x, frame_len, hop, center=False))


def stft_mag(x: torch.Tensor, frame_len: int = 512,
             hop: int = 256) -> torch.Tensor:
    """Float32 (rows, N) -> float32 (rows, T, bins)."""
    if x.device.type == "cpu":
        return stft_mag_plain(x, frame_len, hop)
    if x.device.type != "cuda":
        raise ValueError(f"stft_mag: unsupported device {x.device}")
    if frame_len != 2 * hop:
        raise ValueError(f"stft_mag kernel needs frame_len == 2*hop, got "
                         f"{frame_len} and {hop}")
    if x.dtype != torch.float32:
        raise TypeError(f"stft_mag kernel takes float32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"stft_mag kernel takes (rows, N), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("stft_mag kernel needs a contiguous signal")
    rows, n = x.shape
    if n < frame_len or rows > 65535:
        raise ValueError(f"stft_mag kernel: unsupported shape "
                         f"{tuple(x.shape)} with frame_len {frame_len}")
    bins = stft_ops.num_fft_bins(frame_len)
    num_frames = (n - frame_len) // hop + 1
    kern = stft_ops._on_device(stft_ops.stft_analysis_kernel, x.device,
                               frame_len, True, "hann")
    out = torch.empty((rows, num_frames, bins), dtype=torch.float32,
                      device=x.device)
    lib = _build.load_library()
    err = lib.css_stft_mag(
        x.data_ptr(), kern.data_ptr(), out.data_ptr(), rows, n, num_frames,
        bins, hop, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stft_mag")
    stft_mag.launches += 1
    return out


stft_mag.launches = 0
