"""K3: STFT magnitude — the CUDA kernel ``csrc/stft_mag.cu`` and its plain
version.

Replaces the TPU kernel ``css_tpu/ops/_stft_pallas_r01.py:stft_mag_pallas``
(body ``_stft_mag_kernel``): real (rows, N) -> (rows, T, bins) float32
magnitudes of the uncentered Hann-windowed STFT, frame_len == 2*hop,
T = (N - frame_len)//hop + 1. On the main path it computes the 1ch
feature magnitude of every separator batch (``ops/features.py``).

What bounds the function on the H100: bytes — ~10 MB in and out per batch
of 32 windows of 150 frames, 0.003 ms at 3.35 TB/s. The kernel computes
each frame's real FFT in shared memory (a half-length complex FFT of the
even/odd-packed frame, then the split step), ~11.5k operations a frame,
so operations are far below the bytes; it reads no analysis matrix, only
a float32 twiddle table built in float64 on the host and the window. See
the source for the layout.

``stft_mag(x)`` on a CPU tensor returns the plain version. On a CUDA
tensor it launches the kernel, or raises, except on one route, decided
from the shape alone before any launch and counted in
``stft_mag.plain_routes``: **frame_len != 2*hop, or an FFT length outside
[4, 2048]**, runs the plain version on the card, as the reference runs
such shapes on XLA. More than ``MAX_ROWS`` rows are split across
launches (rows are independent, so this is exact). ``stft_mag.launches``
counts kernel launches (``ops/_build.py``), a captured program's replays
too (``utils/programs.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from css_tpu_torch.ops import _build
from css_tpu_torch.ops import stft as stft_ops

MAX_ROWS = 65535  # rows sit in gridDim.y
MIN_FFT, MAX_FFT = 4, 2048  # the kernel's FFT lengths (shared memory)


def stft_mag_plain(x: torch.Tensor, frame_len: int = 512,
                   hop: int = 256) -> torch.Tensor:
    """The plain PyTorch version: ``|ops.stft.stft(center=False)|``."""
    return torch.abs(stft_ops.stft(x, frame_len, hop, center=False))


def takes_kernel(frame_len: int, hop: int) -> bool:
    """Whether the kernel computes this framing (else the plain route)."""
    n_fft = stft_ops.num_fft_bins(frame_len) * 2 - 2
    return frame_len == 2 * hop and MIN_FFT <= n_fft <= MAX_FFT


@functools.lru_cache(maxsize=None)
def twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """The FFT kernels' twiddles (K3, and K1 conjugates them), computed in
    float64 and stored in float32: W^j = e^{-2 pi i j / n_fft} as
    (2M - 1, 2) [re, im], M = n_fft/2: W^k for k < M (the split step),
    then for each FFT stage s < log2(M) the 2^s twiddles
    W^{pos * M / 2^s}, pos < 2^s, side by side."""
    m = n_fft // 2
    idx = [np.arange(m)] + [np.arange(1 << s) * (m >> s)
                            for s in range(m.bit_length() - 1)]
    ang = -2.0 * math.pi * np.concatenate(idx) / n_fft
    twid = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.as_tensor(twid, device=device)


@functools.lru_cache(maxsize=None)
def _tables(frame_len: int, device: torch.device):
    """The kernel's twiddles (``twiddles``) for frame_len's FFT length and
    its window, the periodic Hann window of frame_len computed in float64
    and stored in float32."""
    n_fft = stft_ops.num_fft_bins(frame_len) * 2 - 2
    window = stft_ops.hann_window(frame_len, dtype=np.float64)
    return (twiddles(n_fft, device),
            torch.as_tensor(window.astype(np.float32), device=device))


@_build.counted
def stft_mag(x: torch.Tensor, frame_len: int = 512,
             hop: int = 256) -> torch.Tensor:
    """Float32 (rows, N) -> float32 (rows, T, bins)."""
    if x.device.type == "cpu":
        return stft_mag_plain(x, frame_len, hop)
    if x.device.type != "cuda":
        raise ValueError(f"stft_mag: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"stft_mag kernel takes float32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"stft_mag kernel takes (rows, N), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("stft_mag kernel needs a contiguous signal")
    rows, n = x.shape
    if n < frame_len:
        raise ValueError(f"stft_mag kernel: unsupported shape "
                         f"{tuple(x.shape)} with frame_len {frame_len}")
    if not takes_kernel(frame_len, hop):
        _build.KERNELS["stft_mag"].plain_routes += 1
        return stft_mag_plain(x, frame_len, hop)
    bins = stft_ops.num_fft_bins(frame_len)
    log_m = (bins - 1).bit_length() - 1
    num_frames = (n - frame_len) // hop + 1
    twid, window = _tables(frame_len, x.device)
    out = torch.empty((rows, num_frames, bins), dtype=torch.float32,
                      device=x.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for lo, hi in _build.split_rows(rows, MAX_ROWS):
        err = lib.css_stft_mag(
            x[lo].data_ptr(), twid.data_ptr(), window.data_ptr(),
            out[lo].data_ptr(), hi - lo, n, num_frames, hop, frame_len,
            log_m, x.device.index or 0, stream)
        _build.check(err, "stft_mag")
        _build.KERNELS["stft_mag"].launches += 1
    return out
