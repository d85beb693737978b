"""K1: masked iSTFT — the CUDA kernel ``csrc/istft.cu`` and its plain version.

Replaces the TPU kernel ``css_tpu/ops/istft_pallas.py:istft_pallas`` (body
``_istft_kernel``): complex (rows, T, bins) -> (rows, (T+1)*hop) float32,
uncentered, frame_len == 2*hop. On the main path it resynthesises every
masked stream of a recording in one launch (``executor/beamformer.py``).

What bounds the function on the H100: bytes — ~0.46 MB in and out per
row, 0.020 ms for the 146 rows of a 60 s recording at 3.35 TB/s; an
inverse FFT needs ~40x fewer operations than that takes. This kernel
computes the DFT as a matrix product instead (2*T*2*bins*frame_len FLOPs
per row, 79 MFLOP at T=150, 0.17 ms for 146 rows at the FP32 peak), so
its own operation count bounds it well above the function's bound; a
radix-FFT design is what closes that gap. The kernel gives each block
one row and 8 hop-slots, stages the 9 contributing spectra in shared
memory and reuses each synthesis-matrix value for the 8 slots from a
register; see the source for the layout.

``istft(spec)`` on a CPU tensor returns the plain version. On a CUDA
tensor it launches the kernel, or raises, except on one route, decided
from the shape alone before any launch and counted in
``istft.plain_routes``: **frame_len != 2*hop, or hop > 1024** (one
thread per sample of a hop-slot), runs the plain version on the card, as
the reference runs such shapes on XLA. More than ``MAX_ROWS`` rows are
split across launches (rows are independent, so this is exact).
``istft.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from css_tpu_torch.ops import _build
from css_tpu_torch.ops import stft as stft_ops

MAX_ROWS = 65535  # rows sit in gridDim.y
MAX_HOP = 1024  # threads per block


def istft_plain(spec: torch.Tensor, frame_len: int = 512,
                hop: int = 256) -> torch.Tensor:
    """The plain PyTorch version: ``ops.stft.istft(center=False)``."""
    return stft_ops.istft(spec, frame_len, hop, center=False)


@functools.lru_cache(maxsize=None)
def _synthesis_interleaved(frame_len: int, n_fft: int,
                           device: torch.device) -> torch.Tensor:
    """(2*bins, frame_len) Hann-windowed synthesis matrix with its [re|im]
    row halves interleaved, to match view_as_real's [re, im] pairs."""
    kern = stft_ops._istft_synthesis_kernel(frame_len, n_fft)
    kern = kern * stft_ops.hann_window(frame_len)[None, :]
    bins = kern.shape[0] // 2
    inter = np.stack([kern[:bins], kern[bins:]], axis=1).reshape(
        2 * bins, frame_len)
    return torch.as_tensor(np.ascontiguousarray(inter, np.float32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _envelope_recip(frame_len: int, hop: int, num_frames: int,
                    device: torch.device) -> torch.Tensor:
    """1 / summed squared-window envelope, 0 where the envelope < 1e-2."""
    w2 = stft_ops.hann_window(frame_len).astype(np.float64) ** 2
    env = np.zeros((num_frames - 1) * hop + frame_len)
    for i in range(num_frames):
        env[i * hop : i * hop + frame_len] += w2
    recip = np.where(env >= 1e-2, 1.0 / np.maximum(env, 1e-2), 0.0)
    return torch.as_tensor(recip.astype(np.float32), device=device)


def istft(spec: torch.Tensor, frame_len: int = 512,
          hop: int = 256) -> torch.Tensor:
    """Complex64 (rows, T, bins) -> float32 (rows, (T+1)*hop)."""
    if spec.device.type == "cpu":
        return istft_plain(spec, frame_len, hop)
    if spec.device.type != "cuda":
        raise ValueError(f"istft: unsupported device {spec.device}")
    if spec.dtype != torch.complex64:
        raise TypeError(f"istft kernel takes complex64, got {spec.dtype}")
    if spec.ndim != 3:
        raise ValueError(f"istft kernel takes (rows, T, bins), got "
                         f"{tuple(spec.shape)}")
    if not spec.is_contiguous():
        raise ValueError("istft kernel needs a contiguous spectrum")
    rows, num_frames, bins = spec.shape
    n_fft = (bins - 1) * 2
    if not 0 < frame_len <= n_fft:
        raise ValueError(f"istft kernel: unsupported shape {tuple(spec.shape)}"
                         f" with frame_len {frame_len}")
    if frame_len != 2 * hop or hop > MAX_HOP:
        istft.plain_routes += 1
        return istft_plain(spec, frame_len, hop)
    ri = torch.view_as_real(spec)  # (rows, T, bins, 2) float32 view
    synth = _synthesis_interleaved(frame_len, n_fft, spec.device)
    env = _envelope_recip(frame_len, hop, num_frames, spec.device)
    out = torch.empty((rows, (num_frames + 1) * hop), dtype=torch.float32,
                      device=spec.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    for lo, hi in _build.split_rows(rows, MAX_ROWS):
        err = lib.css_istft(
            ri[lo].data_ptr(), synth.data_ptr(), env.data_ptr(),
            out[lo].data_ptr(), hi - lo, num_frames, 2 * bins, hop,
            spec.device.index or 0, stream)
        _build.check(err, "istft")
        istft.launches += 1
    return out


istft.launches = 0
istft.plain_routes = 0
